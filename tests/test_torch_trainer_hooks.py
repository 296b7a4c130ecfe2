"""What the port's ``Trainer`` took over from the JAX trainer besides its
steps: the metric logger (``metrics.jsonl``, the config copy), the
``data_time``/``batch_time`` split, ``grad_stats``, the profiler trace,
the ``epoch_hook`` and ``mesh_hook`` cadence (and the completion task's
mesh hook), the retry and quarantine of an auto-resume, and the loader's
worker threads.  CPU only, no JAX.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
import yaml

from cloud_transformers_tpu_torch.data import DataLoader, Indoor3DSemSeg
from cloud_transformers_tpu_torch.train import trainer as trainer_mod
from cloud_transformers_tpu_torch.train.trainer import (
    Trainer,
    unreadable_checkpoint,
)

STEPS_PER_EPOCH = 3


class _Loader:
    """Three batches an epoch, each of its own values."""

    epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        for i in range(STEPS_PER_EPOCH):
            rs = np.random.RandomState(10 * self.epoch + i)
            yield {"x": rs.randn(4, 3).astype(np.float32),
                   "y": rs.randn(4, 2).astype(np.float32)}


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(3, 5)
        self.b = torch.nn.Linear(5, 2)
        self.unused = torch.nn.Linear(1, 1)   # never gets a gradient

    def forward(self, x):
        return self.b(torch.relu(self.a(x)))


def _loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean(), {}


def _cfg(tmp_path, **train):
    return {"experiment": {"root": str(tmp_path / "exp"),
                           "writer_root": str(tmp_path / "runs")},
            "train": {"optimizer": {"type": "Adam", "lr": 1e-2},
                      "show_each": 2, "save": False, **train}}


def _trainer(tmp_path, config_path=None, **train):
    return Trainer(_Model(), _cfg(tmp_path, **train), "run", _loss,
                   device="cpu", seed=0, config_path=config_path)


def _jsonl(tmp_path):
    path = tmp_path / "runs" / "run" / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_metrics_jsonl_and_the_config_copy(tmp_path):
    path = tmp_path / "mine.yaml"
    path.write_text(yaml.safe_dump(_cfg(tmp_path)))
    trainer = _trainer(tmp_path, config_path=str(path), val_step=1)
    trainer.fit(_Loader(), val_loader=_Loader(), num_epochs=2)
    assert (tmp_path / "exp" / "run" / "mine.yaml").read_text() == \
        path.read_text()
    lines = _jsonl(tmp_path)
    train = [m for m in lines if "train/loss" in m]
    val = [m for m in lines if "val/loss" in m]
    # show_each 2 over 6 steps, one validation an epoch
    assert [m["step"] for m in train] == [2, 4, 6]
    assert [m["step"] for m in val] == [3, 6]
    for m in train:
        assert set(m) == {"step", "time", "train/loss",
                          "train/steps_per_sec", "train/data_time",
                          "train/batch_time"}
        assert m["train/data_time"] >= 0 and m["train/batch_time"] > 0
    assert set(val[0]) == {"step", "time", "val/loss"}
    # the window mean of the loss is the mean of its steps' losses
    assert np.isfinite(train[0]["train/loss"])


def test_grad_norm_is_the_norm_of_all_gradients(tmp_path):
    trainer = _trainer(tmp_path, grad_stats=True)
    batch = next(iter(_Loader()))
    m = trainer.train_step(batch)
    named = dict(trainer.model.named_parameters())
    want = torch.cat([p.grad.reshape(-1) for p in named.values()
                      if p.grad is not None]).norm()
    torch.testing.assert_close(m["grad_norm"], want, rtol=1e-6, atol=0)
    for n, p in named.items():
        got = m[f"grad_norm/{n}"]
        assert got.dim() == 0
        if p.grad is None:
            assert n.startswith("unused.") and float(got) == 0.0
        else:
            torch.testing.assert_close(got, p.grad.norm(), rtol=1e-6, atol=0)
    # and it reaches the log, per parameter too
    trainer.fit(_Loader(), max_steps=3)
    logged = [m for m in _jsonl(tmp_path) if "train/grad_norm" in m]
    assert logged and "train/grad_norm/a.weight" in logged[0]


def test_no_grad_stats_without_the_key(tmp_path):
    trainer = _trainer(tmp_path)
    assert set(trainer.train_step(next(iter(_Loader())))) == {"loss"}


@pytest.mark.parametrize("max_steps", [4, None])
def test_profiler_trace_written(tmp_path, max_steps):
    """A trace from ``profile_step`` for ``profile_steps`` steps, also when
    ``max_steps`` ends the run inside the window, and the tracer's spans of
    those steps beside it."""
    from cloud_transformers_tpu_torch.utils import trace as tracer
    trainer = _trainer(tmp_path, profile_step=2, profile_steps=5)
    trainer.fit(_Loader(), num_epochs=3, max_steps=max_steps)
    out = tmp_path / "exp" / "run" / "profile"
    stop = 4 if max_steps else 7
    assert sorted(os.listdir(out)) == [f"spans_step{stop}.json",
                                       f"trace_step{stop}.json"]
    trace = json.loads((out / f"trace_step{stop}.json").read_text())
    assert trace["traceEvents"]
    assert not torch.autograd._profiler_enabled()   # off again
    spans = json.loads((out / f"spans_step{stop}.json").read_text())
    steps = [s for s in spans["spans"] if s["name"] == "trainer.step"]
    assert spans["clock"] == "time.time_ns" and len(steps) == stop - 2
    assert not tracer.TRACER.on   # off again


def test_epoch_hook_and_mesh_hook_cadence(tmp_path):
    calls = {"epoch": [], "mesh": []}

    def epoch_hook(epoch):
        calls["epoch"].append(epoch)
        return {"vote_miou": 0.5 + epoch}

    def mesh_hook(trainer, batch):
        assert set(batch) == {"x", "y"}
        calls["mesh"].append(trainer.global_step)

    trainer = _trainer(tmp_path, val_step=2, mesh_each=2)
    trainer.fit(_Loader(), num_epochs=4, epoch_hook=epoch_hook,
                mesh_hook=mesh_hook)
    assert calls["epoch"] == [1, 3]              # after every val_step epochs
    assert calls["mesh"] == [2, 4, 6, 8, 10, 12]
    hooked = [m for m in _jsonl(tmp_path) if "val/vote_miou" in m]
    assert [(m["step"], m["val/vote_miou"]) for m in hooked] == [
        (6, 1.5), (12, 3.5)]
    # mesh_each defaults to 100
    calls["mesh"].clear()
    _trainer(tmp_path / "b").fit(_Loader(), num_epochs=2,
                                 mesh_hook=mesh_hook)
    assert calls["mesh"] == []


def _saved(tmp_path, steps=2):
    """A trainer that saved ckpt_latest after ``steps`` steps."""
    trainer = _trainer(tmp_path, save=True)
    trainer.fit(_Loader(), max_steps=steps)
    return trainer


def test_torn_latest_is_quarantined_and_the_run_starts_fresh(tmp_path,
                                                             caplog):
    first = _saved(tmp_path)
    path = first.ckpt.path("latest")
    data = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(data[:len(data) // 2])
    fresh = _trainer(tmp_path / "other")
    with caplog.at_level("WARNING", "cloud_transformers_tpu_torch"):
        again = _trainer(tmp_path, save=True)
    assert "retrying" in caplog.text and "AUTO-RESUME FAILED" in caplog.text
    assert again.global_step == 0 and again.epoch == 0
    for (n, p), q in zip(again.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(p, q), n
    left = sorted(os.listdir(first.exp_dir))
    assert "ckpt_latest.pt" not in left
    moved = [f for f in left if f.startswith("ckpt_latest_unreadable_")]
    assert len(moved) == 1
    assert open(os.path.join(first.exp_dir, moved[0]), "rb").read() == \
        data[:len(data) // 2]


@pytest.mark.parametrize("payload", ["foreign", "missing_key", "shape"])
def test_structural_mismatch_is_quarantined(tmp_path, payload):
    first = _saved(tmp_path)
    ckpt = first.checkpoint()
    if payload == "foreign":
        ckpt = {"weights": [1, 2, 3]}
    elif payload == "missing_key":
        del ckpt["optimizer"]
    else:
        ckpt["model"]["a.weight"] = torch.zeros(7, 3)
    first.ckpt.save(ckpt, "latest")
    again = _trainer(tmp_path, save=True)
    assert again.global_step == 0
    assert not again.ckpt.exists("latest")


def test_other_errors_are_raised_after_one_retry(tmp_path, monkeypatch):
    first = _saved(tmp_path)
    tries = []

    def failing(tag="latest"):
        tries.append(tag)
        raise OSError("the disk went away")
    monkeypatch.setattr(trainer_mod.CheckpointManager, "restore",
                        staticmethod(failing))
    with pytest.raises(OSError):
        _trainer(tmp_path, save=True)
    assert tries == ["latest", "latest"]
    assert first.ckpt.exists("latest")           # left where it was


def test_a_transient_failure_is_retried(tmp_path, monkeypatch):
    first = _saved(tmp_path, steps=2)
    real = trainer_mod.CheckpointManager.restore
    tries = []

    def flaky(self, tag="latest"):
        tries.append(tag)
        if len(tries) == 1:
            raise OSError("interrupted read")
        return real(self, tag)
    monkeypatch.setattr(trainer_mod.CheckpointManager, "restore", flaky)
    again = _trainer(tmp_path, save=True)
    assert len(tries) == 2 and again.global_step == 2
    assert first.ckpt.exists("latest")


def test_which_errors_mean_an_unreadable_checkpoint(tmp_path):
    assert unreadable_checkpoint(KeyError("model"))
    assert unreadable_checkpoint(EOFError())
    assert unreadable_checkpoint(RuntimeError(
        "PytorchStreamReader failed reading zip archive"))
    assert unreadable_checkpoint(RuntimeError(
        "Error(s) in loading state_dict for Linear"))
    assert not unreadable_checkpoint(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Error(s) in loading state_dict"))
    assert not unreadable_checkpoint(RuntimeError("CUDA error: launch"))
    assert not unreadable_checkpoint(OSError("no space"))
    # torch's zip reader says EINVAL for some torn files: an OSError counts
    # where the file is no whole archive, and never for a missing file
    whole = _saved(tmp_path).ckpt.path("latest")
    torn = str(tmp_path / "torn.pt")
    with open(whole, "rb") as fh, open(torn, "wb") as out:
        out.write(fh.read()[:-100])
    err = OSError(22, "Invalid argument")
    assert unreadable_checkpoint(err, torn)
    assert not unreadable_checkpoint(err, whole)
    assert not unreadable_checkpoint(err, str(tmp_path / "missing.pt"))


def test_loader_batches_do_not_depend_on_the_workers():
    ds = Indoor3DSemSeg(num_points=64, synthetic_items=10, aug=True)
    runs = {}
    for workers in (0, 1, 4):
        loader = DataLoader(ds, 3, shuffle=True, seed=2, drop_last=False,
                            num_workers=workers)
        assert loader.prefetch == max(2, workers)
        runs[workers] = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            runs[workers] += list(loader)
    assert len(runs[0]) == 8
    for workers in (1, 4):
        for a, b in zip(runs[0], runs[workers], strict=True):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_loader_stops_its_threads_and_passes_errors_on():
    class Failing:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise ValueError("item 4")
            return {"x": np.full(2, i)}

    before = threading.active_count()
    for workers in (0, 4):
        it = iter(DataLoader(Failing(), 2, shuffle=False,
                             num_workers=workers))
        assert next(it)["x"][0, 0] == 0
        it.close()                               # the consumer stops early
        with pytest.raises(ValueError, match="item 4"):
            list(DataLoader(Failing(), 2, shuffle=False,
                            num_workers=workers))
    assert threading.active_count() == before


def test_completion_mesh_hook_logs_the_clouds(tmp_path):
    from cloud_transformers_tpu_torch.data.completion import (
        ShapeNetCompletion,
    )
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.tasks import completion
    tiny = dict(num_latent=16, model_dim=32, latent_width=24,
                encoder_repeats=1, decoder_repeats=1,
                stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),),
                pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
                trunk_width=8)
    gen = torch.Generator().manual_seed(1)
    trainer = Trainer(get_model("completion_inpainter", **tiny),
                      _cfg(tmp_path, mesh_each=1), "run",
                      completion.make_loss_fn(gen), device="cpu")
    ds = ShapeNetCompletion(split="train", n_renders=1, n_input=64,
                            n_output=128)
    batch = DataLoader(ds, 5, shuffle=False)._build_batch(np.arange(5), 0)
    logged = []
    trainer.metrics.mesh = lambda step, tag, points: logged.append(
        (step, tag, np.asarray(points).shape))
    trainer.global_step = 7
    hook = completion.make_mesh_hook(max_clouds=4)
    hook(trainer, batch)
    assert trainer.model.training                # back in training mode
    assert logged == [(7, "train/recon", (4, 128, 3)),
                      (7, "train/gt", (4, 128, 3)),
                      (7, "train/partial_input", (4, 64, 3))]
