"""The single-view reconstruction task and command lines of the port, on
the CPU without JAX: the loss function (the auction EMD on the model's
reconstruction of sphere noise, the Chamfer monitor without a gradient,
the occupancy), the mesh hook, the training command line (a tiny config,
a few synthetic steps, a validation and ``ckpt_best``), the evaluation's
two-pass merge and per-class table, and the model registry.

The reconstructor has no depth knob, so the tiny model patches the module
names ``AdaInDecoder`` and ``ResNet50`` where ``Reconstructor`` looks them
up, as ``tests/test_torch_reconstructor.py`` does.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import yaml

import cloud_transformers_tpu_torch.models.reconstructor as trec_mod
import cloud_transformers_tpu_torch.nn.resnet as tresnet
from cloud_transformers_tpu_torch import eval_reconstruction_f1 as ev
from cloud_transformers_tpu_torch.data import DataLoader, ImageToPoint
from cloud_transformers_tpu_torch.models import available_models, get_model
from cloud_transformers_tpu_torch.models.inpainter import AdaInDecoder
from cloud_transformers_tpu_torch.nn.init import init_model_
from cloud_transformers_tpu_torch.tasks import reconstruction
from cloud_transformers_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PLAN = (((4, 4), (2, 2), (16, 8), (2, 3)),)
WIDTHS = dict(num_latent=16, model_dim=32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test runs: the suite's worker processes
    share the CPU's cores, and a pool of a thread for every core in each
    worker oversubscribes them (``tests/test_torch_chip_smoke.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def tiny(monkeypatch):
    """``get_model("image_reconstructor", **WIDTHS)`` builds one TINY
    decoder stage and a (1, 1, 1, 1) ResNet while the test runs."""
    monkeypatch.setattr(trec_mod, "AdaInDecoder",
                        lambda dim, latent, repeats, plan: AdaInDecoder(
                            dim, latent, 1, TINY_PLAN))
    monkeypatch.setattr(tresnet, "ResNet50", functools.partial(
        tresnet.ResNet50, stage_sizes=(1, 1, 1, 1)))


def _model(seed=0):
    return init_model_(get_model("image_reconstructor", **WIDTHS),
                       torch.Generator().manual_seed(seed))


def _batch(b=2, points=64, im_size=32):
    ds = ImageToPoint(split="train", im_size=im_size, points=points)
    return DataLoader(ds, b, shuffle=False)._build_batch(np.arange(b), 0)


def test_loss_fn(tiny):
    model = _model().train()
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    gen = torch.Generator().manual_seed(1)
    loss, aux = reconstruction.make_loss_fn(gen)(model, batch)
    assert loss.requires_grad and np.isfinite(float(loss.detach()))
    assert set(aux) == {"loss_chamfer", "occupancy_mean"}
    assert not aux["loss_chamfer"].requires_grad
    assert float(aux["loss_chamfer"]) > 0
    assert np.isfinite(float(aux["occupancy_mean"].detach()))
    loss.backward()
    assert model.res50.trunk.stem_conv.weight.grad.abs().max() > 0
    # the noise is drawn from the generator: the same state, the same loss
    again, _ = reconstruction.make_loss_fn(
        torch.Generator().manual_seed(1))(model, batch)
    assert float(again.detach()) == float(loss.detach())


def test_mesh_hook_logs_the_clouds(tiny, tmp_path):
    cfg = {"experiment": {"root": str(tmp_path / "exp")},
           "train": {"optimizer": {"type": "Adam", "lr": 1e-4}}}
    trainer = Trainer(get_model("image_reconstructor", **WIDTHS), cfg, "run",
                      reconstruction.make_loss_fn(torch.Generator()),
                      device="cpu")
    logged = []
    trainer.metrics.mesh = lambda step, tag, points: logged.append(
        (step, tag, np.asarray(points).shape))
    trainer.global_step = 7
    trainer.model.train()
    reconstruction.make_mesh_hook(max_clouds=2)(trainer, _batch(b=3))
    assert trainer.model.training                # back in training mode
    assert logged == [(7, "train/recon", (2, 64, 3)),
                      (7, "train/gt", (2, 64, 3))]


def test_cli_trains_validates_and_keeps_the_best(tiny, tmp_path):
    from cloud_transformers_tpu_torch import train_image_reconstruction
    with open(os.path.join(ROOT, "configs", "reconstruction.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["experiment"] = {"root": str(tmp_path / "exp"),
                         "writer_root": str(tmp_path / "runs")}
    # 32 synthetic items: 2 steps an epoch, a validation after each
    cfg["data"].update(batch_size=16, batch_size_val=16, im_size=32,
                       gt_size=64, num_workers=2)
    cfg["model"].update(WIDTHS)
    cfg["train"].update(show_each=1)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = train_image_reconstruction.main(
        ["x", "-c", str(path), "--synthetic", "--steps", "3", "--device",
         "cpu"])
    assert trainer.global_step == 3
    assert trainer.device == torch.device("cpu")
    exp = tmp_path / "exp" / "x"
    assert (exp / "tiny.yaml").exists()
    assert (exp / "ckpt_best.pt").exists()
    assert (exp / "ckpt_latest.pt").exists()
    logged = [json.loads(line) for line in
              (tmp_path / "runs" / "x" / "metrics.jsonl").read_text()
              .splitlines()]
    assert {"train/loss", "train/loss_chamfer", "train/occupancy_mean",
            "train/data_time"} <= set(logged[0])
    val = [m for m in logged if "val/loss" in m]
    assert len(val) == 1 and val[0]["step"] == 2
    assert np.isfinite(val[0]["val/loss"])


def test_clis_default_to_the_card():
    from cloud_transformers_tpu_torch import train_image_reconstruction
    for mod in (train_image_reconstruction, ev):
        with pytest.raises(SystemExit):
            mod.main(["--help"])
    import inspect
    for mod in (train_image_reconstruction, ev):
        assert 'ap.add_argument("--device", default="cuda")' in \
            inspect.getsource(mod.main)


def test_merge_keeps_points_of_both_passes_once():
    b, n = 3, 8192
    # each point names itself: pass, row and index
    idx = torch.arange(n, dtype=torch.float32)
    r1 = torch.stack([torch.zeros(b, n), torch.arange(b)[:, None].expand(
        b, n).float(), idx.expand(b, n)], -1)
    r2 = r1.clone()
    r2[..., 0] = 1
    gen = torch.Generator().manual_seed(4)
    merged = ev.merge_passes(r1, r2, 10000, gen)
    assert merged.shape == (b, 10000, 3)
    keys = (merged[..., 0] * n + merged[..., 2]).long()
    # 10000 distinct points of the 16384, from both passes, the same
    # choice for every row of the batch, each row's own points
    for i in range(b):
        assert len(torch.unique(keys[i])) == 10000
        assert (merged[i, :, 1] == i).all()
    assert torch.equal(keys[0], keys[1]) and torch.equal(keys[0], keys[2])
    assert 0 < int((merged[0, :, 0] == 0).sum()) < 10000
    # the draw is the generator's
    again = ev.merge_passes(r1, r2, 10000, torch.Generator().manual_seed(4))
    assert torch.equal(again, merged)
    with pytest.raises(ValueError):
        ev.merge_passes(r1, r2, 2 * n + 1, gen)


def test_evaluate_scores_two_merged_passes(tiny, monkeypatch):
    import cloud_transformers_tpu_torch.losses as losses
    seen = []
    f_score = losses.f_score

    def spy(pred, gt, threshold):
        seen.append((tuple(pred.shape), tuple(gt.shape), threshold))
        return f_score(pred, gt, threshold=threshold)
    monkeypatch.setattr(losses, "f_score", spy)
    ds = ImageToPoint(split="test", im_size=32, points=10000)
    loader = DataLoader(ds, 2, shuffle=False, drop_last=False)
    per_class = ev.evaluate(_model(), loader, torch.Generator().manual_seed(1),
                            "cpu", limit=1)
    assert seen == [((2, 10000, 3), (2, 10000, 3), 0.01)]
    assert list(per_class) == [0]
    m = per_class[0]
    assert {k: len(v) for k, v in m.items()} == {"f": 2, "p": 2, "r": 2,
                                                 "seconds": 2}
    for k in ("f", "p", "r"):
        assert all(0.0 <= x <= 1.0 for x in m[k])
    table = ev.format_table(per_class, ds.class_names).splitlines()
    assert table[0] == "class\t#\tF\tprec\trecall"
    assert table[1].startswith("synthetic\t2\t")
    assert table[-1] == f"mean F: {np.mean(m['f']):.4f}"


def test_available_models_and_generator_paths():
    """The six ported models are registered, and every reference
    ``generator:`` path of a ported model resolves to the port's class."""
    from cloud_transformers_tpu_torch import models
    names = available_models()
    assert names == sorted(names)
    assert {"scanobject_classifier", "completion_inpainter",
            "s3dis_segmenter", "image_reconstructor",
            "s3dis_segmenter_pad", "scanobject_classifier_scales"} \
        <= set(names)
    resolved = 0
    for path, name in models._GENERATOR_ALIASES.items():
        if name not in names:
            continue
        for alias in (path, path.replace("model_zoo", "model_zoo_tpu")):
            cls = type(models.get_model(alias, **(
                WIDTHS if name == "image_reconstructor" else {})))
            assert cls is models._REGISTRY[name], alias
        resolved += 1
    assert resolved == 6
    with pytest.raises(KeyError, match="image_reconstructor"):
        models.get_model("no_such_model")
