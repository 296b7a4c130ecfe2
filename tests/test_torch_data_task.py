"""Port parity: the ScanObjectNN data path, the classification loss and
metrics, the config loader and the training command line, against the JAX
package on the CPU.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cloud_transformers_tpu.data import (
    DataLoader as JDataLoader,
    ScanObjectNN as JScanObjectNN,
)
from cloud_transformers_tpu.tasks import classification as jcls
from cloud_transformers_tpu.utils.metrics import (
    ConfusionAccumulator as JConfusionAccumulator,
)
from cloud_transformers_tpu_torch.data import DataLoader, ScanObjectNN
from cloud_transformers_tpu_torch.nn import precision
from cloud_transformers_tpu_torch.tasks import classification as tcls
from cloud_transformers_tpu_torch.train.config import (
    experiment_dirs,
    load_config,
    model_from_config,
)
from cloud_transformers_tpu_torch.utils.metrics import ConfusionAccumulator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_MODEL = dict(model_dim=32, repeats=1,
                  stage_plan=[[[4, 4], [2, 2], [16, 16], [2, 3]]],
                  pool_heads=2, pool_feature_dims=[4, 4], pool_sizes=[4, 8],
                  trunk_width=8, class_dim=32, mask_dim=16)


def _datasets(train, **kw):
    kw = dict(train=train, synthetic_items=24, num_points=64, seed=3, **kw)
    return JScanObjectNN(None, **kw), ScanObjectNN(None, **kw)


@pytest.mark.parametrize("train,subsample", [(True, None), (False, None),
                                             (True, 32)])
def test_synthetic_items_match_jax(train, subsample):
    jds, tds = _datasets(train, subsample=subsample)
    assert len(jds) == len(tds) == 24
    for epoch in (0, 2):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for item in (0, 7, 23):
            a, b = jds[item], tds[item]
            assert set(a) == set(b) == {"pcd", "label", "mask"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    if train:                                    # augmentation moves by epoch
        tds.set_epoch(0)
        first = tds[0]["pcd"]
        tds.set_epoch(1)
        assert np.abs(first - tds[0]["pcd"]).max() > 1e-3


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_yields_the_jax_loaders_batches(shuffle, drop_last):
    jds, tds = _datasets(True)
    jl = JDataLoader(jds, 5, shuffle=shuffle, seed=1, drop_last=drop_last)
    tl = DataLoader(tds, 5, shuffle=shuffle, seed=1, drop_last=drop_last)
    assert len(jl) == len(tl) == (4 if drop_last else 5)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for a, b in zip(jb, tb):
            assert b["pcd"].shape == (5, 64, 3) and b["label"].shape == (5,)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_loss_and_metrics_match_jax_on_fixed_logits():
    rs = np.random.RandomState(0)
    b, p, c = 4, 10, 15
    class_pred = rs.randn(b, c).astype(np.float32) * 3
    mask_pred = rs.randn(b, p, 1).astype(np.float32) * 2
    stats = [{"occupancy": np.float32(v)} for v in (0.25, 0.5, 0.125)]
    batch = {"pcd": rs.randn(b, p, 3).astype(np.float32),
             "label": rs.randint(0, c, b).astype(np.int32),
             "mask": (rs.uniform(size=(b, p)) > 0.5).astype(np.float32)}
    batch["label"][0] = class_pred[0].argmax()   # at least one hit

    def apply_fn(variables, pcd, train, rngs, mutable):
        return (jnp.asarray(class_pred), jnp.asarray(mask_pred),
                [{k: jnp.asarray(v) for k, v in s.items()}
                 for s in stats]), {}

    j_loss, j_aux, _ = jcls.make_loss_fn(0.3)(
        apply_fn, {}, {k: jnp.asarray(v) for k, v in batch.items()}, None,
        True)

    def model(pcd):
        return (torch.from_numpy(class_pred), torch.from_numpy(mask_pred),
                [{k: torch.tensor(v) for k, v in s.items()} for s in stats])

    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch["label"] = t_batch["label"].long()
    t_loss, t_aux = tcls.make_loss_fn(0.3)(model, t_batch)

    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    assert set(t_aux) == set(j_aux)
    for k in j_aux:
        np.testing.assert_allclose(t_aux[k].numpy(), np.asarray(j_aux[k]),
                                   rtol=1e-6, err_msg=k)
    assert float(t_aux["cls_acc"]) > 0


def test_confusion_accumulator_matches_jax():
    rs = np.random.RandomState(1)
    jacc, tacc = JConfusionAccumulator(5), ConfusionAccumulator(5)
    for _ in range(3):
        pred, label = rs.randint(0, 4, 40), rs.randint(0, 4, 40)  # class 4
        valid = (rs.uniform(size=40) > 0.2)                       # absent
        jacc.update(pred, label, valid)
        tacc.update(pred, label, valid)
    np.testing.assert_array_equal(tacc.cm, jacc.cm)
    j, t = jacc.compute(), tacc.compute()
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=1e-7)
    hook = tcls.ClassEvalAccumulator(5)
    hook({"label": np.array([0, 1, 1])}, {"pred": torch.tensor([0, 1, 2])})
    assert hook.compute() == {"cls_acc": pytest.approx(2 / 3),
                              "m_acc": pytest.approx(0.75)}
    hook.reset()
    assert hook.cm.cm.sum() == 0


def _tiny_config(tmp_path):
    cfg = load_config(os.path.join(ROOT, "configs", "scanobjectnn.yaml"))
    assert cfg["train"]["optimizer"] == {
        "type": "Adam", "lr": 1e-3, "betas": [0.9, 0.999],
        "weight_decay": 0.0}
    cfg["experiment"] = {"root": str(tmp_path / "exp"),
                         "writer_root": str(tmp_path / "runs")}
    cfg["data"].update(batch_size=2, batch_size_val=2, num_points=128)
    cfg["model"].update(TINY_MODEL)
    cfg["train"]["show_each"] = 1
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def test_config_builds_the_model_and_the_datasets(tmp_path):
    cfg, path = _tiny_config(tmp_path)
    model = model_from_config(load_config(path))
    assert len(model.backbone.trunk.stages) == 1
    assert model.class_head.out_features == 15
    try:
        model_from_config({"model": {"name": "scanobject_classifier",
                                     "mxu_dtype": "bfloat16", **TINY_MODEL}})
        assert precision.resolve() is torch.bfloat16
        with pytest.raises(TypeError):
            model_from_config({"model": {"name": "scanobject_classifier",
                                         "mxu_dtype": "bfloat17"}})
    finally:
        precision.set_default_mxu_dtype(None)
    model_from_config(load_config(path))
    assert precision.resolve() is None
    exp_dir, writer_dir = experiment_dirs(cfg, "run")
    assert os.path.isdir(exp_dir) and os.path.isdir(writer_dir)
    train_loader, val_loader = tcls.make_datasets(cfg, synthetic=True)
    batch = next(iter(train_loader))
    assert batch["pcd"].shape == (2, 128, 3) and batch["mask"].shape == (2,
                                                                         128)
    assert train_loader.dataset.train and not val_loader.dataset.train
    assert not val_loader.shuffle


def test_training_command_line_runs_on_the_cpu(tmp_path):
    _, path = _tiny_config(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m",
         "cloud_transformers_tpu_torch.train_classification", "x", "-c",
         path, "--synthetic", "--steps", "2", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 2" in out.stderr and "done: 2 steps" in out.stderr
    assert os.path.isdir(tmp_path / "exp" / "x")
