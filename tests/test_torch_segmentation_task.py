"""The S3DIS segmentation task and command line of the port, against the
JAX package where it has a counterpart: the eval hook's OA / mAcc / IoU /
mIoU on the same predictions, the full-width segmenter's parameter tree
against the port's module names, and the command line's ``best_metric``
and logs (a tiny model, a few steps on the CPU).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.tasks import segmentation as jseg
from cloud_transformers_tpu_torch.convert import jax_to_state_dict
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.tasks import segmentation as tseg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_classes=13, model_dim=32, repeats=1,
            stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),))


def test_seg_eval_accumulator_matches_jax():
    rs = np.random.RandomState(2)
    jacc, tacc = jseg.SegEvalAccumulator(6), tseg.SegEvalAccumulator(6)
    for _ in range(3):
        label = rs.randint(0, 5, (2, 50))                 # class 5 absent
        pred = np.where(rs.uniform(size=label.shape) > 0.4, label,
                        rs.randint(0, 6, label.shape))
        jacc({"label": label}, {"pred": jnp.asarray(pred)})
        tacc({"label": label}, {"pred": torch.from_numpy(pred)})
    j, t = jacc.compute(), tacc.compute()
    assert set(j) == set(t) == {"oa", "macc", "miou",
                                *(f"iou_{i}" for i in range(6))}
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    tacc.reset()
    assert not tacc.cm.cm.any()


def test_full_width_names_convert_strictly():
    """The full-width JAX parameter tree (4 scanned stages) maps one-to-one
    onto the port's modules, with matching shapes."""
    jm = jax_model("s3dis_segmenter")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 6)), train=False))
    state = jax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    expected = get_model("s3dis_segmenter").state_dict()
    assert set(state) == set(expected)
    for k, v in expected.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    assert "trunk.stages.3.union_2.attention_1.conv.weight" in state
    assert state["stem.bias"].shape == (512,)


def test_full_width_pad_names_convert_strictly():
    """The same for the KPConv protocol's ``s3dis_segmenter_pad`` (7 stem
    channels: xyz and 4 features)."""
    jm = jax_model("s3dis_segmenter_pad")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 3)), jnp.ones((1, 64)), jnp.zeros((1, 64, 4)),
        train=False))
    state = jax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    expected = get_model("s3dis_segmenter_pad").state_dict()
    assert set(state) == set(expected)
    for k, v in expected.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    assert "trunk.stages.3.union_2.attention_1.conv.weight" in state
    assert state["stem.weight"].shape == (512, 7)


@pytest.mark.parametrize("best,want", [(None, "miou"), ("acc", "acc")])
def test_cli_best_metric_defaults_to_miou(tmp_path, best, want):
    """``configs/s3dis.yaml`` names ``acc``, which the command line keeps;
    a config that names none gets ``miou``, as in the JAX CLI."""
    from cloud_transformers_tpu_torch import train_segmentation
    with open(os.path.join(ROOT, "configs", "s3dis.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    assert cfg["train"]["best_metric"] == "acc"
    cfg["experiment"] = {"root": str(tmp_path / "exp"),
                         "writer_root": str(tmp_path / "runs")}
    cfg["data"].update(batch_size=2, batch_size_val=2, num_points=64,
                       num_workers=2)
    cfg["model"].update(TINY)
    cfg["train"].update(num_epochs=1, show_each=1)
    if best is None:
        del cfg["train"]["best_metric"]
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(
        {**cfg, "model": {**cfg["model"],
                          "stage_plan": [list(map(list, u))
                                         for u in TINY["stage_plan"]]}}))
    trainer = train_segmentation.main(
        ["x", "-c", str(path), "--synthetic", "--steps", "2", "--device",
         "cpu"])
    assert trainer.global_step == 2
    assert trainer.cfg["train"]["best_metric"] == want
    assert (tmp_path / "exp" / "x" / "tiny.yaml").exists()
    first = (tmp_path / "runs" / "x" / "metrics.jsonl").read_text().split(
        "\n")[0]
    assert {"train/loss", "train/acc", "train/data_time",
            "train/batch_time"} <= set(json.loads(first))
