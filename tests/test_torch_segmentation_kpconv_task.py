"""The KPConv-protocol S3DIS task and command lines of the port, against
the JAX package where it has a counterpart.

* The metric functions (``confusion_np``, ``iou_from_confusions`` with its
  absent-class substitution, ``part_metrics``, ``sub_metrics``,
  ``full_metrics``) and ``batch_rotate_scale_jitter``: bit-equal to the JAX
  module's on random inputs.
* ``validate_votes`` through a stub ``eval_step`` (logits a fixed function
  of the batch, a tensor for the port, an array for JAX) over 3 votes on
  small synthetic validation sets: every result bit-equal.
* The reference checkpoint (``synth_reference_segmenter_sd``'s names and
  shapes): the port's converter gives exactly the state that the JAX
  package's ``tools/convert_torch_checkpoint.convert_segmenter_pad``
  followed by ``jax_to_state_dict`` gives, at full width; at model_dim 32
  the port's logits against the JAX model loaded through the JAX tool, by
  the PARITY.md criteria (cosine > 0.999, median abs error <= 1e-3 of the
  logits' scale, max(1, max |logit|)); a
  ``.t7`` file loads through ``load_reference_segmenter_pad``.
* Both command lines, tiny, on the CPU: training (2 steps, then a 1-vote
  validation) and evaluation from its checkpoint.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cloud_transformers_tpu.data.loader import DataLoader as JaxLoader
from cloud_transformers_tpu.data.s3dis_kpconv import S3DISSeg as JaxSeg
from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.tasks import segmentation_kpconv as jtask
from cloud_transformers_tpu_torch.convert import (
    jax_to_state_dict,
    load_reference_segmenter_pad,
    reference_segmenter_pad_state_dict,
)
from cloud_transformers_tpu_torch.data import DataLoader, S3DISSeg
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as ttask
from tests.test_checkpoint_convert import synth_reference_segmenter_sd
from tools.convert_torch_checkpoint import convert_segmenter_pad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_dim=32, repeats=1,
            stage_plan=[[[4, 4], [2, 2], [16, 16], [2, 3]]])


def _equal_results(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_metrics_bit_equal_to_jax():
    rs = np.random.RandomState(0)
    c = 13
    truth = [rs.randint(0, c - 1, n) for n in (300, 41, 7)]   # class 12 absent
    logits = [rs.randn(t.size, c).astype(np.float32) for t in truth]
    np.testing.assert_array_equal(ttask.confusion_np(truth[0], truth[0], c),
                                  jtask.confusion_np(truth[0], truth[0], c))
    conf = rs.randint(0, 50, (c, c)).astype(np.float64)
    conf[3] = 0
    np.testing.assert_array_equal(ttask.iou_from_confusions(conf),
                                  jtask.iou_from_confusions(conf))
    props = rs.uniform(1, 100, c).astype(np.float32)
    _equal_results(dict(enumerate(ttask.part_metrics(c, logits, truth,
                                                     props))),
                   dict(enumerate(jtask.part_metrics(c, logits, truth,
                                                     props))))
    votes = [rs.randn(c, t.size).astype(np.float32) for t in truth]
    _equal_results(dict(enumerate(ttask.sub_metrics(c, votes, truth,
                                                    props))),
                   dict(enumerate(jtask.sub_metrics(c, votes, truth,
                                                    props))))
    proj = [rs.randint(0, t.size, 2 * t.size) for t in truth]
    full = [rs.randint(0, c, 2 * t.size) for t in truth]
    _equal_results(dict(enumerate(ttask.full_metrics(c, votes, proj, full))),
                   dict(enumerate(jtask.full_metrics(c, votes, proj, full))))


def test_rotate_scale_jitter_bit_equal_to_jax():
    pts = np.random.RandomState(1).randn(3, 500, 3).astype(np.float32)
    kw = dict(x_range=0.3, y_range=0.2, augment_symmetries=(True, True,
                                                            False))
    for args in ({}, kw):
        got = ttask.batch_rotate_scale_jitter(pts, np.random.RandomState(2),
                                              **args)
        want = jtask.batch_rotate_scale_jitter(pts, np.random.RandomState(2),
                                               **args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _stub_logits(batch):
    """Logits [B, N, 13], a fixed function of the batch's inputs."""
    w = np.random.RandomState(3).randn(7, 13).astype(np.float32)
    x = np.concatenate([batch["points"], batch["features"]], -1)
    return np.tanh(x @ w)


def test_validate_votes_equal_to_jax():
    kw = dict(split="val", num_points=512, num_steps=4, num_epochs=5,
              in_radius=0.6, subsampling_parameter=0.08)
    calls = []

    def t_step(batch):
        calls.append(batch["points"].shape)
        return {"logits": torch.from_numpy(_stub_logits(batch))}

    def j_step(batch):
        return {"logits": jnp.asarray(_stub_logits(batch))}

    t_ds, j_ds = S3DISSeg(**kw), JaxSeg(**kw)
    got = ttask.validate_votes(t_step, t_ds, DataLoader(t_ds, 2, False), 13,
                               num_votes=3)
    want = jtask.validate_votes(j_step, j_ds, JaxLoader(j_ds, 2, False), 13,
                                num_votes=3)
    assert len(calls) == 3 * 2 and calls[0] == (2, 512, 3)
    _equal_results(got, want)
    assert {"part_miou", "sub_miou", "running_sub_miou", "miou",
            "ious"} == set(got)
    assert 0 < got["miou"] < 1 and got["ious"].shape == (13,)


def _scaled_reference_sd(model_dim):
    """The reference state dict's names and shapes, with values of a
    trained-like scale: kernels by 1 / sqrt(fan in), BatchNorm scales
    about 1 (0.2-0.6 on the keys), biases and running means about 0,
    running variances about 1, so that the random 12-block network's
    activations and keys stay O(1)."""
    rs = np.random.RandomState(1)
    sd = synth_reference_segmenter_sd(np.random.RandomState(0),
                                      model_dim=model_dim)
    bns = {k[:-len(".running_var")] for k in sd if k.endswith("running_var")}
    for k, v in sd.items():
        layer, leaf = k.rsplit(".", 1)
        if layer in bns:
            lo, hi = (0.2, 0.6) if layer.endswith("key_bn") else (0.5, 1.5)
            v = (rs.uniform(lo, hi, v.shape) if leaf in ("weight",
                                                         "running_var")
                 else 0.1 * rs.randn(*v.shape))
        elif leaf == "weight" and v.ndim >= 3:
            v = v / np.sqrt(np.prod(v.shape[1:]))
        elif leaf == "bias":
            v = 0.1 * v
        sd[k] = np.asarray(v, np.float32)
    return sd


def test_reference_state_dict_matches_the_jax_tool():
    """Full width: the same tensors by either route, loaded strictly."""
    sd = _scaled_reference_sd(512)
    params, stats = convert_segmenter_pad(sd)
    want = jax_to_state_dict({"params": params, "batch_stats": stats})
    got = reference_segmenter_pad_state_dict(
        {f"module.{k}": v for k, v in sd.items()})
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    get_model("s3dis_segmenter_pad").load_state_dict(got, strict=True)
    with pytest.raises(KeyError, match="no counterpart"):
        reference_segmenter_pad_state_dict(dict(sd, **{"extra.0.weight":
                                                        sd["final.3.bias"]}))


def test_reference_checkpoint_logits_match_jax(tmp_path):
    sd = _scaled_reference_sd(32)
    params, stats = convert_segmenter_pad(sd)
    jm = jax_model("s3dis_segmenter_pad", model_dim=32, remat=False)
    rs = np.random.RandomState(1)
    pts = rs.uniform(-1, 1, (1, 64, 3)).astype(np.float32)
    feats = rs.uniform(-1, 1, (1, 64, 4)).astype(np.float32)
    mask = np.ones((1, 64), np.float32)
    mask[:, 40:] = 0
    pts[:, 40:], feats[:, 40:] = pts[:, :24], feats[:, :24]
    j_logits, _ = jm.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(pts), jnp.asarray(mask),
                           jnp.asarray(feats), train=False)
    path = tmp_path / "s3dis_kpconvprotocol.t7"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    tm = load_reference_segmenter_pad(
        get_model("s3dis_segmenter_pad", model_dim=32), str(path)).eval()
    with torch.no_grad():
        t_logits, _ = tm(torch.from_numpy(pts), torch.from_numpy(mask),
                         torch.from_numpy(feats))
    a = np.asarray(j_logits, np.float64)[mask > 0].ravel()
    b = t_logits.numpy().astype(np.float64)[mask > 0].ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    # the median error against the logits' scale, as chip_smoke.py's
    # card-vs-CPU comparisons take it
    scale = max(1.0, np.abs(a).max())
    p50 = np.median(np.abs(a - b)) / scale
    assert cos > 0.999 and p50 <= 1e-3, (cos, p50, scale)


@pytest.fixture
def tiny_config(tmp_path):
    with open(os.path.join(ROOT, "configs", "s3dis_kpconv.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["experiment"] = {"root": str(tmp_path / "exp"),
                         "writer_root": str(tmp_path / "runs")}
    cfg["data"].update(batch_size=2, batch_size_val=2, num_points=128,
                       num_steps=4, num_workers=2, in_radius=0.5,
                       sampleDl=0.08)
    cfg["model"].update(TINY)
    cfg["train"].update(num_epochs=2, show_each=1)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return tmp_path, path


def test_cli_train_then_eval_on_cpu(tiny_config):
    from cloud_transformers_tpu_torch import (
        eval_segmentation_kpconv,
        train_segmentation_kpconv,
    )
    torch.set_num_threads(1)
    tmp_path, path = tiny_config
    trainer, results = train_segmentation_kpconv.main(
        ["x", "-c", str(path), "--synthetic", "--steps", "2",
         "--num-votes", "1", "--device", "cpu"])
    assert trainer.global_step == 2
    assert trainer.cfg["train"]["clip_grad_norm"] == 10.0
    ckpt = tmp_path / "exp" / "x" / "ckpt_latest.pt"
    assert ckpt.exists() and (tmp_path / "exp" / "x" / "tiny.yaml").exists()
    for k in ("part_miou", "sub_miou", "miou"):
        assert 0.0 <= results[k] <= 1.0, k
    evaluated = eval_segmentation_kpconv.main(
        ["x", "-c", str(path), "--synthetic", "--ckpt", str(ckpt),
         "--num-votes", "1", "--device", "cpu"])
    assert evaluated["ious"].shape == (13,)
    for k in ("part_miou", "sub_miou", "running_sub_miou", "miou"):
        assert 0.0 <= evaluated[k] <= 1.0, k
