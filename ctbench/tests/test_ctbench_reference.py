"""The plain reference against the program at a tiny size on the CPU: one
training step's loss, every leaf's gradient and the running statistics,
with the same weights, batch and dropout seed."""

import numpy as np
import pytest
import torch

from ctbench.core.weights import fill_
from ctbench.reference import classifier, mhct, segmenter_pad, train

from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.tasks import classification as tcls
from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as tseg

from ctbench.tests._tiny import TINY_MODEL

TRAIN = {"optimizer": {"type": "Adam", "lr": 1e-3}, "seg_weight": 0.5,
         "clip_grad_norm": 10.0}


def _classifier_batch(rs):
    # 4 clouds: the class vector's BatchNorm over 2 would make its
    # gradient hang on the rounding of two values
    return {"pcd": (rs.randn(4, 128, 3) * 0.5).astype(np.float32),
            "label": np.array([1, 4, 0, 14]),
            "mask": (rs.rand(4, 128) > 0.5).astype(np.float32)}


def _segmenter_batch(rs):
    mask = np.zeros((2, 128), np.float32)
    mask[0, :50] = 1
    mask[1, :100] = 1
    return {"points": (rs.randn(2, 128, 3) * 0.5).astype(np.float32),
            "mask": mask, "features": rs.randn(2, 128, 4).astype(np.float32),
            "label": rs.randint(0, 13, (2, 128))}


CASES = {
    "classifier": ("scanobject_classifier", classifier, _classifier_batch,
                   lambda: tcls.make_loss_fn(0.5), {}),
    "segmenter_pad": ("s3dis_segmenter_pad", segmenter_pad,
                      _segmenter_batch, tseg.make_loss_fn,
                      {"n_classes": 13}),
}


@pytest.mark.parametrize("family", sorted(CASES))
def test_one_step_against_the_program(family):
    name, ref, make_batch, make_loss, extra = CASES[family]
    model_cfg = dict(TINY_MODEL, **extra)
    model = get_model(name, **model_cfg)
    weights, buffers = fill_(model, 7, "cpu")
    batch = make_batch(np.random.RandomState(0))
    model.train()
    torch.manual_seed(11)
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    tensors["label"] = tensors["label"].long()
    loss, _ = make_loss()(model, tensors)
    loss.backward()
    out = train.run_steps(ref, model_cfg, dict(TRAIN, clip_grad_norm=None),
                          weights, buffers, [batch], [11], "cpu")
    ref_loss = out["loss"][0]
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    norms = {k: float(g.norm()) for k, g in out["grad"].items()}
    floor = mhct.median(list(norms.values()))
    for k, p in model.named_parameters():
        gap = float((p.grad - out["grad"][k]).norm())
        assert gap <= 1e-3 * max(norms[k], floor), k
    for k, v in model.named_buffers():
        torch.testing.assert_close(v, out["params"][k], rtol=1e-5,
                                   atol=1e-6)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    # the spacing is 2^-10 at 1 and 2^-9 at 3
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.0 + 2 ** -11,
                      3.0 + 3 * 2 ** -11])
    got = mhct.tf32_round(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0, 3.0, 3.0 + 2 ** -9]
