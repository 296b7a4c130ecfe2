"""The ``remat``/``remat_policy`` model keys (``nn/remat.py``).

- A training step of a tiny classifier with scales (two stages), a tiny
  completion inpainter (its encoder and AdaIN decoder) and a tiny KPConv
  segmenter on a ragged mask, under each policy: the loss, every gradient
  and every BatchNorm statistic after the step bit-equal to the step with
  remat off, on the CPU.
- ``full`` moves the running statistics once a step, not once more while
  a stage is recomputed.
- The kernel wrappers' calls a step under each policy are what
  ``chip_smoke.remat_counts`` holds on the card: each head group's splat,
  slice and (X >= 16) 3D conv once more in the backward under
  ``point_io`` and ``full``, nothing more under ``point_io_grids``; the
  inpainter's encoder is under ``point_io`` whatever the decoder's policy,
  as in JAX.
- An unknown policy raises; every key of the JAX models' constructors is
  taken by the port's models, with remat off by default."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from cloud_transformers_tpu.models import _REGISTRY as JAX_REGISTRY
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.models import available_models, get_model
from cloud_transformers_tpu_torch.nn import remat
from cloud_transformers_tpu_torch.nn.init import init_model_
from cloud_transformers_tpu_torch.ops import pallas_grid_conv as tgc
from cloud_transformers_tpu_torch.tasks import classification as tcls
from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as tkp

PLAN = (((4, 4), (2, 2), (16, 16), (2, 3)),)
POOLS = dict(pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
             trunk_width=8)
POLICIES = ("point_io", "point_io_grids", "full", "none", None)


def _classifier(**kw):
    return get_model("scanobject_classifier_scales", n_classes=15,
                     model_dim=32, repeats=2, stage_plan=PLAN, class_dim=32,
                     mask_dim=16, dropout=0.0, **POOLS, **kw)


def _classifier_step(model, rs):
    batch = {"pcd": torch.from_numpy((rs.uniform(-1, 1, (2, 128, 3))
                                      * rs.uniform(0.2, 1, (2, 1, 3))
                                      ).astype(np.float32)),
             "label": torch.tensor([1, 2]),
             "mask": torch.from_numpy(
                 (rs.uniform(size=(2, 128)) > 0.5).astype(np.float32))}
    return tcls.make_loss_fn(0.5)(model, batch)[0]


def _inpainter(**kw):
    return get_model("completion_inpainter", num_latent=16, model_dim=32,
                     latent_width=24, encoder_repeats=1, decoder_repeats=2,
                     stage_plan=PLAN, **POOLS, **kw)


def _inpainter_step(model, rs):
    noise = rs.uniform(-1, 1, (2, 128, 4)).astype(np.float32)
    partial = (rs.uniform(-1, 1, (2, 64, 3))
               * rs.uniform(0.2, 1, (2, 1, 3))).astype(np.float32)
    out, _ = model(torch.from_numpy(noise), torch.from_numpy(partial))
    return (out ** 2).mean()


def _segmenter(**kw):
    return get_model("s3dis_segmenter_pad", model_dim=32, repeats=2,
                     stage_plan=PLAN, **kw)


def _segmenter_step(model, rs):
    mask = np.ones((2, 128), np.float32)
    mask[0, 90:] = 0
    batch = {"points": torch.from_numpy(
                 rs.uniform(-1, 1, (2, 128, 3)).astype(np.float32)),
             "features": torch.from_numpy(
                 rs.uniform(-1, 1, (2, 128, 4)).astype(np.float32)),
             "mask": torch.from_numpy(mask),
             "label": torch.from_numpy(rs.randint(0, 13, (2, 128)))}
    return tkp.make_loss_fn()(model, batch)[0]


ENCODER_CHAIN = {"splat_max": 2, "slice_gather": 2, "grid_conv3d": 1}
MODELS = {"classifier": (_classifier, _classifier_step,
                         lambda p: dict(remat=True, remat_policy=p)),
          "inpainter": (_inpainter, _inpainter_step,
                        lambda p: dict(remat_policy=p)),
          "segmenter_pad": (_segmenter, _segmenter_step,
                            lambda p: dict(remat=True, remat_policy=p))}


def _randomise(model):
    """Random weights, key BatchNorms and frame scales away from their
    initial 0 and 1, running statistics away from 0 and 1, all from one
    seed."""
    init_model_(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(("scales", "key_bn.scale")) or n.endswith(
                    ".scale") and p.dim() == 0:
                p.uniform_(0.2, 0.6, generator=gen)
        for b in model.buffers():
            b.uniform_(0.5, 1.5, generator=gen)
    return model.train()


def _step(build, step, **kw):
    model = _randomise(build(**kw))
    loss = step(model, np.random.RandomState(2))
    loss.backward()
    return (loss.detach(),
            {n: p.grad for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()})


def _spy(monkeypatch):
    calls = {}

    def counted(fn, name):
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper
    for name in ("splat_max", "splat_max_bwd", "slice_gather", "slice_bwd"):
        monkeypatch.setattr(tss, name, counted(getattr(tss, name), name))
    for name in ("grid_conv3d", "grid_conv3d_dw"):
        monkeypatch.setattr(tgc, name, counted(getattr(tgc, name), name))
    return calls


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("policy", POLICIES)
def test_step_under_a_policy_is_bit_equal_to_remat_off(model, policy,
                                                       monkeypatch):
    build, step, keys = MODELS[model]
    calls = _spy(monkeypatch)
    off = _step(build, step)
    per_step = dict(calls)
    calls.clear()
    got = _step(build, step, **keys(policy))
    assert torch.equal(got[0], off[0])
    for want, have in zip(off[1:], got[1:]):
        assert set(want) == set(have)
        for k in want:
            assert torch.equal(have[k], want[k]), k
    want = chip_smoke.remat_counts(remat.policy(policy), per_step)
    if model == "inpainter" and remat.policy(policy) == "point_io_grids":
        # the encoder's one stage (a 16^2 and a 16^3 head group) under
        # point_io
        for name, extra in ENCODER_CHAIN.items():
            want[name] += extra
    assert calls == want


def test_full_moves_the_running_statistics_once(monkeypatch):
    """Under ``full`` each stage runs twice a step; the statistics after
    the step are remat off's, which moved them (so they did move once), and
    with the recompute's guard taken away they land elsewhere."""
    before = {n: b.clone() for n, b in
              _randomise(_classifier()).named_buffers()}
    _, _, off = _step(_classifier, _classifier_step)
    _, _, full = _step(_classifier, _classifier_step, remat=True,
                       remat_policy="full")
    assert sum(not torch.equal(off[n], before[n]) for n in off) > 20
    assert all(torch.equal(full[n], off[n]) for n in off)
    monkeypatch.setattr(remat, "recomputing", lambda: False)
    _, _, twice = _step(_classifier, _classifier_step, remat=True,
                        remat_policy="full")
    assert sum(not torch.equal(twice[n], off[n]) for n in off) > 20


def test_policy_names():
    assert remat.policy("off") is None
    for name in (None, "none", "full"):
        assert remat.policy(name) == "full"
    for name in ("point_io", "point_io_grids"):
        assert remat.policy(name) == name
    for bad in ("point-io", "all", "", True):
        with pytest.raises(ValueError, match="unknown remat policy"):
            remat.policy(bad)
    with pytest.raises(ValueError, match="unknown remat policy"):
        _classifier(remat=True, remat_policy="grids")
    with pytest.raises(ValueError, match="unknown remat policy"):
        _inpainter(remat_policy="grids")
    # remat=False ignores the policy's name, as the JAX models do
    _classifier(remat=False, remat_policy="grids")


def _regions(model):
    return {type(m).__name__: m.remat for m in model.modules()
            if hasattr(m, "remat")}


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_every_jax_constructor_key_is_taken(name):
    """Each JAX model's fields at their JAX defaults construct the port's
    model (remat on, as the JAX defaults say); the port's own defaults
    leave remat off."""
    fields = {f.name: f.default for f in dataclasses.fields(
        JAX_REGISTRY[name]) if f.name not in ("parent", "name")}
    assert name in available_models()
    assert {"remat_policy"} <= set(fields)
    model = get_model(name, **fields)
    assert set(_regions(model).values()) == {"point_io"}
    assert set(_regions(get_model(name)).values()) == {None}
