"""The operand policy (``nn/precision.py``) against the JAX package's.

* ``MXULinear``/``MXUConv{1,2,3}d``, the library branch of ``GridConvK``
  and ``GroupedConv`` under bf16 on the same weights and inputs as JAX's
  ``MXUDense``/``MXUConv``/``GridConvK``/``GroupedConv`` under bf16: the
  output is float32; against the port's own float32 its relative error is
  above 0 and below 0.03 (as the JAX package's ``tests/test_precision.py``
  asserts); against JAX's bf16 every element is within one bf16 rounding
  (2**-7 of its magnitude, the two frameworks sum the float32 products in
  another order before the cast), and most are equal.
* The modules that the policy casts in each of the six models are the
  JAX package's: its ``MXUDense``/``MXUConv``/``GroupedConv``/``GridConvK``
  instances (found by a flax method interceptor) mapped to the port's names
  by ``convert.py``'s rules, against the port's ``MXU*``/``GroupedConv``/
  ``GridConvK`` modules.
* A tiny classifier under bf16 on both sides: eval logits, and one
  training step's loss and gradients, by PARITY.md (cosine > 0.999, median
  error <= 1e-3 of the scale).
* ``model_from_config`` with each ``mxu_dtype`` spelling; an unknown name
  raises.

The policy is process-wide on both sides; a fixture sets both back to
float32 and clears the JAX caches after each test.
"""

from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.core.splat_slice import (
    gridk_to_spatial as j_to_spatial,
    spatial_to_gridk as j_to_gridk,
)
from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.nn import grouped_conv as jgc
from cloud_transformers_tpu.nn import precision as jprec
from cloud_transformers_tpu.tasks import classification as jcls
from cloud_transformers_tpu_torch import convert
from cloud_transformers_tpu_torch.core.splat_slice import (
    gridk_to_spatial,
    spatial_to_gridk,
)
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.nn import grouped_conv as tgc
from cloud_transformers_tpu_torch.nn import precision as tprec
from cloud_transformers_tpu_torch.tasks import classification as tcls
from cloud_transformers_tpu_torch.train.config import model_from_config

BF16_ULP = 2.0 ** -7   # a bf16 rounding step, relative to the magnitude

PLAN = (((4, 4), (2, 2), (16, 16), (2, 3)),)
TRUNK = dict(pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
             trunk_width=8)
TINY = dict(n_classes=15, model_dim=32, repeats=1, stage_plan=PLAN,
            class_dim=32, mask_dim=16, **TRUNK)


@pytest.fixture(autouse=True)
def _f32_after():
    yield
    tprec.set_default_mxu_dtype(None)
    jprec.set_default_mxu_dtype(None)
    jax.clear_caches()


def _bf16(on):
    tprec.set_default_mxu_dtype("bfloat16" if on else None)
    jprec.set_default_mxu_dtype("bfloat16" if on else None)
    jax.clear_caches()


def _held_to_jax(got16, got32, ref16, bias):
    """``got16`` (port bf16) against the port's f32 and JAX's bf16."""
    assert got16.dtype == np.float32
    rel = np.abs(got16 - got32).max() / np.abs(got32).max()
    assert 0 < rel < 0.03, rel
    pre = np.abs(ref16 - bias)        # the contraction before the bias
    err = np.abs(got16 - ref16)
    assert (err <= BF16_ULP * pre + 1e-6).all(), (err - BF16_ULP * pre).max()
    assert (err <= 1e-6).mean() > 0.9


def _apply_both(jmod, tmod, x_jax, x_port, to_numpy):
    """Outputs at f32 and bf16 of JAX ``jmod`` (variables from numpy) and the
    port's ``tmod`` loaded from them."""
    rs = np.random.RandomState(1)
    v = jax.tree_util.tree_map(np.asarray,
                               jmod.init(jax.random.PRNGKey(0), x_jax))
    v["params"]["bias"] = rs.randn(*v["params"]["bias"].shape).astype(
        np.float32)
    convert.load_jax_variables(tmod, v)
    out = {}
    for on in (False, True):
        _bf16(on)
        with torch.no_grad():
            got = tmod(x_port)
        out[on] = (to_numpy(got), np.asarray(jmod.apply(v, x_jax)))
    return out, v["params"]["bias"]


@pytest.mark.parametrize("case", ["dense", "conv1d", "conv2d_grouped",
                                  "conv3d_strided", "resnet_stem"])
def test_mxu_modules_under_bf16_match_jax(case):
    rs = np.random.RandomState(0)
    if case == "dense":
        x = rs.randn(4, 7, 64).astype(np.float32)
        jmod = jprec.MXUDense(48)
        tmod = tprec.MXULinear(64, 48)
        xj, xt, back = jnp.asarray(x), torch.from_numpy(x), lambda t: t
    else:
        dim, cin, cout, k, stride, pad, groups = {
            "conv1d": (1, 8, 12, 3, 1, 1, 1),
            "conv2d_grouped": (2, 16, 24, 3, 1, 1, 4),
            "conv3d_strided": (3, 8, 16, 3, 2, 1, 2),
            "resnet_stem": (2, 3, 16, 7, 2, 3, 1)}[case]
        x = rs.randn(*((2,) + (10,) * dim + (cin,))).astype(np.float32)
        jmod = jprec.MXUConv(cout, (k,) * dim, strides=stride, padding=pad,
                             feature_group_count=groups)
        tmod = tprec.mxu_conv(dim)(cin, cout, k, stride=stride,
                                   padding=pad, groups=groups)
        xj, xt = jnp.asarray(x), torch.from_numpy(x).movedim(-1, 1)
        back = lambda t: t.movedim(1, -1)   # noqa: E731
    out, bias = _apply_both(jmod, tmod, xj, xt,
                            lambda t: back(t).numpy())
    (got32, ref32), (got16, ref16) = out[False], out[True]
    np.testing.assert_allclose(got32, ref32, rtol=0, atol=1e-4)
    _held_to_jax(got16, got32, ref16, bias)


@pytest.mark.parametrize("sizes", [(8, 8, 8), (16, 16)])
def test_grid_conv_library_branch_under_bf16_matches_jax(sizes):
    feat, heads, b = 4, 2, 2
    rs = np.random.RandomState(0)
    gs = np.maximum(rs.randn(b, *sizes, heads * feat), 0).astype(np.float32)
    jmod = jgc.GridConvK(feat=feat, heads=heads, sizes=sizes)
    jgk = j_to_gridk(jnp.asarray(gs), heads, sizes, feat)
    tmod = tgc.GridConvK(feat, heads, sizes)
    assert not tgc.kernel_wins(sizes)
    out, bias = _apply_both(
        jmod, tmod, jgk, spatial_to_gridk(torch.from_numpy(gs), heads, sizes,
                                          feat),
        lambda t: gridk_to_spatial(t, b, sizes, feat).numpy())
    for on in out:
        out[on] = (out[on][0],
                   np.asarray(j_to_spatial(jnp.asarray(out[on][1]), b, sizes,
                                           feat)))
    (got32, ref32), (got16, ref16) = out[False], out[True]
    np.testing.assert_allclose(got32, ref32, rtol=0, atol=1e-5)
    _held_to_jax(got16, got32, ref16, bias)


def test_grid_conv_kernel_branch_stays_f32():
    sizes, feat, heads = (16, 16, 16), 2, 2
    rs = np.random.RandomState(0)
    gk = torch.from_numpy(rs.randn(2 * heads, 16 ** 3, feat).astype(
        np.float32))
    tmod = tgc.GridConvK(feat, heads, sizes)
    with torch.no_grad():
        tmod.weight.normal_()
        f32 = tmod(gk)
        _bf16(True)
        assert torch.equal(tmod(gk), f32)


@pytest.mark.parametrize("dim,groups", [(2, 4), (3, 2), (2, 1)])
def test_grouped_conv_under_bf16_matches_jax(dim, groups):
    cin, cout = 8 * groups, 4 * groups
    rs = np.random.RandomState(0)
    x = rs.randn(*((2,) + (6,) * dim + (cin,))).astype(np.float32)
    jmod = jgc.GroupedConv(cout, kernel_size=(3,) * dim, groups=groups,
                           padding=1)
    tmod = tgc.GroupedConv(cin, cout, (3,) * dim, groups=groups, padding=1)
    out, bias = _apply_both(jmod, tmod, jnp.asarray(x),
                            torch.from_numpy(x).movedim(-1, 1),
                            lambda t: t.movedim(1, -1).numpy())
    (got32, ref32), (got16, ref16) = out[False], out[True]
    np.testing.assert_allclose(got32, ref32, rtol=0, atol=1e-5)
    _held_to_jax(got16, got32, ref16, bias)


# --- the policy-cast modules of each model --------------------------------

def _pcd(b=1, p=64):
    return jnp.asarray(np.random.RandomState(0).uniform(-1, 1, (b, p, 3)),
                       jnp.float32)


def _recon_inputs():
    return (_pcd(1, 16), jnp.zeros((1, 64, 64, 3), jnp.float32))


def _tiny_recon():
    """Both reconstructors with one decoder stage and a (1, 1, 1, 1)
    ResNet, as ``tests/test_torch_reconstructor.py`` builds them."""
    import functools

    import cloud_transformers_tpu.models.reconstructor as jrec
    import cloud_transformers_tpu.nn.resnet as jres
    import cloud_transformers_tpu_torch.models.reconstructor as trec
    import cloud_transformers_tpu_torch.nn.resnet as tres
    from cloud_transformers_tpu.models.classifier import TINY_STAGE_PLAN
    from cloud_transformers_tpu.models.inpainter import AdaInDecoder as JDec
    from cloud_transformers_tpu_torch.models.inpainter import AdaInDecoder

    mp = pytest.MonkeyPatch()
    mp.setattr(jrec, "AdaInDecoder", functools.partial(
        JDec, repeats=1, stage_plan=TINY_STAGE_PLAN, remat=False))
    mp.setattr(jres, "ResNet50", functools.partial(
        jres.ResNet50, stage_sizes=(1, 1, 1, 1)))
    mp.setattr(trec, "AdaInDecoder", lambda dim, latent, repeats, plan:
               AdaInDecoder(dim, latent, 1, TINY_STAGE_PLAN))
    mp.setattr(tres, "ResNet50", functools.partial(
        tres.ResNet50, stage_sizes=(1, 1, 1, 1)))
    return mp


MODELS = {
    "scanobject_classifier": (dict(TINY, repeats=2), lambda: (_pcd(),)),
    "scanobject_classifier_scales": (TINY, lambda: (_pcd(),)),
    "s3dis_segmenter": (dict(n_classes=13, model_dim=32, repeats=1,
                             stage_plan=PLAN), lambda: (_pcd(),)),
    "s3dis_segmenter_pad": (
        dict(n_classes=13, model_dim=32, repeats=1, stage_plan=PLAN),
        lambda: (_pcd(), jnp.ones((1, 64)), jnp.zeros((1, 64, 4)))),
    "completion_inpainter": (
        dict(num_latent=16, model_dim=32, latent_width=24, encoder_repeats=1,
             decoder_repeats=2, stage_plan=PLAN, **TRUNK),
        lambda: (jnp.zeros((1, 32, 4)), _pcd())),
    "image_reconstructor": (dict(num_latent=16, model_dim=32),
                            _recon_inputs),
}


def _jax_cast_modules(name, kw, inputs):
    jm = jax_model(name, **kw)
    found = set()
    kinds = (jprec.MXUDense, jprec.MXUConv, jgc.GroupedConv, jgc.GridConvK)

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module,
                                                            kinds):
            found.add(tuple(context.module.scope.path))
        return next_fun(*args, **kwargs)

    with flax.linen.intercept_methods(record):
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, *inputs, train=False))
    # the port's module names of each JAX module, one per scanned stage
    names = set()
    params = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                    shapes["params"])
    for key, _, _, path, _ in convert._entries(params):
        if path[:-1] in found:
            names.add(key.rsplit(".", 1)[0])
    assert len(names) >= len(found)
    return names


@pytest.mark.parametrize("name", sorted(MODELS))
def test_policy_cast_modules_are_the_jax_packages(name):
    kw, inputs = MODELS[name]
    mp = _tiny_recon() if name == "image_reconstructor" else None
    try:
        want = _jax_cast_modules(name, kw, inputs())
        tm = get_model(name, **kw)
    finally:
        if mp is not None:
            mp.undo()
    cast = tprec.MXU_MODULES + (tgc.GroupedConv, tgc.GridConvK)
    got = {n for n, m in tm.named_modules() if isinstance(m, cast)}
    assert got == want
    # the AdaINs' dense layers are plain nn.Linear on both sides
    adain = {n for n, m in tm.named_modules()
             if type(m) is torch.nn.Linear}
    assert all(n.endswith(".dense") for n in adain)
    assert bool(adain) == (name in ("completion_inpainter",
                                    "image_reconstructor"))


# --- a tiny classifier under bf16 on both sides ---------------------------

# the tiny classifier of the module sets, with 2D 8^2 and 3D 8^3 head grids
# (the library branch, which the policy casts) and the pools at the full
# model's 8^3 and 16^2: a pool trunk's last BatchNorm then normalizes over
# more than a few values, which would amplify bf16 rounding without bound
STEP = dict(TINY, stage_plan=(((4, 4), (2, 2), (8, 8), (2, 3)),),
            pool_sizes=(8, 16))


def _batch(seed=0, b=4, p=128):
    rs = np.random.RandomState(seed)
    return {"pcd": rs.uniform(-1, 1, (b, p, 3)).astype(np.float32),
            "label": rs.randint(0, 15, b).astype(np.int32),
            "mask": (rs.uniform(size=(b, p)) > 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def classifier():
    """JAX variables from the port's initialisation (``eval_shape`` gives
    the tree), the BatchNorm scales and statistics randomised from numpy,
    the key BatchNorms' scales left at 0 as when training starts: the keys
    are then the input geometry on both sides, bit for bit.  With a key
    scale of 0.2-0.6, a bf16 rounding of one framework's key offsets moves
    points across cell edges where the other's does not, and one bf16
    gradient agrees with another no better than with itself in float32."""
    from cloud_transformers_tpu_torch.nn.init import init_model_

    batch = _batch()
    jm = jax_model("scanobject_classifier", **STEP)
    shapes = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.asarray(batch["pcd"]), train=False)))
    port = init_model_(get_model("scanobject_classifier", **STEP),
                       torch.Generator().manual_seed(0))
    v = {"params": convert.port_to_jax_tree(dict(port.named_parameters()),
                                            shapes["params"]),
         "batch_stats": convert.port_to_jax_tree(dict(port.named_buffers()),
                                                 shapes["batch_stats"])}
    rs = np.random.RandomState(0)

    def scales(path, a):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] != "scale" or "key_bn" in names:
            return np.asarray(a)
        return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)

    def stats(path, a):
        lo, hi = (-0.1, 0.1) if path[-1].key == "mean" else (0.5, 1.5)
        return rs.uniform(lo, hi, a.shape).astype(np.float32)

    v["params"] = jax.tree_util.tree_map_with_path(scales, v["params"])
    v["batch_stats"] = jax.tree_util.tree_map_with_path(stats,
                                                        v["batch_stats"])
    return jm, v, batch


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def _parity(got, ref, what):
    cos = _cos(got, ref)
    p50 = np.median(np.abs(np.asarray(got, np.float64) - ref)) / max(
        1.0, np.abs(ref).max())
    assert cos > 0.999 and p50 <= 1e-3, (what, cos, p50)


def test_classifier_eval_under_bf16_matches_jax(classifier):
    jm, v, batch = classifier
    tm = convert.load_jax_variables(get_model("scanobject_classifier",
                                              **STEP), v).eval()
    x = torch.from_numpy(batch["pcd"])
    with torch.no_grad():
        t32 = [t.numpy() for t in tm(x)[:2]]
    _bf16(True)
    j16 = jm.apply(v, jnp.asarray(batch["pcd"]), train=False)[:2]
    with torch.no_grad():
        t16 = [t.numpy() for t in tm(x)[:2]]
    for got, ref, f32, what in zip(t16, j16, t32, ("logits", "mask")):
        _parity(got, np.asarray(ref), f"bf16 {what}")
        assert np.abs(got - f32).max() > 0     # the policy took effect


def _leaves(tree, prefix=()):
    for k, a in tree.items():
        if hasattr(a, "items"):
            yield from _leaves(a, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(a, np.float64)


def _port_step(v, batch):
    """-> (loss, the concatenated gradient in the JAX tree's leaf order)."""
    tm = convert.load_jax_variables(
        get_model("scanobject_classifier", dropout=0.0, **STEP), v).train()
    t_batch = {k: torch.from_numpy(a) for k, a in batch.items()}
    t_batch["label"] = t_batch["label"].long()
    loss, _ = tcls.make_loss_fn(0.5)(tm, t_batch)
    loss.backward()
    grads = dict(_leaves(convert.port_to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, v["params"])))
    return float(loss.detach()), grads


def test_classifier_training_step_under_bf16_matches_jax(classifier):
    """PARITY.md's gradient gate with the float32 gradient as referee: both
    bf16 gradients approximate it, and the port's misses it by at most
    twice what JAX's does (1 - cosine), so the difference between the two
    is bf16 rounding, not semantics.  At this size bf16 rounding alone
    turns about 2% of the gradient's direction: near-equal splat
    contributions round to ties or swap winners, and each such cell routes
    its gradient to another point."""
    jm, v, batch = classifier
    ref_loss, ref = _port_step(v, batch)             # the float32 referee
    _bf16(True)
    j_loss_fn = jcls.make_loss_fn(0.5)

    def compute(params):
        loss, _, _ = j_loss_fn(
            jm.apply, {"params": params, "batch_stats": v["batch_stats"]},
            {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(0), True)
        return loss

    with mock.patch.object(
            flax.linen.Dropout, "__call__",
            lambda self, inputs, deterministic=None, rng=None: inputs):
        j_loss, j_grads = jax.value_and_grad(compute)(v["params"])
    t_loss, t_grads = _port_step(v, batch)
    j_grads = dict(_leaves(j_grads))
    assert set(t_grads) == set(j_grads) == set(ref)
    names = sorted(ref)
    flat = [np.concatenate([g[n].ravel() for n in names])
            for g in (ref, t_grads, j_grads)]
    assert np.isfinite(flat[1]).all()
    port_miss, jax_miss = 1 - _cos(flat[0], flat[1]), 1 - _cos(flat[0],
                                                                flat[2])
    assert 0 < port_miss <= 2 * jax_miss, (port_miss, jax_miss)
    assert 1 - _cos(flat[1], flat[2]) <= 4 * jax_miss
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-3)
    assert abs(t_loss - ref_loss) > 0


@pytest.mark.parametrize("spelling,want", [
    (None, None), ("float32", None), ("f32", None), ("none", None),
    ("bfloat16", torch.bfloat16), ("float16", torch.float16)])
def test_model_from_config_sets_the_policy(spelling, want):
    model = {"name": "scanobject_classifier", **TINY}
    if spelling is not None:
        model["mxu_dtype"] = spelling
    tprec.set_default_mxu_dtype("float16")      # reset by every spelling
    model_from_config({"model": model})
    assert tprec.resolve() is want
    jprec.set_default_mxu_dtype(spelling)
    assert (jprec.resolve(None) is None) == (want is None)


def test_unknown_dtype_raises_as_jax_does():
    with pytest.raises(TypeError):
        jprec.set_default_mxu_dtype("bfloat17")
    with pytest.raises(TypeError):
        model_from_config({"model": {"name": "scanobject_classifier",
                                     "mxu_dtype": "bfloat17", **TINY}})
    with pytest.raises(TypeError):
        tprec.set_default_mxu_dtype("int9")
    assert tprec.resolve(torch.bfloat16) is torch.bfloat16
    assert tprec.cast_operands(None, torch.ones(2))[0].dtype == torch.float32
