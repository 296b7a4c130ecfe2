"""The V2V and UNet blocks against the JAX package's.

* ``GroupedConvTranspose`` (k = stride = 2) against the JAX block on random,
  hence asymmetric, kernels, 2D and 3D, with groups and a bias: the port
  keeps the JAX kernel in the conv layout and flips and regroups it for
  ``F.conv_transpose*d``; within 1e-5.
* ``V2VModel`` (16^3, groups 2, B=4) and ``UNet`` (32^2, groups 2,
  bilinear and transposed upsampling) with JAX variables loaded strictly
  through ``load_jax_variables``, and an ``Up`` whose skip is larger than
  the upsampled map by an odd number of rows and columns: the train-mode
  output by PARITY.md (cosine > 0.999, median error <= 1e-3 of the scale)
  and within 1e-3 of its scale everywhere (the V2V's deepest level is 1^3,
  where its BatchNorms normalize over the B values of a channel and so
  amplify float32 rounding), every parameter's gradient by PARITY.md (the
  bias of a conv that feeds a BatchNorm has none: it must be rounding
  noise, below 1e-5 of the largest gradient, on both sides), and the
  BatchNorm running statistics after the step within 1e-5.
* The train-mode UNet under bf16 departs from float32 as much in the port
  as in JAX, and the two bf16 outputs agree more closely than either
  agrees with float32.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.nn import conv_blocks as jcb
from cloud_transformers_tpu.nn import unet2d as jun
from cloud_transformers_tpu_torch.convert import (
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.nn import conv_blocks as tcb
from cloud_transformers_tpu_torch.nn.init import init_model_
from cloud_transformers_tpu_torch.nn import unet2d as tun


def _cl(t):
    """channels-first torch -> channel-last numpy."""
    return t.detach().movedim(1, -1).numpy()


@pytest.mark.parametrize("dim,groups,bias", [(2, 2, True), (3, 4, False),
                                             (2, 1, False)])
def test_grouped_conv_transpose_matches_jax(dim, groups, bias):
    cin, cout = 4 * groups, 6 * groups
    rs = np.random.RandomState(0)
    x = rs.randn(*((2,) + (5,) * dim + (cin,))).astype(np.float32)
    jmod = jcb.GroupedConvTranspose(cout, groups=groups, use_bias=bias)
    v = jax.tree_util.tree_map(np.asarray,
                               jmod.init(jax.random.PRNGKey(0), x))
    if bias:
        v["params"]["bias"] = rs.randn(cout).astype(np.float32)
    ref = np.asarray(jmod.apply(v, jnp.asarray(x)))
    tmod = load_jax_variables(
        tcb.GroupedConvTranspose(cin, cout, groups=groups, use_bias=bias,
                                 dim=dim), v)
    got = _cl(tmod(torch.from_numpy(x).movedim(-1, 1)))
    assert got.shape == (2,) + (10,) * dim + (cout,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _leaves(tree, prefix=()):
    for k, a in tree.items():
        if hasattr(a, "items"):
            yield from _leaves(a, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(a, np.float64)


def _parity(got, ref, what):
    got = np.asarray(got, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
    p50 = np.median(np.abs(got - ref)) / np.abs(ref).max()
    assert cos > 0.999 and p50 <= 1e-3, (what, cos, p50)


def _step_matches_jax(jmod, tmod, inputs):
    """One train-mode forward + backward of ``sum(out * cot)`` on both
    sides from the same variables: the port's initialisation carried into
    the JAX tree (``eval_shape`` gives the tree, so no JAX init runs), the
    BatchNorm scales and statistics randomised from numpy."""
    rs = np.random.RandomState(1)
    shapes = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                         *map(jnp.asarray, inputs),
                                         train=False)))
    init_model_(tmod, torch.Generator().manual_seed(0))
    v = {"params": port_to_jax_tree(dict(tmod.named_parameters()),
                                    shapes["params"]),
         "batch_stats": port_to_jax_tree(dict(tmod.named_buffers()),
                                         shapes["batch_stats"])}

    def scales(path, a):
        return (rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
                if path[-1].key == "scale" else np.asarray(a))

    v["params"] = jax.tree_util.tree_map_with_path(scales, v["params"])
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rs.uniform(*((-0.1, 0.1) if p[-1].key == "mean"
                                  else (0.5, 1.5)), a.shape).astype(
                                      np.float32), v["batch_stats"])
    out_shape = jax.eval_shape(
        lambda: jmod.apply(v, *map(jnp.asarray, inputs), train=False))
    cot = rs.randn(*out_shape.shape).astype(np.float32)

    def loss(params):
        out, new = jmod.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            *map(jnp.asarray, inputs), train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new["batch_stats"])

    (_, (j_out, j_stats)), j_grads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])

    load_jax_variables(tmod, v).train()
    t_in = [torch.from_numpy(a).movedim(-1, 1).contiguous() for a in inputs]
    t_out = tmod(*t_in)
    (t_out * torch.from_numpy(cot).movedim(-1, 1)).sum().backward()

    ref = np.asarray(j_out)
    _parity(_cl(t_out), ref, "output")
    np.testing.assert_allclose(_cl(t_out), ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())
    j_leaves = dict(_leaves(j_grads))
    t_leaves = dict(_leaves(port_to_jax_tree(
        {n: p.grad for n, p in tmod.named_parameters()}, v["params"])))
    assert set(j_leaves) == set(t_leaves)
    floor = 1e-5 * max(np.abs(a).max() for a in j_leaves.values())
    compared = 0
    for name, ref in j_leaves.items():
        got = t_leaves[name]
        if re.search(r"(DoubleConv|OutConv)_\d+/Conv_\d+/bias$", name):
            # feeds a BatchNorm, which takes it out again
            assert max(np.abs(got).max(), np.abs(ref).max()) <= floor, name
            continue
        _parity(got, ref, name)
        compared += 1
    t_stats = dict(_leaves(port_to_jax_tree(dict(tmod.named_buffers()),
                                            v["batch_stats"])))
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(t_stats[name], ref, rtol=0, atol=1e-5,
                                   err_msg=name)
    return compared, len(j_leaves)


def test_v2v_model_matches_jax():
    x = np.random.RandomState(0).randn(4, 16, 16, 16, 4).astype(np.float32)
    tm = tcb.V2VModel(4, 3, groups=2)
    assert len(tm.res_blocks) == 19 and len(tm.upsample_blocks) == 4
    assert tm.res_blocks[15].conv1.groups == 1      # decoder_res0
    compared, leaves = _step_matches_jax(jcb.V2VModel(4, 3, groups=2), tm,
                                         [x])
    assert compared == leaves == 137


@pytest.mark.parametrize("bilinear", [True, False])
def test_unet_matches_jax(bilinear):
    x = np.random.RandomState(0).randn(2, 32, 32, 6).astype(np.float32)
    tm = tun.UNet(6, n_out=3, groups=2, bilinear=bilinear)
    assert (tm.ups[0].up is None) == bilinear
    compared, leaves = _step_matches_jax(
        jun.UNet(n_out=3, groups=2, bilinear=bilinear), tm, [x])
    assert compared >= leaves // 2 and leaves > 60


@pytest.mark.parametrize("bilinear", [True, False])
def test_up_pads_an_odd_difference_like_jax(bilinear):
    rs = np.random.RandomState(2)
    x1 = rs.randn(2, 5, 5, 4).astype(np.float32)
    x2 = rs.randn(2, 11, 12, 6).astype(np.float32)
    tm = tun.Up(4, 6, 8, groups=2, bilinear=bilinear)
    _step_matches_jax(jun.Up(8, 2, bilinear), tm, [x1, x2])


def test_bilinear_upsampling_is_jaxs_at_the_border():
    x = np.random.RandomState(3).randn(1, 7, 6, 2).astype(np.float32)
    ref = np.asarray(jun._resize_bilinear(jnp.asarray(x), (14, 12)))
    got = _cl(torch.nn.functional.interpolate(
        torch.from_numpy(x).movedim(-1, 1), scale_factor=2, mode="bilinear",
        align_corners=False))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], atol=1e-6)


def test_group_cat_interleaves_groups():
    a = torch.arange(4.0).reshape(1, 4, 1, 1)
    b = torch.arange(10.0, 16.0).reshape(1, 6, 1, 1)
    out = tun.GroupCat(2)(a, b).flatten().tolist()
    assert out == [0, 1, 10, 11, 12, 2, 3, 13, 14, 15]
    ref = jun.group_cat(jnp.asarray(a.movedim(1, -1).numpy()),
                        jnp.asarray(b.movedim(1, -1).numpy()), 2)
    assert np.asarray(ref).ravel().tolist() == out


def test_unet_under_bf16_departs_from_f32_as_jax_does():
    """Under the bf16 operand policy the train-mode UNet's output departs
    from float32 by as much in the port as in the JAX package (1 - cosine
    within a factor 2 each way: train-mode BatchNorm magnifies a
    contraction's rounding where a channel's mean dwarfs its spread, so
    neither framework meets a cosine of 0.999 here), and the port's bf16
    output is closer to JAX's bf16 output than either is to float32."""
    from cloud_transformers_tpu.nn import precision as jprec
    from cloud_transformers_tpu_torch.nn import precision as tprec

    x = np.random.RandomState(0).randn(4, 32, 32, 6).astype(np.float32)
    jm = jun.UNet(n_out=3, groups=2)
    tm = init_model_(tun.UNet(6, 3, 2), torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x), train=False)))
    v = {"params": port_to_jax_tree(dict(tm.named_parameters()),
                                    shapes["params"]),
         "batch_stats": port_to_jax_tree(dict(tm.named_buffers()),
                                         shapes["batch_stats"])}
    out = {}
    try:
        for dtype in (None, "bfloat16"):
            tprec.set_default_mxu_dtype(dtype)
            jprec.set_default_mxu_dtype(dtype)
            jax.clear_caches()
            j = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])[0]
            with torch.no_grad():
                t = tm.train()(torch.from_numpy(x).movedim(-1, 1))
            out[dtype] = (np.asarray(j, np.float64).ravel(),
                          _cl(t).astype(np.float64).ravel())
    finally:
        tprec.set_default_mxu_dtype(None)
        jprec.set_default_mxu_dtype(None)
        jax.clear_caches()

    def miss(a, b):
        return 1 - a @ b / (np.linalg.norm(a) * np.linalg.norm(b))

    (j32, t32), (j16, t16) = out[None], out["bfloat16"]
    assert miss(t32, j32) < 1e-9
    jax_miss, port_miss = miss(j16, j32), miss(t16, t32)
    assert 0 < port_miss <= 2 * jax_miss and jax_miss <= 2 * port_miss, (
        port_miss, jax_miss)
    assert miss(t16, j16) < min(port_miss, jax_miss)
