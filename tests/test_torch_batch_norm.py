"""``nn/norm.BatchNorm``'s two paths and the kernels' launch plan, on the
CPU.

The kernels of ``ops/batch_norm.py`` run only on a CUDA card
(``tests/test_torch_kernels_gpu.py``).  Here: the ``relu=`` argument at
every call site that folds a ReLU in is bit-equal to the old ``F.relu(bn(
x))`` expression, so the JAX parity suites see the same ops; the path is
chosen by device, dtype, axis and the statistics' spread; the kernel
path's autograd Function and backward formula, run on the wrappers' plain
versions, against the plain path (and by ``gradcheck`` in float64); the
launch plan mirrored in numpy from ``csrc/batch_norm.cu``'s index
arithmetic, with its Chan merge of the row blocks; the tracer lists the
wrappers.  No JAX.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.models.classifier import replicated_dropout
from cloud_transformers_tpu_torch.models.inpainter import CompletionEncoder
from cloud_transformers_tpu_torch.nn import remat
from cloud_transformers_tpu_torch.nn.multihead import (
    MultiHead,
    MultiHeadUnion,
)
from cloud_transformers_tpu_torch.nn.norm import (
    BatchNorm,
    _KernelBatchNorm,
    kernel_path,
)
from cloud_transformers_tpu_torch.ops import batch_norm as kbn
from cloud_transformers_tpu_torch.utils import trace

CLS_TINY = dict(model_dim=32, repeats=1,
                stage_plan=[[[4, 4], [2, 2], [16, 16], [2, 3]]],
                pool_heads=2, pool_feature_dims=[4, 4], pool_sizes=[4, 8],
                trunk_width=8, class_dim=32, mask_dim=16)
SEG_TINY = dict(n_classes=13, model_dim=32, repeats=1,
                stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),))
# the channel counts of the cells' channel-last BatchNorms, and more
WIDTHS = (1, 3, 48, 64, 112, 256, 512, 768, 1024)


def _bn(c, seed=0, train=True):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
        bn.mean.normal_(generator=g)
        bn.var.uniform_(0.5, 2.0, generator=g)
    return bn.train(train)


def _grads(out, params, seed=1):
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    return torch.autograd.grad(out, params, g)


# --- the relu= argument ------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dim", [-1, 1])
def test_relu_argument_is_bit_equal_to_relu_after(train, dim):
    bn = _bn(12, train=train)
    bn.dim = dim
    old = copy.deepcopy(bn)
    x = torch.randn(4, 12, 9, requires_grad=True) if dim == 1 else \
        torch.randn(4, 9, 12, requires_grad=True)
    y, y_old = bn(x, relu=True), F.relu(old(x))
    assert torch.equal(y, y_old)
    assert torch.equal(bn.mean, old.mean) and torch.equal(bn.var, old.var)
    for a, b in zip(_grads(y, [x, bn.scale]), _grads(y_old, [x, old.scale])):
        assert torch.equal(a, b)


def _old_union_gather(m, x, *outs):
    residual = m.shortcut_bn(m.shortcut_conv(x)) if m.has_shortcut else x
    gathered = m.after_conv(torch.cat(
        [F.relu(getattr(m, f"attention_{i}").after_bn(o))
         for i, o in enumerate(outs)], -1))
    return residual + F.relu(m.after_bn(gathered))


def _old_classifier(m, pcd):
    bb = m.backbone
    x = F.relu(bb.stem_bn(bb.stem(pcd)))
    x, _ = bb.trunk(x, pcd)
    to_3d, _ = bb.pool3d(x, pcd)
    to_2d, _ = bb.pool2d(x, pcd)
    pooled = torch.cat([bb._trunk(bb.res2d, to_2d.movedim(-1, 1)),
                        bb._trunk(bb.res3d, to_3d.movedim(-1, 1))], -1)
    class_vect = F.relu(m.class_vector_bn(m.class_vector(pooled)))
    class_pred = m.class_head(replicated_dropout(class_vect, m.dropout))
    b, p, _ = x.shape
    mh = torch.cat([x, class_vect[:, None, :].expand(
        b, p, class_vect.shape[-1])], -1)
    mh = m.mask_bn(m.mask_conv1(m.dropout(mh)))
    return class_pred, m.mask_conv2(m.dropout(F.relu(mh)))


def _old_segmenter(m, feat, xyz, mask=None):
    x = F.relu(m.stem_bn(m.stem(feat)))
    x, _ = m.trunk(x, xyz, mask)
    return m.final_conv2(F.relu(m.final_bn(m.final_conv1(x))))


def _site(name):
    """(module, new forward, old forward, inputs) of one changed call site."""
    g = torch.Generator().manual_seed(3)
    pcd = torch.rand(2, 64, 3, generator=g) * 2 - 1
    if name == "multihead_after":
        m = MultiHead(16, 4, 8, 2, 2)
        return m, m.after, lambda m, o: F.relu(m.after_bn(o)), \
            (torch.randn(2, 64, 8, generator=g),)
    if name == "union_gather":
        m = MultiHeadUnion(16, (4, 2), (8, 4), (2, 3), (2, 2),
                           model_dim_out=24)
        return m, m._gather, _old_union_gather, (
            torch.randn(2, 64, 16, generator=g),
            torch.randn(2, 64, 8, generator=g),
            torch.randn(2, 64, 4, generator=g))
    if name == "classifier":
        m = get_model("scanobject_classifier", **CLS_TINY)
        return m, lambda p: m(p)[:2], _old_classifier, (pcd,)
    if name == "segmenter":
        m = get_model("s3dis_segmenter", **SEG_TINY)
        feat = torch.cat([pcd, torch.rand(2, 64, 3, generator=g)], -1)
        return m, lambda f, x: m._forward(f, x)[0], _old_segmenter, \
            (feat, pcd)
    m = CompletionEncoder(model_dim=32, latent_width=24, repeats=1,
                          stage_plan=CLS_TINY["stage_plan"], pool_heads=2,
                          pool_feature_dims=(4, 4), pool_sizes=(4, 8),
                          trunk_width=8)
    pooled = torch.randn(2, 32, generator=g)
    return m, lambda p: m.class_head_bn(m.class_head(p), relu=True), \
        lambda m, p: F.relu(m.class_head_bn(m.class_head(p))), (pooled,)


@pytest.mark.parametrize("name", ["multihead_after", "union_gather",
                                  "classifier", "segmenter",
                                  "inpainter_class_head"])
def test_relu_call_sites_are_bit_equal_to_the_old_expressions(name):
    torch.manual_seed(0)
    m, new, old_fn, inputs = _site(name)
    m.train()
    old = copy.deepcopy(m)
    torch.manual_seed(1)
    got = new(*inputs)
    torch.manual_seed(1)
    want = old_fn(old, *inputs)
    got, want = (got,) if torch.is_tensor(got) else got, \
        (want,) if torch.is_tensor(want) else want
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (k, a), b in zip(m.state_dict().items(), old.state_dict().values()):
        assert torch.equal(a, b), k
    loss = sum(t.square().sum() for t in got)
    loss_old = sum(t.square().sum() for t in want)
    ps, ps_old = list(m.parameters()), list(old.parameters())
    for a, b in zip(torch.autograd.grad(loss, ps, allow_unused=True),
                    torch.autograd.grad(loss_old, ps_old,
                                        allow_unused=True)):
        assert (a is None and b is None) or torch.equal(a, b)


# --- the path ----------------------------------------------------------------

@pytest.mark.parametrize("device,dtype,channel_last,spread,fused", [
    ("cuda", torch.float32, True, False, True),
    ("cpu", torch.float32, True, False, False),
    ("cuda", torch.float64, True, False, False),
    ("cuda", torch.bfloat16, True, False, False),
    ("cuda", torch.float32, False, False, False),
    ("cuda", torch.float32, True, True, False),
])
def test_kernel_path_by_device_dtype_axis_and_spread(device, dtype,
                                                     channel_last, spread,
                                                     fused):
    assert kernel_path(torch.device(device), dtype, channel_last,
                       spread) is fused


def test_cpu_batch_norm_takes_the_plain_ops_and_counts_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel path ran on the CPU")
    monkeypatch.setattr(BatchNorm, "_kernels", refuse)
    trace.take()
    was = trace.enable(True)
    try:
        BatchNorm(8)(torch.randn(5, 8), relu=True)
        assert "bn.plain" not in trace.take()["counts"]
    finally:
        trace.enable(was)


# --- the kernel path's Function on the plain wrappers ------------------------

@pytest.fixture
def plain_wrappers(monkeypatch):
    """The wrappers' plain versions in their place: the wrappers take CUDA
    tensors alone, and the module's Function reaches them through the
    module ``ops.batch_norm``."""
    for name in ("bn_stats", "bn_apply", "bn_backward"):
        monkeypatch.setattr(kbn, name, getattr(kbn, f"{name}_plain"))


def test_wrappers_refuse_a_cpu_tensor():
    x = torch.randn(8, 4)
    c = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        kbn.bn_stats(x, c.clone(), c.clone(), 1e-5, 0.1, True)
    with pytest.raises(ValueError, match="CUDA"):
        kbn.bn_apply(x, c, c, c, c, True)
    with pytest.raises(ValueError, match="CUDA"):
        kbn.bn_backward(x, x, c, c, c, c, True, True)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [3, 48, 64])
def test_kernel_function_matches_the_plain_path(train, relu, c,
                                                 plain_wrappers):
    """The module's kernel path (its Function and backward formula, on the
    wrappers' plain versions here) against its plain ops, on a column
    slice of a wider tensor, with a cotangent at a row stride."""
    bn = _bn(c, train=train)
    ref = copy.deepcopy(bn)
    kv = torch.randn(3, 70, c + 20, generator=torch.Generator().manual_seed(
        c)).mul_(2).add_(0.5).requires_grad_()
    x = kv[..., 8:8 + c]
    assert kbn.rows_of(x) == (210, c, c + 20)
    y, y_ref = bn._kernels(x, relu), ref._plain(x, relu)
    tol = 1e-5 * max(1.0, float(y_ref.detach().abs().max()))
    assert float((y - y_ref).detach().abs().max()) <= tol
    for a, b in ((bn.mean, ref.mean), (bn.var, ref.var)):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            1.0, float(b.abs().max()))
    wide = torch.randn(3, 70, 2 * c, generator=torch.Generator().manual_seed(
        7))
    dy = wide[..., :c]
    got = torch.autograd.grad(y, [kv, bn.scale, bn.bias], dy)
    want = torch.autograd.grad(y_ref, [kv, ref.scale, ref.bias], dy)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


def test_kernel_function_gradcheck_in_float64(plain_wrappers):
    c = 6
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, c, dtype=torch.float64, generator=g,
                    requires_grad=True)
    scale = (torch.rand(c, dtype=torch.float64, generator=g) + 0.5
             ).requires_grad_()
    bias = torch.randn(c, dtype=torch.float64, generator=g,
                       requires_grad=True)
    run = (torch.zeros(c, dtype=torch.float64),
           torch.ones(c, dtype=torch.float64))

    def train(x, scale, bias):
        mean, rstd = kbn.bn_stats(x.detach(), *run, 1e-5, 0.1, False)
        return _KernelBatchNorm.apply(x, scale, bias, mean, rstd, True, True)

    def frozen(x, scale, bias):
        return _KernelBatchNorm.apply(x, scale, bias, run[0] + 0.3,
                                      run[1] * 0.7, True, False)
    assert torch.autograd.gradcheck(train, (x, scale, bias))
    assert torch.autograd.gradcheck(frozen, (x, scale, bias))


def test_recompute_under_remat_leaves_the_running_statistics(
        plain_wrappers):
    bn = _bn(16)
    ref = copy.deepcopy(bn)
    x = torch.randn(50, 16, requires_grad=True)
    y = remat.region(True, lambda t: bn._kernels(t, True), x)
    y.square().sum().backward()
    ref._plain(x, True)
    assert torch.allclose(bn.mean, ref.mean, rtol=0, atol=1e-6)
    assert torch.allclose(bn.var, ref.var, rtol=0, atol=1e-6)


# --- the launch plan ---------------------------------------------------------

def _cover(plan, n, c):
    """How often the kernels' threads touch each row and each channel under
    ``plan`` (a thread's row and its channel depend on disjoint indices, so
    each (row, channel) is touched rows x channels times): block (bx, by),
    thread (tx, ty), chunk ch, row slot k, channel j."""
    vec, lanes, tr = plan["vec"], plan["lanes"], plan["rows_lanes"]
    bx, ty, ch, k = np.meshgrid(
        np.arange(plan["row_blocks"]), np.arange(tr),
        np.arange(plan["chunks"]), np.arange(kbn.BN_ROWS), indexing="ij")
    row = (bx * plan["block_rows"] + (ch * kbn.BN_ROWS + k) * tr + ty).ravel()
    by, tx, j = np.meshgrid(np.arange(plan["channel_tiles"]),
                            np.arange(lanes), np.arange(vec), indexing="ij")
    col = ((by * lanes + tx) * vec + j).ravel()
    return (np.bincount(row[row < n], minlength=n),
            np.bincount(col[col < c], minlength=c))


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("n", [1, 32, 333, 4096, 20000, 196608])
def test_plan_covers_every_row_and_channel_once(n, c):
    for vec in (1, 4) if c % 4 == 0 else (1,):
        plan = kbn.bn_plan(n, c, vec)
        assert plan["threads"] <= kbn.BN_THREADS
        assert plan["lanes"] * vec <= kbn.BN_TILE
        assert 1 <= plan["chunks"] <= kbn.BN_CHUNKS
        rows, cols = _cover(plan, n, c)
        assert (rows == 1).all() and (cols == 1).all()
        one = dict(plan, chunks=1, row_blocks=plan["apply_blocks"],
                   block_rows=plan["block_rows"] // plan["chunks"])
        rows, _ = _cover(one, n, c)
        assert (rows == 1).all()
        assert plan["workspace_bytes"] == 12 * plan["row_blocks"] * c


@pytest.mark.parametrize("n,c,tile,chunks,blocks", [
    (196608, 512, 128, 8, (192, 4)), (196608, 48, 48, 1, (586, 1)),
    (65536, 64, 64, 1, (256, 1)), (196608, 1024, 128, 8, (192, 8)),
    (65536, 512, 128, 3, (171, 4)), (32, 1024, 128, 1, (1, 8)),
    (65536, 112, 112, 1, (456, 1))])
def test_plan_at_the_cells_shapes(n, c, tile, chunks, blocks):
    plan = kbn.bn_plan(n, c, 4)
    assert plan["lanes"] * 4 == tile and plan["chunks"] == chunks
    assert (plan["row_blocks"], plan["channel_tiles"]) == blocks
    assert plan["row_blocks"] * plan["block_rows"] >= n > (
        plan["row_blocks"] - 1) * plan["block_rows"]


def _chan(x, tr, chunks):
    """The statistics kernels' arithmetic in numpy, ``tr`` row lanes and
    ``chunks`` chunks a block: per thread and chunk the float32 mean and
    M2 of its rows, merged into the thread's by Chan's rule in float32;
    per block its row lanes merged in float64 and written as (m_b, o_b,
    M2_b); then the float64 merge of the blocks.  -> (mean, biased
    variance) in float64."""
    n, c = x.shape
    f32 = np.float32
    step = tr * kbn.BN_ROWS
    parts = []
    for row0 in range(0, n, step * chunks):
        bn, bmean, bm2 = 0.0, np.zeros(c), np.zeros(c)
        for ty in range(tr):
            tn, tmean, tm2 = 0, np.zeros(c, f32), np.zeros(c, f32)
            for ch in range(chunks):
                rows = x[row0 + ch * step + ty:row0 + (ch + 1) * step:tr]
                if not len(rows):
                    break
                nc, nn = len(rows), tn + len(rows)
                mc = rows.sum(0, dtype=f32) / f32(nc)
                m2c = np.square(rows - mc).sum(0, dtype=f32)
                d = mc - tmean
                tmean = tmean + d * f32(nc / nn)
                tm2 = tm2 + m2c + d * d * f32(tn * nc / nn)
                tn = nn
            if tn:
                d = tmean - bmean
                bmean = bmean + d * (tn / (bn + tn))
                bm2 = bm2 + tm2 + d * d * (bn * tn / (bn + tn))
                bn += tn
        mb = bmean.astype(f32)
        parts.append((bn, mb.astype(np.float64),
                      (bn * (bmean - mb)).astype(f32), bm2.astype(f32)))
    mu = sum(nb * mb + ob for nb, mb, ob, _ in parts) / n
    m2 = sum(m2b + (mb - mu) * (2.0 * ob + nb * (mb - mu))
             for nb, mb, ob, m2b in parts)
    return mu, m2 / n


@pytest.mark.parametrize("chunks", [1, 3, 8])
@pytest.mark.parametrize("offset", [0.0, 100.0])
def test_chan_merge_matches_the_two_pass_variance(offset, chunks):
    rs = np.random.RandomState(0)
    x = (offset + rs.standard_normal((9000, 48)) * 1.5).astype(np.float32)
    mu, var = _chan(x, 21, chunks)
    x64 = x.astype(np.float64)
    want_mu = x64.mean(0)
    want_var = np.square(x64 - want_mu).mean(0)
    np.testing.assert_allclose(mu, want_mu, rtol=0,
                               atol=1e-7 * (offset + 1.5))
    np.testing.assert_allclose(var, want_var, rtol=1e-6, atol=0)


def test_rows_of_strided_views():
    t = torch.zeros(2, 5, 12)
    assert kbn.rows_of(t) == (10, 12, 12)
    assert kbn.rows_of(t[..., 4:]) == (10, 8, 12)
    assert kbn.rows_of(t[:, :3]) is None          # rows at two strides
    assert kbn.rows_of(t.transpose(1, 2)) is None   # channel stride 5
    assert kbn.rows_of(t[:1, :1]) == (1, 12, 12)
    assert kbn.rows_of(torch.zeros(7)) == (1, 7, 7)


def test_tracer_lists_the_batch_norm_wrappers():
    assert {"bn_stats", "bn_apply", "bn_backward"} <= set(trace.launches())
