"""The port's parallel layer on the CPU, held against the JAX package.

Two ranks over gloo (``tests/_torch_parallel_ranks.py``, which imports no
JAX) run ``parallel/point_sharded.py`` on their halves of each cloud; the
JAX package runs its ``shard_map`` versions on the conftest's virtual
8-CPU mesh with ``n_points = 2`` (its Pallas kernels in interpret mode).
Compared: the splat grid exactly (with ``pts_mask`` too, and with a
positive tie across the ranks, whose cotangent the two ranks split evenly
as JAX's max VJP does), the slice within 1e-6, the value gradient and the
slice's grid gradient within 1e-5 (JAX's own tolerance,
``tests/test_point_sharded.py``), the Chamfer distances and gradients
within 1e-6 with equal global indices, the F-score within 1e-6.  Then,
against the port on one process: a synced BatchNorm step, the KPConv
masked loss on ragged ranks (its global normaliser), the vote validation
gathered over the ranks, the loader's rows (also bit-equal to the JAX
loader's) and ``InferenceEngine`` replicas.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from cloud_transformers_tpu.core import grid_mapping as j_grid_mapping
from cloud_transformers_tpu.data.loader import DataLoader as JDataLoader
from cloud_transformers_tpu.losses.chamfer import chamfer_distance
from cloud_transformers_tpu.parallel import point_sharded as jps
from cloud_transformers_tpu.parallel.mesh import make_mesh
from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
from cloud_transformers_tpu_torch.core.splat_slice import splat_max_mapping
from cloud_transformers_tpu_torch.data.loader import DataLoader
from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.parallel import distributed
from cloud_transformers_tpu_torch.serve import InferenceEngine
from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
from cloud_transformers_tpu_torch.train.trainer import Trainer

B, P, H, F = 2, 64, 2, 8
SIZES = (8, 8, 8)
N, M, CHUNK = 64, 96, 32
WORLD = 2


def _data():
    rs = np.random.RandomState(0)
    keys = np.tanh(rs.randn(B, P, H, 3)).astype(np.float32)
    values = rs.randn(B, P, H * F).astype(np.float32)
    half = P // 2
    d = {"sizes": np.array(SIZES), "chunk": np.array(CHUNK),
         "keys": keys, "values": values,
         # every point of the second half repeats one of the first half:
         # each positive cell maximum is a tie across the two ranks
         "keys_tie": np.concatenate([keys[:, :half]] * 2, 1),
         "values_tie": np.concatenate([values[:, :half]] * 2, 1),
         "mask": (rs.rand(B, P) > 0.2).astype(np.float32),
         "x": rs.randn(B, N, 3).astype(np.float32),
         "y": rs.randn(B, M, 3).astype(np.float32),
         "v1": rs.rand(B, N) > 0.2, "v2": rs.rand(B, M) > 0.2,
         "pred": rs.randn(B, N, 3).astype(np.float32),
         "gt": (rs.randn(B, M, 3) * 1.02).astype(np.float32),
         "bn_x": (rs.randn(8, 16, 6) * 3 + 1).astype(np.float32),
         "bn_w": rs.randn(8, 16, 6).astype(np.float32)}
    m = grid_mapping(torch.from_numpy(keys), SIZES, 3)
    d["slice_grid"] = splat_max_mapping(
        m, torch.from_numpy(values), SIZES).numpy()
    return d


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = _data()
    return d, ranks.run_ranks(ranks.point_sharded_ops, WORLD,
                              tmp_path_factory.mktemp("ops"), d)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=1, n_points=2, devices=jax.devices()[:2])


def _cat(outs, key, axis=1):
    return np.concatenate([o[key] for o in outs], axis)


@pytest.mark.parametrize("tag", ["", "_tie"])
def test_splat_matches_jax(run, mesh, tag):
    d, outs = run
    m = j_grid_mapping(jnp.asarray(d["keys" + tag]), SIZES, 3)
    v = jnp.asarray(d["values" + tag])

    def loss(v_):
        return jnp.sum(jps.splat_max_point_sharded(mesh, m, v_, SIZES) ** 2)

    with mesh:
        grid = jax.jit(lambda v_, k: jps.splat_max_point_sharded(
            mesh, m, v_, SIZES, pts_mask=k))(v, jnp.asarray(d["mask"]))
        grid_nomask = jax.jit(lambda v_: jps.splat_max_point_sharded(
            mesh, m, v_, SIZES))(v)
        dv = jax.jit(jax.grad(loss))(v)
    for o in outs:   # the same global grid on every rank
        np.testing.assert_array_equal(o["grid_masked" + tag],
                                      np.asarray(grid))
        np.testing.assert_array_equal(o["grid" + tag],
                                      np.asarray(grid_nomask))
    np.testing.assert_allclose(_cat(outs, "d_values" + tag), np.asarray(dv),
                               rtol=0, atol=1e-5)


def test_cross_rank_tie_splits_the_cotangent(run):
    """Where the single-process splat routes a positive maximum to its
    lowest-indexed point, the sharded splat gives each rank's copy half."""
    d, outs = run
    np.testing.assert_array_equal(outs[0]["d_values_tie"],
                                  outs[1]["d_values_tie"])
    m = grid_mapping(torch.from_numpy(d["keys_tie"]), SIZES, 3)
    v = torch.from_numpy(d["values_tie"]).requires_grad_(True)
    (splat_max_mapping(m, v, SIZES) ** 2).sum().backward()
    single = v.grad.numpy()
    half = P // 2
    assert np.abs(single[:, :half]).max() > 0
    np.testing.assert_array_equal(single[:, half:], 0.0)
    np.testing.assert_allclose(
        outs[0]["d_values_tie"] + outs[1]["d_values_tie"], single[:, :half],
        rtol=0, atol=1e-6)


def test_slice_matches_jax(run, mesh):
    d, outs = run
    m = j_grid_mapping(jnp.asarray(d["keys"]), SIZES, 3)
    mask = jnp.asarray(d["mask"])
    grid = jnp.asarray(d["slice_grid"])

    def fn(g):
        return jps.slice_grid_point_sharded(mesh, m, g, SIZES, pts_mask=mask)

    with mesh:
        pts = jax.jit(fn)(grid)
        dg = jax.jit(jax.grad(lambda g: jnp.sum(fn(g) ** 2)))(grid)
    np.testing.assert_allclose(_cat(outs, "slice"), np.asarray(pts),
                               rtol=0, atol=1e-6)
    for o in outs:   # the grid's cotangent summed over the ranks
        np.testing.assert_allclose(o["d_slice_grid"], np.asarray(dg),
                                   rtol=0, atol=1e-5)


def test_chamfer_matches_jax(run, mesh):
    d, outs = run
    x, y = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    v1, v2 = jnp.asarray(d["v1"]), jnp.asarray(d["v2"])
    with mesh:
        masked = jax.jit(lambda *a: jps.chamfer_point_sharded(
            mesh, *a[:2], chunk_size=CHUNK, valid1=a[2], valid2=a[3]))(
                x, y, v1, v2)
        plain = jax.jit(lambda a, b: jps.chamfer_point_sharded(
            mesh, a, b, chunk_size=CHUNK))(x, y)

        def loss(a, b):
            d1, d2, _, _ = jps.chamfer_point_sharded(mesh, a, b,
                                                     chunk_size=CHUNK)
            return jnp.mean(d1) + jnp.mean(d2)

        gx, gy = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, y)
    # the sharded JAX search is the single-device one
    ref = chamfer_distance(x, y, chunk_size=CHUNK, valid1=v1, valid2=v2)
    for k, r, s in zip(("d1", "d2", "i1", "i2"), masked, ref):
        np.testing.assert_allclose(np.asarray(r), np.asarray(s), atol=1e-6)
        got = _cat(outs, "masked_" + k)
        if k.startswith("i"):
            np.testing.assert_array_equal(got, np.asarray(r))
        else:
            np.testing.assert_allclose(got, np.asarray(r), rtol=0,
                                       atol=1e-6)
    for k, r in zip(("d1", "d2", "i1", "i2"), plain):
        np.testing.assert_allclose(_cat(outs, k), np.asarray(r), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(_cat(outs, "d_x"), np.asarray(gx), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_cat(outs, "d_y"), np.asarray(gy), rtol=0,
                               atol=1e-6)


def test_f_score_matches_jax(run, mesh):
    d, outs = run
    with mesh:
        ref = jax.jit(lambda p, g: jps.f_score_point_sharded(
            mesh, p, g, threshold=0.5, chunk_size=CHUNK))(
                jnp.asarray(d["pred"]), jnp.asarray(d["gt"]))
    assert 0 < float(np.asarray(ref[0]).mean()) < 1
    for o in outs:
        for got, r in zip(o["f_score"], ref):
            np.testing.assert_allclose(got, np.asarray(r), rtol=0,
                                       atol=1e-6)


def test_batchnorm_statistics_are_global(run):
    """Two ranks' synced BatchNorm step against one process's on the whole
    batch: output, input gradient, parameter gradients (each rank's, for
    the sum of both ranks' losses), running statistics."""
    d, outs = run
    bn = BatchNorm(d["bn_x"].shape[-1]).train()
    x = torch.from_numpy(d["bn_x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(d["bn_w"])).sum().backward()
    np.testing.assert_allclose(_cat(outs, "bn_y", 0), y.detach().numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_cat(outs, "bn_dx", 0), x.grad.numpy(),
                               rtol=0, atol=1e-5)
    for k, ref in (("bn_dscale", bn.scale.grad), ("bn_dbias", bn.bias.grad)):
        np.testing.assert_allclose(outs[0][k] + outs[1][k], ref.numpy(),
                                   rtol=1e-5, atol=1e-4)
    for k, ref in (("bn_mean", bn.mean), ("bn_var", bn.var)):
        for o in outs:
            np.testing.assert_allclose(o[k], ref.numpy(), rtol=1e-6,
                                       atol=1e-7)


def _kp_batch():
    """Two ragged halves: rank 0's rows nearly full, rank 1's nearly empty,
    so that a per-rank normaliser would weigh the ranks wrongly."""
    rs = np.random.RandomState(5)
    b, p = 4, 24
    share = np.array([0.9, 0.8, 0.1, 0.2])
    return {"points": rs.randn(b, p, 3).astype(np.float32),
            "features": rs.randn(b, p, 4).astype(np.float32),
            "mask": (rs.rand(b, p) < share[:, None]).astype(np.float32),
            "label": rs.randint(0, 5, (b, p)).astype(np.int64)}


def test_kpconv_masked_loss_is_global(tmp_path):
    """The KPConv masked loss on 2 ragged ranks: the ranks' averaged
    gradient and mean loss are the single process's on the global
    batch."""
    batch = _kp_batch()
    cfg = {"experiment": {"root": str(tmp_path / "exp")},
           "train": {"optimizer": {"type": "Adam", "lr": 1e-3},
                     "save": False, "auto_resume": False}}
    outs = ranks.run_ranks(ranks.kpconv_step, WORLD, tmp_path / "ranks",
                           cfg, batch)
    trainer = Trainer(ranks.PointHead(4, 5), dict(cfg),
                      "single", segmentation_kpconv.make_loss_fn(),
                      device="cpu", seed=0)
    loss = float(trainer.train_step(batch)["loss"])
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), loss,
                               rtol=1e-6)
    # the bias before the BatchNorm has rounding noise for a gradient (the
    # batch mean takes it out again), so the scale is the largest leaf's
    scale = max(np.abs(p.grad.numpy()).max()
                for p in trainer.model.parameters())
    for name, p in trainer.model.named_parameters():
        for o in outs:
            np.testing.assert_allclose(o["grads"][name], p.grad.numpy(),
                                       rtol=0, atol=1e-6 * scale,
                                       err_msg=name)


def test_vote_validation_gathers_the_ranks(tmp_path):
    """``validate_votes`` over 2 ranks' rows (the second vote augmented)
    gives every rank the single process's votes and metrics."""
    outs = ranks.run_ranks(ranks.validate_votes, WORLD, tmp_path, 7)
    single = segmentation_kpconv.validate_votes(
        ranks.vote_logits, ranks.VoteSet(7),
        ranks.rows_of(ranks.vote_batches(7), 0, 1), num_classes=4,
        num_votes=2)
    assert set(single) == set(outs[0])
    for o in outs:
        for k, v in single.items():
            np.testing.assert_array_equal(o[k], np.asarray(v), err_msg=k)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i], np.int64),
                "x": np.full((3,), i * 0.5, np.float32)}


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_rows_match_jax(count, shuffle, drop_last):
    """Each process's batches bit-equal to the JAX loader's, and together,
    rank-major, the single-process loader's global batches."""
    ds, bs = _Items(23), 2
    single = DataLoader(ds, bs * count, shuffle=shuffle, seed=3,
                        drop_last=drop_last)
    single.set_epoch(1)
    glob = list(single)
    per_rank = []
    for p in range(count):
        kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last,
                  process_index=p, process_count=count)
        mine, ref = DataLoader(ds, bs, **kw), JDataLoader(ds, bs, **kw)
        mine.set_epoch(1)
        ref.set_epoch(1)
        got, want = list(mine), list(ref)
        assert len(mine) == len(ref) == len(got) == len(want) == len(glob)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        per_rank.append(got)
    for b, whole in enumerate(glob):
        for k in whole:
            np.testing.assert_array_equal(
                np.concatenate([r[b][k] for r in per_rank]), whole[k])


def test_one_process_loader_is_unchanged():
    ds = _Items(17)
    for shuffle in (True, False):
        a = DataLoader(ds, 4, shuffle=shuffle, seed=1, drop_last=False)
        b = DataLoader(ds, 4, shuffle=shuffle, seed=1, drop_last=False,
                       process_index=0, process_count=1)
        idx = np.arange(17)
        if shuffle:
            np.random.RandomState(1).shuffle(idx)
        idx = np.concatenate([idx, idx[:3]])
        for b_, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x["i"], y["i"])
            np.testing.assert_array_equal(x["i"][:, 0],
                                          idx[b_ * 4:(b_ + 1) * 4])


def test_serving_replicas_equal_one():
    tiny = dict(n_classes=15, model_dim=16, repeats=1,
                stage_plan=(((4, 4), (2, 2), (8, 8), (2, 3)),),
                pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
                trunk_width=4, class_dim=16, mask_dim=8)
    kw = dict(seed=0, device="cpu", batch_buckets=(1, 4),
              point_buckets=(64, 128))
    one = InferenceEngine.build("scanobject_classifier", **kw, **tiny)
    two = InferenceEngine.build("scanobject_classifier",
                                devices=["cpu", "cpu"], **kw, **tiny)
    assert len(two.replicas) == 2 and two.replicas[1] is not two.model
    rs = np.random.RandomState(0)
    clouds = [rs.randn(n, 3).astype(np.float32) for n in (50, 100, 70)]
    # three requests: the bucket of 4 (a multiple of 2) either way
    (c1, m1, s1), n1, b1, p1 = one.predict_padded(clouds)
    (c2, m2, s2), n2, b2, p2 = two.predict_padded(clouds)
    assert (n1, b1, p1) == (n2, b2, p2) == (3, 4, 128)
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(m2.numpy(), m1.numpy(), rtol=0, atol=1e-6)
    assert len(s1) == len(s2)
    for a, b in zip(s1, s2):
        assert a.keys() == b.keys()
    # one cloud: one replica's bucket of 1 becomes 2, a row each
    (c3, _, _), n3, b3, _ = two.predict_padded(clouds[:1])
    assert (n3, b3) == (1, 2)
    np.testing.assert_allclose(two.classify(clouds), one.classify(clouds),
                               rtol=0, atol=1e-6)
    for r1, r2 in zip(one.predict(clouds), two.predict(clouds)):
        np.testing.assert_allclose(r2[1], r1[1], rtol=0, atol=1e-6)


def test_a_failing_rank_fails_fast(tmp_path):
    """A rank that raises fails the run within the group's timeout, with
    its traceback; its peer, waiting in a collective, does not hang."""
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="rank 1 fails on purpose"):
        ranks.run_ranks(ranks.raise_on_rank_one, WORLD, tmp_path,
                        timeout=60, group_timeout=10)
    assert time.monotonic() - t0 < 60


def test_a_failed_rendezvous_raises(tmp_path):
    """A rank whose peers never come raises after the timeout and is left
    with no process group: nothing carries on as a single process."""
    with pytest.raises(RuntimeError):
        distributed.distributed_init(f"file://{tmp_path}/rendezvous", 2, 0,
                                     backend="gloo", device="cpu",
                                     timeout_s=2)
    assert not distributed.is_distributed()
    assert distributed.world_size() == 1
