"""Ranks of the port's multi-process CPU tests.

``run_ranks`` starts ``world`` processes (spawn), each joins a gloo group
through a ``file://`` rendezvous in the test's own directory (no port to
collide with under xdist), with a finite timeout, runs ``fn(rank, world,
*args)`` and saves what it returns; a rank that raises writes its
traceback and exits 1, and a rank still alive at the deadline is killed,
so a failing rank fails its test within the timeout and never blocks the
suite.  This module imports only torch, numpy and the port, never JAX.
"""

import multiprocessing
import os
import time
import traceback
import uuid

import numpy as np
import torch

RANK_TIMEOUT_S = 60     # the process group's: a dead peer fails the rest
JOIN_TIMEOUT_S = 150    # the whole run's


def run_ranks(fn, world, workdir, *args, timeout=JOIN_TIMEOUT_S,
              group_timeout=RANK_TIMEOUT_S):
    """-> [what ``fn`` returned on rank r for r in range(world)]; raises
    AssertionError with the ranks' tracebacks if any rank failed or hung."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    tag = uuid.uuid4().hex
    init = f"file://{os.path.join(workdir, f'rendezvous-{tag}')}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, init, workdir, tag, args,
                               group_timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(workdir, f"rank{r}-{tag}.err")
        if r in hung:
            errors.append(f"rank {r} still running after {timeout} s")
        elif p.exitcode != 0:
            text = open(err).read() if os.path.exists(err) else ""
            errors.append(f"rank {r} exit {p.exitcode}\n{text}")
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(os.path.join(workdir, f"rank{r}-{tag}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(fn, rank, world, init, workdir, tag, args, group_timeout):
    torch.set_num_threads(1)
    try:
        from cloud_transformers_tpu_torch.parallel import distributed
        distributed.distributed_init(init, world, rank, backend="gloo",
                                     device="cpu", timeout_s=group_timeout)
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}-{tag}.pt"))
        distributed.destroy()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}-{tag}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def shard(a, rank, world, axis=1):
    """Rank ``rank``'s contiguous block of ``a`` along ``axis``."""
    n = a.shape[axis] // world
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)


def _np(t):
    return t.detach().cpu().numpy()


def point_sharded_ops(rank, world, d):
    """The point-sharded splat, slice, Chamfer and F-score on this rank's
    shard of the clouds in ``d`` (numpy), with their gradients, and a
    BatchNorm step on this rank's rows."""
    from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
    from cloud_transformers_tpu_torch.nn.norm import BatchNorm
    from cloud_transformers_tpu_torch.parallel import point_sharded as ps

    sizes = tuple(int(s) for s in d["sizes"])
    out = {}
    for tag in ("", "_tie"):
        keys = torch.from_numpy(shard(d["keys" + tag], rank, world))
        values = torch.from_numpy(shard(d["values" + tag], rank, world))
        mask = torch.from_numpy(shard(d["mask"], rank, world))
        m = grid_mapping(keys, sizes, len(sizes))
        v = values.clone().requires_grad_(True)
        grid = ps.splat_max_point_sharded(m, v, sizes, pts_mask=mask)
        out["grid_masked" + tag] = _np(grid)
        v = values.clone().requires_grad_(True)
        grid = ps.splat_max_point_sharded(m, v, sizes)
        (grid ** 2).sum().backward()
        out["grid" + tag] = _np(grid)
        out["d_values" + tag] = _np(v.grad)
    keys = torch.from_numpy(shard(d["keys"], rank, world))
    mask = torch.from_numpy(shard(d["mask"], rank, world))
    m = grid_mapping(keys, sizes, len(sizes))
    g = torch.from_numpy(d["slice_grid"]).requires_grad_(True)
    pts = ps.slice_grid_point_sharded(m, g, sizes, pts_mask=mask)
    (pts ** 2).sum().backward()
    out["slice"] = _np(pts)
    out["d_slice_grid"] = _np(g.grad)

    x = torch.from_numpy(shard(d["x"], rank, world)).requires_grad_(True)
    y = torch.from_numpy(shard(d["y"], rank, world)).requires_grad_(True)
    v1 = torch.from_numpy(shard(d["v1"], rank, world))
    v2 = torch.from_numpy(shard(d["v2"], rank, world))
    cs = int(d["chunk"])
    for k, t in zip(("d1", "d2", "i1", "i2"), ps.chamfer_point_sharded(
            x, y, chunk_size=cs, valid1=v1, valid2=v2)):
        out["masked_" + k] = _np(t)
    d1, d2, i1, i2 = ps.chamfer_point_sharded(x, y, chunk_size=cs)
    # this rank's part of mean(d1) + mean(d2) over the whole clouds
    (d1.sum() / d["x"][..., 0].size + d2.sum() / d["y"][..., 0].size) \
        .backward()
    out.update(d1=_np(d1), d2=_np(d2), i1=_np(i1), i2=_np(i2),
               d_x=_np(x.grad), d_y=_np(y.grad))
    p = torch.from_numpy(shard(d["pred"], rank, world))
    q = torch.from_numpy(shard(d["gt"], rank, world))
    out["f_score"] = [_np(t) for t in ps.f_score_point_sharded(
        p, q, threshold=0.5, chunk_size=cs)]

    bn = BatchNorm(d["bn_x"].shape[-1]).train()
    xb = torch.from_numpy(shard(d["bn_x"], rank, world, axis=0))
    xb.requires_grad_(True)
    y = bn(xb)
    (y * torch.from_numpy(shard(d["bn_w"], rank, world, axis=0))).sum() \
        .backward()
    out.update(bn_y=_np(y), bn_dx=_np(xb.grad), bn_mean=_np(bn.mean),
               bn_var=_np(bn.var), bn_dscale=_np(bn.scale.grad),
               bn_dbias=_np(bn.bias.grad))
    return out


class Batches(list):
    """A fixed list of batches as ``Trainer.fit``/``validate`` take it."""

    def set_epoch(self, epoch):
        self.epoch = epoch


def rows_of(batches, rank, world):
    """Each batch's rows of rank ``rank``."""
    out = Batches()
    for b in batches:
        n = len(next(iter(b.values()))) // world
        out.append({k: v[rank * n:(rank + 1) * n] for k, v in b.items()})
    return out


def classifier_step(rank, world, cfg, state_path, batch, val, tiny):
    """One ``Trainer.train_step`` of the tiny classifier (dropout 0) on this
    rank's rows of ``batch``, from the weights at ``state_path`` (loaded
    by ``cfg['restore']`` on every rank) -> the loss, the averaged
    gradients, the BatchNorm buffers after the step, the parameters after
    the update, and ``Trainer.validate`` with ``ClassEvalAccumulator``
    over this rank's rows of the batches ``val``."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    model = get_model("scanobject_classifier", dropout=0.0, **tiny)
    cfg = dict(cfg, restore={"generator": state_path})
    trainer = Trainer(model, cfg, "step", classification.make_loss_fn(0.5),
                      device="cpu", seed=0)
    loss = trainer.train_step(rows_of([batch], rank, world)[0])["loss"]
    out = {"loss": float(loss),
           "grads": {k: _np(p.grad) for k, p in model.named_parameters()},
           "buffers": {k: _np(b) for k, b in model.named_buffers()},
           "params": {k: _np(p) for k, p in model.named_parameters()}}
    out["val"] = trainer.validate(rows_of(val, rank, world),
                                  classification.ClassEvalAccumulator(15))
    return out


class PointHead(torch.nn.Module):
    """A per-point linear classifier with a BatchNorm, in the KPConv
    segmenter's call signature ``(points, mask, features) -> (logits,
    stats)``: the masked loss's test model."""

    def __init__(self, features, classes):
        super().__init__()
        from cloud_transformers_tpu_torch.nn.norm import BatchNorm

        self.lin = torch.nn.Linear(3 + features, 16)
        self.bn = BatchNorm(16)
        self.out = torch.nn.Linear(16, classes)

    def forward(self, points, mask, features):
        h = self.lin(torch.cat([points, features], -1))
        return self.out(torch.relu(self.bn(h))), []


def kpconv_step(rank, world, cfg, batch):
    """One ``Trainer.train_step`` of ``PointHead`` under the KPConv task's
    masked loss on this rank's rows (ragged masks) -> the loss and the
    averaged gradients."""
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    trainer = Trainer(PointHead(batch["features"].shape[-1], 5), cfg, "kp",
                      segmentation_kpconv.make_loss_fn(), device="cpu",
                      seed=0)
    n = len(batch["points"]) // world
    rows = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    loss = trainer.train_step(rows)["loss"]
    return {"loss": float(loss),
            "grads": {k: _np(p.grad)
                      for k, p in trainer.model.named_parameters()}}


class VoteSet:
    """The parts of ``S3DISSeg`` that ``validate_votes`` reads: sub-cloud
    and full-cloud labels and the projections between them."""

    num_epochs = 1

    def __init__(self, seed, classes=4, sub=(40, 30), full=(50, 45)):
        rs = np.random.RandomState(seed)
        self.sub_labels = [rs.randint(0, classes, n) for n in sub]
        self.clouds_labels = [rs.randint(0, classes, n) for n in full]
        self.projections = [rs.randint(0, s, n) for s, n in zip(sub, full)]

    def set_epoch(self, epoch):
        self.epoch = epoch


def vote_batches(seed, n_batches=3, b=4, n=16, sub=(40, 30)):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        ci = rs.randint(0, len(sub), b)
        out.append({
            "points": rs.randn(b, n, 3).astype(np.float32),
            "features": rs.randn(b, n, 4).astype(np.float32),
            "mask": (rs.rand(b, n) > 0.3).astype(np.float32),
            "cloud_index": ci.astype(np.int32),
            "input_inds": np.stack([rs.randint(0, sub[c], n) for c in ci])
            .astype(np.int32)})
    return out


def vote_logits(batch, classes=4):
    """A fixed function of the points, as an evaluation step."""
    w = torch.linspace(-1.0, 1.0, 3 * classes).reshape(3, classes)
    return {"logits": torch.from_numpy(np.asarray(batch["points"])) @ w}


def validate_votes(rank, world, seed):
    """``validate_votes`` over this rank's rows of ``vote_batches(seed)``,
    2 votes (the second augmented)."""
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv

    r = segmentation_kpconv.validate_votes(
        vote_logits, VoteSet(seed), rows_of(vote_batches(seed), rank, world),
        num_classes=4, num_votes=2)
    return {k: np.asarray(v) for k, v in r.items()}


def raise_on_rank_one(rank, world):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    from cloud_transformers_tpu_torch.parallel.distributed import all_reduce_

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    all_reduce_(torch.ones(4))
    return {}


# --- the points axis ---------------------------------------------------------

POINTS_CFG = {"train": {"optimizer": {"type": "Adam", "lr": 1e-3},
                        "save": False, "auto_resume": False}}


def chamfer_loss_fn(model, batch):
    """The inpainter's step of ``__graft_entry__``'s dryrun: the Chamfer
    loss of the reconstruction against ``gt``."""
    from cloud_transformers_tpu_torch.losses.chamfer import loss_chamfer

    recon, _ = model(batch["noise"], batch["partial"])
    return loss_chamfer(recon, batch["gt"]), {}


def family_loss_fn(family):
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv

    if family == "classifier":
        return classification.make_loss_fn(0.5)
    if family == "segmenter":
        return segmentation_kpconv.make_loss_fn()
    return chamfer_loss_fn


def family_model(family, kwargs):
    from cloud_transformers_tpu_torch.models import get_model

    name = {"classifier": "scanobject_classifier",
            "segmenter": "s3dis_segmenter_pad",
            "inpainter": "completion_inpainter"}[family]
    return get_model(name, **kwargs)


def family_step(family, kwargs, state_path, batch, root, mesh=None):
    """One ``Trainer.train_step`` of ``family`` from the weights at
    ``state_path`` on the rows ``batch`` (numpy), under ``mesh`` (None:
    no mesh) -> the loss, the averaged gradients, the buffers after the
    step and the parameters after the update, as numpy."""
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    cfg = dict(POINTS_CFG, experiment={"root": root},
               restore={"generator": state_path})
    trainer = Trainer(family_model(family, kwargs), cfg, family,
                      family_loss_fn(family), device="cpu", seed=0,
                      mesh=mesh)
    loss = trainer.train_step(batch)["loss"]
    model = trainer.model
    return {"loss": float(loss),
            "grads": {k: _np(p.grad) for k, p in model.named_parameters()},
            "buffers": {k: _np(b) for k, b in model.named_buffers()},
            "params": {k: _np(p) for k, p in model.named_parameters()}}


def _row(batch, mesh):
    """The data row's rows of the global batch."""
    from cloud_transformers_tpu_torch.parallel.mesh import shard_batch
    return shard_batch(mesh, batch, points_axis=None)


def _scrambled(batch, seed):
    """``batch`` with every float array redrawn: what a points rank of a
    row might build where the augmentation is not reproducible."""
    rs = np.random.RandomState(seed)
    return {k: (rs.permutation(v.reshape(-1)).reshape(v.shape)
                if v.dtype.kind == "f" else v) for k, v in batch.items()}


def points_axis_steps(rank, world, d):
    """The points-axis cases on this rank of a world of 4: each family's
    step on a data 2 x points 2 grid (the row's second points rank given
    a scrambled batch, which the row's first rank's replaces), the
    classifier's also on a data 4 x points 1 grid and with no mesh, under
    ``remat_policy="point_io"`` and under ``FWD_WINNER``, its class
    prediction under dropout 0.5, the fused block, an indivisible point
    count, the EMD auction and a validation with an eval hook (each must
    raise); the F-score of the row's clouds and a replicated tensor."""
    from cloud_transformers_tpu_torch.core import splat_slice
    from cloud_transformers_tpu_torch.nn.grouped_conv import (
        set_block_fusion,
    )
    from cloud_transformers_tpu_torch.parallel import mesh as pmesh
    from cloud_transformers_tpu_torch.parallel.distributed import (
        all_gather_array,
    )

    grid = pmesh.make_mesh(n_data=2, n_points=2)
    flat = pmesh.make_mesh(n_data=4, n_points=1)
    out = {"index": (grid.data_index, grid.points_index)}
    root = d["root"]
    for family in ("classifier", "segmenter", "inpainter"):
        row = _row(d["batch"][family], grid)
        if grid.points_index:
            row = _scrambled(row, rank)
        out[family] = family_step(family, d["kwargs"][family],
                                  d["state"][family], row,
                                  f"{root}/{family}{rank}", grid)
        # every rank's row batch after the broadcast, on every rank
        got = pmesh.broadcast_row(grid, row)
        out[family]["row_batch"] = {k: all_gather_array(v[None])
                                    for k, v in got.items()}

    cls, kw, state = d["batch"]["classifier"], d["kwargs"]["classifier"], \
        d["state"]["classifier"]
    out["flat"] = family_step("classifier", kw, state, _row(cls, flat),
                              f"{root}/flat{rank}", flat)
    out["no_mesh"] = family_step("classifier", kw, state, _row(cls, flat),
                                 f"{root}/none{rank}")
    out["remat"] = family_step(
        "classifier", dict(kw, remat=True, remat_policy="point_io"), state,
        _row(cls, grid), f"{root}/remat{rank}", grid)
    splat_slice.FWD_WINNER = True
    try:
        out["winner"] = family_step("classifier", kw, state,
                                    _row(cls, grid), f"{root}/win{rank}",
                                    grid)
    finally:
        splat_slice.FWD_WINNER = False

    model = family_model("classifier", dict(kw, dropout=0.5))
    model.load_state_dict(torch.load(state, weights_only=True)["model"])
    grid.seed(0)
    torch.manual_seed(rank)   # the per-point draws differ by rank
    pcd = torch.from_numpy(pmesh.shard_batch(grid, cls, 1)["pcd"])
    with grid:
        class_pred, _, _ = model.train()(pcd)
    out["dropout"] = {"class_pred": _np(class_pred)}

    set_block_fusion("fused")
    try:
        with grid:
            model(pcd)
    except ValueError as e:
        out["fused"] = str(e)
    finally:
        set_block_fusion(None)
    try:
        pmesh.shard_batch(grid, {"pcd": cls["pcd"][:, :-1]}, 1)
    except ValueError as e:
        out["indivisible"] = str(e)
    from cloud_transformers_tpu_torch.losses.emd import emd_auction
    from cloud_transformers_tpu_torch.train.trainer import Trainer
    try:
        with grid:
            emd_auction(pcd, pcd)
    except ValueError as e:
        out["emd"] = str(e)
    trainer = Trainer(model, dict(POINTS_CFG, experiment={
        "root": f"{root}/val{rank}"}), "val", family_loss_fn("classifier"),
        device="cpu", mesh=grid)
    try:
        trainer.validate([_row(cls, grid)], eval_hook=lambda b, m: None)
    except ValueError as e:
        out["eval_hook"] = str(e)

    from cloud_transformers_tpu_torch.losses.fscore import f_score
    clouds = {k: torch.from_numpy(v) for k, v in
              pmesh.shard_batch(grid, d["fscore"], 1).items()}
    with grid:
        out["f_score"] = [_np(t) for t in f_score(
            clouds["pred"], clouds["gt"], threshold=0.5, chunk_size=8)]
    out["replicated"] = _np(pmesh.replicate(
        grid, [torch.full((3,), float(rank))])[0])
    return out


def _count_launches():
    """Count the calls of the kernel wrappers (#1-#6 and the switched
    paths') that the autograd Functions and the convs reach, as
    ``tests/test_torch_chip_smoke.py`` counts them -> the counts dict."""
    from cloud_transformers_tpu_torch.core import splat_slice as tss
    from cloud_transformers_tpu_torch.ops import pallas_grid_conv as tgc

    calls = {}

    def counted(fn, name):
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper
    for name in ("splat_max", "splat_max_winner", "splat_route",
                 "splat_max_bwd", "slice_gather", "slice_bwd",
                 "fused_block"):
        setattr(tss, name, counted(getattr(tss, name), name))
    for name in ("grid_conv3d", "grid_conv2d", "grid_conv3d_dw",
                 "grid_conv2d_dw"):
        setattr(tgc, name, counted(getattr(tgc, name), name))
    return calls


def grid_launches(rank, world, root):
    """Phase 17 of ``chip_smoke.py`` at a tiny size: its three models at
    full width and its depths, one ``Trainer`` step each on the data 2 x
    points 2 grid, a few points a cloud -> {model: this rank's kernel
    launches in the step}."""
    import chip_smoke
    from cloud_transformers_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
    )
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(2, 2)
    calls = _count_launches()
    rs = np.random.RandomState(0)
    mask = np.ones((2, 32), np.float32)
    mask[0, 12:] = 0   # the first cloud's second block holds no valid point
    setups = {
        "classifier": ("scanobjectnn.yaml", {"dropout": 0.0},
                       classification.make_loss_fn(0.5),
                       {"pcd": rs.uniform(-1, 1, (2, 32, 3)),
                        "label": np.array([1, 2]),
                        "mask": rs.uniform(size=(2, 32)) > 0.5}),
        "segmenter": (chip_smoke.PTS_MODELS["segmenter"][0],
                      chip_smoke.PTS_MODELS["segmenter"][1],
                      segmentation_kpconv.make_loss_fn(),
                      {"points": rs.uniform(-1, 1, (2, 32, 3)),
                       "features": rs.uniform(0, 1, (2, 32, 4)),
                       "mask": mask, "label": rs.randint(0, 13, (2, 32))}),
        "inpainter": (chip_smoke.PTS_MODELS["inpainter"][0],
                      chip_smoke.PTS_MODELS["inpainter"][1],
                      chip_smoke.chamfer_loss,
                      {"partial": rs.uniform(-0.5, 0.5, (2, 16, 3)),
                       "gt": rs.uniform(-0.5, 0.5, (2, 32, 3)),
                       "noise": rs.randn(2, 32, 4)})}
    out = {}
    for family, (config, keys, loss_fn, batch) in setups.items():
        cfg = load_config(os.path.join(os.path.dirname(
            os.path.abspath(chip_smoke.__file__)), "configs", config))
        cfg["model"].update(keys)
        cfg["experiment"] = {"root": os.path.join(str(root), family)}
        cfg["train"]["auto_resume"] = False
        trainer = Trainer(model_from_config(cfg), cfg, family, loss_fn,
                          device="cpu", seed=0, mesh=mesh)
        batch = {k: (v.astype(np.float32) if v.dtype.kind in "fb" else v)
                 for k, v in batch.items()}
        calls.clear()
        trainer.train_step(shard_batch(mesh, batch))
        out[family] = dict(calls)
    return out
