"""The training window: a closed loop of ``Trainer.train_step`` on the
task's own loader, one process on one card.

Set-up builds one ``Trainer`` (model, Adam and its schedule) for the
configuration, draws the weights from the seed on the device
(``core/weights.py``), builds the task's loader with its worker threads
(``tasks/<task>.py``), and drives the trainer through its first
``CHECKED_STEPS`` steps on the loader's first batches, each after seeding
PyTorch's generators (the dropout draws) from the seed.  Those steps'
losses, the first gradient (from Adam's first moment) and the parameters
and running statistics after them are kept for the check; the traffic's
``warmup_steps`` follow.  The same trainer and loader then run the window:
each step waits for the loader's next batch and enqueues
``train_step``; after ``--seconds`` the window closes at a synchronize.
With ``--trace 1`` a fixed ``profile_steps`` more steps run under the
profiler.  Then the program's state is freed and the reference
(``reference/train.py``) takes the same three steps from the same weights,
batches and seeds.
"""

import itertools
import shutil
import statistics
import sys
import tempfile
import time

import torch

from ctbench.core import compare, profile
from ctbench.core.device import free, on_card, peak_bytes, sync
from ctbench.core.weights import fill_

CHECKED_STEPS = 3


def step_seed(seed, k):
    """The dropout seed of checked step ``k``."""
    return (int(seed) * 4 + k + 1) % 2 ** 63


def endless(loader):
    """The loader's batches, epoch after epoch."""
    for epoch in itertools.count():
        loader.set_epoch(epoch)
        yield from loader


def first_gradient(trainer):
    """{name: the gradient of Adam's first step}, from its first moment
    (m = (1 - b1) g after one step)."""
    opt = trainer.optimizer.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    return {n: opt.state[p]["exp_avg"].detach() / (1 - beta1)
            for n, p in trainer.model.named_parameters() if p in opt.state}


def snapshot(model):
    return {**{k: v.detach().clone() for k, v in model.named_parameters()},
            **{k: v.detach().clone() for k, v in model.named_buffers()}}


def build(ctx, exp_root):
    """-> (trainer, loader, weights, buffers, task) for the cell."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.train.trainer import Trainer
    task = ctx.module("tasks", ctx.config["task"])
    cfg = task.trainer_config(ctx.config, ctx.traffic, exp_root)
    model = get_model(ctx.config["registry"], **ctx.config["model"])
    trainer = Trainer(model, cfg, "ctbench", task.loss_fn(ctx.config),
                      device=ctx.device, seed=int(ctx.seed) % 2 ** 63)
    weights, buffers = fill_(trainer.model, ctx.seed, ctx.device)
    return trainer, task.loader(cfg, ctx.traffic, ctx.seed), weights, \
        buffers, task


def window(trainer, feed, task, seconds, device):
    """Steps until ``seconds`` have passed, then a synchronize.  -> the
    window's record."""
    waits, enqueues, losses, valid = [], [], [], []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        batch = next(feed)
        t1 = time.perf_counter()
        losses.append(trainer.train_step(batch)["loss"])
        t2 = time.perf_counter()
        waits.append(t1 - t0)
        enqueues.append(t2 - t1)
        valid.append(task.valid_points(batch))
        if t2 - start >= seconds:
            break
    sync(device)
    end = time.perf_counter()
    q = statistics.quantiles([1e3 * e for e in enqueues], n=10)
    tenth = max(1, len(enqueues) // 10)
    print(f"ctbench: window {len(losses)} steps in {end - start:.3f} s; "
          f"train_step ms p10 {q[0]:.1f} p50 {q[4]:.1f} p90 {q[8]:.1f}; "
          f"first and last tenth {1e3 * sum(enqueues[:tenth]) / tenth:.1f}, "
          f"{1e3 * sum(enqueues[-tenth:]) / tenth:.1f}", file=sys.stderr)
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    return {"seconds": end - start, "steps": len(losses),
            "samples": sum(len(v) for v in valid), "valid_points": valid,
            "failed": int((~finite).sum()),
            "spans": {"loader_wait": waits, "step_enqueue": enqueues}}


def profiled_steps(trainer, feed, steps, device):
    """``steps`` steps under the profiler, reduced."""
    def stretch(span):
        for _ in range(steps):
            with span("loader_wait"):
                batch = next(feed)
            with span("train_step"):
                trainer.train_step(batch)
        with span("synchronize"):
            sync(device)
    return profile.reduce(*profile.profiled(stretch))


def checked_steps(ctx, exp_root):
    """Build the cell's trainer and loader and take the checked steps.
    -> (trainer, feed, task, the reference's inputs and the program's
    readings)."""
    trainer, loader, weights, buffers, task = build(ctx, exp_root)
    feed = endless(loader)
    checked = {"loss": [], "batches": [], "seeds": [], "weights": weights,
               "buffers": buffers}
    for k in range(CHECKED_STEPS):
        batch = next(feed)
        checked["seeds"].append(step_seed(ctx.seed, k))
        torch.manual_seed(checked["seeds"][-1])
        checked["loss"].append(trainer.train_step(batch)["loss"])
        checked["batches"].append(batch)
        if k == 0:
            checked["grad"] = first_gradient(trainer)
    checked["params"] = snapshot(trainer.model)
    checked["loss"] = [float(x) for x in checked["loss"]]
    return trainer, feed, task, checked


def reference(ctx, checked, tf32=False, rows=None):
    """The reference's steps on the checked steps' weights, batches and
    seeds (with ``rows``, on those rows of each batch only)."""
    batches = checked["batches"]
    if rows is not None:
        batches = [{k: v[rows] for k, v in b.items()} for b in batches]
    return ctx.module("reference", "train").run_steps(
        ctx.module("reference", ctx.config["family"]), ctx.config["model"],
        ctx.config["train"], checked["weights"], checked["buffers"],
        batches, checked["seeds"], ctx.device, tf32=tf32)


def gaps(checked, prog, ref):
    """The numbers compared, of ``prog`` against ``ref`` from the checked
    steps' start."""
    return compare.training_gaps(prog, ref, checked["weights"],
                                 checked["buffers"])


def readings(ctx, kind):
    """The numbers compared, for one seed: of the program (``program``), of
    the reference at TF32 in its place (``control``), or of the program
    with half of each batch left out and the mean taken over the rest
    (``half_batch``, planted in the reference put in its place)."""
    exp_root = tempfile.mkdtemp(prefix="ctbench-", dir=ctx.tmp)
    try:
        trainer, feed, _, checked = checked_steps(ctx, exp_root)
        feed.close()
        del trainer, feed
        free(ctx.device)
        ref = reference(ctx, checked)
        if kind == "program":
            return gaps(checked, checked, ref)
        if kind == "control":
            return gaps(checked, reference(ctx, checked, tf32=True), ref)
        b = len(checked["batches"][0][next(iter(checked["batches"][0]))])
        return gaps(checked, reference(ctx, checked, rows=slice(0, b // 2)),
                    ref)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)


def run(ctx):
    exp_root = tempfile.mkdtemp(prefix="ctbench-", dir=ctx.tmp)
    try:
        return _run(ctx, exp_root)
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)


def _run(ctx, exp_root):
    trainer, feed, task, checked = checked_steps(ctx, exp_root)
    for _ in range(int(ctx.traffic.get("warmup_steps", 2))):
        trainer.train_step(next(feed))
    sync(ctx.device)
    setup_s = ctx.since_start()
    rec = window(trainer, feed, task, ctx.seconds, ctx.device)
    out = {"setup_s": setup_s, "window": rec, "spans": rec["spans"],
           "attempted": rec["steps"], "failed": rec["failed"]}
    counts = ctx.module("counts", ctx.config["family"])
    model_cfg = ctx.config["model"]
    out["flops"] = sum(3 * counts.forward_flops(model_cfg, v)
                       for v in rec["valid_points"])
    if ctx.trace:
        steps = int(ctx.traffic["profile_steps"])
        reduced = profiled_steps(trainer, feed, steps, ctx.device)
        if reduced is not None:
            clouds, points = task.launch_shape(ctx.traffic)
            reduced["steps"] = steps
            reduced["kernel_rows"] = counts.kernel_rows(
                model_cfg, clouds, points) * steps
            out["profile"] = reduced
            out["breakdown"] = profile.breakdown(reduced)
    out["memory_peak_bytes"] = peak_bytes(ctx.device)
    feed.close()
    del trainer, feed
    free(ctx.device)
    if on_card(ctx.device):
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out["readings"] = gaps(checked, checked, reference(ctx, checked))
    print(f"ctbench: reference {time.perf_counter() - t0:.1f} s, peak "
          f"{peak_bytes(ctx.device)} bytes", file=sys.stderr)
    limits = ctx.data["limits"]
    out["checks"] = {k: (out["readings"][k], limits[k]) for k in limits}
    return out
