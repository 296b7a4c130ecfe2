"""Data-parallel training of the port across processes, on the CPU.

One training step of the tiny ScanObjectNN classifier on 2 gloo ranks
(``tests/_torch_parallel_ranks.py``: ``Trainer`` restores the same
weights on every rank, each rank takes its half of the global batch,
gradients are averaged, BatchNorm statistics are global) against the JAX
package's step on ``make_mesh(n_data=2)`` with the batch sharded over
'data' (the ``__graft_entry__._dryrun_impl`` pattern), weights from
``convert.load_jax_variables``, dropout 0 on both sides: the loss within
1e-5, every gradient leaf by the PARITY.md criteria (cosine > 0.999,
median error <= 1e-3 of its scale), the running statistics within 1e-6;
both ranks end with bit-equal parameters and buffers, and their
validation with ``ClassEvalAccumulator`` equals one process's.  Then the
real ``train_classification`` command line as two processes with
``--coordinator``, and under ``torchrun``, against one process at the
same global batch: the
per-step losses within 1e-5, as ``tests/test_multiprocess.py`` holds the
JAX command line.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_parallel_ranks as ranks
from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
)
from cloud_transformers_tpu.tasks import classification as jcls
from cloud_transformers_tpu_torch.convert import (
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.tasks import classification as tcls
from cloud_transformers_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_classes=15, model_dim=16, repeats=1,
            stage_plan=(((4, 4), (2, 2), (8, 8), (2, 3)),),
            pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
            trunk_width=4, class_dim=16, mask_dim=8)
GLOBAL_B, POINTS = 4, 64


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"pcd": rs.uniform(-1, 1, (GLOBAL_B, POINTS, 3))
            .astype(np.float32),
            "label": rs.randint(0, 15, GLOBAL_B).astype(np.int32),
            "mask": (rs.uniform(size=(GLOBAL_B, POINTS)) > 0.5)
            .astype(np.float32)}


def _jax_variables(model, pcd):
    """Fresh variables with every BatchNorm scale and running statistic
    drawn from numpy (``key_bn.scale`` starts at 0, which would hide the
    key path's gradient)."""
    v = jax.device_get(jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, train=False))(jnp.asarray(pcd)))
    rs = np.random.RandomState(0)

    def scales(path, a):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] != "scale":
            return np.asarray(a)
        lo, hi = (0.2, 0.6) if "key_bn" in names else (0.5, 1.5)
        return rs.uniform(lo, hi, a.shape).astype(np.float32)

    v["params"] = jax.tree_util.tree_map_with_path(scales, v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return v


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def _jax_step(jm, variables, batch):
    """JAX's loss, gradients and new statistics with the batch sharded over
    a 'data' axis of 2 devices (global BatchNorm statistics by GSPMD)."""
    mesh = make_mesh(n_data=2, n_points=1, devices=jax.devices()[:2])
    loss_fn = jcls.make_loss_fn(0.5)

    def compute(params, stats, b):
        loss, _, new_stats = loss_fn(
            jm.apply, {"params": params, "batch_stats": stats}, b,
            jax.random.PRNGKey(0), True)
        return loss, new_stats

    with mock.patch.object(
            flax.linen.Dropout, "__call__",
            lambda self, inputs, deterministic=None, rng=None: inputs), \
            mesh:
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            compute, has_aux=True))(
                replicate(mesh, variables["params"]),
                replicate(mesh, variables["batch_stats"]),
                shard_batch(mesh, batch))
    return float(loss), jax.device_get(grads), jax.device_get(stats)


def test_two_rank_step_matches_jax_mesh(tmp_path):
    batch = _batch(0)
    val = [_batch(s) for s in (1, 2)]
    jm = jax_model("scanobject_classifier", **TINY)
    variables = _jax_variables(jm, batch["pcd"])
    j_loss, j_grads, j_stats = _jax_step(jm, variables, batch)

    tm = load_jax_variables(
        get_model("scanobject_classifier", dropout=0.0, **TINY), variables)
    state = str(tmp_path / "weights.pt")
    torch.save({"model": tm.state_dict()}, state)
    cfg = {"experiment": {"root": str(tmp_path / "exp")},
           "train": {"optimizer": {"type": "Adam", "lr": 1e-3},
                     "save": False, "auto_resume": False}}
    outs = ranks.run_ranks(ranks.classifier_step, 2, tmp_path / "ranks",
                           cfg, state, batch, val, TINY)

    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), j_loss,
                               rtol=1e-5)
    for key in ("grads", "buffers", "params"):   # one step on every rank
        for name, a in outs[0][key].items():
            np.testing.assert_array_equal(outs[1][key][name], a,
                                          err_msg=f"{key} {name}")

    t_grads = port_to_jax_tree(
        {k: torch.from_numpy(v) for k, v in outs[0]["grads"].items()},
        variables["params"])
    j_leaves, t_leaves = dict(_leaves(j_grads)), dict(_leaves(t_grads))
    assert set(j_leaves) == set(t_leaves) and len(j_leaves) > 50
    # a bias that feeds a BatchNorm has rounding noise for a gradient in
    # both frameworks: such a leaf must be noise in the port too
    floor = 1e-6 * max(np.abs(r).max() for r in j_leaves.values())
    compared = 0
    for name, ref in j_leaves.items():
        got = t_leaves[name]
        scale = np.abs(ref).max()
        if scale <= floor:
            assert name.endswith("/bias") and np.abs(got).max() <= floor, \
                name
            continue
        cos = (got.ravel() @ ref.ravel()
               / (np.linalg.norm(got) * np.linalg.norm(ref)))
        p50 = np.median(np.abs(got - ref)) / scale
        assert cos > 0.999 and p50 <= 1e-3, (name, cos, p50)
        compared += 1
    assert compared >= len(j_leaves) - 6

    t_stats = dict(_leaves(port_to_jax_tree(
        {k: torch.from_numpy(v) for k, v in outs[0]["buffers"].items()},
        variables["batch_stats"])))
    moved = 0
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(t_stats[name], ref, rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        before = dict(_leaves(variables["batch_stats"]))[name]
        moved += np.abs(ref - before).max() > 1e-3
    assert moved > 10

    # validation: the ranks' mean loss and pooled confusion are one
    # process's over the whole batches
    single = get_model("scanobject_classifier", dropout=0.0, **TINY)
    trainer = Trainer(single, dict(cfg), "single", tcls.make_loss_fn(0.5),
                      device="cpu", seed=0)
    single.load_state_dict({**{k: torch.from_numpy(v) for k, v in
                               outs[0]["params"].items()},
                            **{k: torch.from_numpy(v) for k, v in
                               outs[0]["buffers"].items()}})
    want = trainer.validate(ranks.rows_of(val, 0, 1),
                            tcls.ClassEvalAccumulator(15))
    for o in outs:
        assert o["val"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(o["val"][k], v, rtol=1e-6, err_msg=k)


CONFIG = """
experiment:
    root: '{root}/exp'
    writer_root: '{root}/runs'
data:
    batch_size: {batch}
    num_workers: 0
    num_points: 64
model:
    name: 'scanobject_classifier'
    n_classes: 15
    model_dim: 16
    repeats: 1
    pool_heads: 2
    pool_feature_dims: [4, 4]
    pool_sizes: [4, 8]
    trunk_width: 4
    class_dim: 16
    mask_dim: 8
    dropout: 0.0
    stage_plan: [[[4, 4], [2, 2], [8, 8], [2, 3]]]
train:
    seg_weight: 0.5
    show_each: 1
    num_epochs: 1
    optimizer:
        type: 'Adam'
        lr: 0.001
"""


def _cli(args, log, launcher=()):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", *launcher,
             "cloud_transformers_tpu_torch.train_classification"] + args,
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)


def _wait(procs, logs, timeout=120):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, open(log).read()[-4000:]


def _losses(root, exp):
    out = {}
    with open(os.path.join(root, "runs", exp, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train/loss" in rec:
                assert rec["step"] not in out   # one writer
                out[rec["step"]] = rec["train/loss"]
    return out


def test_two_process_cli_matches_one(tmp_path):
    """Two processes by ``--coordinator`` (a ``file://`` rendezvous, so no
    port can collide) and two under ``torchrun --standalone`` (a free
    port of its own) against one process."""
    steps = 3
    multi, launched, single = tmp_path / "m", tmp_path / "t", tmp_path / "s"
    for name, root, batch in (("multi", multi, 4), ("launched", launched, 4),
                              ("single", single, 8)):
        (tmp_path / f"{name}.yaml").write_text(
            CONFIG.format(root=root, batch=batch))
    base = ["--synthetic", "--steps", str(steps), "--device", "cpu"]
    logs = [str(tmp_path / f"{n}.log") for n in ("mp0", "mp1", "tr", "sp")]
    procs = [_cli(["mp", "-c", str(tmp_path / "multi.yaml")] + base
                  + ["--coordinator", f"file://{tmp_path}/rendezvous",
                     "--num-processes", "2", "--process-id", str(pid)],
                  logs[pid]) for pid in (0, 1)]
    procs.append(_cli(["tr", "-c", str(tmp_path / "launched.yaml")] + base,
                      logs[2], launcher=("torch.distributed.run",
                                         "--standalone",
                                         "--nproc-per-node", "2", "-m")))
    procs.append(_cli(["sp", "-c", str(tmp_path / "single.yaml")] + base,
                      logs[3]))
    _wait(procs, logs)
    want = _losses(single, "sp")
    assert sorted(want) == list(range(1, steps + 1))
    for got in (_losses(multi, "mp"), _losses(launched, "tr")):
        assert sorted(got) == sorted(want)
        for step in want:
            np.testing.assert_allclose(got[step], want[step], rtol=1e-5,
                                       err_msg=str(step))
    # rank 0 wrote the checkpoint of the run's end
    assert os.path.isfile(multi / "exp" / "mp" / "ckpt_latest.pt")
