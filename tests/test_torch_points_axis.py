"""The whole-model points axis of the port, on the CPU.

The three model families of ``__graft_entry__._dryrun_impl`` at its tiny
sizes (the classifier of ``_TINY_CLASSIFIER`` with ``TINY_STAGE_PLAN``,
``s3dis_segmenter_pad`` at ``model_dim=64, repeats=1`` on ragged valid
prefixes of 21..63 of 64 points, one of which leaves the second point
block of its cloud without a valid point, and the AdaIN inpainter of
``_TINY_INPAINTER`` on the Chamfer loss), with the port's initial weights
(brought into the JAX tree by ``convert.port_to_jax_tree`` and back by
``load_jax_variables``) and the dryrun's batches, take one
``Trainer.train_step`` on a
data 2 x points 2 grid of 4 gloo ranks (``tests/_torch_parallel_ranks.py``,
``parallel/mesh.make_mesh(2, 2)``; dropout 0), held against:

* the JAX package's one-device step on the same global batch and
  weights: the loss within 1e-5, every gradient
  leaf by the PARITY.md criteria (cosine > 0.999, median error <= 1e-3 of
  its scale), the running statistics within 1e-6 of max(1, the buffer's
  largest);
* the port's own one-process step: the loss and every gradient at the
  dryrun's atol 1e-5 / rtol 1e-4, the running statistics within 1e-6 of
  max(1, the buffer's largest).

And: the classifier's grid step against the JAX step on
``make_mesh(n_data=1, n_points=2)`` with the points sharded; every rank
ends with bit-equal parameters and buffers; the row's second points rank,
given a scrambled batch, trains on its first rank's (the row batches are
bit-equal); a data 4 x points 1 grid is bit-equal to the data-parallel
step without a mesh; ``remat_policy="point_io"`` and ``FWD_WINNER`` give
the grid step's gradients bit for bit; under dropout 0.5 the points ranks
of a row predict the same classes; the F-score is the whole clouds';
the fused block, an indivisible point count, the EMD auction and a
validation with an eval hook raise.
"""

from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
import __graft_entry__ as graft
from cloud_transformers_tpu.losses import loss_chamfer as jax_chamfer
from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.models.classifier import TINY_STAGE_PLAN
from cloud_transformers_tpu.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
)
from cloud_transformers_tpu.tasks import classification as jcls
from cloud_transformers_tpu.tasks import segmentation_kpconv as jseg
from cloud_transformers_tpu_torch.convert import (
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.nn.init import init_model_

FAMILIES = ("classifier", "segmenter", "inpainter")
NAMES = {"classifier": "scanobject_classifier",
         "segmenter": "s3dis_segmenter_pad",
         "inpainter": "completion_inpainter"}
KWARGS = {"classifier": dict(stage_plan=TINY_STAGE_PLAN,
                             **graft._TINY_CLASSIFIER),
          "segmenter": dict(n_classes=13, model_dim=64, repeats=1,
                            stage_plan=TINY_STAGE_PLAN),
          "inpainter": dict(stage_plan=TINY_STAGE_PLAN,
                            **graft._TINY_INPAINTER)}
N, P = 8, 64   # the dryrun's global batch on 4 devices, points a cloud
VALID = (21, 29, 40, 63, 33, 47, 58, 25)   # the segmenter's valid prefixes


def _batches():
    """The dryrun's batches, the segmenter's valid prefixes fixed so that
    they do not divide by 2 and the 1st cloud's second block (points
    32..63) holds no valid point."""
    rs = np.random.RandomState(0)
    out = {"classifier": {
        "pcd": rs.randn(N, P, 3).astype(np.float32),
        "label": np.random.RandomState(3).randint(0, 15, N).astype(np.int32),
        "mask": (np.random.RandomState(4).rand(N, P) > 0.5)
        .astype(np.float32)}}
    rs = np.random.RandomState(1)
    out["segmenter"] = {
        "points": rs.randn(N, P, 3).astype(np.float32),
        "mask": (np.arange(P)[None] < np.array(VALID)[:, None])
        .astype(np.float32),
        "features": rs.randn(N, P, 4).astype(np.float32),
        "label": rs.randint(0, 13, size=(N, P)).astype(np.int32)}
    rs = np.random.RandomState(2)
    out["inpainter"] = {
        "noise": rs.randn(N, P, 4).astype(np.float32),
        "partial": (rs.randn(N, P // 2, 3) * 0.3).astype(np.float32),
        "gt": (rs.randn(N, P, 3) * 0.3).astype(np.float32)}
    return out


def _apply_args(family, batch):
    if family == "classifier":
        return (batch["pcd"],)
    if family == "segmenter":
        return (batch["points"], batch["mask"], batch["features"])
    return (batch["noise"], batch["partial"])


def _jax_loss(family, model):
    """-> compute(params, stats, batch) -> (loss, new stats), the dryrun's
    losses with dropout off."""
    if family == "classifier":
        loss_fn = jcls.make_loss_fn(0.5)
    elif family == "segmenter":
        loss_fn = jseg.make_loss_fn()

    def compute(params, stats, batch):
        variables = {"params": params, "batch_stats": stats}
        if family == "inpainter":
            (recon, _), updates = model.apply(
                variables, batch["noise"], batch["partial"], train=True,
                mutable=["batch_stats"])
            return jax_chamfer(recon, batch["gt"]), updates["batch_stats"]
        loss, _, new_stats = loss_fn(model.apply, variables, batch,
                                     jax.random.PRNGKey(0), True)
        return loss, new_stats
    return compute


def _jax_step(family, model, variables, batch, mesh=None, points_axis=None):
    compute = _jax_loss(family, model)
    step = jax.jit(jax.value_and_grad(compute, has_aux=True))
    params, stats = variables["params"], variables["batch_stats"]
    with mock.patch.object(
            flax.linen.Dropout, "__call__",
            lambda self, inputs, deterministic=None, rng=None: inputs):
        if mesh is None:
            (loss, new_stats), grads = step(params, stats, batch)
        else:
            with mesh:
                (loss, new_stats), grads = step(
                    replicate(mesh, params), replicate(mesh, stats),
                    shard_batch(mesh, batch, points_axis=points_axis))
    return {"loss": float(loss), "grads": jax.device_get(grads),
            "stats": jax.device_get(new_stats)}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX steps, the 4-rank grid run and the one-process steps,
    shared by the file's tests."""
    root = tmp_path_factory.mktemp("points_axis")
    batches = _batches()
    out = {"batches": batches, "variables": {}, "jax": {}, "one": {},
           "start": {}}
    state, kwargs = {}, {}
    for family in FAMILIES:
        jm = jax_model(NAMES[family], **KWARGS[family])
        kwargs[family] = dict(KWARGS[family])
        if family == "classifier":
            kwargs[family]["dropout"] = 0.0
        tm = ranks.family_model(family, kwargs[family])
        init_model_(tm, torch.Generator().manual_seed(0))
        shapes = jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
                lambda: jm.init(
                    {"params": jax.random.PRNGKey(0),
                     "dropout": jax.random.PRNGKey(1)},
                    *map(jnp.asarray, _apply_args(family, batches[family])),
                    train=True)))
        variables = {k: port_to_jax_tree(tm.state_dict(), shapes[k])
                     for k in ("params", "batch_stats")}
        load_jax_variables(tm, variables)   # the round trip, strict
        out["variables"][family] = variables
        out["jax"][family] = _jax_step(family, jm, variables,
                                       batches[family])
        if family == "classifier":
            out["jax_points"] = _jax_step(
                family, jm, variables, batches[family],
                make_mesh(n_data=1, n_points=2, devices=jax.devices()[:2]),
                points_axis=1)
        out["start"][family] = {k: b.numpy().copy()
                                for k, b in tm.named_buffers()}
        state[family] = str(root / f"{family}.pt")
        torch.save({"model": tm.state_dict()}, state[family])
        out["one"][family] = ranks.family_step(
            family, kwargs[family], state[family], batches[family],
            str(root / f"one_{family}"))
    rs = np.random.RandomState(5)
    out["fscore"] = {k: rs.uniform(-1, 1, (N // 2, 16, 3)).astype(np.float32)
                     for k in ("pred", "gt")}
    out["ranks"] = ranks.run_ranks(
        ranks.points_axis_steps, 4, root / "ranks",
        {"batch": batches, "kwargs": kwargs, "state": state,
         "root": str(root), "fscore": out["fscore"]}, timeout=240)
    return out


def _check_against_jax(port, ref, variables):
    """PARITY.md's criteria for every gradient leaf (a leaf whose reference
    is rounding noise or zero, a bias before a BatchNorm or the inpainter's
    key AdaINs behind their zero ``scale``, must be so in the port too),
    the loss within 1e-5, the statistics within 1e-6."""
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    t_grads = port_to_jax_tree(
        {k: torch.from_numpy(v) for k, v in port["grads"].items()},
        variables["params"])
    j_leaves, t_leaves = dict(_leaves(ref["grads"])), dict(_leaves(t_grads))
    assert set(j_leaves) == set(t_leaves) and len(j_leaves) > 30
    floor = 1e-6 * max(np.abs(r).max() for r in j_leaves.values())
    compared = 0
    for name, r in j_leaves.items():
        got = t_leaves[name]
        scale = np.abs(r).max()
        if scale <= floor:
            assert (name.endswith("/bias") or "keys_adain" in name) and \
                np.abs(got).max() <= floor, name
            continue
        cos = got.ravel() @ r.ravel() / (np.linalg.norm(got)
                                         * np.linalg.norm(r))
        p50 = np.median(np.abs(got - r)) / scale
        assert cos > 0.999 and p50 <= 1e-3, (name, cos, p50)
        compared += 1
    assert compared >= 0.9 * len(j_leaves)
    t_stats = dict(_leaves(port_to_jax_tree(
        {k: torch.from_numpy(v) for k, v in port["buffers"].items()},
        variables["batch_stats"])))
    for name, r in _leaves(ref["stats"]):
        err = np.abs(t_stats[name] - r).max() / max(1.0, np.abs(r).max())
        assert err <= 1e-6, (name, err)


def _grid(runs, family):
    """The grid's step as one result: the ranks' mean loss, rank 0's
    averaged gradients, buffers and parameters."""
    outs = runs["ranks"]
    return dict(outs[0][family],
                loss=float(np.mean([o[family]["loss"] for o in outs])))


@pytest.mark.parametrize("family", FAMILIES)
def test_grid_step_matches_jax_one_device(runs, family):
    _check_against_jax(_grid(runs, family), runs["jax"][family],
                       runs["variables"][family])


def test_classifier_grid_step_matches_jax_points_mesh(runs):
    """The JAX step on data 1 x points 2, the points sharded."""
    _check_against_jax(_grid(runs, "classifier"), runs["jax_points"],
                       runs["variables"]["classifier"])


@pytest.mark.parametrize("family", FAMILIES)
def test_grid_step_matches_one_process(runs, family):
    """The dryrun's tolerances: the loss and each gradient at atol 1e-5,
    rtol 1e-4; the running statistics within 1e-6 of max(1, |buffer|)."""
    grid, one = _grid(runs, family), runs["one"][family]
    np.testing.assert_allclose(grid["loss"], one["loss"], atol=1e-5,
                               rtol=1e-5)
    assert grid["grads"].keys() == one["grads"].keys()
    for name, g in one["grads"].items():
        np.testing.assert_allclose(grid["grads"][name], g, atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    for name, b in one["buffers"].items():
        err = np.abs(grid["buffers"][name] - b).max() / max(
            1.0, np.abs(b).max())
        assert err <= 1e-6, (name, err)
    moved = sum(np.abs(grid["buffers"][k] - v).max() > 1e-4
                for k, v in runs["start"][family].items())
    assert moved > 5


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_end_bit_equal(runs, family):
    outs = runs["ranks"]
    for key in ("grads", "buffers", "params"):
        for name, a in outs[0][family][key].items():
            for o in outs[1:]:
                np.testing.assert_array_equal(o[family][key][name], a,
                                              err_msg=f"{key} {name}")


@pytest.mark.parametrize("family", FAMILIES)
def test_row_batches_are_the_first_points_ranks(runs, family):
    """The row's second points rank built a scrambled batch; after the
    broadcast both ranks of a row hold its first rank's, bit for bit."""
    outs = runs["ranks"]
    gathered = outs[0][family]["row_batch"]   # every rank's, in rank order
    for r, o in enumerate(outs):
        d = o["index"][0]
        for k, v in runs["batches"][family].items():
            np.testing.assert_array_equal(gathered[k][r],
                                          v[d * N // 2:(d + 1) * N // 2],
                                          err_msg=k)


def test_n_points_one_is_the_data_parallel_step(runs):
    """A data 4 x points 1 grid takes the step without a mesh, bit for
    bit."""
    for o in runs["ranks"]:
        for key in ("grads", "buffers", "params"):
            for name, a in o["no_mesh"][key].items():
                np.testing.assert_array_equal(o["flat"][key][name], a,
                                              err_msg=f"{key} {name}")
        assert o["flat"]["loss"] == o["no_mesh"]["loss"]


@pytest.mark.parametrize("case", ["remat", "winner"])
def test_remat_and_fwd_winner_give_the_grid_step(runs, case):
    """``remat_policy="point_io"`` recomputes each kernel chain, its
    all-reduce included, in the backward, and moves the statistics once;
    ``FWD_WINNER`` routes each rank's share through its winner map.  Both
    give the grid step bit for bit."""
    for o in runs["ranks"]:
        for key in ("grads", "buffers", "params"):
            for name, a in o["classifier"][key].items():
                np.testing.assert_array_equal(o[case][key][name], a,
                                              err_msg=f"{key} {name}")


def test_dropout_draws_alike_on_a_row(runs):
    """Under dropout 0.5 the class vector's mask is the row's: its points
    ranks predict the same classes (the rows, holding other clouds,
    differ)."""
    by = {o["index"]: o["dropout"] for o in runs["ranks"]}
    for d in (0, 1):
        np.testing.assert_array_equal(by[(d, 0)]["class_pred"],
                                      by[(d, 1)]["class_pred"])
    assert not np.array_equal(by[(0, 0)]["class_pred"],
                              by[(1, 0)]["class_pred"])


def test_what_needs_whole_clouds_raises(runs):
    """Under the grid the fused block, an indivisible point count, the EMD
    auction and a validation with an eval hook raise; none falls back."""
    for o in runs["ranks"]:
        assert "points axis" in o["fused"]
        assert "does not divide" in o["indivisible"]
        assert "points axis" in o["emd"]
        assert "eval hook" in o["eval_hook"]


def test_f_score_and_replicate_on_the_grid(runs):
    """Under the grid the F-score of each rank's blocks is the row's whole
    clouds' (``f_score_point_sharded``), and ``replicate`` gives every
    rank rank 0's tensor."""
    from cloud_transformers_tpu_torch.losses.fscore import f_score

    whole = [t.numpy() for t in f_score(
        *(torch.from_numpy(runs["fscore"][k]) for k in ("pred", "gt")),
        threshold=0.5)]
    for o in runs["ranks"]:
        d = o["index"][0]
        for got, want in zip(o["f_score"], whole):
            np.testing.assert_allclose(got, want[d * 2:(d + 1) * 2],
                                       rtol=1e-6)
        np.testing.assert_array_equal(o["replicated"], np.zeros(3))
