"""``chip_smoke.py``'s library yardstick for the slice: one
``F.grid_sample`` call on the re-laid-out grid computes what the slice
computes, here on the CPU at a small size.  And the kernel launches it
expects per forward and per training step, on the default path and under
each set of execution switches, are the full-width classifier's, the
S3DIS segmenter's and the single-view reconstructor's, and on every rank
of phase 17's data 2 x points 2 grid its three models'."""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
from cloud_transformers_tpu_torch.core.splat_slice import _flatten_mapping
from cloud_transformers_tpu_torch.ops import pallas_splat as ps


@pytest.mark.parametrize("sizes", [(16, 16), (8, 16), (8, 8, 8), (4, 8, 16)])
def test_grid_sample_matches_slice(sizes):
    rng = np.random.RandomState(0)
    b, k, h, f = 2, 64, 3, 5
    lat = torch.from_numpy(np.tanh(
        rng.randn(b, k, h, len(sizes)) * 2).astype(np.float32))
    mapping = _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))
    cells = ps.kernel_grid_dims(sizes)[2]
    grid = torch.from_numpy(rng.randn(b * h, cells, f).astype(np.float32))
    keys = lat.transpose(1, 2).reshape(b * h, k, len(sizes)).clamp(
        -1 + 1e-7, 1 - 1e-7)
    inp, pts = chip_smoke.grid_sample_inputs(grid, keys, sizes)
    got = chip_smoke.grid_sample_slice(inp, pts).reshape(b * h, f, k)
    want = ps.slice_plain(*mapping, grid, sizes)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want.numpy(),
                               atol=chip_smoke.LIB_TOL)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test runs a full-width model on the CPU.
    The suite runs six worker processes on the CPU's cores, and a worker
    whose own pool has a thread for every core oversubscribes them: a
    classifier's forward and backward at 32 points took 267-427 s there
    against 4 s alone (16-19 s alone on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _spy_launches(monkeypatch):
    """{kernel: calls} of the kernel wrappers as the model calls them: on
    the card each call is one launch; on the CPU the same calls reach the
    plain versions.  The BatchNorms take their kernels' path as on the
    card (a float32 tensor normalised over its last axis, statistics in
    one process), on the wrappers' plain versions."""
    from cloud_transformers_tpu_torch.core import splat_slice as tss
    from cloud_transformers_tpu_torch.nn import norm
    from cloud_transformers_tpu_torch.ops import batch_norm as tbn
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
        monkeypatch.setattr(tss, name, counted(getattr(tss, name), name))
    # the conv Functions reach these through the module's globals
    for name in ("grid_conv3d", "grid_conv2d", "grid_conv3d_dw",
                 "grid_conv2d_dw"):
        monkeypatch.setattr(tgc, name, counted(getattr(tgc, name), name))
    monkeypatch.setattr(
        norm, "kernel_path", lambda device, dtype, channel_last, spread:
        dtype == torch.float32 and channel_last and not spread)
    for name in chip_smoke.BN_WRAPPERS:
        monkeypatch.setattr(tbn, name, counted(
            getattr(tbn, f"{name}_plain"), name))
    return calls


@pytest.mark.parametrize("name", (None,) + chip_smoke.SETS)
def test_expected_launches_are_the_full_width_classifiers(monkeypatch, name):
    """The launches ``chip_smoke.py`` expects per forward and per training
    step, on the default path and under each set of switches, are the
    kernel calls of the full-width classifier (the widths and grids of
    ``DEFAULT_STAGE_PLAN``), counted here on the CPU with a few points."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.tasks import classification
    model = get_model("scanobject_classifier")
    rs = np.random.RandomState(0)
    batch = {"pcd": torch.from_numpy(
                 rs.uniform(-1, 1, (2, 32, 3)).astype(np.float32)),
             "label": torch.tensor([1, 2]),
             "mask": torch.ones(2, 32)}
    runs = {}
    with chip_smoke.switches(name) if name else contextlib.nullcontext():
        calls = _spy_launches(monkeypatch)
        with torch.no_grad():
            model.eval()(batch["pcd"])
        runs["forward"] = dict(calls)
        calls.clear()
        loss, _ = classification.make_loss_fn(0.5)(model.train(), batch)
        loss.backward()
        runs["step"] = dict(calls)
    forward, step = chip_smoke.PER_FORWARD, chip_smoke.PER_STEP
    if name:
        forward, step = (chip_smoke.set_counts(name, per, training)
                         for per, training in ((forward, False),
                                               (step, True)))
    assert runs == {"forward": forward, "step": step}


@pytest.mark.parametrize("name", (None,) + chip_smoke.SETS)
def test_expected_launches_are_the_full_width_segmenters(monkeypatch, name):
    """The same for the S3DIS segmenter: the classifier's trunk without its
    pools, per forward (``PER_FORWARD_SEGMENTER``, which its validation
    runs) and per training step (``PER_STEP_SEGMENTER``), on the default
    path and under each set; counted on the CPU with one block of a few
    points."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.tasks import segmentation
    model = get_model("s3dis_segmenter")
    rs = np.random.RandomState(0)
    batch = {"pcd": torch.from_numpy(np.concatenate(
                 [rs.uniform(-1, 1, (1, 32, 3)), rs.uniform(0, 1, (1, 32, 3))],
                 -1).astype(np.float32)),
             "label": torch.from_numpy(rs.randint(0, 13, (1, 32)))}
    runs = {}
    with chip_smoke.switches(name) if name else contextlib.nullcontext():
        calls = _spy_launches(monkeypatch)
        with torch.no_grad():
            model.eval()(batch["pcd"])
        runs["forward"] = dict(calls)
        calls.clear()
        loss, _ = segmentation.make_loss_fn(13)(model.train(), batch)
        loss.backward()
        runs["step"] = dict(calls)
    forward = chip_smoke.PER_FORWARD_SEGMENTER
    step = chip_smoke.PER_STEP_SEGMENTER
    if name:
        forward, step = (chip_smoke.set_counts(name, per, training)
                         for per, training in ((forward, False),
                                               (step, True)))
        forward = {k: v for k, v in forward.items() if v}
        step = {k: v for k, v in step.items() if v}
    assert runs == {"forward": forward, "step": step}


@pytest.mark.parametrize("name", (None,) + chip_smoke.SETS)
def test_expected_launches_are_the_full_width_reconstructors(monkeypatch,
                                                             name):
    """The same for the single-view reconstructor: its AdaIN decoder's 24
    head groups, per forward (``PER_FORWARD_RECONSTRUCTOR``, two of which
    make an evaluated batch) and per training step of the task's loss
    (``PER_STEP_RECONSTRUCTOR``; the auction's ``top2`` launches are
    counted by rounds), on the default path and under each set; counted on
    the CPU with one 32^2 image and 32 points."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.tasks import reconstruction
    model = get_model("image_reconstructor")
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(
                 rs.randn(1, 32, 32, 3).astype(np.float32)),
             "pcd": torch.from_numpy(rs.rand(1, 32, 3).astype(np.float32))}
    noise = torch.from_numpy(rs.randn(1, 32, 3).astype(np.float32))
    runs = {}
    with chip_smoke.switches(name) if name else contextlib.nullcontext():
        calls = _spy_launches(monkeypatch)
        with torch.no_grad():
            model.eval()(noise, batch["image"])
        runs["forward"] = dict(calls)
        calls.clear()
        loss, _ = reconstruction.make_loss_fn(
            torch.Generator().manual_seed(0))(model.train(), batch)
        loss.backward()
        runs["step"] = dict(calls)
    forward = chip_smoke.PER_FORWARD_RECONSTRUCTOR
    step = chip_smoke.PER_STEP_RECONSTRUCTOR
    if name:
        forward, step = (chip_smoke.set_counts(name, per, training)
                         for per, training in ((forward, False),
                                               (step, True)))
        forward = {k: v for k, v in forward.items() if v}
        step = {k: v for k, v in step.items() if v}
    assert runs == {"forward": forward, "step": step}


@pytest.mark.parametrize("name", (None,) + chip_smoke.SETS)
def test_expected_launches_are_the_full_width_kpconv_segmenters(monkeypatch,
                                                                name):
    """The same for the KPConv protocol's segmenter (``s3dis_segmenter_pad``,
    the same trunk with the mask applied around the kernels), per forward
    (``PER_FORWARD_KPCONV``, which its vote validation runs) and per
    training step of the masked loss (``PER_STEP_KPCONV``), on the default
    path and under each set; counted on the CPU with one sphere of 32
    points, 20 of them valid."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
    model = get_model("s3dis_segmenter_pad")
    rs = np.random.RandomState(0)
    idx = np.concatenate([np.arange(20), rs.randint(0, 20, 12)])
    mask = np.zeros((1, 32), np.float32)
    mask[:, :20] = 1
    batch = {"points": torch.from_numpy(
                 rs.uniform(-1, 1, (1, 32, 3)).astype(np.float32)[:, idx]),
             "features": torch.from_numpy(
                 rs.uniform(-1, 1, (1, 32, 4)).astype(np.float32)[:, idx]),
             "mask": torch.from_numpy(mask),
             "label": torch.from_numpy(rs.randint(0, 13, (1, 32))[:, idx])}
    runs = {}
    with chip_smoke.switches(name) if name else contextlib.nullcontext():
        calls = _spy_launches(monkeypatch)
        with torch.no_grad():
            model.eval()(batch["points"], batch["mask"], batch["features"])
        runs["forward"] = dict(calls)
        calls.clear()
        loss, _ = segmentation_kpconv.make_loss_fn()(model.train(), batch)
        loss.backward()
        runs["step"] = dict(calls)
    forward = chip_smoke.PER_FORWARD_KPCONV
    step = chip_smoke.PER_STEP_KPCONV
    if name:
        forward, step = (chip_smoke.set_counts(name, per, training)
                         for per, training in ((forward, False),
                                               (step, True)))
        forward = {k: v for k, v in forward.items() if v}
        step = {k: v for k, v in step.items() if v}
    assert runs == {"forward": forward, "step": step}


_LAUNCH_TESTS = {
    "classifier": test_expected_launches_are_the_full_width_classifiers,
    "segmenter": test_expected_launches_are_the_full_width_segmenters,
    "reconstructor":
        test_expected_launches_are_the_full_width_reconstructors,
    "kpconv": test_expected_launches_are_the_full_width_kpconv_segmenters}


@pytest.mark.parametrize("model,name", [
    ("classifier", None), ("classifier", "set_a"), ("classifier", "set_b"),
    ("segmenter", None), ("reconstructor", None), ("kpconv", None)])
def test_bf16_launches_are_the_f32_ones(monkeypatch, model, name):
    """Under the bf16 operand policy (``model.mxu_dtype: bfloat16``) every
    kernel stays float32, so the bf16 paths of ``chip_smoke.py`` expect the
    launches of the float32 ones: the same counts as above, on the default
    path and, for the classifier, under each set."""
    from cloud_transformers_tpu_torch.nn import precision
    precision.set_default_mxu_dtype("bfloat16")
    try:
        _LAUNCH_TESTS[model](monkeypatch, name)
    finally:
        precision.set_default_mxu_dtype(None)


def test_points_axis_launches_per_rank(tmp_path):
    """Phase 17's launch counts on every rank of its data 2 x points 2 grid
    (``PTS_PER_STEP``: the full classifier's ``PER_STEP``, the one-stage
    segmenter's and the inpainter's one encoder and one decoder stage with
    the encoder's two pools) are each rank's kernel calls in a grid step
    of its three models at full width, counted here on the CPU over 4 gloo
    ranks with 16 points a cloud on a rank."""
    import _torch_parallel_ranks as ranks
    # the grid's BatchNorms take their statistics over the points group,
    # on the plain ops
    assert chip_smoke.PTS_PER_STEP["classifier"] == {
        k: v for k, v in chip_smoke.PER_STEP.items()
        if k not in chip_smoke.BN_WRAPPERS}
    outs = ranks.run_ranks(ranks.grid_launches, 4, tmp_path / "ranks",
                           tmp_path)
    for counts in outs:
        assert counts == chip_smoke.PTS_PER_STEP


def _remat_model_and_step(family, policy):
    """A full-width model of ``family`` under the remat ``policy`` (None:
    off) and a closure running its training step's forward and backward on
    a few points, as ``chip_smoke.remat_phase`` steps it."""
    from cloud_transformers_tpu_torch.core.noise import partial_postprocess
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
    rs = np.random.RandomState(0)
    if family == "completion":
        model = get_model("completion_inpainter",
                          remat_policy=policy or "off")
        parts, noise = partial_postprocess(
            torch.Generator().manual_seed(0), torch.from_numpy(
                rs.uniform(-1, 1, (2, 32, 3)).astype(np.float32)), 64)
        return model, lambda: model(noise, parts)[0].square().mean()
    keys = dict(remat=policy is not None, remat_policy=policy or "point_io")
    if family == "classifier":
        model = get_model("scanobject_classifier_scales", **keys)
        batch = {"pcd": torch.from_numpy(
                     rs.uniform(-1, 1, (2, 32, 3)).astype(np.float32)),
                 "label": torch.tensor([1, 2]), "mask": torch.ones(2, 32)}
        return model, lambda: classification.make_loss_fn(0.5)(model, batch)[0]
    model = get_model("s3dis_segmenter_pad", **keys)
    mask = np.zeros((1, 32), np.float32)
    mask[:, :20] = 1
    batch = {"points": torch.from_numpy(
                 rs.uniform(-1, 1, (1, 32, 3)).astype(np.float32)),
             "features": torch.from_numpy(
                 rs.uniform(-1, 1, (1, 32, 4)).astype(np.float32)),
             "mask": torch.from_numpy(mask),
             "label": torch.from_numpy(rs.randint(0, 13, (1, 32)))}
    return model, lambda: segmentation_kpconv.make_loss_fn()(model, batch)[0]


@pytest.mark.parametrize("family,policy", [
    ("classifier", "point_io"), ("classifier", "point_io_grids"),
    ("classifier", "full"), ("completion", "point_io"),
    ("kpconv", "point_io")])
def test_remat_runs_the_union_batch_norms_again(monkeypatch, family, policy):
    """Phase 14's remat runs expect ``remat_counts(policy, step,
    UNION_BNS)``: the full-width step's launches with remat off, and under
    a policy the head groups' kernel chains and the ``UNION_BNS``
    channel-last BatchNorms of the unions once more (statistics and apply,
    not the backward), for the scales classifier, the completion model and
    the KPConv segmenter; counted on the CPU with a few points."""
    calls = _spy_launches(monkeypatch)
    runs = {}
    for name in (None, policy):
        model, loss = _remat_model_and_step(family, name)
        calls.clear()
        loss_value = loss()
        loss_value.backward()
        runs[name] = dict(calls)
    assert runs[None]["bn_stats"] == runs[None]["bn_backward"] > \
        chip_smoke.UNION_BNS
    assert runs[policy] == chip_smoke.remat_counts(policy, runs[None],
                                                   chip_smoke.UNION_BNS)
