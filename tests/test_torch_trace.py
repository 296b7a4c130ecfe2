"""The port's tracer (``utils/trace.py``) and its spans and counters where
the work happens: off it records nothing; on, nested spans keep their
parents, threads and ``time_ns`` bounds; a tiny classifier's
``train_step`` is ``trainer.step`` made of its four phases in order;
``Trainer.fit``'s ``data_time`` and ``batch_time`` are the spans' sums; the
loader's spans and counter on both of its paths; the set-up spans.  CPU
only, no JAX."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from cloud_transformers_tpu_torch.data import DataLoader, ScanObjectNN
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.ops import cuda_build
from cloud_transformers_tpu_torch.tasks import classification
from cloud_transformers_tpu_torch.train.trainer import Trainer
from cloud_transformers_tpu_torch.utils import trace

PHASES = ("trainer.to_device", "trainer.forward", "trainer.backward",
          "trainer.update")
TINY = dict(model_dim=32, repeats=1,
            stage_plan=[[[4, 4], [2, 2], [16, 16], [2, 3]]],
            pool_heads=2, pool_feature_dims=[4, 4], pool_sizes=[4, 8],
            trunk_width=8, class_dim=32, mask_dim=16)


@pytest.fixture
def tracer():
    """The process's tracer, on and empty; off and empty afterwards."""
    trace.take()
    was = trace.enable(True)
    try:
        yield trace
    finally:
        trace.enable(was)
        trace.take()


def _named(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_off_records_nothing_but_spans_still_measure_themselves():
    trace.take()
    assert not trace.TRACER.on
    before = trace.seconds("t.off")
    with trace.span("t.off") as s:
        time.sleep(0.002)
    trace.count("t.counter", 3)
    snap = trace.take()
    assert snap["spans"] == [] and snap["counts"] == {}
    assert s.end - s.start >= 2e6
    assert trace.seconds("t.off") - before == pytest.approx(
        (s.end - s.start) * 1e-9)


def test_on_records_nested_spans_with_parents_threads_and_bounds(tracer):
    t0 = time.time_ns()
    with trace.span("t.outer"):
        with trace.span("t.inner"):
            trace.count("t.counter")
        with trace.span("t.second"):
            pass
        worker = threading.Thread(target=lambda: trace.span("t.worker")
                                  .__enter__().__exit__(None, None, None))
        worker.start()
        worker.join(10)
    t1 = time.time_ns()
    assert not worker.is_alive()
    trace.count("t.counter", 2)
    snap = trace.take()
    (outer,), (inner,), (second,), (other,) = (
        _named(snap, n) for n in ("t.outer", "t.inner", "t.second",
                                  "t.worker"))
    main = threading.get_ident()
    assert outer["parent"] is None
    assert inner["parent"] == second["parent"] == outer["id"]
    assert {outer["thread"], inner["thread"], second["thread"]} == {main}
    assert other["thread"] != main and other["parent"] is None
    assert t0 <= outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= second["start_ns"] <= second["end_ns"] <= outer["end_ns"] <= t1
    assert outer["start_ns"] <= other["start_ns"] <= other["end_ns"] \
        <= outer["end_ns"]
    assert snap["counts"] == {"t.counter": 3}
    assert set(snap["launches"]) >= {"splat_max", "slice_bwd", "top2"}
    json.dumps(snap)
    assert trace.take()["spans"] == []   # taken means cleared


def test_enable_returns_the_state_it_replaced():
    assert trace.enable(True) is False
    try:
        assert trace.enable(True) is True
    finally:
        assert trace.enable(False) is True


def _classifier_trainer(tmp_path):
    cfg = {"experiment": {"root": str(tmp_path / "exp"),
                          "writer_root": str(tmp_path / "runs")},
           "train": {"optimizer": {"type": "Adam", "lr": 1e-3},
                     "clip_grad_norm": 10.0, "grad_stats": True,
                     "show_each": 3, "save": False}}
    model = get_model("scanobject_classifier", **TINY)
    return Trainer(model, cfg, "run", classification.make_loss_fn(0.5),
                   device="cpu", seed=0)


def _batch(seed, b=2, p=128):
    rs = np.random.RandomState(seed)
    return {"pcd": rs.randn(b, p, 3).astype(np.float32),
            "label": rs.randint(0, 15, b).astype(np.int32),
            "mask": (rs.rand(b, p) > 0.5).astype(np.float32)}


def check_step_spans(snap, steps):
    """Each ``trainer.step`` is made of the four phases, once each, in
    order, none overlapping another."""
    by_id = {s["id"]: s for s in snap["spans"]}
    outer = _named(snap, "trainer.step")
    assert len(outer) == steps
    for step in outer:
        kids = sorted((s for s in snap["spans"]
                       if s["parent"] == step["id"]),
                      key=lambda s: s["start_ns"])
        assert tuple(s["name"] for s in kids) == PHASES
        last = step["start_ns"]
        for s in kids:
            assert last <= s["start_ns"] <= s["end_ns"] <= step["end_ns"]
            last = s["end_ns"]
        assert all(by_id[s["parent"]]["name"] == "trainer.step"
                   for s in kids)


def test_train_step_is_its_four_phases_in_order(tmp_path, tracer):
    trainer = _classifier_trainer(tmp_path)
    tracer.take()
    for k in range(2):
        assert torch.isfinite(trainer.train_step(_batch(k))["loss"])
    check_step_spans(tracer.take(), 2)


def test_a_phase_dropped_from_train_step_fails_the_check(tmp_path, tracer,
                                                         monkeypatch):
    trainer = _classifier_trainer(tmp_path)
    span = trace.span
    monkeypatch.setattr(trace, "span", lambda name: (
        contextlib.nullcontext() if name == "trainer.backward"
        else span(name)))
    tracer.take()
    trainer.train_step(_batch(0))
    with pytest.raises(AssertionError):
        check_step_spans(tracer.take(), 1)


class _Items:
    """Items of their index, slow enough that the loader's threads work."""

    def __init__(self, n=8):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(0.002)
        return {"x": np.full(3, i, np.float32)}


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_builds_on_its_threads_and_counts_ready_batches(tracer,
                                                               workers):
    loader = DataLoader(_Items(), 2, shuffle=False, num_workers=workers)
    tracer.take()
    got = []
    for batch in loader:
        got.append(batch["x"][:, 0].tolist())
        time.sleep(0.05)   # the loader's threads run ahead
    assert got == [[0, 1], [2, 3], [4, 5], [6, 7]]
    snap = tracer.take()
    main = threading.get_ident()
    builds = _named(snap, "loader.build")
    assert len(builds) == 4 and all(s["thread"] != main for s in builds)
    waits = _named(snap, "loader.next")
    # the queued path's last wait is for its end
    assert len(waits) == (5 if workers == 0 else 4)
    assert all(s["thread"] == main for s in waits)
    assert 1 <= snap["counts"]["loader.ready"] <= 4 * (2 + 2 * workers)


def test_fit_reads_data_time_and_batch_time_from_the_spans(tmp_path, tracer):
    trainer = _classifier_trainer(tmp_path)
    items = [_batch(k, b=1) for k in range(6)]

    class Set:
        def __len__(self):
            return len(items)

        def __getitem__(self, i):
            return {k: v[0] for k, v in items[i].items()}
    tracer.take()
    trainer.fit(DataLoader(Set(), 2, shuffle=False, num_workers=2),
                num_epochs=1)
    snap = tracer.take()
    path = tmp_path / "runs" / "run" / "metrics.jsonl"
    (line,) = [json.loads(x) for x in path.read_text().splitlines()]
    assert line["step"] == 3

    def mean(name):
        spans = _named(snap, name)
        assert len(spans) == 3
        return sum(s["end_ns"] - s["start_ns"] for s in spans) * 1e-9 / 3
    assert line["train/data_time"] == pytest.approx(mean("loader.next"),
                                                    rel=1e-9)
    assert line["train/batch_time"] == pytest.approx(mean("trainer.step"),
                                                     rel=1e-9)
    check_step_spans(snap, 3)


def test_set_up_spans_of_the_weights_and_the_data(tmp_path, tracer):
    from cloud_transformers_tpu_torch.data.s3dis_kpconv import S3DISSeg
    tracer.take()
    _classifier_trainer(tmp_path)
    ScanObjectNN(train=True, synthetic_items=4, num_points=64)
    S3DISSeg(num_points=64, num_steps=4, in_radius=0.5,
             subsampling_parameter=0.08, synthetic_clouds=1)
    snap = tracer.take()
    (weights,) = _named(snap, "setup.weights")
    data = _named(snap, "setup.data")
    assert len(data) == 2 and weights["end_ns"] > weights["start_ns"]
    (schedule,) = _named(snap, "data.schedule")
    assert schedule["parent"] == data[1]["id"]   # the first epoch's


def test_the_first_kernel_load_is_a_set_up_span(tracer, monkeypatch,
                                                tmp_path):
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)   # no sources
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    tracer.take()
    assert cuda_build.libraries() == {}
    snap = tracer.take()
    assert len(_named(snap, "setup.kernels")) == 1
    assert snap["counts"] == {"kernels.built": 0, "kernels.loaded": 0}
