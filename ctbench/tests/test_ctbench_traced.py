"""``ctbench/traced.py`` and ``core/program.py`` on the CPU: a tiny traced
run of each cell with the port's tracer on reports the program's numbers,
with it off none; and ``core/profile.py``'s ``reduce`` on synthetic device
events, where the program's spans on the stepping thread split the idle
time the benchmark's spans named, leave its sum and bounds as they were, and a
worker's span names no gap."""

import argparse

import pytest
import torch

from ctbench import traced
from ctbench.core import profile, program
from ctbench.tests._tiny import SEED, cell

TRAIN_CELLS = ("cls_train_b32", "kpconv_train_b24")
WINDOW = ("step_h2d_ms.train", "step_forward_ms.train",
          "step_backward_ms.train", "step_update_ms.train",
          "loader_build_ms.train", "loader_ready.train")


def _execute(name, tracer):
    bench, c, config, traffic, data = cell(name)
    args = argparse.Namespace(workload=name, seed=SEED, seconds=2.0,
                              tracer=tracer)
    return traced.execute(args, bench, c, config, traffic, data, "cpu",
                          "cpu")


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_traced_run_reports_the_programs_numbers(name):
    line = _execute(name, "on")
    assert line["correct"] and line["tracer"] == "on"
    got = line["program"]
    # no kernel is built or loaded on the CPU
    assert set(got) >= set(WINDOW) | {"setup_weights_s", "setup_data_s"}
    assert "setup_kernels_s" not in got
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    phases = sum(got[k] for k in WINDOW[:4])
    enqueue = metrics["step_enqueue_ms.train"]
    assert abs(phases - enqueue) <= 0.05 * enqueue, (phases, enqueue)
    assert 0 <= got["step_self_ms.train"] <= 0.05 * enqueue
    assert got["setup_weights_s"] + got["setup_data_s"] <= \
        metrics["setup_s"]
    assert got["loader_ready.train"] >= 0 and got["loader_build_ms.train"] > 0
    assert metrics["train_samples_per_s"] > 0


def test_with_the_tracer_off_it_reports_none_of_them():
    line = _execute("cls_train_b32", "off")
    assert line["correct"] and line["program"] == {}
    assert "train_samples_per_s" in line["metrics"]


class _Event:
    def __init__(self, start, end, name="kernel"):
        self.s, self.e, self.n = start, end, name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def name(self):
        return self.n


BENCH = [(0, 10, "loader_wait"), (10, 100, "train_step"),
          (100, 120, "synchronize")]
MAIN, WORKER = 1, 2
PROGRAM = {"counts": {}, "spans": [
    {"name": n, "start_ns": s, "end_ns": e, "thread": t, "id": i,
     "parent": None}
    for i, (s, e, n, t) in enumerate([
        (1, 9, "loader.next", MAIN), (11, 99, "trainer.step", MAIN),
        (12, 20, "trainer.to_device", MAIN), (20, 50, "trainer.forward", MAIN),
        (50, 80, "trainer.backward", MAIN), (80, 98, "trainer.update", MAIN),
        (0, 120, "loader.build", WORKER), (0, 130, "trainer.step", MAIN)])]}
EVENTS = [_Event(15, 18), _Event(30, 45), _Event(60, 70), _Event(85, 95),
          _Event(105, 110)]


def test_program_spans_split_the_idle_time_and_leave_its_sum():
    mine = program.thread_spans(PROGRAM, MAIN, 0, 120)
    # the worker's span and a span past the stretch are left out
    assert [n for _, _, n in mine] == [
        "loader.next", "trainer.step", "trainer.to_device",
        "trainer.forward", "trainer.backward", "trainer.update"]
    before = profile.reduce(EVENTS, BENCH)
    after = profile.reduce(EVENTS, BENCH + mine)
    assert before["gaps"] == pytest.approx(
        {"loader_wait": 15e-9, "train_step": 52e-9, "synchronize": 10e-9})
    assert after["gaps"] == pytest.approx(
        {"loader_wait": 15e-9, "trainer.to_device": 12e-9,
         "trainer.forward": 15e-9, "trainer.backward": 15e-9,
         "trainer.update": 10e-9, "synchronize": 10e-9})
    assert sum(after["gaps"].values()) == pytest.approx(
        sum(before["gaps"].values()))
    assert (after["window_s"], after["busy_s"]) == (before["window_s"],
                                                    before["busy_s"])
    assert program.under(after["gaps"], "trainer.") == 1.0
    assert program.clock_margins(EVENTS, BENCH, mine) == pytest.approx(
        {"first_us": 14e-3, "last_us": 10e-3})
