"""Whole runs of tiny cells on the CPU, past the harness's look for a card:
a sound run, and the timed path broken underneath (a step that leaves the
state unchanged, running statistics left unchanged, half of the batch
left out),
which has to come out as not correct.  And the command itself on a machine
without a card, and in a directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ctbench.tests._tiny import execute

ROOT = Path(__file__).resolve().parents[2]
TRAIN_CELLS = ("cls_train_b32", "kpconv_train_b24")


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_sound_training_run(cell):
    line = execute(cell, trace=1)
    assert line["correct"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    r = line["readings"]
    assert r["loss1_gap"] < 1e-5 and r["grad_gap"] < 1e-2
    assert set(line["metrics"]) >= {"loader_wait_ms.train",
                                    "step_enqueue_ms.train"}
    json.dumps(line)


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from cloud_transformers_tpu_torch.train import optim
    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)
    line = execute("cls_train_b32")
    assert not line["correct"]
    assert line["readings"]["change_gap"] > 0.99


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_running_statistics_left_unchanged_are_not_correct(monkeypatch,
                                                           cell):
    from cloud_transformers_tpu_torch.train.trainer import Trainer
    train_step = Trainer.train_step

    def frozen(self, batch):
        kept = {k: v.clone() for k, v in self.model.named_buffers()}
        out = train_step(self, batch)
        for k, v in self.model.named_buffers():
            v.copy_(kept[k])
        return out
    monkeypatch.setattr(Trainer, "train_step", frozen)
    line = execute(cell)
    assert not line["correct"]
    assert line["checks"]["stats_median_gap"]["value"] > 0.99
    assert line["checks"]["grad_gap"]["value"] < \
        line["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_of_the_batch_left_out_is_not_correct(monkeypatch, cell):
    from cloud_transformers_tpu_torch.train.trainer import Trainer
    to_device = Trainer.to_device

    def half(self, batch):
        b = len(next(iter(batch.values())))
        return to_device(self, {k: v[:b // 2] for k, v in batch.items()})
    monkeypatch.setattr(Trainer, "to_device", half)
    line = execute(cell)
    assert not line["correct"]


def _command(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "ctbench/run.py", "--workload", "cls_train_b32",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = _command(ROOT)
    assert done.returncode != 0 and '"correct"' not in done.stdout


def test_alone_in_a_directory_it_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ctbench", tmp_path / "ctbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _command(tmp_path)
    assert done.returncode != 0 and '"correct"' not in done.stdout

