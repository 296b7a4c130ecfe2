"""The control at a tiny size on the CPU: the reference put in the
program's place with TF32 operands (the nearest precision below the
configurations' float32) reads well above the program on the numbers a
cell compares, and fails the cell's limits.  On the card the same readings
come, at each cell's own size, from ``ctbench/readings.py``."""

import pytest

from ctbench import run as R
from ctbench.tests._tiny import context

CELLS = ("cls_train_b32", "kpconv_train_b24")


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_the_program_and_fails(cell):
    ctx = context(cell)
    driver = R.load_module("drivers", ctx.traffic["driver"])
    program = driver.readings(ctx, "program")
    control = driver.readings(ctx, "control")
    limits = ctx.data["limits"]
    assert any(control[k] > limits[k] for k in limits), (control, limits)
    assert all(program[k] <= limits[k] for k in limits
               if k in ("loss1_gap", "grad_gap")), program
    first = ("loss1_gap", "grad_gap")
    assert all(control[k] >= 3 * program[k] for k in first), \
        (program, control)
