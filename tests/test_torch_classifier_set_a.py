"""Port parity: the tiny classifier under set A of the execution switches,
``set_grid_conv_strategy("pallas")`` + ``FWD_WINNER = True``, on both sides.

The JAX package then runs ``pallas_grid_conv2d``/``_dm`` for the 2D head
group and the forward-tracked winner map with its routed backward, in
interpret mode on the CPU; the port the same paths' plain versions.  The
classifier of ``tests/test_torch_train_step.py`` (B=2, P=128, one block
with a 16^2 and a 16^3 head group) serves a forward in eval mode and takes
one training step, compared by the PARITY.md criteria as in
``tests/test_torch_classifier.py`` and ``tests/test_torch_train_step.py``;
the port's calls show which paths ran.  The fused block's set (set B) is in
``tests/test_torch_classifier_set_b.py``.
"""

import jax
import pytest

import cloud_transformers_tpu.nn.grouped_conv as jgc
from cloud_transformers_tpu.core import splat_slice as jss
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.nn import grouped_conv as tgcm
from test_torch_classifier_set_b import (
    check_serving_forward,
    check_training_step,
    count_calls,
    jax_classifier,
)


@pytest.fixture(scope="module")
def set_a():
    """Set A on both sides for this file's tests -> the JAX classifier.
    The JAX jit caches are cleared around it, since the switches are read
    when a function is traced."""
    old = jss.FWD_WINNER, tss.FWD_WINNER
    jgc.set_grid_conv_strategy("pallas")
    tgcm.set_grid_conv_strategy("pallas")
    jss.FWD_WINNER = tss.FWD_WINNER = True
    jax.clear_caches()
    try:
        yield jax_classifier()
    finally:
        jgc.set_grid_conv_strategy(None)
        tgcm.set_grid_conv_strategy(None)
        jss.FWD_WINNER, tss.FWD_WINNER = old
        jax.clear_caches()


@pytest.fixture
def calls(set_a, monkeypatch):
    return count_calls(monkeypatch)


def test_serving_forward_matches_jax(set_a, calls):
    check_serving_forward(*set_a)
    # eval under no_grad: the plain splat (no winner map); both convs take
    # the kernel branch
    assert calls == {"splat_max": 4, "slice_gather": 2, "grid_conv 2D": 1,
                     "grid_conv 3D": 1}


def test_training_step_matches_jax(set_a, calls):
    check_training_step(*set_a)
    assert calls == {"splat_max_winner": 4, "splat_route": 4,
                     "slice_gather": 2, "slice_bwd": 2, "grid_conv 2D": 1,
                     "grid_conv 3D": 1, "grid_conv_vjp 2D": 1,
                     "grid_conv_vjp 3D": 1}
