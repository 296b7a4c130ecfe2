"""Gradient balancing: scale the forward value, keep the backward gradient.

Counterpart of ``cloud_transformers_tpu/core/balance.py``: key coordinates
are rescaled from [-1, 1] to grid units in the forward pass while the
gradient keeps the magnitude of the normalized coordinates.
"""

import torch


class _Balance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        return x * scale

    @staticmethod
    def backward(ctx, g):
        # identity on x; scale gets no gradient
        return g, None


def balance_op(x, scale):
    """Forward ``x * scale``; backward passes the gradient through unscaled."""
    return _Balance.apply(x, scale)
