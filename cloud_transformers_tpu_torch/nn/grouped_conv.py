"""Grouped 3^dim 'same' conv of the MHCT grids, and the execution switches
of the MHCT block.

Counterpart of ``GridConvK``, ``FusedSplatConvSlice`` and the two switches
of ``cloud_transformers_tpu/nn/grouped_conv.py``, with the same names and
defaults:

- ``set_grid_conv_strategy`` / ``CT_GRID_CONV``: ``"pallas"`` sends every
  grid to the hand-written kernels (``ops/pallas_grid_conv.py``), ``"xla"``
  every grid to PyTorch's grouped ``F.conv2d``/``F.conv3d`` (the port's
  counterpart of XLA's conv), ``"auto"`` (the default) 3D grids with
  X >= 16 (32^3 and 16^3 in the classifier) to the kernels and the rest to
  the library, as the JAX package's ``_pallas_wins``.
- ``set_block_fusion`` / ``CT_BLOCK_FUSION``: ``"fused"`` runs the whole
  splat -> conv -> slice block as one kernel (``GridConvK.fused``);
  ``"ops"`` runs the three separately; ``"auto"`` (the default) is
  ``"ops"``, the JAX package's measured choice.

The switches are process-wide, as in the JAX package; ``None`` hands the
choice back to the environment variable, then to ``"auto"``.

The library branch follows the operand policy (``nn/precision.py``): under
bf16 it convolves the cast grid and weight without the bias, casts to
float32 and adds the bias, as the JAX package's ``"xla"`` branch does.  The
kernel branch and the fused block take float32 whatever the policy, as the
JAX package's Pallas kernels do.  ``GroupedConv`` is the JAX package's
public grouped conv under the policy: a grouped ``F.conv{2,3}d`` (the JAX
package's block-diagonal expansion of small groups is a TPU layout choice
with the same values).

The kernel branch is a ``torch.autograd.Function`` (the counterpart of
``_grid_conv``'s ``custom_vjp``), for 2D and 3D alike: the input gradient is
the forward kernel on the cotangent with the transposed weights and a zero
bias, the weight gradient is the weight-gradient kernel, and the bias
gradient a plain sum of the cotangent (``grid_conv_vjp``).  The library
branch's backward is PyTorch's own.
"""

import os

import torch
from torch import nn

from cloud_transformers_tpu_torch.core.splat_slice import fused_block_mk
from cloud_transformers_tpu_torch.nn.precision import policy_conv
from cloud_transformers_tpu_torch.ops.pallas_grid_conv import (
    grid_conv,
    grid_conv_vjp,
)

_GRID_CONV_STRATEGY = None
_BLOCK_FUSION = None


def set_grid_conv_strategy(name):
    """Force GridConvK's execution ('pallas'/'xla'/'auto'/None)."""
    global _GRID_CONV_STRATEGY
    _GRID_CONV_STRATEGY = name


def _grid_conv_strategy():
    return (_GRID_CONV_STRATEGY
            or os.environ.get("CT_GRID_CONV", None) or "auto")


def set_block_fusion(name):
    """Force the MHCT block execution ('fused'/'ops'/'auto'/None)."""
    global _BLOCK_FUSION
    _BLOCK_FUSION = name


def block_fusion_strategy(sizes):
    """'fused' or 'ops' for a block on grids of ``sizes``; 'auto' is 'ops'
    for every size, as in the JAX package."""
    mode = _BLOCK_FUSION or os.environ.get("CT_BLOCK_FUSION", None) or "auto"
    return "ops" if mode == "auto" else mode


def kernel_wins(sizes):
    """Grids that ``"auto"`` sends to the kernels (the JAX package's
    dispatch)."""
    return len(sizes) == 3 and sizes[0] >= 16


class GroupedConv(nn.Module):
    """Grouped conv under the operand policy: ``[B, in_channels,
    *spatial]`` -> ``[B, features, *spatial]``, ``weight [features,
    in_channels / groups, *kernel_size]``, ``bias [features]`` where
    ``use_bias``; ``padding`` an int (the same on every side)."""

    def __init__(self, in_channels, features, kernel_size, groups=1,
                 padding=0, use_bias=True):
        super().__init__()
        self.groups, self.padding = groups, padding
        self.weight = nn.Parameter(torch.zeros(
            (features, in_channels // groups) + tuple(kernel_size)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x):
        return policy_conv(x, self.weight, self.bias, padding=self.padding,
                           groups=self.groups)


class _GridConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gk, weight, bias, sizes, heads):
        ctx.save_for_backward(gk, weight)
        ctx.sizes, ctx.heads = sizes, heads
        return grid_conv(gk, weight, bias, sizes, heads)

    @staticmethod
    def backward(ctx, g):
        gk, weight = ctx.saved_tensors
        return grid_conv_vjp(gk, weight, g, ctx.sizes, ctx.heads) + (
            None, None)


class GridConvK(nn.Module):
    """Grouped 'same' conv + bias on flat grids [R = B*H, G, F].

    ``weight`` [H*F, F, 3, 3(, 3)] (PyTorch's grouped layout, groups = H),
    ``bias`` [H*F]; row r of the grid belongs to head r % H.  ``fused``
    runs the same parameters in the fused block, so the ``state_dict`` is
    the same under either block strategy."""

    def __init__(self, feat, heads, sizes):
        super().__init__()
        self.feat, self.heads, self.sizes = feat, heads, tuple(sizes)
        dim = len(sizes)
        self.weight = nn.Parameter(
            torch.zeros((heads * feat, feat) + (3,) * dim))
        self.bias = nn.Parameter(torch.zeros(heads * feat))

    def forward(self, gk):
        strategy = _grid_conv_strategy()
        if strategy == "auto":
            strategy = "pallas" if kernel_wins(self.sizes) else "xla"
        if strategy == "pallas":
            return _GridConv.apply(gk, self.weight, self.bias, self.sizes,
                                   self.heads)
        if strategy != "xla":
            raise ValueError(f"unknown grid conv strategy {strategy!r}")
        h, f = self.heads, self.feat
        b = gk.shape[0] // h
        x = gk.reshape((b, h) + self.sizes + (f,))
        x = x.movedim(-1, 2).reshape((b, h * f) + self.sizes)
        out = policy_conv(x, self.weight, self.bias, padding=1, groups=h)
        out = out.reshape((b, h, f) + self.sizes).movedim(2, -1)
        return out.reshape(b * h, -1, f)

    def fused(self, mapping, values, pts_mask=None):
        """The counterpart of the JAX package's ``FusedSplatConvSlice``:
        splat -> this conv -> slice as one kernel.  values [B, P, H*F] ->
        (out [B, P, H*F], the splatted grid [B*H, G, F] for the stats)."""
        return fused_block_mk(mapping, values, self.weight, self.bias,
                              self.sizes, self.feat, self.heads,
                              pts_mask=pts_mask)
