"""Numeric policy of the port: float32 parameters and activations, with an
optional low-precision operand dtype for the large contractions.

Counterpart of ``cloud_transformers_tpu/nn/precision.py``.  Parameters,
BatchNorm statistics, the frames, the losses and every hand-written kernel
stay float32.  The dense contractions (the 1x1 point projections, the heads,
the Res trunks' and the ResNet-50's convolutions, the library branch of the
MHCT grid conv) run through ``MXULinear``/``MXUConv{1,2,3}d``: under the
policy dtype (``set_default_mxu_dtype("bfloat16")``; the CLIs read
``model.mxu_dtype`` from the YAML config) their input and weight are cast
to it, the contraction accumulates in float32, its result is cast to float32
and the float32 bias is added after the cast, as the JAX package's
``MXUDense``/``MXUConv`` do.  Off (the default) they are exactly
``nn.Linear``/``nn.Conv*d``, whose parameter names they keep, so checkpoints
and ``convert.py`` are the same under either setting.

The JAX package reads the policy when it traces a model; the port reads it
at every call, so a model built before the policy was set follows it.

On the card PyTorch runs float32 convolutions in TF32 unless told otherwise,
which keeps only about three decimal digits, so ``strict_f32`` turns TF32
off for both matmuls and cuDNN convolutions, and keeps cuBLAS's bf16
reductions in float32 (as the TPU's MXU accumulates bf16 products).
``torch.autocast`` is not used: it keeps a contraction's output in the low
dtype, so the BatchNorms and the kernels after it would receive bf16.
"""

import torch
import torch.nn.functional as F
from torch import nn

_DEFAULT = [None]   # None: plain float32 compute

_NAMES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "half": torch.float16}
_F32_NAMES = ("float32", "f32", "none")


def strict_f32():
    """Run float32 matmuls and convolutions in full float32 (no TF32), and
    accumulate bf16 matmuls in float32.  Sets PyTorch's process-wide
    backend flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return None if dtype == torch.float32 else dtype
    if dtype in _F32_NAMES:
        return None
    if dtype in _NAMES:
        return _NAMES[dtype]
    raise TypeError(f"data type {dtype!r} not understood")


def set_default_mxu_dtype(dtype):
    """Set the policy: None, ``"float32"``, ``"f32"`` or ``"none"``: float32;
    ``"bfloat16"`` or ``torch.bfloat16``: bf16 operands; ``"float16"``:
    fp16 operands.  Another name raises, as ``jnp.dtype`` does."""
    _DEFAULT[0] = _dtype(dtype)


def resolve(dtype=None):
    """``dtype`` if given, else the policy's operand dtype (None: float32)."""
    return _dtype(dtype) if dtype is not None else _DEFAULT[0]


def cast_operands(dtype, *tensors):
    """Cast contraction operands to ``dtype`` (a no-op for None)."""
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) for t in tensors)


def _biased(y, bias, shape):
    """The low-dtype result back in float32, plus the float32 bias."""
    y = y.float()
    return y if bias is None else y + bias.reshape(shape)


def policy_conv(x, weight, bias=None, **kwargs):
    """``F.conv{1,2,3}d(x, weight, bias, **kwargs)`` at the policy dtype:
    the bias-free conv of the cast operands, then float32 and the bias."""
    conv = (F.conv1d, F.conv2d, F.conv3d)[x.dim() - 3]
    dt = resolve()
    if dt is None:
        return conv(x, weight, bias, **kwargs)
    xq, wq = cast_operands(dt, x, weight)
    return _biased(conv(xq, wq, None, **kwargs), bias,
                   (-1,) + (1,) * (x.dim() - 2))


class MXULinear(nn.Linear):
    """``nn.Linear`` whose contraction runs at the policy dtype."""

    def forward(self, x):
        dt = resolve()
        if dt is None:
            return super().forward(x)
        xq, wq = cast_operands(dt, x, self.weight)
        return _biased(F.linear(xq, wq), self.bias, (-1,))


class _MXUConv:
    """``policy_conv`` with the module's parameters and settings (zero
    padding only)."""

    def forward(self, x):
        return policy_conv(x, self.weight, self.bias, stride=self.stride,
                           padding=self.padding, dilation=self.dilation,
                           groups=self.groups)


class MXUConv1d(_MXUConv, nn.Conv1d):
    """``nn.Conv1d`` whose contraction runs at the policy dtype."""


class MXUConv2d(_MXUConv, nn.Conv2d):
    """``nn.Conv2d`` whose contraction runs at the policy dtype."""


class MXUConv3d(_MXUConv, nn.Conv3d):
    """``nn.Conv3d`` whose contraction runs at the policy dtype."""


MXU_MODULES = (MXULinear, MXUConv1d, MXUConv2d, MXUConv3d)


def mxu_conv(dim):
    """The ``MXUConv`` class of ``dim`` spatial dimensions."""
    return {1: MXUConv1d, 2: MXUConv2d, 3: MXUConv3d}[dim]
