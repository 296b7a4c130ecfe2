"""Grouped dense-grid convolution blocks (2D and 3D): the classifier trunks'
residual blocks and the V2V hourglass.

Counterpart of ``cloud_transformers_tpu/nn/conv_blocks.py``.  The JAX
blocks are channel-last; these take PyTorch's channels-first
``[B, C, *spatial]``, so the trunks run cuDNN convolutions without layout
copies.  Each block takes its input channels first (PyTorch needs them to
build its layers), then the JAX block's fields.  The convolutions are
``MXUConv*d`` (``nn/precision.py``) except the transposed conv, which the
JAX package runs in float32 whatever the policy.  Module names follow the
converter's rules for the JAX tree's auto-named layers (``convert.py``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.nn.precision import mxu_conv


def _conv(dim, cin, cout, k, groups):
    return mxu_conv(dim)(cin, cout, k, padding=(k - 1) // 2, groups=groups,
                         bias=False)


class GroupedConvTranspose(nn.Module):
    """Transposed conv with feature groups, ``k == stride`` (exact
    upsampling by ``stride``).

    The JAX package runs it as a conv over the input dilated by ``stride``
    with ``k - 1`` zeros of padding, kernel ``[*k, in/groups, out]``.
    ``weight`` keeps that kernel in the port's conv layout ``[out,
    in/groups, *k]``, so the converter's conv rule holds; the forward runs
    ``F.conv_transpose{2,3}d`` with the kernel flipped on every spatial
    axis and its in/out axes swapped within each group, which gives the
    same values without the dilated copy."""

    def __init__(self, in_channels, features, kernel_size=2, stride=2,
                 groups=1, use_bias=False, dim=3):
        super().__init__()
        if kernel_size != stride:
            raise ValueError("only the exact-upsampling k == stride case is "
                             "supported")
        self.stride, self.groups, self.dim = stride, groups, dim
        self.weight = nn.Parameter(torch.zeros(
            (features, in_channels // groups) + (kernel_size,) * dim))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def transposed_weight(self):
        """``weight`` as ``F.conv_transpose*d`` takes it:
        ``[in, out/groups, *k]``."""
        out, ci = self.weight.shape[:2]
        k = self.weight.shape[2:]
        w = self.weight.flip(tuple(range(2, 2 + self.dim)))
        w = w.reshape((self.groups, out // self.groups, ci) + k)
        return w.transpose(1, 2).reshape((self.groups * ci,
                                          out // self.groups) + k)

    def forward(self, x):
        conv = F.conv_transpose2d if self.dim == 2 else F.conv_transpose3d
        return conv(x, self.transposed_weight(), self.bias,
                    stride=self.stride, groups=self.groups)


class BasicBlock(nn.Module):
    """Conv(k) -> BN -> ReLU."""

    def __init__(self, in_planes, out_planes, kernel_size=3, groups=1,
                 dim=3):
        super().__init__()
        self.conv = _conv(dim, in_planes, out_planes, kernel_size, groups)
        self.bn = BatchNorm(out_planes, dim=1)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ResBlock(nn.Module):
    """[conv3-BN-ReLU-conv3-BN] + skip (1x1 conv-BN if channels change),
    ReLU."""

    def __init__(self, in_planes, out_planes, groups=1, dim=3):
        super().__init__()
        self.conv1 = _conv(dim, in_planes, out_planes, 3, groups)
        self.bn1 = BatchNorm(out_planes, dim=1)
        self.conv2 = _conv(dim, out_planes, out_planes, 3, groups)
        self.bn2 = BatchNorm(out_planes, dim=1)
        if in_planes != out_planes:
            self.skip_conv = _conv(dim, in_planes, out_planes, 1, groups)
            self.skip_bn = BatchNorm(out_planes, dim=1)
        else:
            self.skip_conv = self.skip_bn = None

    def forward(self, x):
        res = F.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        skip = x if self.skip_conv is None else self.skip_bn(self.skip_conv(x))
        return F.relu(res + skip)


def max_pool_nd(x, window):
    """Non-overlapping max pool over all spatial dims of [B, C, *spatial]."""
    pool = F.max_pool2d if x.dim() == 4 else F.max_pool3d
    return pool(x, window)


class UpsampleBlock(nn.Module):
    """ConvTranspose(k=2, s=2) -> BN -> ReLU."""

    def __init__(self, in_planes, out_planes, groups=1, dim=3):
        super().__init__()
        self.conv = GroupedConvTranspose(in_planes, out_planes, 2, 2, groups,
                                         use_bias=False, dim=dim)
        self.bn = BatchNorm(out_planes, dim=1)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


# --- 2D / 3D aliases with the reference's names ---

class Basic3DBlock(BasicBlock):
    def __init__(self, in_planes, out_planes, kernel_size=3, groups=1):
        super().__init__(in_planes, out_planes, kernel_size, groups, dim=3)


class Basic2DBlock(BasicBlock):
    def __init__(self, in_planes, out_planes, kernel_size=3, groups=1):
        super().__init__(in_planes, out_planes, kernel_size, groups, dim=2)


class Res3DBlock(ResBlock):
    def __init__(self, in_planes, out_planes, groups=1):
        super().__init__(in_planes, out_planes, groups, dim=3)


class Res2DBlock(ResBlock):
    def __init__(self, in_planes, out_planes, groups=1):
        super().__init__(in_planes, out_planes, groups, dim=2)


class Pool3DBlock(nn.Module):
    def __init__(self, pool_size=2):
        super().__init__()
        self.pool_size = pool_size

    def forward(self, x):
        return max_pool_nd(x, self.pool_size)


class Upsample3DBlock(UpsampleBlock):
    def __init__(self, in_planes, out_planes, groups=1):
        super().__init__(in_planes, out_planes, groups, dim=3)


# The V2V encoder in call order: a ResBlock's (in, out) widths in units of
# 32 * groups and "skip" where its output is kept for the way up while its
# input goes on; None is a max pool.  The decoder: each ResBlock's (in, out)
# and the width of the upsample after it, which adds the last kept skip.
_V2V_ENCODER = ((1, 1, ""), (1, 1, ""), (1, 1, ""),
                (1, 1, "skip"), None, (1, 1, ""), (1, 1, "skip"), None,
                (1, 2, ""), (2, 2, "skip"), None, (2, 4, ""), (4, 4, "skip"),
                None, (4, 4, ""), (4, 4, ""))
_V2V_DECODER = (((4, 4), 4), ((4, 4), 2), ((2, 2), 1), ((1, 1), 1))


class V2VModel(nn.Module):
    """The V2V-PoseNet hourglass: a front res stack, a 4-level pool/upsample
    encoder-decoder with res-block skips, a back res stack and a grouped 1x1
    output conv with bias.  ``[B, input_channels, X, Y, Z]`` (sides
    divisible by 16) -> ``[B, output_channels * groups, X, Y, Z]``.  The
    last decoder ResBlock has groups=1, as in the reference."""

    def __init__(self, input_channels, output_channels, groups=1):
        super().__init__()
        g, w = groups, 32 * groups
        self.basic = BasicBlock(input_channels, w, 3, g, 3)
        res, ups = [], []
        for step in _V2V_ENCODER:
            if step is not None:
                res.append(ResBlock(step[0] * w, step[1] * w, g, 3))
        for i, ((cin, cout), up) in enumerate(_V2V_DECODER):
            res.append(ResBlock(cin * w, cout * w, 1 if i == 3 else g, 3))
            ups.append(UpsampleBlock(cout * w, up * w, g, 3))
        for _ in range(3):
            res.append(ResBlock(w, w, g, 3))
        self.res_blocks = nn.ModuleList(res)
        self.upsample_blocks = nn.ModuleList(ups)
        self.out_conv = mxu_conv(3)(w, output_channels * g, 1, groups=g,
                                    bias=True)

    def forward(self, x):
        x = self.basic(x)
        res = iter(self.res_blocks)
        skips = []
        for step in _V2V_ENCODER:
            if step is None:
                x = max_pool_nd(x, 2)
            elif step[2] == "skip":
                skips.append(next(res)(x))
            else:
                x = next(res)(x)
        for up in self.upsample_blocks:
            x = up(next(res)(x)) + skips.pop()
        for block in res:
            x = block(x)
        return self.out_conv(x)
