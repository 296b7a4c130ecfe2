"""Grouped 2D UNet with a global-feature bottleneck.

Counterpart of ``cloud_transformers_tpu/nn/unet2d.py``, channels-first
``[B, C, H, W]``.  ``group_cat`` interleaves the skip's and the upsampled
map's channels group by group, so that the grouped convs after it keep each
group's channels together.  The convolutions and the bottleneck's dense are
``MXUConv2d``/``MXULinear`` (``nn/precision.py``); the transposed conv of
``Up(bilinear=False)`` stays float32, as in the JAX package.  Each module
takes its input channels first, then the JAX module's fields.  Module names
follow the converter's rules for the JAX tree's auto-named layers
(``convert.py``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.nn.conv_blocks import (
    GroupedConvTranspose,
    max_pool_nd,
)
from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.nn.precision import MXUConv2d, MXULinear


def group_cat(x1, x2, groups):
    """Concatenate [B, C1, H, W] and [B, C2, H, W] group by group: group j
    of the result is group j of ``x1``, then group j of ``x2``."""
    b, c1, h, w = x1.shape
    c2 = x2.shape[1]
    r1 = x1.reshape(b, groups, c1 // groups, h, w)
    r2 = x2.reshape(b, groups, c2 // groups, h, w)
    return torch.cat([r1, r2], 2).reshape(b, c1 + c2, h, w)


class GroupCat(nn.Module):
    def __init__(self, groups):
        super().__init__()
        self.groups = groups

    def forward(self, x1, x2):
        return group_cat(x1, x2, self.groups)


class DoubleConv(nn.Module):
    """(conv3x3 with bias -> BN -> ReLU) x 2."""

    def __init__(self, in_channels, out_channels, groups):
        super().__init__()
        self.conv1 = MXUConv2d(in_channels, out_channels, 3, padding=1,
                               groups=groups)
        self.bn1 = BatchNorm(out_channels, dim=1)
        self.conv2 = MXUConv2d(out_channels, out_channels, 3, padding=1,
                               groups=groups)
        self.bn2 = BatchNorm(out_channels, dim=1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Down(nn.Module):
    """maxpool2 -> DoubleConv."""

    def __init__(self, in_channels, out_channels, groups):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, groups)

    def forward(self, x):
        return self.conv(max_pool_nd(x, 2))


class Up(nn.Module):
    """Upsample ``x1`` by 2 (bilinear, or a grouped transposed conv with
    bias) -> zero-pad it to the skip ``x2``'s size -> ``group_cat(x2, x1)``
    -> DoubleConv.  ``in_channels``: those of ``x1``; ``skip_channels``:
    those of ``x2``.

    The bilinear upsampling is ``jax.image.resize(..., "bilinear")`` at 2x:
    both sample at half-pixel centres, and at the border both take the edge
    pixel alone (PyTorch clamps the source coordinate, JAX renormalizes the
    weights that fall inside)."""

    def __init__(self, in_channels, skip_channels, out_channels, groups,
                 bilinear=True):
        super().__init__()
        self.groups = groups
        self.up = None if bilinear else GroupedConvTranspose(
            in_channels, in_channels, 2, 2, groups, use_bias=True, dim=2)
        self.conv = DoubleConv(in_channels + skip_channels, out_channels,
                               groups)

    def forward(self, x1, x2):
        if self.up is None:
            x1 = F.interpolate(x1, scale_factor=2, mode="bilinear",
                               align_corners=False)
        else:
            x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(group_cat(x2, x1, self.groups))


class OutConv(nn.Module):
    """1x1 conv with bias -> BN."""

    def __init__(self, in_channels, out_channels, groups):
        super().__init__()
        self.conv = MXUConv2d(in_channels, out_channels, 1, groups=groups)
        self.bn = BatchNorm(out_channels, dim=1)

    def forward(self, x):
        return self.bn(self.conv(x))


class UNet(nn.Module):
    """Grouped UNet: ``[B, in_channels, H, W]`` (sides divisible by 16) ->
    ``[B, n_out * groups, H, W]``.  The bottleneck adds a dense map of the
    spatially averaged deepest features to them, then a leaky ReLU
    (slope 0.01)."""

    def __init__(self, in_channels, n_out, groups, bilinear=True):
        super().__init__()
        g = groups
        self.inc = DoubleConv(in_channels, 16 * g, g)
        self.downs = nn.ModuleList([
            Down(16 * g, 32 * g, g), Down(32 * g, 64 * g, g),
            Down(64 * g, 64 * g, g), Down(64 * g, 64 * g, g)])
        self.dense = MXULinear(64 * g, 64 * g)
        self.ups = nn.ModuleList([
            Up(64 * g, 64 * g, 64 * g, g, bilinear),
            Up(64 * g, 64 * g, 64 * g, g, bilinear),
            Up(64 * g, 32 * g, 32 * g, g, bilinear),
            Up(32 * g, 16 * g, 16 * g, g, bilinear)])
        self.outc = OutConv(16 * g, n_out * g, g)

    def forward(self, x):
        skips = [self.inc(x)]
        for down in self.downs:
            skips.append(down(skips[-1]))
        x = skips.pop()
        glob = self.dense(x.mean((2, 3)))
        x = F.leaky_relu(x + glob[:, :, None, None], negative_slope=0.01)
        for up in self.ups:
            x = up(x, skips.pop())
        return self.outc(x)
