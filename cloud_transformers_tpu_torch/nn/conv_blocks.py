"""Grouped dense-grid residual blocks (2D and 3D) of the classifier trunks.

Counterpart of ``ResBlock``/``max_pool_nd`` in
``cloud_transformers_tpu/nn/conv_blocks.py``.  The JAX blocks are
channel-last; these take PyTorch's channels-first ``[B, C, *spatial]``,
so the trunks run cuDNN convolutions without layout copies.
"""

import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.nn.norm import BatchNorm


def _conv(dim, cin, cout, k, groups):
    conv = nn.Conv2d if dim == 2 else nn.Conv3d
    return conv(cin, cout, k, padding=(k - 1) // 2, groups=groups,
                bias=False)


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
