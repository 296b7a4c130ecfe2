"""SO(3) exponential map (Rodrigues' formula).

Counterpart of ``cloud_transformers_tpu/core/so3.py``, same formula and the
same ``eps`` guard at theta -> 0.
"""

import torch


def hat(v):
    """``[..., 3]`` axis vectors -> ``[..., 3, 3]`` skew-symmetric matrices."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zeros], -1),
    ], -2)


def so3_exponential_map(log_rot, eps=1e-4):
    """``[..., 3]`` log-rotations -> ``[..., 3, 3]`` rotation matrices:
    R = I + sin(t)/t K + (1 - cos(t))/t^2 K^2, K = hat(log_rot),
    t = |log_rot| clamped below by ``eps``; K^2 = v v^T - t^2 I is formed
    without a matmul."""
    theta_sq = (log_rot * log_rot).sum(-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=eps * eps))
    k = hat(log_rot)
    outer = log_rot[..., :, None] * log_rot[..., None, :]
    a = (torch.sin(theta) / theta)[..., None, None]
    b = ((1.0 - torch.cos(theta)) / (theta * theta))[..., None, None]
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device)
    return (1.0 - b * (theta * theta)[..., None, None]) * eye + a * k \
        + b * outer
