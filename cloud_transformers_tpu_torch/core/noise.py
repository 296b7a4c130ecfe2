"""Sphere noise and the completion input's preprocessing.

Counterpart of ``cloud_transformers_tpu/core/noise.py``.  A zero-padded
partial cloud ``[B, P, 3]`` becomes

* ``parts [B, P, 3]``: the partial cloud with every invalid (all-zero) row
  replaced by a valid point drawn with replacement, and
* ``labeled_noise [B, gt_size, 4]``: slot i < P keeps the partial cloud's
  point i where it is valid, every other slot is sphere noise; the fourth
  channel is the is-a-real-point label.

``jax.random`` and ``torch.Generator`` give different numbers from one seed,
so the function is split: ``partial_postprocess_from_draws`` takes the noise
and the resampling draws as arguments and computes the rest, and
``partial_postprocess`` draws them from an explicit generator.
"""

import math

import torch


def sphere_from_uniforms(u_theta, u_phi):
    """Points on the unit sphere ``[..., 3]`` from two uniforms in [0, 1):
    theta = 2 pi u_theta, cos(phi) = 1 - 2 u_phi."""
    theta = 2.0 * math.pi * u_theta
    cos_phi = 1.0 - 2.0 * u_phi
    sin_phi = torch.sqrt((1.0 - cos_phi * cos_phi).clamp_min(0.0))
    return torch.stack([sin_phi * torch.cos(theta),
                        sin_phi * torch.sin(theta), cos_phi], -1)


def sphere_noise(generator, batch, num_pts, device=None,
                 dtype=torch.float32):
    """Uniform samples on the unit sphere, ``[B, N, 3]``, drawn on the
    generator's device and moved to ``device``."""
    u = torch.rand(2, batch, num_pts, generator=generator, dtype=dtype,
                   device=generator.device)
    return sphere_from_uniforms(u[0], u[1]).to(device or generator.device)


def partial_postprocess_from_draws(partial_pcd, noise, draw):
    """The deterministic half: ``noise [B, gt_size, 3]`` fills the slots
    that hold no real point, ``draw [B, P]`` (int64, each a valid row's
    index) names the point an invalid row is replaced by.
    -> (parts [B, P, 3], labeled_noise [B, gt_size, 4])."""
    b, p, _ = partial_pcd.shape
    gt_size = noise.shape[1]
    valid = ~(partial_pcd == 0.0).all(-1)                        # [B, P]
    pad = gt_size - p
    padded = torch.nn.functional.pad(partial_pcd, (0, 0, 0, pad))
    valid_full = torch.nn.functional.pad(valid, (0, pad))
    xyz = torch.where(valid_full[..., None], padded, noise)
    labeled_noise = torch.cat(
        [xyz, valid_full[..., None].to(partial_pcd.dtype)], -1)
    resampled = torch.gather(partial_pcd, 1, draw[..., None].expand(-1, -1, 3))
    parts = torch.where(valid[..., None], partial_pcd, resampled)
    return parts, labeled_noise


def partial_postprocess(generator, partial_pcd, gt_size):
    """Prepare completion inputs from a zero-padded partial cloud: draws
    the sphere noise and, for every row, ``P`` valid points with replacement
    (``torch.multinomial`` over the valid rows), then
    ``partial_postprocess_from_draws``.  A cloud without any valid point
    draws from all its rows."""
    b, p, _ = partial_pcd.shape
    dev = partial_pcd.device
    noise = sphere_noise(generator, b, gt_size, dev, partial_pcd.dtype)
    valid = ~(partial_pcd == 0.0).all(-1)
    weights = valid.to(torch.float32)
    weights = torch.where(valid.any(1, keepdim=True), weights,
                          torch.ones_like(weights))
    draw = torch.multinomial(weights.to(generator.device), p,
                             replacement=True, generator=generator).to(dev)
    return partial_postprocess_from_draws(partial_pcd, noise, draw)
