"""Numpy point-cloud augmentations (host side, before the device).

The port's own copy of ``cloud_transformers_tpu/data/augment.py``: the
ScanObjectNN ones (jitter, rotation about y, centering, unit sphere) and the
S3DIS ones (rotation about z, scale, flips, dropout, the chromatic
augmentations, elastic distortion).  The draws from ``rng`` come in the same
order, so a seed gives the same arrays in both packages.
"""

import numpy as np


def rotate_y(pcd, rng):
    """Random rotation about the up (y) axis."""
    angle = rng.uniform() * 2 * np.pi
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=pcd.dtype)
    return pcd @ rot


def rotate_z(pcd, rng):
    """Random rotation about the z axis."""
    angle = rng.uniform() * 2 * np.pi
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=pcd.dtype)
    return pcd @ rot


def jitter(pcd, rng, sigma=0.01, clip=0.05):
    """Per-point gaussian jitter, clipped."""
    return pcd + np.clip(sigma * rng.randn(*pcd.shape), -clip, clip).astype(
        pcd.dtype)


def center(pcd):
    return pcd - pcd.mean(axis=0, keepdims=True)


def normalize_unit_sphere(pcd):
    """Divide by the radius of the furthest point."""
    d = np.sqrt((pcd ** 2).sum(-1)).max()
    return pcd / max(d, 1e-12)


def random_scale(pcd, rng, low=0.8, high=1.25):
    """One random scale for the whole cloud."""
    return pcd * rng.uniform(low, high)


def random_flip_xy(pcd, rng, p=0.5):
    """Negate x, then y, each with probability ``p``."""
    out = pcd.copy()
    for axis in (0, 1):
        if rng.rand() < p:
            out[:, axis] = -out[:, axis]
    return out


def random_dropout(pcd, labels, rng, max_ratio=0.875):
    """Replace a random share (up to ``max_ratio``) of the points and their
    labels by the first point's: the array shapes stay fixed."""
    ratio = rng.rand() * max_ratio
    drop = rng.rand(pcd.shape[0]) < ratio
    out = pcd.copy()
    out[drop] = pcd[0]
    lab = labels.copy()
    lab[drop] = labels[0]
    return out, lab


def chromatic_jitter(colors, rng, std=0.01):
    """Per-point color noise, colors in [0, 1]."""
    return np.clip(colors + rng.randn(*colors.shape) * std, 0, 1).astype(
        colors.dtype)


def chromatic_translation(colors, rng, ratio=0.05):
    """One random color shift for the whole cloud, colors in [0, 1]."""
    return np.clip(colors + (rng.rand(1, 3) - 0.5) * 2 * ratio, 0, 1).astype(
        colors.dtype)


def chromatic_autocontrast(colors, rng, p=0.2):
    """With probability ``p``, blend the colors with their per-channel
    contrast stretch by a random amount."""
    if rng.rand() >= p:
        return colors
    lo = colors.min(0, keepdims=True)
    hi = colors.max(0, keepdims=True)
    scale = 1.0 / np.maximum(hi - lo, 1e-6)
    blend = rng.rand()
    return (colors * (1 - blend) + blend * (colors - lo) * scale).astype(
        colors.dtype)


def elastic_distortion(coords, granularity, magnitude, rng):
    """A smooth random displacement field: gaussian noise on a lattice of
    ``granularity`` spacing, blurred twice by a 3-tap box along each axis,
    interpolated at the points and scaled by ``magnitude`` (scipy)."""
    from scipy.interpolate import RegularGridInterpolator
    from scipy.ndimage import convolve
    blurs = [np.ones((3, 1, 1, 1)) / 3, np.ones((1, 3, 1, 1)) / 3,
             np.ones((1, 1, 3, 1)) / 3]
    mins = coords.min(0)
    dims = ((coords.max(0) - mins) // granularity).astype(int) + 3
    noise = rng.randn(*dims, 3).astype(np.float32)
    for _ in range(2):
        for blur in blurs:
            noise = convolve(noise, blur, mode="constant", cval=0)
    ax = [np.linspace(d_min, d_max, d) for d_min, d_max, d in
          zip(mins - granularity, mins + granularity * (dims - 2), dims)]
    interp = RegularGridInterpolator(ax, noise, bounds_error=False,
                                     fill_value=0)
    return (coords + interp(coords) * magnitude).astype(coords.dtype)
