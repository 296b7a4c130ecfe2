"""Numpy point-cloud augmentations (host side, before the device).

The port's own copy of what the classifier's dataset takes from
``cloud_transformers_tpu/data/augment.py``; the draws from ``rng`` come in
the same order, so a seed gives the same clouds in both packages.
"""

import numpy as np


def rotate_y(pcd, rng):
    """Random rotation about the up (y) axis."""
    angle = rng.uniform() * 2 * np.pi
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=pcd.dtype)
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
