"""Geometric helpers: distances to line segments and seed fall-off profiles.

Re-implements the reference's ``src/m_geometry.f90`` (GM_dist_vec_line
``:23-44``, GM_density_line ``:54-83``, fall-off profiles ``:85-140``) in a
form vectorized over an arbitrary batch of points: ``r`` has shape
``[..., ndim]`` and all outputs broadcast over the leading axes, so a whole
box batch is evaluated in one vectorized NumPy call.
"""

from __future__ import annotations

import numpy as np


def dist_vec_line(r, r0, r1):
    """Distance vector between points and their projection onto segment
    r0-r1; also return the fraction [0, 1] along the line
    (GM_dist_vec_line)."""
    r = np.asarray(r, dtype=np.float64)
    r0 = np.asarray(r0, dtype=np.float64)
    r1 = np.asarray(r1, dtype=np.float64)
    line_len2 = np.sum((r1 - r0) ** 2)
    frac_raw = np.sum((r - r0) * (r1 - r0), axis=-1)
    if line_len2 > 0:
        frac = np.clip(frac_raw / line_len2, 0.0, 1.0)
    else:
        frac = np.zeros_like(frac_raw)
    proj = r0 + frac[..., None] * (r1 - r0)
    dist_vec = r - proj
    return dist_vec, frac


def dist_line(r, r0, r1):
    """Distance between points and segment r0-r1 (GM_dist_line)."""
    dv, _ = dist_vec_line(r, r0, r1)
    return np.sqrt(np.sum(dv**2, axis=-1))


def _sigmoid(dist, width):
    tmp = dist / width
    big = np.log(0.5 * np.finfo(np.float64).max)
    return np.where(tmp > big, 0.0, 2.0 / (1.0 + np.exp(np.minimum(tmp, big))))


def _gaussian(dist, width):
    return np.exp(-((dist / width) ** 2))


def _smoothstep(dist, width):
    t = dist / width - 1.0
    mid = 1.0 - (3.0 * t**2 - 2.0 * t**3)
    return np.where(dist < width, 1.0, np.where(dist < 2 * width, mid, 0.0))


def _step(dist, width):
    return np.where(dist < width, 1.0, 0.0)


def density_line(r, r0, r1, n_0, n_1, width, falloff):
    """Density profile of a seed between r0 and r1 (GM_density_line,
    ``m_geometry.f90:54-83``). Note the reference's convention: the density is
    multiplied by ``frac * n_0 + (1 - frac) * n_1`` with frac the position
    fraction along the line (frac = 0 nearest r0)."""
    dist_vec, frac = dist_vec_line(r, r0, r1)
    dist = np.sqrt(np.sum(dist_vec**2, axis=-1))
    if falloff == "sigmoid":
        val = _sigmoid(dist, width)
    elif falloff == "gaussian":
        val = _gaussian(dist, width)
    elif falloff == "smoothstep":
        val = _smoothstep(dist, width)
    elif falloff == "step":
        val = _step(dist, width)
    elif falloff == "laser":
        xz = np.stack([dist_vec[..., 0], dist_vec[..., 2]], axis=-1)
        dy = np.abs(dist_vec[..., 1])
        dxz = np.sqrt(np.sum(xz**2, axis=-1))
        val = np.where((dy < width) & (dxz < width), 1.0,
                       np.exp(1.0 - (dy**2 + dxz**2) / width**2))
    else:
        raise ValueError(f"unknown fall-off type: {falloff}")
    return val * (frac * n_0 + (1.0 - frac) * n_1)
