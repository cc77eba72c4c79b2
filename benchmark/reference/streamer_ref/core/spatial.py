"""Flat spatial indexing helpers for the SoA box batch.

Cell-centered data of one box is stored flattened: a box has (nc+2)^ndim
cells including one ghost layer; index 0 and nc+1 per dimension are ghost
cells, 1..nc is the interior (matching the reference's
``box%cc(0:nc+1, ...)`` layout, ``afivo/src/m_af_types.f90:286-322``).
Face-centered data uses (nc+1)^ndim per direction with index 1..nc+1 of the
reference mapped to 0..nc here.

All helpers return NumPy int32 index arrays; they run on the host when
building index plans at refinement epochs. ``device_copy`` moves a plan's
index tables to the device once, so the per-step work never copies an
index table from the host.
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace
from typing import List, Sequence, Union

import numpy as np
import torch

IdxLike = Union[int, Sequence[int], np.ndarray]


def _as_axes(nc: int, per_dim: Sequence[IdxLike]) -> List[np.ndarray]:
    axes = []
    for a in per_dim:
        if isinstance(a, slice):
            start = 0 if a.start is None else a.start
            stop = a.stop
            axes.append(np.arange(start, stop, dtype=np.int64))
        elif np.isscalar(a):
            axes.append(np.array([a], dtype=np.int64))
        else:
            axes.append(np.asarray(a, dtype=np.int64))
    return axes


def cc_flat(ndim: int, nc: int, *per_dim: IdxLike) -> np.ndarray:
    """Flat indices into the (nc+2)^ndim cell array for the outer product of
    per-dimension index lists. Returns shape = product of lengths, flattened
    in C order over the given per-dim axes."""
    axes = _as_axes(nc, per_dim)
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.ravel_multi_index([m.ravel() for m in mesh],
                                [nc + 2] * ndim).astype(np.int32)


def interior_flat(ndim: int, nc: int) -> np.ndarray:
    """Flat indices of the nc^ndim interior cells."""
    rng = np.arange(1, nc + 1)
    return cc_flat(ndim, nc, *([rng] * ndim))


def cc_flat_nd(ndim: int, nc: int, idx_nd: np.ndarray) -> np.ndarray:
    """Flat indices for an array of nd coordinates [..., ndim] (0..nc+1)."""
    idx_nd = np.asarray(idx_nd)
    return np.ravel_multi_index(
        [idx_nd[..., k] for k in range(ndim)], [nc + 2] * ndim).astype(np.int32)


def fc_flat(ndim: int, nc: int, *per_dim: IdxLike) -> np.ndarray:
    """Flat indices into the (nc+1)^ndim face array (one direction)."""
    axes = _as_axes(nc, per_dim)
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.ravel_multi_index([m.ravel() for m in mesh],
                                [nc + 1] * ndim).astype(np.int32)


def ext_flat(ndim: int, nc: int, *per_dim: IdxLike) -> np.ndarray:
    """Flat indices into the extended 2-ghost array (nc+4)^ndim. Coordinates
    here are shifted by +2 relative to reference convention (-1..nc+2 maps to
    0..nc+3)."""
    axes = _as_axes(nc, per_dim)
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.ravel_multi_index([m.ravel() for m in mesh],
                                [nc + 4] * ndim).astype(np.int32)


def face_transverse_axes(ndim: int, nc: int, dim: int, normal_idx: int,
                         lo: int = 1, hi: int = None) -> List:
    """Per-dim axes for one face layer: `normal_idx` in dimension `dim`,
    lo..hi (default 1..nc) in the others."""
    hi = nc if hi is None else hi
    axes: List = []
    for k in range(ndim):
        if k == dim:
            axes.append(normal_idx)
        else:
            axes.append(np.arange(lo, hi + 1))
    return axes


def corner_list(ndim: int, nc: int):
    """All 2^ndim corner ghost positions (each dim 0 or nc+1) with their
    inward offsets di (+1 at the low side, -1 at the high side)."""
    out = []
    for bits in itertools.product([0, 1], repeat=ndim):
        pos = np.array([nc + 1 if b else 0 for b in bits], dtype=np.int64)
        di = np.array([-1 if b else 1 for b in bits], dtype=np.int64)
        out.append((pos, di))
    return out


def device_copy(obj, device, dtype=torch.float64) -> SimpleNamespace:
    """Device copies of the NumPy array attributes of ``obj`` (a plan object
    or a dict): integer tables become int64 index tensors, float tables
    tensors of ``dtype`` (the state's; built in float64 on the host and
    cast at the end). Lists of arrays are copied element-wise; other
    attributes are skipped."""
    items = obj.items() if isinstance(obj, dict) else vars(obj).items()
    out = SimpleNamespace()
    for k, v in items:
        if isinstance(v, np.ndarray) and v.dtype != object:
            setattr(out, k, _tensor(v, device, dtype))
        elif (isinstance(v, list) and v
              and all(isinstance(a, np.ndarray) for a in v)):
            setattr(out, k, [_tensor(a, device, dtype) for a in v])
    return out


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    if a.dtype.kind in "iub":
        return torch.as_tensor(a, dtype=torch.int64, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)
