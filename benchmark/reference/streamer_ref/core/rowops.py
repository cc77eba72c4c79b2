"""Interior and face access on whole box rows.

Every access gathers whole rows of ``cc``/``fc`` by box id, reshapes them
to ``[n, nc+2, nc+2]`` (or the face layout) and slices statically; writes
put the whole rows back. Row gathers and scatters are contiguous on the
device, where per-cell (row, cell) index pairs are not.
"""

from __future__ import annotations

import torch


def interior(nc: int, ndim: int):
    """Index of the interior cells of blocks [n] + [nc+2]^ndim."""
    return (slice(None),) + (slice(1, nc + 1),) * ndim


def cc_rows(cc, iv: int, ids, nc: int, ndim: int):
    """Whole rows of variable iv as blocks [n] + [nc+2]^ndim."""
    return cc[iv, ids].reshape((len(ids),) + (nc + 2,) * ndim)


def cc_get_interior(cc, iv: int, ids, nc: int, ndim: int):
    """Interior cells of cc rows: [n, nc^ndim]."""
    return cc_rows(cc, iv, ids, nc, ndim)[interior(nc, ndim)].flatten(1)


def cc_set_interior(cc, iv: int, ids, vals, nc: int, ndim: int):
    """Write interior cells [n, nc^ndim] into cc rows (in place)."""
    B = cc_rows(cc, iv, ids, nc, ndim)
    B[interior(nc, ndim)] = vals.reshape((len(ids),) + (nc,) * ndim)
    cc[iv, ids] = B.flatten(1)
    return cc


def cc_add_interior(cc, iv: int, ids, vals, nc: int, ndim: int):
    """Add to interior cells [n, nc^ndim] of cc rows (in place)."""
    B = cc_rows(cc, iv, ids, nc, ndim)
    B[interior(nc, ndim)] += vals.reshape((len(ids),) + (nc,) * ndim)
    cc[iv, ids] = B.flatten(1)
    return cc


def _faces(nc: int, ndim: int, d: int):
    return (slice(None),) + tuple(
        slice(0, nc + 1) if k == d else slice(0, nc) for k in range(ndim))


def fc_get_faces(fc, f_iv: int, d: int, ids, nc: int, ndim: int):
    """Faces of one flux dim: [n] + [nc+1 if k==d else nc]."""
    B = fc[f_iv, d, ids].reshape((len(ids),) + (nc + 1,) * ndim)
    return B[_faces(nc, ndim, d)]


def fc_set_faces(fc, f_iv: int, d: int, ids, vals, nc: int, ndim: int):
    """Write the faces of one flux dim back (in place)."""
    B = fc[f_iv, d, ids].reshape((len(ids),) + (nc + 1,) * ndim)
    shape = (len(ids),) + tuple(nc + 1 if k == d else nc
                                for k in range(ndim))
    B[_faces(nc, ndim, d)] = vals.reshape(shape)
    fc[f_iv, d, ids] = B.flatten(1)
    return fc


def as_value(val, like: torch.Tensor):
    """A boundary value as a Python float or a tensor like ``like``."""
    if isinstance(val, (int, float)):
        return float(val)
    return torch.as_tensor(val, dtype=like.dtype, device=like.device)
