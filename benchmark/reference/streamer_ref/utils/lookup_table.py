"""Regularly-spaced multi-column lookup tables.

Re-implements the semantics of the reference's vendored lookup_table_fortran
(``src/lookup_table_fortran/m_lookup_table.f90``): a 1D table with n_cols
columns on a regular x-grid with linear / quadratic / cubic x-spacing
(``m_lookup_table.f90:218-237``, table_set_x), clamped linear interpolation
(LT_get_loc, ``:330-362``), and column filling by linear interpolation of
irregular input data (LT_get_spaced_data, ``:240-254``).

The table is built on the host in NumPy float64; a lookup is a torch index
plus lerp over a whole batch of cells, on the device of the query tensor.
"""

from __future__ import annotations

import numpy as np
import torch

XSPACING_LINEAR = 1
XSPACING_QUADRATIC = 2
XSPACING_CUBIC = 3


def lin_interp_list(x_list, y_list, x):
    """Clamped linear interpolation on an irregular grid
    (LT_lin_interp_list, ``m_lookup_table.f90:163-186``)."""
    x_list = np.asarray(x_list, dtype=np.float64)
    y_list = np.asarray(y_list, dtype=np.float64)
    return np.interp(np.asarray(x, dtype=np.float64), x_list, y_list)


def _get_x(x_min: float, x_max: float, n_points: int, xspacing: int) -> np.ndarray:
    """x-coordinates of the table (get_x, ``m_lookup_table.f90:305-327``)."""
    t = np.arange(n_points, dtype=np.float64) / (n_points - 1)
    if xspacing == XSPACING_LINEAR:
        x = t
    elif xspacing == XSPACING_QUADRATIC:
        x = t**2
    elif xspacing == XSPACING_CUBIC:
        x = t**3
    else:
        raise ValueError("unknown xspacing")
    return x_min + x * (x_max - x_min)


class LookupTable:
    """Regular multi-column lookup table (LT_t)."""

    def __init__(self, x_min: float, x_max: float, n_points: int, n_cols: int,
                 xspacing: int = XSPACING_LINEAR, extrapolate_above: bool = False):
        if x_max <= x_min:
            raise ValueError("x_max should be > x_min")
        if n_points <= 1:
            raise ValueError("n_points should be > 1")
        self.n_points = n_points
        self.n_cols = n_cols
        self.x_min = float(x_min)
        self.x_max = float(x_max)
        self.xspacing = xspacing
        self.extrapolate_above = extrapolate_above
        # inverse x-spacing factor (table_set_x, m_lookup_table.f90:218-237)
        if xspacing == XSPACING_LINEAR:
            self.inv_fac = (n_points - 1) / (x_max - x_min)
        elif xspacing == XSPACING_QUADRATIC:
            self.inv_fac = (n_points - 1.0) ** 2 / (x_max - x_min)
        elif xspacing == XSPACING_CUBIC:
            self.inv_fac = (n_points - 1.0) ** 3 / (x_max - x_min)
        else:
            raise ValueError("unknown xspacing")
        self.x = _get_x(x_min, x_max, n_points, xspacing)
        # rows_cols[n_points, n_cols] in float64 (host copy)
        self.rows_cols = np.zeros((n_points, n_cols), dtype=np.float64)
        self._dev = {}  # (columns, device, dtype) -> device sub-table

    # ------------------------------------------------------------- filling
    def set_col(self, col_ix: int, x, y) -> None:
        """Fill a column by linearly interpolating (x, y) data
        (LT_set_col, ``m_lookup_table.f90:257-267``)."""
        self.rows_cols[:, col_ix] = lin_interp_list(x, y, self.x)
        self._dev = {}

    def set_col_data(self, col_ix: int, y) -> None:
        y = np.asarray(y, dtype=np.float64)
        if y.shape != (self.n_points,):
            raise ValueError("size(y) /= number of rows")
        self.rows_cols[:, col_ix] = y
        self._dev = {}

    def host_col(self, col_ix: int, x) -> np.ndarray:
        """Host-side lookup of one column at NumPy x (table building)."""
        out = self.get_col(col_ix, torch.as_tensor(
            np.asarray(x), dtype=torch.float64, device="cpu"))
        return out.numpy()

    # -------------------------------------------------------------- lookup
    def _table(self, cols: tuple, like: torch.Tensor) -> torch.Tensor:
        """Columns ``cols`` of the table on the device and in the dtype of
        ``like``, copied once."""
        key = (cols, like.device, like.dtype)
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(self.rows_cols[:, list(cols)],
                                dtype=like.dtype, device=like.device)
            self._dev[key] = t
        return t

    def _loc(self, x: torch.Tensor):
        """(low_ix, low_frac) as in LT_get_loc
        (``m_lookup_table.f90:330-362``); low_ix is 1-based like the
        reference."""
        frac = (x - self.x_min) * self.inv_fac
        if self.xspacing == XSPACING_QUADRATIC:
            frac = torch.where(frac > 0, torch.sqrt(torch.clamp(frac, min=0.0)),
                               frac)
        elif self.xspacing == XSPACING_CUBIC:
            frac = torch.where(frac > 0,
                               torch.clamp(frac, min=0.0) ** (1.0 / 3.0), frac)
        n = self.n_points
        low_ix = torch.clamp(torch.ceil(frac), 1, n - 1)
        low_frac = low_ix - frac
        low_frac = torch.where(frac <= 0, torch.ones_like(low_frac), low_frac)
        if self.extrapolate_above:
            hi_frac = (n - 1) - frac
        else:
            hi_frac = torch.zeros_like(low_frac)
        low_frac = torch.where(frac >= n - 1, hi_frac, low_frac)
        return low_ix.to(torch.int64), low_frac

    def get_col(self, col_ix: int, x: torch.Tensor) -> torch.Tensor:
        """Interpolate one column at a tensor x of any shape.

        value = low_frac * v[low_ix-1] + (1-low_frac) * v[low_ix]
        (LT_get_col_at_loc; note the 1-based low_ix)."""
        return self.get_cols((col_ix,), x)[0]

    def get_cols(self, col_ixs, x: torch.Tensor):
        """Interpolate several columns at the same x with one shared
        location; returns a tuple of tensors shaped like x."""
        col_ixs = tuple(col_ixs)
        sub = self._table(col_ixs, x)
        low_ix, low_frac = self._loc(x)
        flat = low_ix.reshape(-1)
        v0 = sub[flat - 1].reshape(x.shape + (len(col_ixs),))
        v1 = sub[flat].reshape(x.shape + (len(col_ixs),))
        lf = low_frac[..., None]
        out = lf * v0 + (1.0 - lf) * v1
        return tuple(out[..., i] for i in range(len(col_ixs)))
