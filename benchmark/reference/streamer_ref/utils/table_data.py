"""Reading tabulated data from named text blocks.

Re-implements the reference's ``src/m_table_data.f90``:

* ``table_from_file`` finds a block ``<data_name>`` followed by optional
  ``FACTOR:`` / ``COMMENT:`` lines, a line of at least five dashes, two-column
  data rows, and closing dashes (``m_table_data.f90:121-255``);
* ``table_set_column`` interpolates input data onto the regular table grid,
  by default linearly (``m_table_data.f90:82-118``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .lookup_table import (LookupTable, XSPACING_LINEAR, XSPACING_QUADRATIC,
                           lin_interp_list)


class TableDataSettings:
    """Settings registered by table_data_initialize (``m_table_data.f90:39-80``)."""

    def __init__(self, cfg=None):
        self.table_size = 1000
        self.min_townsend = 0.0
        self.max_townsend = -1.0
        self.xspacing = XSPACING_LINEAR
        self.input_interpolation = "linear"
        if cfg is not None:
            self.table_size = cfg.add_get(
                "table_data%size", self.table_size,
                "Size of the lookup table for reaction rates")
            self.min_townsend = cfg.add_get(
                "table_data%min_townsend", self.min_townsend,
                "Minimal field (in Td) for the rate coeff. lookup table")
            self.max_townsend = cfg.add_get(
                "table_data%max_townsend", self.max_townsend,
                "Maximal field (Td) for lookup tables, < 0 means automatic")
            method = cfg.add_get("table_data%input_interpolation", "linear",
                                 "Input interpolation method (linear, cubic_spline)")
            self.input_interpolation = method
            xsp = cfg.add_get("table_data%xspacing", "linear",
                              "x-spacing for lookup table (linear, quadratic)")
            self.xspacing = {"linear": XSPACING_LINEAR,
                             "quadratic": XSPACING_QUADRATIC}[xsp]


def table_from_file(file_name: str, data_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Find and read a named data block (``m_table_data.f90:121-255``)."""
    with open(file_name) as f:
        lines = f.read().splitlines()
    i = 0
    n = len(lines)
    while i < n and lines[i].rstrip() != data_name:
        i += 1
    if i >= n:
        raise ValueError(
            f"table_from_file: no block {data_name!r} in {file_name}")
    i += 1
    factor = 1.0
    while i < n:
        line = lines[i].strip()
        i += 1
        if line.startswith("-----"):
            break
        if line.startswith("FACTOR:"):
            factor = float(line[len("FACTOR:"):])
        elif line.startswith("COMMENT:"):
            continue
        else:
            raise ValueError(
                f"Unknown statement in {file_name} before data of {data_name!r}: "
                f"{line!r}")
    xs, ys = [], []
    while i < n:
        line = lines[i].strip()
        i += 1
        if line.startswith("-----"):
            break
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        xs.append(float(parts[0]))
        ys.append(float(parts[1]))
    return np.asarray(xs), factor * np.asarray(ys)


def table_set_column(tbl: LookupTable, i_col: int, x, y,
                     settings: Optional[TableDataSettings] = None) -> float:
    """Interpolate data onto the table grid and store it; return the relative
    interpolation error estimate (``m_table_data.f90:82-118``)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape:
        raise ValueError("size(x) /= size(y)")
    interp = "linear" if settings is None else settings.input_interpolation
    if interp == "linear":
        tbl.set_col(i_col, x, y)
    elif interp == "cubic_spline":
        try:
            from scipy.interpolate import CubicSpline
            spl = CubicSpline(x, y)
            y_table = spl(tbl.x)
        except ImportError:
            y_table = lin_interp_list(x, y, tbl.x)
        if y.min() >= 0.0:
            y_table = np.maximum(0.0, y_table)
        tbl.set_col_data(i_col, y_table)
    else:
        raise ValueError("invalid input_interpolation")
    return float(np.max(np.abs(y - tbl.host_col(i_col, x))) / np.max(np.abs(y)))
