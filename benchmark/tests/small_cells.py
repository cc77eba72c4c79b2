"""Small versions of the benchmark's cells for the CPU tests: the same
settings at the port's committed slice sizes (boxes of 8, 11,392 cells on
6 levels in 2D), where a run takes seconds."""

from __future__ import annotations

SMALL = {2: {"box_size": "8", "coarse_grid_size": "16 16",
             "refine_max_dx": "2.5e-4", "refine_min_dx": "3e-5"}}


def small_cell(spec, name):
    """Cell ``name`` of ``spec`` at the small size of its dimension."""
    cell = spec.cell(name)
    cell.config["settings"].update(SMALL[cell.config["ndim"]])
    return cell
