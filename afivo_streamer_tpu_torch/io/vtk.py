"""Legacy-VTK unstructured-grid writer for the leaves of the mesh.

Port of the JAX package's ``io/vtk.py``, which takes the place of the
reference's Silo output and mirrors its plain VTK writer (af_write_vtk,
``afivo/src/m_af_output.f90:556-752`` and ``m_vtk.f90``): every leaf cell
becomes a line, quad or hexahedron with the cell-centered variables marked
for output as its data. Readable by VisIt and ParaView. The points and
cells are built per level for all its leaves at once; the data of a level
comes from the device in one gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rowops as ro

#: the corners of a cell in VTK's order (x fastest), per dimension
CORNERS = {1: [(0,), (1,)],
           2: [(0, 0), (1, 0), (1, 1), (0, 1)],
           3: [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
               (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]}
#: VTK_LINE, VTK_QUAD, VTK_HEXAHEDRON
CELL_TYPE = {1: 3, 2: 9, 3: 12}


def write_vtk(fname: str, sim, cycle: int = 0, time: float = 0.0) -> None:
    """The leaves' cells and the variables marked for output as one ASCII
    VTK unstructured grid. Each box contributes its points corner by
    corner (each corner of all its cells in turn), as in the JAX
    package."""
    t = sim.tree
    nc, ndim = t.nc, t.ndim
    reg = sim.registry
    ivs = [iv for iv in range(len(reg.cc_names)) if reg.cc_write_output[iv]]
    corners = np.asarray(CORNERS[ndim], np.float64)       # [K, ndim]
    K = len(corners)
    cell_nd = np.stack(np.meshgrid(*[np.arange(nc)] * ndim, indexing="ij"),
                       -1).reshape(-1, ndim)              # [C, ndim]
    C = len(cell_nd)
    points, cells, data = [], [], []
    offset = 0
    for lvl in range(1, t.highest_lvl + 1):
        leaves = np.asarray(t.lvl_leaves[lvl - 1])
        if len(leaves) == 0:
            continue
        n = len(leaves)
        dr = t.lvl_dr(lvl)
        base = t.box_r_min(leaves)[:, None, :] + cell_nd[None] * dr
        # [n, K, C, ndim]: box-major, then corner, then cell
        pts = base[:, None, :, :] + (corners * dr)[None, :, None, :]
        points.append(pts.reshape(-1, ndim))
        box_off = offset + np.arange(n) * (C * K)
        cells.append((box_off[:, None, None] + np.arange(C)[None, :, None]
                      + np.arange(K)[None, None, :] * C).reshape(-1, K))
        offset += n * C * K
        lv = sim.mesh.tb(lvl).d.leaves
        data.append(torch.stack([ro.cc_get_interior(sim.cc, iv, lv, nc, ndim)
                                 for iv in ivs]).reshape(len(ivs), -1))
    all_pts = np.concatenate(points)
    all_cells = np.concatenate(cells)
    values = torch.cat(data, 1).to(torch.float64).cpu().numpy()
    n_cells = len(all_cells)
    with open(fname, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"cycle {cycle} time {time:.8E}\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        np3 = np.zeros((len(all_pts), 3))
        np3[:, :ndim] = all_pts
        f.write(f"POINTS {len(all_pts)} double\n")
        np.savetxt(f, np3, fmt="%.10E")
        f.write(f"\nCELLS {n_cells} {n_cells * (2 ** ndim + 1)}\n")
        arr = np.column_stack([np.full(n_cells, 2 ** ndim), all_cells])
        np.savetxt(f, arr, fmt="%d")
        f.write(f"\nCELL_TYPES {n_cells}\n")
        np.savetxt(f, np.full(n_cells, CELL_TYPE[ndim]), fmt="%d")
        f.write(f"\nCELL_DATA {n_cells}\n")
        for k, iv in enumerate(ivs):
            f.write(f"SCALARS {reg.cc_names[iv]} double 1\n"
                    "LOOKUP_TABLE default\n")
            np.savetxt(f, values[k], fmt="%.10E")
