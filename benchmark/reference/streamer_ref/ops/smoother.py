"""The multigrid smoother of the frozen reference: plain PyTorch only.

A copy of the port's ``ops/smoother.py`` without its CUDA kernels: each
wrapper (K1 ``fill_sweep_2d``, K2 ``sweep_2d``, K3 ``fill_2d``, K3-swap
``fill_2d_swap``, K4 ``sweep_3d``, K5 ``fill_3d``) validates its inputs
(``_check``) and runs the plain version on every device. One half
red-black sweep of gsrb_boxes (``afivo/src/m_af_multigrid.f90:648-687``)
on the level-local block arrays ``[n] + [nc+2]^ndim`` of the block V-cycle
(solvers/mg_blocks.py) is built from them. In 1D ``sweep_1d`` and
``fill_1d`` are the same tensor operations.

``SmootherTables`` builds the per-level runtime tables (neighbor rows
``g``, ghost weights ``W``, the stencil blocks ``cs`` and, with an
electrode, the rhs factor ``corr`` of its boundary potential).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ghostcell as gc
from ..core.tree import neighb_dim, neighb_low

_MODE_SWEEP, _MODE_FILL, _MODE_FILL_SWEEP, _MODE_FILL_SWAP = 0, 1, 2, 3


def _check(ndim, phi3, R=None, mask=None, A=None, g=None, W=None,
           cs=None):
    """Validate device, dtype, shape and contiguity of a kernel's inputs,
    on every device: a mixed dtype that the CPU would promote fails on
    the card."""
    if phi3.dim() != ndim + 1:
        raise ValueError(f"phi3 must have {ndim + 1} dims, got "
                         f"{tuple(phi3.shape)}")
    if ndim not in (2, 3) or len(set(phi3.shape[1:])) != 1:
        raise ValueError(f"phi3 must be [n, C, C(, C)], got "
                         f"{tuple(phi3.shape)}")
    if phi3.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {phi3.dtype}")
    n, C = phi3.shape[0], phi3.shape[1]
    nc = C - 2
    if nc % 2:
        raise ValueError(f"nc must be even, got {nc}")
    cube = (nc,) * ndim
    face = (nc,) * (ndim - 1)
    spec = {"R": (R, (n,) + cube, phi3.dtype),
            "mask": (mask, cube, torch.float32),
            "A": (A, (n, 2 * ndim) + face, phi3.dtype),
            "g": (g, (n, 1 + 2 * ndim), torch.int32),
            "W": (W, (n, 2 * ndim, 8), phi3.dtype),
            "cs": (cs, (n, 2 + 2 * ndim) + cube, phi3.dtype)}
    for name, (t, shape, dtype) in [("phi3", (phi3, tuple(phi3.shape),
                                              phi3.dtype))] + list(spec.items()):
        if t is None:
            continue
        if t.device != phi3.device:
            raise ValueError(f"{name} on {t.device}, phi3 on {phi3.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, nc


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the reference of the kernels)
# ---------------------------------------------------------------------------
def _sweep_blocks(B, R, mask, cs):
    """Red-black update of own blocks B [n, C, C]."""
    nc = B.shape[-1] - 2
    B0 = B[:, 1:nc + 1, 1:nc + 1]
    # difference form (see solvers/multigrid.LevelOp): no |phi|-scale
    # cancellation in the residual
    lphi = (cs[:, 5] * B0
            + cs[:, 1] * (B[:, 0:nc, 1:nc + 1] - B0)
            + cs[:, 2] * (B[:, 2:nc + 2, 1:nc + 1] - B0)
            + cs[:, 3] * (B[:, 1:nc + 1, 0:nc] - B0)
            + cs[:, 4] * (B[:, 1:nc + 1, 2:nc + 2] - B0))
    new = B0 + (R - lphi) / cs[:, 0]
    out = B.clone()
    out[:, 1:nc + 1, 1:nc + 1] = torch.where(mask > 0, new, B0)
    return out


def _fill_blocks(phi3, A, g, W, swap: bool = False):
    """Own blocks phi3[g[:, 0]] with rebuilt side ghosts (with ``swap``
    the parity-swap terms W3*swap(f1) + W4*swap(f2) added last)."""
    nc = phi3.shape[-1] - 2
    gl = g.long()
    B = phi3[gl[:, 0]]
    out = B.clone()
    inner = slice(1, nc + 1)
    for d in range(4):
        nb = phi3[gl[:, 1 + d]]
        if d == 0:
            slab, f1, f2 = nb[:, nc, inner], B[:, 1, inner], B[:, 2, inner]
        elif d == 1:
            slab, f1, f2 = nb[:, 1, inner], B[:, nc, inner], B[:, nc - 1, inner]
        elif d == 2:
            slab, f1, f2 = nb[:, inner, nc], B[:, inner, 1], B[:, inner, 2]
        else:
            slab, f1, f2 = nb[:, inner, 1], B[:, inner, nc], B[:, inner, nc - 1]
        w = W[:, d]
        ghost = (w[:, 0:1] * slab + w[:, 1:2] * f1 + w[:, 2:3] * f2
                 + A[:, d])
        if swap:
            ghost = (ghost + w[:, 3:4] * gc.pair_swap(f1)
                     + w[:, 4:5] * gc.pair_swap(f2))
        if d == 0:
            out[:, 0, inner] = ghost
        elif d == 1:
            out[:, nc + 1, inner] = ghost
        elif d == 2:
            out[:, inner, 0] = ghost
        else:
            out[:, inner, nc + 1] = ghost
    return out


def sweep_2d_plain(phi3, R, mask, g, cs):
    """Plain version of K2 (afivo_streamer_tpu/ops/pallas_smoother.py
    _sweep_2d)."""
    return _sweep_blocks(phi3[g.long()[:, 0]], R, mask, cs)


def fill_2d_plain(phi3, A, g, W):
    """Plain version of K3 without parity-swap terms (pallas_smoother.py
    _fill_2d, has_swap=False)."""
    return _fill_blocks(phi3, A, g, W)


def fill_2d_swap_plain(phi3, A, g, W):
    """Plain version of K3 with parity-swap terms (pallas_smoother.py
    _fill_2d, has_swap=True)."""
    return _fill_blocks(phi3, A, g, W, swap=True)


def fill_sweep_2d_plain(phi3, R, mask, A, g, W, cs):
    """Plain version of K1 (pallas_smoother.py _fill_sweep_2d)."""
    return _sweep_blocks(_fill_blocks(phi3, A, g, W), R, mask, cs)


def sweep_3d_plain(phi3, R, mask, g, cs):
    """Plain version of K4 (pallas_smoother.py _sweep_3d): the 7-point
    red-black update of the own blocks phi3[g[:, 0]]."""
    B = phi3[g.long()[:, 0]]
    nc = B.shape[-1] - 2
    i = slice(1, nc + 1)
    B0 = B[:, i, i, i]
    lphi = (cs[:, 7] * B0
            + cs[:, 1] * (B[:, 0:nc, i, i] - B0)
            + cs[:, 2] * (B[:, 2:nc + 2, i, i] - B0)
            + cs[:, 3] * (B[:, i, 0:nc, i] - B0)
            + cs[:, 4] * (B[:, i, 2:nc + 2, i] - B0)
            + cs[:, 5] * (B[:, i, i, 0:nc] - B0)
            + cs[:, 6] * (B[:, i, i, 2:nc + 2] - B0))
    new = B0 + (R - lphi) / cs[:, 0]
    out = B.clone()
    out[:, i, i, i] = torch.where(mask > 0, new, B0)
    return out


def _face(X, axis: int, row: int):
    """The nc x nc slab of blocks X [n, C, C, C] at ``row`` along ``axis``
    (interior on the two other axes, in their natural order)."""
    i = slice(1, X.shape[-1] - 1)
    sl = [i, i, i]
    sl[axis] = row
    return (slice(None),) + tuple(sl)


def fill_3d_plain(phi3, A, g, W):
    """Plain version of K5 (pallas_smoother.py _fill_3d): the six face
    ghosts of the own blocks phi3[g[:, 0]] (edges and corners kept)."""
    nc = phi3.shape[-1] - 2
    gl = g.long()
    B = phi3[gl[:, 0]]
    out = B.clone()
    for d in range(6):
        axis, low = neighb_dim(d), neighb_low(d)
        nb_row, f1_row, f2_row, g_row = ((nc, 1, 2, 0) if low
                                         else (1, nc, nc - 1, nc + 1))
        slab = phi3[gl[:, 1 + d]][_face(B, axis, nb_row)]
        w = W[:, d, :, None, None]
        out[_face(out, axis, g_row)] = (
            w[:, 0] * slab + w[:, 1] * B[_face(B, axis, f1_row)]
            + w[:, 2] * B[_face(B, axis, f2_row)] + A[:, d])
    return out


# ---------------------------------------------------------------------------
# 1D: tensor operations on any device (no kernel exists for one dimension)
# ---------------------------------------------------------------------------
def sweep_1d(phi3, R, mask, g, cs):
    """One red-black half sweep of the 3-point stencil on the own blocks
    phi3[g[:, 0]] [n, nc + 2], in the operation order of the 2D and 3D
    sweeps."""
    B = phi3[g.long()[:, 0]]
    nc = B.shape[-1] - 2
    B0 = B[:, 1:nc + 1]
    lphi = (cs[:, 3] * B0
            + cs[:, 1] * (B[:, 0:nc] - B0)
            + cs[:, 2] * (B[:, 2:nc + 2] - B0))
    new = B0 + (R - lphi) / cs[:, 0]
    out = B.clone()
    out[:, 1:nc + 1] = torch.where(mask > 0, new, B0)
    return out


def fill_1d(phi3, A, g, W):
    """The two end ghosts of the own blocks phi3[g[:, 0]] [n, nc + 2] from
    the linear form W0*nb_cell + W1*f1 + W2*f2 + A, with A [n, 2]."""
    nc = phi3.shape[-1] - 2
    gl = g.long()
    B = phi3[gl[:, 0]]
    out = B.clone()
    for d in range(2):
        nb_i, f1_i, f2_i, g_i = ((nc, 1, 2, 0) if neighb_low(d)
                                 else (1, nc, nc - 1, nc + 1))
        w = W[:, d]
        out[:, g_i] = (w[:, 0] * phi3[gl[:, 1 + d], nb_i] + w[:, 1] * B[:, f1_i]
                       + w[:, 2] * B[:, f2_i] + A[:, d])
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _run(fn, mode: int, ndim: int, plain, phi3, **inputs):
    """Wrapper ``fn``: check the inputs, then the plain version on every
    device (this copy holds no kernel)."""
    _check(ndim, phi3, **inputs)
    return plain(phi3, **inputs)


def sweep_2d(phi3, R, mask, g, cs):
    """K2: one red-black half sweep on the blocks' current ghosts."""
    return _run(sweep_2d, _MODE_SWEEP, 2, sweep_2d_plain, phi3, R=R,
                mask=mask, g=g, cs=cs)


def fill_2d(phi3, A, g, W):
    """K3: side-ghost exchange of every block."""
    return _run(fill_2d, _MODE_FILL, 2, fill_2d_plain, phi3, A=A, g=g, W=W)


def fill_2d_swap(phi3, A, g, W):
    """K3-swap: side-ghost exchange of every block with the parity-swap
    terms of the extrapolating refinement-boundary ghosts."""
    return _run(fill_2d_swap, _MODE_FILL_SWAP, 2, fill_2d_swap_plain, phi3,
                A=A, g=g, W=W)


def fill_sweep_2d(phi3, R, mask, A, g, W, cs):
    """K1: side-ghost exchange, then a red-black half sweep on the filled
    blocks."""
    return _run(fill_sweep_2d, _MODE_FILL_SWEEP, 2, fill_sweep_2d_plain,
                phi3, R=R, mask=mask, A=A, g=g, W=W, cs=cs)


def sweep_3d(phi3, R, mask, g, cs):
    """K4: one 3D red-black half sweep on the blocks' current ghosts."""
    return _run(sweep_3d, _MODE_SWEEP, 3, sweep_3d_plain, phi3, R=R,
                mask=mask, g=g, cs=cs)


def fill_3d(phi3, A, g, W):
    """K5: face-ghost exchange of every 3D block."""
    return _run(fill_3d, _MODE_FILL, 3, fill_3d_plain, phi3, A=A, g=g, W=W)


KERNELS = {"fill_sweep_2d": fill_sweep_2d, "sweep_2d": sweep_2d,
           "fill_2d": fill_2d, "fill_2d_swap": fill_2d_swap,
           "sweep_3d": sweep_3d, "fill_3d": fill_3d}
PLAIN = {"fill_sweep_2d": fill_sweep_2d_plain, "sweep_2d": sweep_2d_plain,
         "fill_2d": fill_2d_plain, "fill_2d_swap": fill_2d_swap_plain,
         "sweep_3d": sweep_3d_plain, "fill_3d": fill_3d_plain}


# ---------------------------------------------------------------------------
# runtime tables of one level
# ---------------------------------------------------------------------------
class SmootherTables:
    """Neighbor-row and ghost-weight tables of one level's blocks
    (afivo_streamer_tpu PackSmoother2D/PackSmoother3D.__init__, without
    padded rows): g [n, 1 + 2 ndim], W [n, 2 ndim, 8]. The refinement
    boundary weights are those of mg_sides_rb in every dimension.

    ``bc_recipe`` lists (direction, bc type, gamma) for the physical
    boundaries, whose values the A constants fold in at every level visit
    (solvers/mg_blocks.build_A_blocks); ``rb_dirs`` the directions with
    refinement boundaries, whose coarse strips do the same.

    ``rb_extrap`` ({direction: bool per refinement-boundary entry}, the
    multigrid's variable-eps mask) selects the extrapolating ghosts of
    mg_sides_rb_extrap (pallas_smoother.py PallasSmoother2D :115-126): in
    2D the weights 1.125, -0.375 and the parity-swap weights -0.375, 0.125,
    in 1D and 3D the one-dimensional form 0.75, -0.25; their A constants take half
    the parent copy. ``has_swap`` tells whether any parity-swap weight is
    set (K3-swap)."""

    def __init__(self, tree, lvl: int, plan, tb, bc_fn, i_phi: int, device,
                 rb_extrap=None):
        self.nc, self.ndim = tree.nc, tree.ndim
        n_dir = 2 * tree.ndim
        ids = np.asarray(tb.ids, np.int64)
        n = len(ids)
        self.n = n
        pos = np.full(int(tree.highest_id) + 1, -1, np.int64)
        pos[ids] = np.arange(n)

        g = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, 1 + n_dir))
        W = np.zeros((n, n_dir, 8))
        bc_recipe, rb_dirs = [], []
        self.bc_pos = [None] * n_dir
        self.rb_pos = [None] * n_dir
        self.rb_extrap = [None] * n_dir
        for d, p in enumerate(plan.dirs):
            if len(p.copy_ids):
                rows = pos[p.copy_ids]
                g[rows, 1 + d] = pos[p.copy_nb]
                W[rows, d, 0] = 1.0
            if len(p.bc_ids):
                bc_type, _ = bc_fn(i_phi, d, p.bc_coords, {})
                rows = pos[p.bc_ids]
                dim, low = neighb_dim(d), neighb_low(d)
                if bc_type == gc.BC_DIRICHLET:
                    W[rows, d, 1] = -1.0
                    gamma = 2.0
                elif bc_type == gc.BC_NEUMANN:
                    W[rows, d, 1] = 1.0
                    gamma = (1.0 if not low else -1.0) * float(plan.dr[dim])
                elif bc_type == gc.BC_CONTINUOUS:
                    W[rows, d, 1] = 2.0
                    W[rows, d, 2] = -1.0
                    gamma = 0.0
                elif bc_type == gc.BC_DIRICHLET_COPY:
                    gamma = 1.0
                else:
                    raise ValueError("unsupported bc type")
                bc_recipe.append((d, int(bc_type), float(gamma)))
                self.bc_pos[d] = torch.as_tensor(rows, dtype=torch.int64,
                                                 device=device)
            if len(p.rb_ids):
                rows = pos[p.rb_ids]
                emask = np.zeros(len(rows), bool)
                if rb_extrap is not None and rb_extrap.get(d) is not None:
                    emask = np.asarray(rb_extrap[d], bool)
                W[rows[~emask], d, 1] = 0.75
                W[rows[~emask], d, 2] = -0.25
                if emask.any():
                    W[rows[emask], d, 1:5] = ((1.125, -0.375, -0.375, 0.125)
                                              if tree.ndim == 2
                                              else (0.75, -0.25, 0.0, 0.0))
                    self.rb_extrap[d] = torch.as_tensor(emask, device=device)
                rb_dirs.append(d)
                self.rb_pos[d] = torch.as_tensor(rows, dtype=torch.int64,
                                                 device=device)
        if n and (g.min() < 0 or g.max() >= n):
            raise ValueError("neighbor row table out of range")
        self.g = torch.as_tensor(g, dtype=torch.int32, device=device)
        self._W = W
        self.has_swap = bool(np.any(W[:, :, 3:5] != 0.0))
        self.bc_recipe = tuple(bc_recipe)
        self.rb_dirs = tuple(rb_dirs)
        self.device = device
        self._cache = {}

    def W(self, dtype):
        key = ("W", dtype)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self._W, dtype=dtype,
                                               device=self.device)
        return self._cache[key]

    def cs(self, op, dtype):
        """Stencil coefficient blocks [n, 2 + 2 ndim] + [nc]^ndim from the
        LevelOp coefficients (c0, 2 ndim neighbors, c_sum), built once per
        dtype."""
        key = ("cs", dtype)
        if key not in self._cache:
            shape = (self.n,) + (self.nc,) * self.ndim
            cols = [op.c0] + list(op.c_nb) + [op.c_sum]
            blocks = [np.broadcast_to(np.asarray(c, np.float64), shape)
                      for c in cols]
            self._cache[key] = torch.as_tensor(
                np.stack(blocks, axis=1), dtype=dtype, device=self.device)
        return self._cache[key]

    def corr(self, op, dtype):
        """The factor f * bc_coeff [n] + [nc]^ndim of a level-set boundary
        potential in the rhs (LevelOp), built once per dtype; None for an
        operator without a level-set boundary on this level."""
        if op.f is None:
            return None
        key = ("corr", dtype)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                op.f * op.bc_coeff, dtype=dtype, device=self.device)
        return self._cache[key]
