"""Level-set-function (electrode) machinery for the multigrid solver.

Re-implements the reference's internal-boundary support in
``afivo/src/m_af_multigrid.f90``:

* root detection via a numerical-gradient bound
  (get_possible_lsf_root_mask ``:955-974``);
* per-cell boundary distances along the 2*ndim axes, with a
  gradient-descent fallback search when the electrode is thinner than the
  grid spacing (store_lsf_distance_matrix ``:977-1097``);
* distance functions: linear interpolation (mg_lsf_dist_linear
  ``:1607-1623``) and bisection + Golden-section bracket search
  (mg_lsf_dist_gss ``:1629-1664``, gss ``:1700-1760``);
* the generalized Laplacian stencil with eliminated boundary couplings
  moved to the right-hand side (mg_box_lsf_stencil ``:1762-1834``),
  including the cylindrical 1/r d/dr correction.

All of this is host geometry in NumPy float64, vectorized over cell
batches, in the operation order of the JAX package's solvers/lsf.py: the
root searches are iterative, and the stencil divides by the distances they
return. The per-level results are cached with the mesh's plans and by the
positions of the level's boxes, so a refinement epoch recomputes only the
levels whose boxes were added or removed; the
multigrid turns them into per-level device tensors (solvers/multigrid.py).
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Optional

import numpy as np

INVPHI = (np.sqrt(5.0) - 1) / 2
INVPHI2 = (3 - np.sqrt(5.0)) / 2


def numerical_gradient(f, r):
    """Central-difference gradient, vectorized over points [n, ndim]."""
    sqrteps = np.sqrt(np.finfo(np.float64).eps)
    eps = np.finfo(np.float64).eps
    step = np.maximum(eps, sqrteps * np.abs(r))
    ndim = r.shape[-1]
    grad = np.zeros_like(r)
    for d in range(ndim):
        rp = r.copy()
        rp[..., d] += step[..., d]
        rm = r.copy()
        rm[..., d] -= step[..., d]
        grad[..., d] = (f(rp) - f(rm)) / (2 * step[..., d])
    return grad


def bisection(f, a, b, tol, max_iter=100):
    """Vectorized bisection for points [n, ndim] (``:1667-1690``)."""
    a = a.copy()
    b = b.copy()
    for _ in range(max_iter):
        c = 0.5 * (a + b)
        fc = f(c)
        done = (0.5 * np.linalg.norm(b - a, axis=-1) < tol) | (np.abs(fc) <= 0)
        if done.all():
            break
        move_a = (fc * f(a) >= 0) & ~done
        move_b = ~move_a & ~done
        a[move_a] = c[move_a]
        b[move_b] = c[move_b]
    return 0.5 * (a + b)


def gss_bracket(f, a, b, minimization, tol):
    """Vectorized Golden-section bracket search (gss with
    find_bracket=.true., ``:1700-1760``). minimization: bool array [n]."""
    a = a.copy()
    b = b.copy()
    h = b - a
    hn = np.linalg.norm(h, axis=-1)
    n_pts = len(a)
    small = hn <= tol
    n_steps = np.zeros(n_pts, dtype=np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        n_steps[~small] = np.ceil(
            np.log(tol / hn[~small]) / np.log(INVPHI)).astype(np.int64)
    max_n = int(n_steps.max(initial=0))
    c = a + INVPHI2 * h
    d = a + INVPHI * h
    ya = f(a)
    yc = f(c)
    yd = f(d)
    frozen = small.copy()
    for k in range(1, max(max_n, 1)):
        active = (~frozen) & (k <= n_steps - 1)
        take_c = ((yc < yd) == minimization) & active
        take_d = (~take_c) & active
        # branch 1: b=d, d=c, h*=invphi, c=a+invphi2*h
        b[take_c] = d[take_c]
        d[take_c] = c[take_c]
        yd[take_c] = yc[take_c]
        h[take_c] *= INVPHI
        c_new = a + INVPHI2 * h
        c[take_c] = c_new[take_c]
        if take_c.any():
            yc[take_c] = f(c[take_c])
        # branch 2: a=c, c=d, h*=invphi, d=a+invphi*h
        a[take_d] = c[take_d]
        c[take_d] = d[take_d]
        yc[take_d] = yd[take_d]
        h[take_d] *= INVPHI
        d_new = a + INVPHI * h
        d[take_d] = d_new[take_d]
        if take_d.any():
            yd[take_d] = f(d[take_d])
        # early bracket exit
        frozen = frozen | ((ya * yc <= 0) & (ya * yd <= 0))
        if frozen.all():
            break
    lo = np.where(((yc < yd) == minimization)[:, None], a, c)
    hi = np.where(((yc < yd) == minimization)[:, None], d, b)
    return lo, hi


def dist_gss(f, a, b, tol, min_rel_distance):
    """Vectorized mg_lsf_dist_gss: relative root location in [0, 1] along
    a->b, 1 when no root."""
    lsf_a = f(a)
    lsf_b = f(b)
    n = len(a)
    dist = np.ones(n)
    direct = lsf_a * lsf_b <= 0
    if direct.any():
        root = bisection(f, a[direct], b[direct], tol)
        d = (np.linalg.norm(root - a[direct], axis=-1)
             / np.linalg.norm(b[direct] - a[direct], axis=-1))
        dist[direct] = np.maximum(d, min_rel_distance)
    rest = ~direct
    if rest.any():
        lo, hi = gss_bracket(f, a[rest], b[rest], (lsf_a[rest] >= 0), tol)
        # pick the endpoint with a sign change from a
        use_lo = f(lo) * lsf_a[rest] <= 0
        b_new = np.where(use_lo[:, None], lo, hi)
        has_root = f(b_new) * lsf_a[rest] <= 0
        if has_root.any():
            idx = np.nonzero(rest)[0][has_root]
            root = bisection(f, a[idx], b_new[has_root], tol)
            d = (np.linalg.norm(root - a[idx], axis=-1)
                 / np.linalg.norm(b[idx] - a[idx], axis=-1))
            dist[idx] = np.maximum(d, min_rel_distance)
    return dist


def dist_linear(f, a, b, tol, min_rel_distance):
    """Vectorized mg_lsf_dist_linear."""
    lsf_a = f(a)
    lsf_b = f(b)
    dist = np.ones(len(a))
    cross = lsf_a * lsf_b < 0
    d = lsf_a[cross] / (lsf_a[cross] - lsf_b[cross])
    dist[cross] = np.maximum(d, min_rel_distance)
    return dist


class LsfData:
    """Boundary distances and stencil data of a level set on the levels of
    a mesh (core/levels.MeshPlans), cached per level."""

    def __init__(self, mesh, lsf_fn: Callable,
                 length_scale: float = 1e100,
                 dist_mode: str = "gss", tol: float = 1e-8,
                 min_rel_distance: float = 1e-4,
                 gradient_safety_factor: float = 1.5,
                 boundary_coeff_fn: Optional[Callable] = None):
        """lsf_fn: vectorized callable [n, ndim] -> [n].
        boundary_coeff_fn: optional per-position multiplier for the boundary
        potential (rod_rod style); default 1 everywhere."""
        self.mesh = mesh
        self.tree = mesh.tree
        self.lsf = lsf_fn
        self.length_scale = length_scale
        self.dist_mode = dist_mode
        self.tol = tol
        self.min_rel_distance = min_rel_distance
        self.safety = gradient_safety_factor
        self.boundary_coeff_fn = boundary_coeff_fn
        #: host seconds spent computing level data (a share of the mesh's
        #: build_seconds)
        self.build_seconds = 0.0
        self._by_position = {}  # lvl -> (digest of ids and positions, data)
        self._whole = None  # whole(), in a sharded run

    def _dist(self, a, b):
        if self.dist_mode == "gss":
            return dist_gss(self.lsf, a, b, self.tol, self.min_rel_distance)
        return dist_linear(self.lsf, a, b, self.tol, self.min_rel_distance)

    def level_data(self, lvl: int):
        """Distances for all boxes of a level (in a sharded run, the
        rank's rows of the level: its own boxes, then its halo).

        Returns dict with: dd [n, C, 2*ndim] (1 = no boundary), has_bnd [n]
        (bool, i.e. the mg_lsf_box tag), lsf_cc [n, C] (cell-centered lsf),
        bc_coeff [n, C] (per-cell boundary-potential multiplier), ids [n]
        (the level's boxes, or rows, as the multigrid's level arrays hold
        them: MeshPlans.level_rows), n_own (how many of them come first
        and are the level's id list, the rank's own boxes)."""
        def make():
            # a level's fingerprint also changes with the leaf status of
            # its boxes; the distances depend on their positions only
            t = self.tree
            ids = np.asarray(self.mesh.level_rows(lvl), np.int64)
            n_own = len(t.lvl_ids[lvl - 1])
            where = hashlib.blake2b(
                ids.tobytes() + t.ix[ids].tobytes()
                + np.int64(n_own).tobytes(), digest_size=16).digest()
            hit = self._by_position.get(lvl)
            if hit is None or hit[0] != where:
                t0 = time.perf_counter()
                hit = (where, dict(self._level_data(lvl, ids), n_own=n_own))
                self._by_position[lvl] = hit
                self.build_seconds += time.perf_counter() - t0
            return hit[1]
        return self.mesh.cached(("lsf", self, lvl), make, (lvl,))

    def whole(self) -> "LsfData":
        """The same level set on the whole tree (mesh.full): itself when
        unsharded; in a sharded run a twin that every rank holds, for the
        level-1 operator of the dense coarse solve."""
        if self.mesh.full is self.mesh:
            return self
        if self._whole is None:
            self._whole = LsfData(
                self.mesh.full, self.lsf, self.length_scale, self.dist_mode,
                self.tol, self.min_rel_distance, self.safety,
                self.boundary_coeff_fn)
        return self._whole

    def _level_data(self, lvl: int, ids: np.ndarray):
        t = self.tree
        nc, ndim = t.nc, t.ndim
        n = len(ids)
        C = nc ** ndim
        dr = t.lvl_dr(lvl)
        dmax = float(np.linalg.norm(dr))
        min_dr = float(dr.min())

        # cell centers [n, C, ndim]
        r0 = t.box_r_min(ids)
        axes = [np.arange(nc) + 0.5 for _ in range(ndim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        local = np.stack([m.ravel() for m in mesh], -1) * dr  # [C, ndim]
        coords = r0[:, None, :] + local[None, :, :]
        flat = coords.reshape(-1, ndim)

        lsf_cc = self.lsf(flat).reshape(n, C)
        grad = numerical_gradient(self.lsf, flat)
        gradnorm = np.linalg.norm(grad, axis=-1).reshape(n, C)
        root_mask = np.abs(lsf_cc) < dmax * gradnorm * self.safety

        dd = np.ones((n, C, 2 * ndim))
        dd_flat = dd.reshape(-1, 2 * ndim)
        pts = np.nonzero(root_mask.reshape(-1))[0]
        if len(pts):
            a = flat[pts]
            for d in range(2 * ndim):
                dim = d // 2
                b = a.copy()
                b[:, dim] += (-dr[dim] if d % 2 == 0 else dr[dim])
                dd_flat[pts, d] = self._dist(a, b)

            # gradient-descent fallback for under-resolved electrodes
            # (store_lsf_distance_matrix :1044-1075)
            if ndim > 1 and min_dr > self.length_scale:
                no_bnd = np.all(dd_flat[pts] >= 1, axis=1)
                if no_bnd.any():
                    sel = pts[no_bnd]
                    a2 = flat[sel]
                    lsf_a = lsf_cc.reshape(-1)[sel]
                    n_steps = int(np.ceil(min_dr / self.length_scale))
                    x = a2.copy()
                    found = np.zeros(len(sel), dtype=bool)
                    step = np.sign(lsf_a) * self.length_scale
                    for _ in range(n_steps):
                        g = numerical_gradient(self.lsf, x)
                        gn = np.maximum(np.linalg.norm(g, axis=-1), 1e-50)
                        x_new = x - g / gn[:, None] * step[:, None]
                        x = np.where(found[:, None], x, x_new)
                        found = found | (self.lsf(x) * lsf_a <= 0)
                    dist = self._dist(a2, x)
                    has = dist < 1
                    if has.any():
                        dvec = x - a2
                        scale = (np.linalg.norm(dvec, axis=-1) / min_dr)
                        dist2 = dist * scale
                        dim_sel = np.argmax(np.abs(dvec), axis=-1)
                        nb = 2 * dim_sel + (dvec[np.arange(len(sel)),
                                                 dim_sel] > 0)
                        dd_flat[sel[has], nb[has]] = dist2[has]

        has_bnd = np.any(dd < 1.0, axis=(1, 2))
        if self.boundary_coeff_fn is not None:
            bc_coeff = self.boundary_coeff_fn(flat).reshape(n, C)
        else:
            bc_coeff = np.ones((n, C))
        return dict(dd=dd, has_bnd=has_bnd, lsf_cc=lsf_cc, bc_coeff=bc_coeff,
                    ids=ids)

    def box_has_boundary(self, ids) -> np.ndarray:
        """The mg_lsf_box tag for boxes ``ids`` of the tree (of any
        levels); in a sharded run every rank tags its own boxes among
        them (MeshPlans.map_boxes)."""
        return self.mesh.map_boxes(ids, lambda rows, _sel: self._has_bnd(
            rows))

    def _has_bnd(self, rows) -> np.ndarray:
        """The mg_lsf_box tag of state rows ``rows``."""
        t = self.tree
        rows = np.asarray(rows, np.int64)
        lvls = t.lvl[rows]
        out = np.zeros(len(rows), dtype=bool)
        pos = np.empty(int(t.highest_id) + 1, np.int64)
        for lvl in np.unique(lvls):
            data = self.level_data(int(lvl))
            pos[data["ids"]] = np.arange(len(data["ids"]))
            sel = lvls == lvl
            out[sel] = data["has_bnd"][pos[rows[sel]]]
        return out


def lsf_stencil_coefficients(tree, lvl: int, data, lam: float = 0.0):
    """Variable 3/5/7-point stencil from boundary distances
    (mg_box_lsf_stencil, ``m_af_multigrid.f90:1762-1834``).

    Returns (c0 [n, C], c_nb list of [n, C], f [n, C]) with eliminated
    boundary couplings moved into f (rhs correction factor)."""
    nc, ndim = tree.nc, tree.ndim
    dr = tree.lvl_dr(lvl)
    dd = data["dd"]  # [n, C, 2*ndim]
    n, C = dd.shape[:2]
    c_nb = []
    for d in range(2 * ndim):
        dim = d // 2
        other = d ^ 1
        c = 1.0 / (0.5 * dr[dim] ** 2 * (dd[:, :, d] + dd[:, :, other])
                   * dd[:, :, d])
        c_nb.append(c)
    if tree.coord == "cyl":
        # cylindrical 1/r d/dr correction (:1797-1805)
        ids = data["ids"]
        r0 = tree.box_r_min(ids)[:, 0]
        i = np.arange(1, nc + 1)
        r_cc = r0[:, None] + (i[None, :] - 0.5) * dr[0]
        r_full = np.repeat(r_cc[:, :, None], nc, 2).reshape(n, C)
        tmp = 1.0 / (dr[0] * (dd[:, :, 0] + dd[:, :, 1]) * r_full)
        c_nb[0] = c_nb[0] - tmp
        c_nb[1] = c_nb[1] + tmp
    c0 = -sum(c_nb) - lam
    f = np.zeros((n, C))
    for d in range(2 * ndim):
        bnd = dd[:, :, d] < 1.0
        f = f - np.where(bnd, c_nb[d], 0.0)
        c_nb[d] = np.where(bnd, 0.0, c_nb[d])
    return c0, c_nb, f
