"""Monte-Carlo photoionization.

Port of the JAX package's ``physics/photoi_mc.py`` (the reference's
``src/m_photoi_mc.f90``): the Zheleznyak absorption function for air
(phmc_absorption_func_air ``:232-252``), the tabulated inverse CDF of the
absorption distance built with RK4 integration (phmc_get_table_air
``:122-195``), photon budgeting between physical photons of weight
``photoi_mc%min_weight`` and at most ``photoi_mc%num_photons`` super-photons
(``:427-447``), stochastic photon generation per leaf cell with cylindrical
volume weighting (phmc_generate_photons ``:686-801``), isotropic flight with
a table-sampled distance (phmc_do_absorption ``:287-330``), and deposition
on a constant or distance-adaptive level followed by an additive
prolongation up the tree (phmc_set_src ``:379-581``).

The photons are made on the host from the JAX package's NumPy stream
(``np.random.default_rng``, seeded as there), with the same draws in the
same order and with the same shapes, so that both packages give the same
photons. The host receives the leaves' source rows once per update and sends
back the photons' boxes and cells; the clearing of the photo row, the
deposit and the prolongation run on the state's device. The locate of the
absorption points is vectorised: per level a sorted table of the boxes'
integer positions, searched for all pending photons at once.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import constants as uc
from ..core import ghostcell as gc
from ..core import prolong_restrict as pr
from ..core import rowops as ro
from ..core import spatial as sp
from ..utils.lookup_table import LookupTable

#: stages of one update, in order, whose seconds ``PhotoiMC.timings`` holds
STAGES = ("generate", "locate", "copy", "deposit", "prolong")


def absorption_func_air(dist, p_O2):
    """Zheleznyak absorption function (phmc_absorption_func_air)."""
    c0 = 3.5 / uc.torr_to_bar
    c1 = 200.0 / uc.torr_to_bar
    eps = np.finfo(np.float64).eps
    r = p_O2 * dist
    small = r * (c0 + c1) < eps
    huge = r * c0 > -np.log(eps)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        main = (np.exp(-c0 * r) - np.exp(-c1 * r)) / (dist * np.log(c1 / c0))
    limit0 = (c1 - c0 + 0.5 * (c0**2 - c1**2) * r) * p_O2 / np.log(c1 / c0)
    return np.where(small, limit0, np.where(huge, eps, main))


def get_table_air(p_O2: float, max_dist: float, absorp_fac: float,
                  frac_is_one: bool = False):
    """The inverse CDF r(F) of the absorption distance by RK4
    (phmc_get_table_air) and the fraction of photons it covers."""
    tbl_size = 500

    def rk4_drdF(r, dF):
        d1 = 1.0 / absorption_func_air(np.asarray(r), p_O2)
        d2 = 1.0 / absorption_func_air(np.asarray(r + 0.5 * dF * d1), p_O2)
        d3 = 1.0 / absorption_func_air(np.asarray(r + 0.5 * dF * d2), p_O2)
        d4 = 1.0 / absorption_func_air(np.asarray(r + dF * d3), p_O2)
        return (d1 + 2 * d2 + 2 * d3 + d4) / 6.0

    Fmax = 1.0
    for _ in range(5):
        dF = Fmax / (tbl_size - 1)
        r = 0.0
        F = 0.0
        while True:
            r += dF * float(rk4_drdF(r, dF))
            F += dF
            if r > max_dist:
                Fmax = F
                break
    dF = Fmax / (tbl_size - 1)
    fsum = [0.0]
    dist = [0.0]
    for _n in range(1, 2 * tbl_size):
        drdF = float(rk4_drdF(dist[-1], dF))
        fsum.append(fsum[-1] + dF)
        dist.append(dist[-1] + dF * drdF)
        if dist[-1] > max_dist:
            break
    fsum = np.asarray(fsum)
    dist = np.asarray(dist)
    if frac_is_one:
        frac_in_tbl = 1.0
    else:
        frac_in_tbl = fsum[-2]
        fsum = fsum / frac_in_tbl
    tbl = LookupTable(0.0, 1.0, tbl_size, 1)
    tbl.set_col(0, fsum[:-1], dist[:-1])
    return tbl, float(frac_in_tbl)


def floor_div(a: np.ndarray, b) -> np.ndarray:
    """``a // b`` as NumPy computes it for floats (from fmod), faster:
    floor(a / b), except where a / b rounds to an integer, the only
    points where the two can differ (a photon on a box face)."""
    r = a / b
    q = np.floor(r)
    edge = r == q
    if edge.any():
        q[edge] = a[edge] // np.broadcast_to(b, a.shape)[edge]
    return q


class PhotoiMC:
    """The Monte-Carlo photoionization of one simulation."""

    def __init__(self, cfg, mesh, gas, settings, rng_seed: int = 0):
        self.mesh = mesh
        #: the whole tree: in a sharded run every rank makes, flies and
        #: locates every photon, and deposits those in its own boxes
        self.tree = mesh.full.tree
        self.gas = gas
        #: physics/dielectric.Dielectric, wired by the driver with
        #: dielectrics; it intercepts the photons that cross a surface
        self.dielectric = None
        self.physical_photons = cfg.add_get(
            "photoi_mc%physical_photons", True,
            "Whether physical photons are used")
        self.min_weight = cfg.add_get(
            "photoi_mc%min_weight", 1.0, "Minimal photon weight")
        self.const_dx = cfg.add_get(
            "photoi_mc%const_dx", True,
            "Whether a constant grid spacing is used for photoionization")
        self.min_dx = cfg.add_get("photoi_mc%min_dx", 1e-9,
                                  "Minimum grid spacing for photoionization")
        self.absorp_fac = cfg.add_get(
            "photoi_mc%absorp_fac", 0.25,
            "At which grid spacing photons are absorbed compared to their "
            "mean distance")
        self.num_photons = cfg.add_get(
            "photoi_mc%num_photons", 5000 * 1000,
            "Maximum number of discrete photons to use")
        ix = gas.index("O2")
        if ix < 0:
            raise ValueError("Photoionization: no oxygen present")
        self.tbl, self.frac_in_tbl = get_table_air(
            gas.fractions[ix] * gas.pressure,
            2 * float(np.max(settings.domain_len)), self.absorp_fac,
            frac_is_one=settings.use_dielectric)
        self.rng = np.random.default_rng(int(abs(int(rng_seed))))
        #: photons made (before the dielectric takes its share) and
        #: deposited in the last update
        self.n_photons = 0
        self.n_deposited = 0
        #: seconds of each stage (STAGES) of the last update; with
        #: ``sync_stages`` the device is synchronised at each stage's end
        self.timings: Dict[str, float] = {}
        self.sync_stages = False

    # ------------------------------------------------------------ locate
    def _level_keys(self, lvl: int):
        """Sorted integer keys of a level's box positions and the ids in
        that order, rebuilt when the level changes."""
        t = self.tree

        def make():
            ids = np.asarray(t.lvl_ids[lvl - 1], np.int64)
            nb = t.n_boxes_lvl(lvl).astype(np.int64)
            keys = np.ravel_multi_index(tuple(t.ix[ids].T), tuple(nb))
            order = np.argsort(keys, kind="stable")
            return keys[order], ids[order]
        return self.mesh.full.cached(("mc_keys", lvl), make, (lvl,))

    def locate(self, pos: np.ndarray, lvl_target):
        """af_get_loc for many points: (box id, flat cell index in the
        (nc+2)^ndim layout) at the deepest existing box of a level of at
        most ``min(lvl_target, highest_lvl)`` per point, which need not be
        a leaf; id -1 outside the domain. Vectorised over the points, level
        by level, with NumPy's floor division as in the JAX package
        (floor_div)."""
        t = self.tree
        ndim, nc = t.ndim, t.nc
        n = len(pos)
        ids = np.full(n, -1, np.int64)
        cells = np.zeros(n, np.int64)
        lvls = (np.full(n, lvl_target, np.int64) if np.isscalar(lvl_target)
                else np.asarray(lvl_target, np.int64).copy())
        lvls = np.minimum(lvls, t.highest_lvl)
        inside = np.all((pos >= t.r_base)
                        & (pos < t.r_base + t.domain_len), axis=1)
        pending = np.nonzero(inside & (lvls >= 1))[0]
        cur = lvls[pending]
        while len(pending):
            found = np.zeros(len(pending), bool)
            uniform = cur.min() == cur.max()
            for lvl in (cur[:1] if uniform else np.unique(cur)[::-1]):
                sel = (np.arange(len(cur)) if uniform
                       else np.nonzero(cur == lvl)[0])
                p = pos[pending[sel]]
                dr = t.lvl_dr(int(lvl))
                bix = floor_div(p - t.r_base, nc * dr).astype(np.int64)
                nb = t.n_boxes_lvl(int(lvl)).astype(np.int64)
                valid = np.all((bix >= 0) & (bix < nb), axis=1)
                keys, kid = self._level_keys(int(lvl))
                q = np.ravel_multi_index(tuple(np.where(valid[:, None], bix,
                                                        0).T), tuple(nb))
                at = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
                hit = valid & (keys[at] == q) if len(keys) else \
                    np.zeros(len(q), bool)
                sel, p, bid = sel[hit], p[hit], kid[at[hit]]
                # the box's minimum corner, as Tree.box_r_min computes it
                r0 = t.r_base + bix[hit] * nc * dr
                cell = np.clip(floor_div(p - r0, dr).astype(np.int64), 0,
                               nc - 1)
                ids[pending[sel]] = bid
                cells[pending[sel]] = sp.cc_flat_nd(ndim, nc, cell + 1)
                found[sel] = True
            cur = cur[~found] - 1
            pending = pending[~found]
            keep = cur >= 1
            cur, pending = cur[keep], pending[keep]
        return ids, cells

    # ------------------------------------------------------------ update
    def _mark(self, name: str, t0: float, device) -> float:
        if self.sync_stages and device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + (t1 - t0)
        return t1

    def _box_tables(self, device):
        """Per box id: the cell volume, the minimum r and the cell size in
        r, on the device (the deposit's weights)."""
        t = self.tree

        def make():
            n = t.highest_id
            lv = t.lvl[:n].astype(np.float64)
            dr_all = t.dr_base[None, :] / (2.0 ** (lv - 1))[:, None]
            return sp.device_copy(dict(
                vol=np.prod(dr_all, axis=1), dr0=dr_all[:, 0],
                r0=t.r_base[0] + t.ix[:n, 0] * t.nc * dr_all[:, 0]), device)
        return self.mesh.full.cached("mc_boxes", make)

    def _leaf_rates(self, cc, i_src, lvls):
        """The source rates of every leaf's interior cells per level of
        ``lvls`` (in the tree's leaf order, on the state's device) and
        their volume integral, as red.tree_sum_cc adds it up. In a sharded
        run the rates come from every rank (MeshPlans.map_boxes) and every
        rank sums all of them as one process would, so that every rank
        draws the same photons."""
        t, mesh = self.tree, self.mesh
        nc, ndim = t.nc, t.ndim
        dev = cc.device
        if mesh.layout is None:
            vals = [ro.cc_get_interior(cc, i_src, mesh.tb(l).d.leaves, nc,
                                       ndim) for l in lvls]
        else:
            vals = [torch.as_tensor(mesh.map_boxes(
                t.lvl_leaves[l - 1], lambda rows, _sel: ro.cc_get_interior(
                    cc, i_src, torch.as_tensor(rows, device=dev), nc, ndim)
                .cpu().numpy()), device=dev) for l in lvls]
        sums = [(v * mesh.full.tb(l).d.two_pi_r.to(v.dtype)
                 if t.coord == "cyl" else v).sum() for l, v in zip(lvls, vals)]
        total = 0.0
        for l, s in zip(lvls, torch.stack(sums).cpu().tolist() if sums
                        else []):
            total += float(np.prod(t.lvl_dr(l))) * s
        return vals, total

    def _clear_photo(self, cc, i_photo):
        cc[i_photo, self.mesh.all_ids()] = 0.0
        return cc

    def set_src(self, photoi, cc, dt: Optional[float], params):
        """phmc_set_src (``m_photoi_mc.f90:379-581``): photons from the
        source in ``photoi.i_rhs``, absorbed into ``photoi.i_photo``."""
        t, mesh = self.tree, self.mesh
        nc, ndim = t.nc, t.ndim
        cyl = t.coord == "cyl"
        i_src, i_photo = photoi.i_rhs, photoi.i_photo
        device = cc.device
        self.timings = {}
        self.n_photons = self.n_deposited = 0
        t0 = time.perf_counter()

        if self.dielectric is not None:
            # clear the surfaces' photon fluxes (m_photoi_mc.f90:415)
            cc = self.dielectric.reset_photons(cc)

        lvls = [l for l in range(1, t.highest_lvl + 1)
                if len(t.lvl_leaves[l - 1])]
        vals, sum_rate = self._leaf_rates(cc, i_src, lvls)
        small = 1e-100
        if dt is not None and self.physical_photons:
            n_produced = dt * sum_rate / self.min_weight
            if n_produced < self.num_photons:
                dt_fac = dt / self.min_weight
            else:
                dt_fac = self.num_photons / (sum_rate + small)
        else:
            dt_fac = self.num_photons / (sum_rate + small)

        # ---- photons per leaf cell (phmc_generate_photons); the rates of
        # all leaves come to the host in one copy
        rates = torch.cat(vals).to(torch.float64).cpu().numpy()
        src_list, start = [], 0
        for lvl in lvls:
            leaves = np.asarray(t.lvl_leaves[lvl - 1])
            dr = t.lvl_dr(lvl)
            n = len(leaves)
            rate = rates[start:start + n]
            start += n
            if cyl:
                r0 = t.box_r_min(leaves)[:, 0]
                i = np.arange(1, nc + 1)
                r_cc = r0[:, None] + (i[None, :] - 0.5) * dr[0]
                w = 2 * np.pi * np.repeat(r_cc[:, :, None], nc, 2
                                          ).reshape(n, -1)
                tmp = dt_fac * w * rate * np.prod(dr)
            else:
                tmp = dt_fac * rate * np.prod(dr)
            n_create = np.floor(tmp).astype(np.int64)
            n_create += (self.rng.random(tmp.shape) < tmp - n_create)
            total = int(n_create.sum())
            if total == 0:
                continue
            box_idx, cell_idx = np.nonzero(n_create)
            reps = n_create[box_idx, cell_idx]
            cell_nd = np.stack(np.unravel_index(cell_idx, (nc,) * ndim), -1)
            corner = t.box_r_min(leaves[box_idx]) + cell_nd * dr
            corner = np.repeat(corner, reps, axis=0)
            u = self.rng.random((total, ndim))
            src_list.append(corner + u * dr)
        if not src_list:
            self._mark("generate", t0, device)
            return self._clear_photo(cc, i_photo)
        xyz = np.concatenate(src_list, axis=0)
        n_used = len(xyz)
        self.n_photons = n_used

        # ---- isotropic flight with a sampled distance
        # (phmc_do_absorption)
        rr = self.rng.random(n_used)
        dist = self.tbl.host_col(0, rr)
        v = self.rng.normal(size=(n_used, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        if cyl:
            # (r, z) -> (x = r, y = z, 0); fly in 3D; back to
            # (sqrt(x^2 + z^2), y)
            p3 = np.zeros((n_used, 3))
            p3[:, 0] = xyz[:, 0]
            p3[:, 1] = xyz[:, 1]
            p3 = p3 + dist[:, None] * v
            abs_pos = np.stack(
                [np.sqrt(p3[:, 0] ** 2 + p3[:, 2] ** 2), p3[:, 1]], axis=1)
        else:
            abs_pos = xyz + dist[:, None] * v[:, :ndim]

        # ---- photons that hit a dielectric surface are absorbed there
        # (m_photoi_mc.f90:466-482)
        if self.dielectric is not None:
            cc, absorbed = self.dielectric.photon_absorption(
                cc, xyz, abs_pos, 1.0 / dt_fac)
            if absorbed.any():
                keep = ~absorbed
                xyz, abs_pos = xyz[keep], abs_pos[keep]
                n_used = len(xyz)
                if n_used == 0:
                    self._mark("generate", t0, device)
                    return self._clear_photo(cc, i_photo)

        # ---- the absorption level
        if self.const_dx:
            lengthscale = float(self.tbl.host_col(0, self.absorp_fac))
            ratio = float(np.max(t.dr_base)) / lengthscale
            pho_lvl = 1 if ratio <= 1 else 1 + int(np.ceil(np.log2(ratio)))
            lvl_target = pho_lvl
        else:
            d = self.absorp_fac * np.linalg.norm(abs_pos - xyz, axis=1)
            d = np.maximum(d, self.min_dx)
            ratio = np.max(t.dr_base) / d
            tmp_l = np.where(ratio <= 1, 1.0, np.log2(np.maximum(ratio, 1)))
            base = np.floor(tmp_l)
            frac = tmp_l - base
            # the JAX package draws a level between base and base + 1,
            # then takes 1 + base: the draw is consumed and overwritten
            lvl_target = (base + (self.rng.random(n_used) < frac)
                          ).astype(np.int64)
            lvl_target = np.maximum(np.where(ratio <= 1, 1, 1 + base), 1
                                    ).astype(np.int64)
            pho_lvl = 1
        t0 = self._mark("generate", t0, device)
        ids, cells = self.locate(abs_pos, lvl_target)
        ok = ids >= 0
        self.n_deposited = int(np.sum(ok))
        if mesh.layout is not None:
            # the photons in this rank's boxes
            ok[ok] = mesh.layout.own_rows(ids[ok])[0]
        idsk = ids[ok].astype(np.int32)
        cellsk = cells[ok].astype(np.int32)
        rows = (idsk if mesh.layout is None
                else mesh.layout.row_of[idsk].astype(np.int32))
        t0 = self._mark("locate", t0, device)

        idsk = torch.as_tensor(idsk).to(device).long()
        rows = torch.as_tensor(rows).to(device).long()
        cellsk = torch.as_tensor(cellsk).to(device).long()
        t0 = self._mark("copy", t0, device)

        # ---- deposit frac_in_tbl / (dt_fac vol), over 2 pi r in
        # cylindrical coordinates, on the device
        cc = self._clear_photo(cc, i_photo)
        if len(idsk):
            bt = self._box_tables(device)
            w = self.frac_in_tbl / (dt_fac * bt.vol[idsk])
            if cyl:
                ci = torch.div(cellsk, (nc + 2) ** (ndim - 1),
                               rounding_mode="floor") - 1
                r_dep = bt.r0[idsk] + (ci + 0.5) * bt.dr0[idsk]
                w = w / (2 * np.pi * r_dep)
            cc[i_photo].index_put_((rows, cellsk), w.to(cc.dtype),
                                   accumulate=True)
        t0 = self._mark("deposit", t0, device)

        # ---- prolong up the tree, the ghost cells filled in between
        min_lvl = pho_lvl if self.const_dx else 1
        for lvl in range(min_lvl, t.highest_lvl):
            cc = gc.fill_ghosts_lvl(
                cc, mesh.gc(lvl), [i_photo], gc.RB_INTERP,
                lambda iv, d, c, p: (gc.BC_NEUMANN, 0.0), params or {})
            cc = pr.prolong(cc, mesh.pr(lvl + 1), [i_photo], "linear",
                            add=True)
        self._mark("prolong", t0, device)
        return cc
