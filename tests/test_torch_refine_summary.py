"""The refinement criterion's flags built on the device and reduced there
to one summary per box (afivo_streamer_tpu_torch/physics/refine.py,
core/tree.box_flag_summary), against a frozen copy of the per-cell host
path that it replaced (``frozen_*`` below: the alpha*dx codes read to the
host, the seed, electrode, region, limit and clamp rules on int64 flags,
and consistent_ref_flags scanning every box's cells):

* on refined 1D, 2D, cylindrical and 3D trees of boxes of 8 cells with
  buffer widths 0, 2 and 4 (4 puts the centre cell in a strip), the seed
  rule selecting some boxes or none, every box rule on, float32 and
  float64: ``cell_flags`` equals the frozen flags exactly, the device
  summary equals ``box_flag_summary`` of them, and
  ``Tree._consistent_ref_flags`` on the summary gives the frozen flags
  dict; each box rule alone the same way;
* ``box_flag_summary`` bit for bit against a scan of each box's edge
  strips, and its refusal of values that are no flag;
* whole epochs of a small live-refinement run (the cylindrical slice with
  the alpha*dx criterion, the seed rule and an expiring region on, and the
  same with a user ``refine`` hook): at every epoch the same flags dict
  and the same mesh as the frozen per-cell path;
* the device summary on the card (marker ``gpu``) equal to the CPU's.

No JAX is imported: the ``gpu`` case runs on a machine with PyTorch alone.
"""

import copy
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from afivo_streamer_tpu_torch import constants as uc
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import (
    DO_REF, KEEP_REF, MAX_LVL, RM_REF, Tree, box_flag_summary,
    neighbour_offsets)
from afivo_streamer_tpu_torch.driver import Simulation
from afivo_streamer_tpu_torch.physics.refine import (RefineCriterion,
                                                     RefineSettings)
from afivo_streamer_tpu_torch.physics.transport_data import TD_ALPHA, TD_ETA
from afivo_streamer_tpu_torch.utils import geometry
from afivo_streamer_tpu_torch.utils.config import CFG

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
NC = 8
GEOMETRIES = ["1d", "2d", "cyl", "3d"]


# ------------------------------------------------ the frozen per-cell path
def frozen_alpha_dx_codes(crit, cc, ids, max_dx):
    """The alpha*dx codes per cell (1 refine, 2 derefine, 0 keep), int8
    on the host."""
    t, rs = crit.tree, crit.rs
    nc, ndim = t.nc, t.ndim
    dev = cc.device
    idx = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    inner = (slice(None),) + (slice(1, nc + 1),) * ndim
    shape = (len(ids),) + (nc + 2,) * ndim
    fld = cc[crit.i_electric_fld, idx].reshape(shape)[inner]
    elec = cc[crit.i_electron, idx].reshape(shape)[inner]
    gas_dens = crit.gas.number_density
    fld_td = fld * uc.SI_to_Townsend / gas_dens
    alpha = crit.td.tbl.get_col(TD_ALPHA, rs.adx_fac * fld_td)
    if rs.use_alpha_effective:
        alpha = torch.clamp(
            alpha - crit.td.tbl.get_col(TD_ETA, rs.adx_fac * fld_td),
            min=0.0)
    alpha = alpha * gas_dens / rs.adx_fac
    mdx = torch.as_tensor(max_dx, dtype=cc.dtype, device=dev).reshape(
        (-1,) + (1,) * ndim)
    adx = alpha * mdx
    ref = (adx > rs.adx) & (elec > rs.min_dens)
    rm = (adx < 0.125 * rs.adx) & (mdx < rs.derefine_dx) & ~ref
    return (ref.to(torch.int8) + 2 * rm.to(torch.int8)).cpu().numpy()


def frozen_cell_flags(crit, cc, ids):
    """default_refinement on int64 flags on the host."""
    t, rs = crit.tree, crit.rs
    nc, ndim = t.nc, t.ndim
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    shape = (n,) + (nc,) * ndim
    bshape = (n,) + (1,) * ndim
    lvls = t.lvl[ids]
    drs = t.dr_base[None, :] / 2.0 ** (lvls[:, None] - 1.0)
    max_dx, min_dx = drs.max(axis=1), drs.min(axis=1)

    code = frozen_alpha_dx_codes(crit, cc, ids, max_dx)
    flags = np.full(shape, KEEP_REF, dtype=np.int64)
    flags[code == 1] = DO_REF
    flags[code == 2] = RM_REF

    if crit.time < rs.init_time and crit.ic is not None and crit.ic.n_cond:
        rmin = t.box_r_min(ids)
        axes = np.stack(np.meshgrid(
            *[np.arange(nc)] * ndim, indexing="ij"),
            axis=-1).reshape(-1, ndim)
        coords = rmin[:, None, :] + (axes[None] + 0.5) * drs[:, None, :]
        for s in range(crit.ic.n_cond):
            w = crit.ic.seed_width[s]
            sel = max_dx > rs.init_fac * w
            if not sel.any():
                continue
            dv, _ = geometry.dist_vec_line(
                coords[sel].reshape(-1, ndim), crit.ic.seed_r0[s],
                crit.ic.seed_r1[s])
            dist = np.sqrt(np.sum(dv ** 2, axis=-1)).reshape(
                (int(sel.sum()),) + (nc,) * ndim)
            flags[sel] = np.where(
                dist - w < 2 * max_dx[sel].reshape((-1,) + (1,) * ndim),
                DO_REF, flags[sel])

    if crit.lsf_data is not None:
        hit = (crit.lsf_data.box_has_boundary(ids)
               & (max_dx > crit.current_electrode_dx))
        flags[hit] = DO_REF

    rmin = t.box_r_min(ids)
    rmax = rmin + drs * nc
    reg_min = rs.regions_rmin.reshape(-1, ndim)
    reg_max = rs.regions_rmax.reshape(-1, ndim)
    center = (slice(None),) + (nc // 2,) * ndim
    for k in range(min(len(rs.regions_dr), reg_min.shape[0])):
        hit = ((crit.time <= rs.regions_tstop[k])
               & (max_dx > rs.regions_dr[k])
               & np.all(rmax >= reg_min[k], axis=1)
               & np.all(rmin <= reg_max[k], axis=1))
        flags[center] = np.where(hit, DO_REF, flags[center])
    lim_min = rs.limits_rmin.reshape(-1, ndim)
    lim_max = rs.limits_rmax.reshape(-1, ndim)
    for k in range(min(len(rs.limits_dr), lim_min.shape[0])):
        hit = ((max_dx < 2 * rs.limits_dr[k])
               & np.all(rmin >= lim_min[k], axis=1)
               & np.all(rmax <= lim_max[k], axis=1)).reshape(bshape)
        flags = np.where(hit & (flags == DO_REF), KEEP_REF, flags)

    too_coarse = max_dx > rs.max_dx
    too_fine = (min_dx < 2 * rs.min_dx) & ~too_coarse
    flags = np.where(too_coarse.reshape(bshape), DO_REF, flags)
    flags = np.where(too_fine.reshape(bshape) & (flags == DO_REF),
                     KEEP_REF, flags)
    return flags


def frozen_consistent_ref_flags(tree, cell_flag_fn, ref_buffer, ref_links):
    """consistent_ref_flags scanning every box's cells."""
    flags = {}
    eval_ids = tree.criterion_eval_ids()
    if len(eval_ids) == 0:
        return flags
    cell_flags = np.asarray(cell_flag_fn(eval_ids))

    def bump(bid, val):
        flags[bid] = max(flags.get(bid, -10**9), val)

    cf_flat = cell_flags.reshape(len(eval_ids), -1)
    if cf_flat.min() < RM_REF or cf_flat.max() > DO_REF:
        raise ValueError("invalid cell flags")
    any_do = (cf_flat == DO_REF).any(axis=1)
    any_keep = (cf_flat == KEEP_REF).any(axis=1)
    for n, bid in enumerate(eval_ids):
        bid = int(bid)
        cf = cell_flags[n]
        if any_do[n]:
            flags[bid] = DO_REF
        elif any_keep[n]:
            bump(bid, KEEP_REF)
        else:
            bump(bid, RM_REF)
        if ref_buffer > 0 and any_do[n]:
            for off in neighbour_offsets(tree.ndim):
                nb_id = tree.neighbor_mat(bid, off)
                if nb_id < 0:
                    continue
                sl = []
                for o in off:
                    if o == 1:
                        sl.append(slice(tree.nc - ref_buffer, tree.nc))
                    elif o == -1:
                        sl.append(slice(0, ref_buffer))
                    else:
                        sl.append(slice(None))
                if np.any(cf[tuple(sl)] == DO_REF):
                    flags[nb_id] = DO_REF
    out = {bid: flags.get(int(bid), KEEP_REF)
           for bid in np.nonzero(tree.in_use[:tree.highest_id])[0]}
    for bid, v in out.items():
        if v == DO_REF and tree.lvl[bid] >= MAX_LVL:
            out[bid] = KEEP_REF
    tree._ensure_two_one_balance(out)
    tree._handle_derefinement_flags(out)
    if ref_links is not None and len(ref_links):
        for pair in np.asarray(ref_links).reshape(-1, 2):
            m = max(out.get(int(pair[0]), KEEP_REF),
                    out.get(int(pair[1]), KEEP_REF))
            out[int(pair[0])] = m
            out[int(pair[1])] = m
        tree._ensure_two_one_balance(out)
        tree._handle_derefinement_flags(out)
    return out


# ------------------------------------------------- a criterion from parts
class Table:
    """A transport table whose alpha is its argument (eta a quarter)."""

    def get_col(self, col, x):
        return x * (1.0 if col == TD_ALPHA else 0.25)


class Electrode:
    """An electrode whose boundary lies in every third box."""

    def box_has_boundary(self, ids):
        return np.asarray(ids) % 3 == 0


def make_tree(geometry_name):
    """Boxes of 8 cells on [0, 1]^ndim, 32 cells per dimension at level 1
    (16 in 3D), refined twice where the box corner lies below 0.45."""
    ndim = {"1d": 1, "2d": 2, "cyl": 2, "3d": 3}[geometry_name]
    cells = 16 if ndim == 3 else 32
    t = Tree(ndim, NC, [1.0] * ndim, [cells] * ndim,
             coord="cyl" if geometry_name == "cyl" else "xyz")

    def flags(ids):
        out = np.full([len(ids)] + [NC] * ndim, KEEP_REF, np.int64)
        for n, b in enumerate(ids):
            r0 = t.box_r_min(np.asarray([int(b)]))[0] - t.r_base
            if np.all(r0 < 0.45) and t.lvl[int(b)] == t.highest_lvl:
                out[n] = DO_REF
        return out
    t.adjust_refinement(flags, ref_buffer=1)
    t.adjust_refinement(flags, ref_buffer=1)
    return t


def make_criterion(geometry_name, dtype, seed, rules, device="cpu"):
    """The default criterion on a refined tree with a field that puts
    alpha*dx between 0 and 2.5 and a random electron density; ``seed``
    'some' selects the level-1 and level-2 boxes, 'none' no box;
    ``rules`` names the box rules that are on."""
    t = make_tree(geometry_name)
    ndim = t.ndim
    rs = RefineSettings(CFG(), ndim)
    rs.adx, rs.derefine_dx, rs.min_dens = 1.0, 0.02, 1e15
    rs.max_dx, rs.min_dx = 1e99, 0.0
    rs.init_time, rs.init_fac = 1.0, 0.25
    lsf = None
    if "electrode" in rules:
        lsf = Electrode()
    if "region" in rules:
        rs.regions_dr = np.array([0.02])
        rs.regions_tstop = np.array([1.0])
        rs.regions_rmin = np.full(ndim, 0.3)
        rs.regions_rmax = np.full(ndim, 0.6)
    if "limit" in rules:
        rs.limits_dr = np.array([0.02])
        rs.limits_rmin = np.zeros(ndim)
        rs.limits_rmax = np.full(ndim, 0.5)
    if "clamps" in rules:
        # level 1 (dx 1/32, in 3D 1/16) too coarse, the finest too fine
        rs.max_dx, rs.min_dx = (0.02, 0.005) if ndim < 3 else (0.05, 0.01)
    if "alpha_effective" in rules:
        rs.use_alpha_effective = True
    widths = {"some": [0.2, 0.1], "none": [1.0, 0.8]}[seed]
    ic = SimpleNamespace(
        n_cond=2, seed_width=widths,
        seed_r0=[np.full(ndim, 0.2), np.full(ndim, 0.55)],
        seed_r1=[np.linspace(0.6, 0.5, ndim), np.full(ndim, 0.55)])
    mesh = MeshPlans(t, device, dtype=dtype)
    crit = RefineCriterion(rs, t, SimpleNamespace(tbl=Table()),
                           SimpleNamespace(number_density=1.0), ic, 0, 1,
                           mesh, lsf_data=lsf)
    crit.current_electrode_dx = 0.02
    rng = np.random.default_rng(5)
    n = t.highest_id
    dx = (t.dr_base[None, :] / 2.0 ** (t.lvl[:n, None] - 1.0)).max(axis=1)
    cells = (NC + 2) ** ndim
    u = rng.uniform(0.0, 2.5, (n, cells))
    cc = np.stack([u / (uc.SI_to_Townsend * dx[:, None]),
                   10.0 ** rng.uniform(13.0, 17.0, (n, cells))])
    return crit, torch.as_tensor(cc, dtype=dtype, device=device)


def check_criterion(crit, cc, ref_buffer):
    """cell_flags, the device summary and the consistent flags against
    the frozen path; returns the frozen flags."""
    t = crit.tree
    ids = t.criterion_eval_ids()
    want = frozen_cell_flags(crit, cc, ids)
    got = crit.cell_flags(cc, ids)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    summary = crit.box_summary(cc, ids, ref_buffer)
    np.testing.assert_array_equal(summary, box_flag_summary(want, ref_buffer))
    # no boxes, as a rank of a sharded run may hold among them
    assert crit.cell_flags(cc, ids[:0]).shape == (0,) + want.shape[1:]
    assert crit.box_summary(cc, ids[:0], ref_buffer).shape == (0,)
    assert (t._consistent_ref_flags(
        lambda i: crit.box_summary(cc, i, ref_buffer), ref_buffer, None)
        == frozen_consistent_ref_flags(
            t, lambda i: frozen_cell_flags(crit, cc, i), ref_buffer, None))
    return want


ALL_RULES = ("electrode", "region", "limit", "clamps")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", ["some", "none"])
@pytest.mark.parametrize("ref_buffer", [0, 2, 4])
@pytest.mark.parametrize("geometry_name", GEOMETRIES)
def test_device_flags_and_summary_match_the_host_path(geometry_name,
                                                      ref_buffer, seed,
                                                      dtype):
    crit, cc = make_criterion(geometry_name, dtype, seed, ALL_RULES)
    want = check_criterion(crit, cc, ref_buffer)
    assert {DO_REF, KEEP_REF} <= set(np.unique(want).tolist())
    t = crit.tree
    ids = t.criterion_eval_ids()
    max_dx = (t.dr_base[None, :]
              / 2.0 ** (t.lvl[ids][:, None] - 1.0)).max(axis=1)
    selected = np.sum(max_dx > crit.rs.init_fac * min(crit.ic.seed_width))
    assert (selected > 0) == (seed == "some")
    # three calls: cell_flags, box_summary, the consistent flags
    assert crit.mesh.tracer.counters["refine.seed_boxes"] == 3 * selected


@pytest.mark.parametrize("rules", [(), ("electrode",), ("region",),
                                   ("limit",), ("clamps",),
                                   ("alpha_effective",)],
                         ids=["none", "electrode", "region", "limit",
                              "clamps", "alpha_effective"])
@pytest.mark.parametrize("geometry_name", GEOMETRIES)
def test_each_box_rule_matches_the_host_path(geometry_name, rules):
    crit, cc = make_criterion(geometry_name, torch.float64, "some", rules)
    check_criterion(crit, cc, 2)


@pytest.mark.parametrize("ref_buffer", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_box_flag_summary_reads_the_strips(ndim, ref_buffer):
    """Bit 0 any DO_REF, bit 1 any KEEP_REF, then per neighbour offset
    whether its edge strip holds a DO_REF."""
    rng = np.random.default_rng(ndim + 10 * ref_buffer)
    n = 200
    shape = (n,) + (NC,) * ndim
    bshape = (n,) + (1,) * ndim
    # per box: KEEP_REF cells or none, DO_REF cells or none (a few, so
    # that strips with and without them occur), the rest RM_REF
    mode = rng.integers(0, 4, n).reshape(bshape)
    cf = np.where((mode & 1 > 0) & (rng.random(shape) < 0.1), KEEP_REF,
                  RM_REF)
    cf = np.where((mode & 2 > 0) & (rng.random(shape) < 2.0 / NC ** ndim),
                  DO_REF, cf)
    got = box_flag_summary(cf, ref_buffer)
    assert got.shape == (n,) and got.dtype == np.int64
    offsets = neighbour_offsets(ndim)
    assert len(offsets) == 3 ** ndim - 1
    seen = set()
    for b in range(n):
        want = (int(np.any(cf[b] == DO_REF))
                | int(np.any(cf[b] == KEEP_REF)) << 1)
        for k, off in enumerate(offsets):
            sl = tuple(slice(NC - ref_buffer, NC) if o == 1
                       else slice(0, ref_buffer) if o == -1 else slice(None)
                       for o in off)
            want |= int(np.any(cf[b][sl] == DO_REF)) << (2 + k)
        assert int(got[b]) == want, b
        seen.add(want)
    assert {0, 1, 2, 3} <= {v & 3 for v in seen}
    assert any(v >> 2 for v in seen) == (ref_buffer > 0)


def test_box_flag_summary_refuses_values_that_are_no_flag():
    cf = np.zeros((3, NC, NC), np.int64)
    cf[1, 2, 2] = 2
    with pytest.raises(ValueError, match="invalid cell flags"):
        box_flag_summary(cf, 2)
    cf[1, 2, 2] = -2
    with pytest.raises(ValueError, match="invalid cell flags"):
        box_flag_summary(cf, 2)


# ------------------------------------------------------------ whole epochs
def live_slice(tmp_path):
    """The cylindrical slice with the alpha*dx criterion and the seed rule
    on, and a refinement region that expires after the first epoch (the
    second removes its boxes)."""
    return Simulation(argv=[
        str(DATA / "air_cyl_slice.cfg"), "-ndim=2",
        f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
        "-output%dt=5e-14", "-refine_max_dx=2.5e-4", "-refine_min_dx=3e-5",
        "-refine_adx=1", "-refine_init_time=1e-8", "-refine_regions_dr=1e-4",
        "-refine_regions_tstop=5e-14", "-refine_regions_rmin=4e-3 2e-3",
        "-refine_regions_rmax=6e-3 4e-3",
        f"-output%name={tmp_path / 'run'}", "-device=cpu"])


def user_refine(s, cc, ids):
    """A user criterion: refine where the electron density is high,
    down to 1e-4 m, derefine where it is low."""
    ids = np.asarray(ids, np.int64)
    t = s.tree
    nc, ndim = t.nc, t.ndim
    ne = np.asarray(cc[s.i_electron][ids]).reshape(
        (len(ids),) + (nc + 2,) * ndim)[(slice(None),)
                                         + (slice(1, nc + 1),) * ndim]
    dx = t.dr_base[0] / 2.0 ** (t.lvl[ids] - 1.0)
    shape = (len(ids),) + (1,) * ndim
    flags = np.where(ne > 1e17, DO_REF, RM_REF)
    flags = np.where((ne > 1e14) & (flags != DO_REF), KEEP_REF, flags)
    return np.where((dx < 1e-4).reshape(shape) & (flags == DO_REF),
                    KEEP_REF, flags)


def check_epochs(sim, frozen_flags_fn):
    """Wrap ``sim.adjust_refinement`` so that every epoch checks its flags
    dict and its mesh against the frozen per-cell path; returns the list
    of the epochs' (additions, removals)."""
    orig = sim.adjust_refinement
    tree = sim.tree
    got = []
    consistent = tree._consistent_ref_flags

    def recorded(*args):
        out = consistent(*args)
        got.append(dict(out))
        return out
    tree._consistent_ref_flags = recorded
    changes = []

    def wrapped():
        sim.refiner.time = sim.global_time
        want = frozen_consistent_ref_flags(
            tree, frozen_flags_fn, sim.refine_cfg.buffer_width, None)
        twin = copy.deepcopy(tree)
        twin_info = twin._apply_flags(dict(want))
        n_got = len(got)
        info = orig()
        assert len(got) == n_got + 1
        assert got[-1] == want
        assert (info.added, info.removed) == (twin_info.added,
                                              twin_info.removed)
        n = tree.highest_id
        assert twin.highest_id == n
        for name in ("lvl", "ix", "parent", "children", "neighbors",
                     "in_use"):
            np.testing.assert_array_equal(getattr(twin, name)[:n],
                                          getattr(tree, name)[:n], name)
        for a, b in zip(twin.lvl_ids, tree.lvl_ids):
            np.testing.assert_array_equal(a, b)
        changes.append((info.n_add, info.n_rm))
        return info
    sim.adjust_refinement = wrapped
    return changes


def test_epochs_of_a_live_run_match_the_host_path(tmp_path):
    sim = live_slice(tmp_path)
    changes = check_epochs(
        sim, lambda ids: frozen_cell_flags(sim.refiner, sim.cc, ids))
    sim.run(max_steps=6)
    assert len(changes) == 3
    assert any(a + r for a, r in changes), "no epoch changed the mesh"
    assert sim.tracer.counters["refine.seed_boxes"] > 0


def test_epochs_with_a_user_refine_hook_match_the_host_path(tmp_path):
    sim = live_slice(tmp_path)
    sim.user.refine = user_refine
    changes = check_epochs(sim, sim._user_flags)
    sim.run(max_steps=6)
    assert len(changes) == 3
    assert any(a + r for a, r in changes), "no epoch changed the mesh"


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
def test_device_summary_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    crit, cc = make_criterion("2d", torch.float64, "some", ALL_RULES)
    ids = crit.tree.criterion_eval_ids()
    want = frozen_cell_flags(crit, cc, ids)
    gcrit, gcc = make_criterion("2d", torch.float64, "some", ALL_RULES,
                                device="cuda")
    np.testing.assert_array_equal(gcrit.cell_flags(gcc, ids), want)
    for ref_buffer in (0, 2, 4):
        np.testing.assert_array_equal(gcrit.box_summary(gcc, ids, ref_buffer),
                                      box_flag_summary(want, ref_buffer))
