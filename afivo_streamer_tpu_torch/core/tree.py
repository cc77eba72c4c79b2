"""Host-side AMR tree topology: the quadtree/octree of fixed-size boxes.

Re-designs the reference's Afivo tree (``afivo/src/m_af_types.f90:286-393``
box_t/af_t and ``afivo/src/m_af_core.f90`` af_init / af_adjust_refinement)
for batched device execution: the topology (levels, parents, children,
neighbors) lives on the host as flat NumPy int32 tables and changes only at
refinement epochs; all cell data lives on the device as a flat batch of
boxes (see core/batch.py). Box ids are stable across refinement
(free-id reuse, ``m_af_core.f90:884-922``), so device arrays persist across
epochs and only new children need data movement.

Refinement-flag semantics are an exact port of
``m_af_core.f90:924-1160`` (consistent_ref_flags, cell_to_ref_flags with
buffer widths, ensure_two_one_balance, handle_derefinement_flags): the mesh
evolution must match the reference cell-for-cell for regression parity.

Direction convention (af_neighb_*): directions d = 0..2*ndim-1 are
(low-x, high-x, low-y, high-y, low-z, high-z); dim = d // 2; a direction is
"low" when d % 2 == 0. Child index c = 0..2^ndim-1 has bit k set when the
child is on the high side in dimension k.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Special neighbor / parent / child values
NO_BOX = -1  #: no box at this position (refinement boundary for neighbors)
PHYS_BOUNDARY = -2  #: physical domain boundary

# Refinement flags (m_af_types.f90:23-35)
RM_REF = -1
KEEP_REF = 0
DO_REF = 1
DEREFINE = -2
REFINE = 2

MAX_LVL = 30  # af_max_lvl

# Bits of a box's flag summary (box_flag_summary): any cell DO_REF, any
# cell KEEP_REF, then from bit SUMMARY_STRIP0 one per neighbour offset (in
# the order of neighbour_offsets) whether the box's edge strip toward that
# neighbour holds a DO_REF
SUMMARY_ANY_DO = 1
SUMMARY_ANY_KEEP = 2
SUMMARY_STRIP0 = 2


def neighb_dim(d: int) -> int:
    return d // 2


def neighb_low(d: int) -> bool:
    return d % 2 == 0


def neighb_offset(d: int, ndim: int) -> np.ndarray:
    off = np.zeros(ndim, dtype=np.int64)
    off[d // 2] = -1 if d % 2 == 0 else 1
    return off


def neighbour_offsets(ndim: int) -> List[Tuple[int, ...]]:
    """The 3^ndim - 1 same-level neighbour offsets in {-1, 0, 1}^ndim, in
    the order consistent_ref_flags visits them."""
    return [off for off in itertools.product([-1, 0, 1], repeat=ndim)
            if any(off)]


def edge_strip(off: Sequence[int], nc: int, ref_buffer: int) -> tuple:
    """The slices of a box's cells next to its neighbour at ``off``:
    ``ref_buffer`` cells wide along every dimension where ``off`` is not
    0, the whole box along the others."""
    return tuple(slice(nc - ref_buffer, nc) if o == 1
                 else slice(0, ref_buffer) if o == -1 else slice(None)
                 for o in off)


def box_flag_summary(cell_flags, ref_buffer: int) -> np.ndarray:
    """Per-cell flags [n, [nc]^ndim] (RM_REF / KEEP_REF / DO_REF) reduced to
    one summary per box (int64, the SUMMARY_* bits): what
    consistent_ref_flags reads of a box's cells with this buffer width."""
    cf = np.asarray(cell_flags)
    if cf.size and (cf.min() < RM_REF or cf.max() > DO_REF):
        raise ValueError("invalid cell flags")
    ndim, nc = cf.ndim - 1, cf.shape[1]
    cells = tuple(range(1, ndim + 1))
    is_do = cf == DO_REF
    out = (is_do.any(axis=cells) * SUMMARY_ANY_DO
           | (cf == KEEP_REF).any(axis=cells) * SUMMARY_ANY_KEEP)
    for k, off in enumerate(neighbour_offsets(ndim)):
        strip = (slice(None),) + edge_strip(off, nc, ref_buffer)
        out |= is_do[strip].any(axis=cells).astype(np.int64) \
            << (SUMMARY_STRIP0 + k)
    return out.astype(np.int64)


def child_dix(c: int, ndim: int) -> np.ndarray:
    """Offset (0/1 per dim) of child c within its parent."""
    return np.array([(c >> k) & 1 for k in range(ndim)], dtype=np.int64)


class RefInfo:
    """Information about one refinement step (ref_info_t)."""

    def __init__(self):
        self.added: List[int] = []  # ids of new boxes (all levels)
        self.removed: List[int] = []  # ids of removed boxes
        self.added_per_lvl: Dict[int, List[int]] = {}

    @property
    def n_add(self) -> int:
        return len(self.added)

    @property
    def n_rm(self) -> int:
        return len(self.removed)


class Tree:
    """Flat pool of boxes + per-level id lists (host side)."""

    #: the partition of a sharded run's state rows (parallel/halo.Layout)
    #: on a rank's view of the tree (parallel/halo.LocalTree); None here
    layout = None

    def __init__(self, ndim: int, n_cell: int, domain_len, coarse_grid_size,
                 periodic=None, coord: str = "xyz", r_min=None):
        """Initialize the coarsest grid (af_init, ``m_af_core.f90:138-203``).

        domain_len: physical size per dimension.
        coarse_grid_size: number of *cells* per dimension at level 1
        (must be divisible by n_cell).
        """
        if n_cell % 2 != 0 or n_cell < 2:
            raise ValueError("n_cell must be even and >= 2")
        self.ndim = int(ndim)
        self.nc = int(n_cell)
        self.coord = coord
        if coord == "cyl" and ndim != 2:
            raise ValueError("cylindrical coordinates only in 2D")
        self.domain_len = np.asarray(domain_len, dtype=np.float64).reshape(ndim)
        self.r_base = (np.zeros(ndim) if r_min is None
                       else np.asarray(r_min, dtype=np.float64).reshape(ndim))
        cgs = np.asarray(coarse_grid_size, dtype=np.int64).reshape(ndim)
        if np.any(cgs % n_cell != 0):
            raise ValueError("coarse_grid_size must be divisible by n_cell")
        self.coarse_grid_size = cgs
        self.dr_base = self.domain_len / cgs  # level-1 cell spacing
        self.periodic = (np.zeros(ndim, dtype=bool) if periodic is None
                         else np.asarray(periodic, dtype=bool).reshape(ndim))

        n1 = cgs // n_cell  # boxes per dim at level 1
        self.n1_boxes = n1

        cap = int(np.prod(n1)) * 2
        self._alloc(cap)
        self.highest_id = 0
        self.removed_ids: List[int] = []
        self.epoch = 0  # topology version; bumped on every change

        # level -> {tuple(ix): id}
        self._ix_maps: List[Dict[Tuple[int, ...], int]] = [dict()]

        # create level-1 boxes
        for ix in itertools.product(*[range(int(n)) for n in n1]):
            bid = self._new_box(1, np.array(ix, dtype=np.int64), NO_BOX)
        for bid in range(self.highest_id):
            self._set_neighbs(bid)
        self._rebuild_levels()

    # ----------------------------------------------------------- box pool
    def _alloc(self, cap: int) -> None:
        self.cap = cap
        nd, nch, nnb = self.ndim, 2**self.ndim, 2 * self.ndim
        self.lvl = np.zeros(cap, dtype=np.int32)
        self.ix = np.zeros((cap, nd), dtype=np.int64)
        self.parent = np.full(cap, NO_BOX, dtype=np.int32)
        self.children = np.full((cap, nch), NO_BOX, dtype=np.int32)
        self.neighbors = np.full((cap, nnb), NO_BOX, dtype=np.int32)
        self.in_use = np.zeros(cap, dtype=bool)

    def _grow(self, new_cap: int) -> None:
        old = self.__dict__.copy()
        n = self.highest_id
        self._alloc(new_cap)
        for name in ("lvl", "ix", "parent", "children", "neighbors", "in_use"):
            getattr(self, name)[:n] = old[name][:n]

    def _new_box(self, lvl: int, ix, parent: int) -> int:
        if self.removed_ids:
            bid = self.removed_ids.pop()
        else:
            if self.highest_id >= self.cap:
                self._grow(max(2 * self.cap, self.cap + 1024))
            bid = self.highest_id
            self.highest_id += 1
        self.lvl[bid] = lvl
        self.ix[bid] = ix
        self.parent[bid] = parent
        self.children[bid] = NO_BOX
        self.neighbors[bid] = NO_BOX
        self.in_use[bid] = True
        while len(self._ix_maps) < lvl:
            self._ix_maps.append(dict())
        self._ix_maps[lvl - 1][tuple(int(x) for x in ix)] = bid
        return bid

    def _remove_box(self, bid: int) -> None:
        lvl = int(self.lvl[bid])
        self._ix_maps[lvl - 1].pop(tuple(int(x) for x in self.ix[bid]), None)
        self.in_use[bid] = False
        self.removed_ids.append(bid)

    # -------------------------------------------------------- connectivity
    def n_boxes_lvl(self, lvl: int) -> np.ndarray:
        """Number of boxes per dimension at a level (full-grid extent)."""
        return self.n1_boxes * 2 ** (lvl - 1)

    def _lookup(self, lvl: int, ix: np.ndarray) -> int:
        """Find box at level lvl and (possibly out-of-domain) index ix.

        Returns an id, NO_BOX, or PHYS_BOUNDARY. Periodic dimensions wrap.
        """
        nb = self.n1_boxes * 2 ** (lvl - 1)
        ixw = ix.copy()
        for k in range(self.ndim):
            if ixw[k] < 0 or ixw[k] >= nb[k]:
                if self.periodic[k]:
                    ixw[k] = ixw[k] % nb[k]
                else:
                    return PHYS_BOUNDARY
        if lvl - 1 >= len(self._ix_maps):
            return NO_BOX
        return self._ix_maps[lvl - 1].get(tuple(int(x) for x in ixw), NO_BOX)

    def _set_neighbs(self, bid: int) -> None:
        """Set the 2*ndim face neighbors of box bid, and update the reverse
        links (set_neighbs, ``m_af_core.f90``)."""
        lvl = int(self.lvl[bid])
        for d in range(2 * self.ndim):
            nb_id = self._lookup(lvl, self.ix[bid] + neighb_offset(d, self.ndim))
            self.neighbors[bid, d] = nb_id
            if nb_id >= 0:
                self.neighbors[nb_id, d ^ 1] = bid

    def neighbor_mat(self, bid: int, offset: Sequence[int]) -> int:
        """Same-level neighbor at an arbitrary offset in {-1,0,1}^ndim
        (box_t%neighbor_mat)."""
        lvl = int(self.lvl[bid])
        return self._lookup(lvl, self.ix[bid] + np.asarray(offset, dtype=np.int64))

    def child_offset(self, bid: int) -> np.ndarray:
        """Cell offset of this box inside its parent (af_get_child_offset):
        (nc/2) * (odd/even position per dim), 0-based."""
        return (self.ix[bid] % 2) * (self.nc // 2)

    def has_children(self, bid: int) -> bool:
        return self.children[bid, 0] != NO_BOX

    # --------------------------------------------------------- level lists
    def _rebuild_levels(self) -> None:
        self.highest_lvl = 0
        lvls: List[np.ndarray] = []
        leaves: List[np.ndarray] = []
        parents: List[np.ndarray] = []
        ids_all = np.nonzero(self.in_use[:self.highest_id])[0]
        if len(ids_all):
            self.highest_lvl = int(self.lvl[ids_all].max())
        for lvl in range(1, self.highest_lvl + 1):
            ids = ids_all[self.lvl[ids_all] == lvl]
            # afivo orders ids within a level by creation; order is irrelevant
            # for the physics, but sort for determinism
            ids = np.sort(ids)
            lvls.append(ids.astype(np.int32))
            is_leaf = self.children[ids, 0] == NO_BOX
            leaves.append(ids[is_leaf].astype(np.int32))
            parents.append(ids[~is_leaf].astype(np.int32))
        self.lvl_ids = lvls
        self.lvl_leaves = leaves
        self.lvl_parents = parents
        self.epoch += 1

    @property
    def all_leaves(self) -> np.ndarray:
        if self.highest_lvl == 0:
            return np.zeros(0, dtype=np.int32)
        return np.concatenate(self.lvl_leaves)

    @property
    def n_boxes(self) -> int:
        return int(np.count_nonzero(self.in_use[:self.highest_id]))

    # ---------------------------------------------------------- geometry
    def lvl_dr(self, lvl: int) -> np.ndarray:
        return self.dr_base / 2 ** (lvl - 1)

    def box_dr(self, bid) -> np.ndarray:
        return self.dr_base / (2.0 ** (self.lvl[bid] - 1))[..., None]

    def box_r_min(self, bid) -> np.ndarray:
        """Minimum coordinate of box(es); bid may be an array."""
        lvl = self.lvl[bid]
        dr = self.dr_base / (2.0 ** (lvl - 1))[..., None]
        return self.r_base + self.ix[bid] * self.nc * dr

    def cell_coords(self, bid: int) -> np.ndarray:
        """Cell-center coordinates of a box incl. one ghost layer:
        shape [nc+2]*ndim + [ndim]."""
        r0 = self.box_r_min(np.asarray([bid]))[0]
        dr = self.box_dr(np.asarray([bid]))[0]
        axes = [r0[k] + (np.arange(-1, self.nc + 1) + 0.5) * dr[k]
                for k in range(self.ndim)]
        grids = np.meshgrid(*axes, indexing="ij")
        return np.stack(grids, axis=-1)

    def boxes_cell_coords(self, ids) -> np.ndarray:
        """Cell-center coordinates of boxes ``ids`` incl. one ghost layer:
        [n] + [nc+2]^ndim + [ndim] (cell_coords for many boxes)."""
        ids = np.asarray(ids, np.int64)
        r0 = self.box_r_min(ids)
        dr = self.box_dr(ids)
        ndim, nc = self.ndim, self.nc
        off = np.arange(-1, nc + 1) + 0.5
        axes = []
        for k in range(ndim):
            shape = [len(ids)] + [1] * ndim
            shape[1 + k] = nc + 2
            axes.append((r0[:, k, None] + off[None, :] * dr[:, k, None])
                        .reshape(shape))
        full = (len(ids),) + (nc + 2,) * ndim
        return np.stack([np.broadcast_to(a, full) for a in axes], axis=-1)

    def total_volume(self) -> float:
        """Volume of the computational domain (af_total_volume,
        ``m_af_types.f90:805-825``); cylindrical uses 2*pi*r weighting."""
        box_len = self.nc * self.dr_base
        if self.ndim == 2 and self.coord == "cyl":
            vol = 0.0
            for bid in self.lvl_ids[0]:
                r0 = self.box_r_min(np.asarray([bid]))[0][0]
                r1 = r0 + box_len[0]
                vol += np.pi * (r1**2 - r0**2) * box_len[1]
            return float(vol)
        return float(np.prod(box_len) * len(self.lvl_ids[0]))

    # --------------------------------------------------------- refinement
    def refine_up_to_lvl(self, target_lvl: int) -> List[RefInfo]:
        """Uniformly refine everything up to target_lvl (af_refine_up_to_lvl)."""
        infos = []
        while self.highest_lvl < target_lvl:
            flags = {int(b): DO_REF for b in self.all_leaves}
            infos.append(self._apply_flags(flags))
        return infos

    def adjust_refinement(self, cell_flag_fn: Callable[[np.ndarray], np.ndarray],
                          ref_buffer: int = 0,
                          ref_links: Optional[np.ndarray] = None) -> RefInfo:
        """One refinement adjustment (af_adjust_refinement,
        ``m_af_core.f90:697-822``).

        cell_flag_fn(ids) -> int array [len(ids)] + [nc]*ndim of per-cell
        flags (RM_REF / KEEP_REF / DO_REF) for the given box ids.
        """
        ref_flags = self._consistent_ref_flags(
            lambda ids: box_flag_summary(cell_flag_fn(ids), ref_buffer),
            ref_buffer, ref_links)
        return self._apply_flags(ref_flags)

    def criterion_eval_ids(self) -> np.ndarray:
        """The box ids the refinement criterion is evaluated on: all
        leaves plus every parent with at least one leaf child
        (m_af_core.f90:955-985). Exposed so the driver can compute the
        criterion flags for exactly these ids inside the fused
        restrict+gc dispatch (driver.jit_restrict_gc_flags)."""
        eval_ids = list(self.all_leaves)
        parent_set = []
        seen = set()
        for bid in self.all_leaves:
            p = int(self.parent[bid])
            if p >= 0 and p not in seen:
                seen.add(p)
                parent_set.append(p)
        return np.asarray(eval_ids + parent_set, dtype=np.int64)

    def _consistent_ref_flags(self, summary_fn, ref_buffer,
                              ref_links) -> Dict[int, int]:
        """Port of consistent_ref_flags (``m_af_core.f90:924-1012``).

        summary_fn(ids) -> the flag summary of each given box
        (box_flag_summary of its cell flags with this ``ref_buffer``)."""
        flags: Dict[int, int] = {}

        # Evaluate criterion on all leaves, and on every parent that has at
        # least one leaf child (m_af_core.f90:955-985)
        eval_ids = self.criterion_eval_ids()
        if len(eval_ids) == 0:
            return flags
        summary = np.asarray(summary_fn(eval_ids)).tolist()
        offsets = neighbour_offsets(self.ndim)

        def bump(bid: int, val: int) -> None:
            flags[bid] = max(flags.get(bid, -10**9), val)

        for bid, s in zip(eval_ids.tolist(), summary):
            # cell_to_ref_flags (m_af_core.f90:1095-1148)
            if s & SUMMARY_ANY_DO:
                flags[bid] = DO_REF
            elif s & SUMMARY_ANY_KEEP:
                bump(bid, KEEP_REF)
            else:
                bump(bid, RM_REF)

            # the buffer only spreads DO_REF flags: skip boxes without any
            if ref_buffer > 0 and s & SUMMARY_ANY_DO:
                # flag same-level neighbors whose adjacent cells are flagged
                for k, off in enumerate(offsets):
                    if s >> (SUMMARY_STRIP0 + k) & 1:
                        nb_id = self.neighbor_mat(bid, off)
                        if nb_id >= 0:
                            flags[nb_id] = DO_REF

        # default for unset is keep
        out = {bid: (flags.get(int(bid), KEEP_REF))
               for bid in np.nonzero(self.in_use[:self.highest_id])[0]}

        # Cannot refine beyond max level
        for bid, v in out.items():
            if v == DO_REF and self.lvl[bid] >= MAX_LVL:
                out[bid] = KEEP_REF

        self._ensure_two_one_balance(out)
        self._handle_derefinement_flags(out)
        if ref_links is not None and len(ref_links):
            for pair in np.asarray(ref_links).reshape(-1, 2):
                m = max(out.get(int(pair[0]), KEEP_REF),
                        out.get(int(pair[1]), KEEP_REF))
                out[int(pair[0])] = m
                out[int(pair[1])] = m
            self._ensure_two_one_balance(out)
            self._handle_derefinement_flags(out)
        return out

    def _ensure_two_one_balance(self, flags: Dict[int, int]) -> None:
        """Port of ensure_two_one_balance (``m_af_core.f90:1016-1057``)."""
        for lvl in range(self.highest_lvl, 0, -1):
            for bid in self.lvl_leaves[lvl - 1]:
                bid = int(bid)
                f = flags.get(bid, KEEP_REF)
                if f in (DO_REF, REFINE):
                    flags[bid] = REFINE
                    for d in range(2 * self.ndim):
                        if self.neighbors[bid, d] == NO_BOX:
                            p = int(self.parent[bid])
                            p_nb = int(self.neighbors[p, d])
                            flags[p_nb] = REFINE
                elif f == RM_REF:
                    for d in range(2 * self.ndim):
                        nb_id = int(self.neighbors[bid, d])
                        if nb_id >= 0 and (self.has_children(nb_id)
                                           or flags.get(nb_id, KEEP_REF) > KEEP_REF):
                            flags[bid] = KEEP_REF
                            break

    def _handle_derefinement_flags(self, flags: Dict[int, int]) -> None:
        """Port of handle_derefinement_flags (``m_af_core.f90:1060-1090``)."""
        for lvl in range(self.highest_lvl - 1, 0, -1):
            for bid in self.lvl_parents[lvl - 1]:
                bid = int(bid)
                c_ids = [int(c) for c in self.children[bid]]
                if all(self.has_children(c) for c in c_ids):
                    continue
                if (all(flags.get(c, KEEP_REF) == RM_REF for c in c_ids)
                        and flags.get(bid, KEEP_REF) <= KEEP_REF):
                    flags[bid] = DEREFINE
                else:
                    flags[bid] = KEEP_REF
                    for c in c_ids:
                        if flags.get(c, KEEP_REF) != DEREFINE:
                            flags[c] = max(flags.get(c, KEEP_REF), KEEP_REF)

    def _apply_flags(self, flags: Dict[int, int]) -> RefInfo:
        """Add/remove children according to final flags."""
        info = RefInfo()
        # fast path: nothing to do -> do NOT bump the topology epoch (the
        # plan/pack caches stay valid; the reference checks refinement
        # every 2 steps but the mesh changes far less often)
        changes = False
        for lvl in range(1, self.highest_lvl + 1):
            if lvl - 1 >= len(self.lvl_ids):
                break
            for bid in self.lvl_ids[lvl - 1]:
                f = flags.get(int(bid), KEEP_REF)
                if (f == REFINE
                        or (f == DO_REF and not self.has_children(int(bid)))
                        or f == DEREFINE):
                    changes = True
                    break
            if changes:
                break
        if not changes:
            return info
        # process level by level (children never flagged REFINE themselves)
        for lvl in range(1, self.highest_lvl + 1):
            if lvl - 1 >= len(self.lvl_ids):
                break
            for bid in list(self.lvl_ids[lvl - 1]):
                bid = int(bid)
                f = flags.get(bid, KEEP_REF)
                if f == REFINE or (f == DO_REF and not self.has_children(bid)):
                    self._add_children(bid, info)
                elif f == DEREFINE:
                    for c in self.children[bid]:
                        info.removed.append(int(c))
                        self._remove_box(int(c))
                    self.children[bid] = NO_BOX
        # fix neighbor links that point at removed boxes
        for bid in info.removed:
            pass  # handled below by recomputing neighbors of affected boxes
        self._rebuild_levels()
        # Recompute all neighbor links (simple and robust; topology is small)
        for lvl_ids in self.lvl_ids:
            for bid in lvl_ids:
                self._set_neighbs_oneway(int(bid))
        return info

    def _set_neighbs_oneway(self, bid: int) -> None:
        lvl = int(self.lvl[bid])
        for d in range(2 * self.ndim):
            self.neighbors[bid, d] = self._lookup(
                lvl, self.ix[bid] + neighb_offset(d, self.ndim))

    def _add_children(self, bid: int, info: RefInfo) -> None:
        lvl = int(self.lvl[bid])
        ch = []
        for c in range(2 ** self.ndim):
            cix = 2 * self.ix[bid] + child_dix(c, self.ndim)
            cid = self._new_box(lvl + 1, cix, bid)
            ch.append(cid)
            info.added.append(cid)
            info.added_per_lvl.setdefault(lvl + 1, []).append(cid)
        self.children[bid] = ch
