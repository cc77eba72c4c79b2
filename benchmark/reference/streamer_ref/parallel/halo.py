"""The box-axis partition of a sharded run, its halo exchange and its
collectives.

A sharded run (``-compiled%shards=N``, parallel/compiled.py) lays the box
axis over N ranks as the JAX package lays it over a device mesh
(``afivo_streamer_tpu/driver.py`` ``_mesh_shardings``,
``parallel/compiled.py`` ``pad_capacity_to``): box b belongs to rank
``b // (cap / N)``, the capacity padded to a multiple of N. The tree and
every host plan stay replicated; every rank takes the same decisions.

Each rank stores its own boxes and a halo (``Layout``): copies of the boxes
that its own boxes read, namely their same-level neighbors (edges and
corners included), their parents and the parents' neighbors, their
children and their neighbors' children. Its state ``cc [n_var, rows, S]``
and ``fc`` hold those rows only, its own boxes first, both in box order.
``Layout.exchange`` refreshes the halo rows of some levels and variables
from their owners (one ``all_to_all_single``) before an operation reads
them.

``LocalTree`` presents the tree to the plan builders in local rows: its
level lists hold the rank's own boxes and its links (neighbors, parents,
children) name local rows, so every index table built from it
(core/levels.MeshPlans) addresses the rank's state and covers its own
boxes. A link to a box outside the rank's rows reads ``POISON``, which no
table can index.

The multigrid's level arrays hold a level's local rows too (``lvl_rows``:
own boxes first), and ``Layout.exchange_blocks`` refreshes their halo
rows between the operations of a cycle (solvers/mg_blocks.py). The
level-1 solve gathers its level on every rank (``Layout.whole_level``).
The numerical code reaches all of this through core/levels.MeshPlans
(``halo``, ``halo_blocks``, ``reduce``, ``extremum``, ``map_boxes``,
``whole_level``), which does nothing of it when unsharded; the wire is
parallel/compiled.Shards.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.tree import NO_BOX, Tree

#: the link of a box to a box that is not in the rank's rows
POISON = 2 ** 30


# --------------------------------------------------------------------------
# the partition
# --------------------------------------------------------------------------
def neighbor_cube(tree: Tree, ids: np.ndarray) -> np.ndarray:
    """[highest_id, 3^ndim] same-level boxes at every offset in
    {-1, 0, 1}^ndim of boxes ``ids`` (the edge and corner neighbors of
    af_gc_box_corner included), NO_BOX or a boundary code elsewhere."""
    ndim = tree.ndim
    offs = [np.asarray(o) for o in itertools.product((-1, 0, 1),
                                                     repeat=ndim)]
    cube = np.full((tree.highest_id, len(offs)), NO_BOX, np.int64)
    for b in ids:
        b = int(b)
        for k, off in enumerate(offs):
            cube[b, k] = b if not off.any() else tree.neighbor_mat(b, off)
    return cube


def halo_of(tree: Tree, own: np.ndarray, cube: np.ndarray) -> np.ndarray:
    """The boxes that boxes ``own`` read and do not hold, sorted: their
    same-level neighbors, parents, the parents' neighbors, their children
    and their neighbors' children."""
    def valid(a):
        a = np.asarray(a, np.int64).ravel()
        return a[a >= 0]
    nb = valid(cube[own])
    par = valid(tree.parent[own])
    pnb = valid(cube[par])
    chi = valid(tree.children[np.concatenate([own, nb])])
    need = np.unique(np.concatenate([nb, par, pnb, chi]))
    return np.setdiff1d(need, own, assume_unique=True)


class Layout:
    """The partition of one mesh over the ranks: every rank's own boxes,
    halo and local rows (own boxes, then halo, both sorted), this rank's
    maps between box ids and rows, and per level the rows it sends to and
    receives from each peer. ``stats`` counts this rank's halo exchanges
    (calls, bytes sent, host seconds) and its gathers of the multigrid's
    level arrays and of the writers' state (``gather_*``: bytes sent)."""

    def __init__(self, tree: Tree, shards, cap: int):
        N, me = shards.world, shards.rank
        self.shards, self.cap, self.world, self.rank = shards, cap, N, me
        self.n_levels = tree.highest_lvl
        ids = np.nonzero(tree.in_use[:tree.highest_id])[0].astype(np.int64)
        owner = shards.owner(ids, cap)
        cube = neighbor_cube(tree, ids)
        self.own = [ids[owner == r] for r in range(N)]
        self.halo = [halo_of(tree, self.own[r], cube) for r in range(N)]
        self.glob = np.concatenate([self.own[me], self.halo[me]])
        self.n_own = len(self.own[me])
        self.n_rows = len(self.glob)
        self.row_of = np.full(max(tree.highest_id, 1), -1, np.int64)
        self.row_of[self.glob] = np.arange(self.n_rows)
        lvl = tree.lvl
        self.send: List[List[np.ndarray]] = []
        self.recv: List[List[np.ndarray]] = []
        self.n_moved = []  # boxes moved over all pairs, per level
        for l in range(1, self.n_levels + 1):
            snd, rcv = [], []
            for p in range(N):
                s = np.intersect1d(self.own[me], self.halo[p])
                r = np.intersect1d(self.halo[me], self.own[p])
                snd.append(self.row_of[s[lvl[s] == l]])
                rcv.append(self.row_of[r[lvl[r] == l]])
            self.send.append(snd)
            self.recv.append(rcv)
            self.n_moved.append(sum(int(np.sum(lvl[h] == l))
                                    for h in self.halo))
        # the multigrid's level arrays: per level the rank's rows, its own
        # boxes first (in the tree's order), then its halo; the position
        # of each row among the level's boxes in the tree's order; and the
        # gather of a level's own rows on every rank
        self.max_own = max(max(len(o) for o in self.own), 1)
        self.lvl_rows, self.lvl_gpos = [], []
        self.lvl_gather = []
        gpos = np.full(max(tree.highest_id, 1), -1, np.int64)
        for l in range(1, self.n_levels + 1):
            ids_l = np.asarray(tree.lvl_ids[l - 1], np.int64)
            gpos[ids_l] = np.arange(len(ids_l))
            o = self.own[me][lvl[self.own[me]] == l]
            h = self.halo[me][lvl[self.halo[me]] == l]
            rows_l = self.row_of[np.concatenate([o, h])]
            self.lvl_rows.append(rows_l)
            self.lvl_gpos.append(gpos[self.glob[rows_l]])
            owner_l = shards.owner(ids_l, cap)
            counts = [int(np.sum(owner_l == r)) for r in range(N)]
            pos = np.zeros(len(ids_l), np.int64)
            for r in range(N):
                pos[owner_l == r] = np.arange(counts[r])
            self.lvl_gather.append((max(max(counts), 1), len(o),
                                    owner_l * max(max(counts), 1) + pos))
        # per level the parents among the rank's rows (own and halo), and
        # the position of each own leaf in the tree's leaf list (the order
        # of the unsharded reductions)
        held = np.zeros(max(tree.highest_id, 1), bool)
        held[self.glob] = True
        mine = np.zeros(max(tree.highest_id, 1), bool)
        mine[self.own[me]] = True
        self.lvl_parents_held = [
            self.row_of[a[held[a]]] for a in
            (np.asarray(x, np.int64) for x in tree.lvl_parents)]
        self.lvl_leaves_gpos = [
            np.nonzero(mine[np.asarray(a, np.int64)])[0]
            for a in tree.lvl_leaves]
        self.stats = new_stats()
        self._dev: Dict = {}

    def leaf_cells(self, tree: Tree) -> List[int]:
        """Leaf cells of every rank."""
        leaf = tree.children[:, 0] == NO_BOX
        return [int(np.sum(leaf[o])) * tree.nc ** tree.ndim
                for o in self.own]

    def _tables(self, key, make):
        if key not in self._dev:
            self._dev[key] = make()
        return self._dev[key]

    def exchange_tables(self, levels: Sequence[int]):
        """Device index tables of an exchange of ``levels``: the rows sent
        to each peer and received from each, concatenated by peer, and the
        split sizes; None when no rank moves a box of those levels."""
        levels = tuple(l for l in levels if 1 <= l <= self.n_levels)

        def make():
            if sum(self.n_moved[l - 1] for l in levels) == 0:
                return None
            dev = self.shards.device
            snd = [np.concatenate([self.send[l - 1][p] for l in levels])
                   for p in range(self.world)]
            rcv = [np.concatenate([self.recv[l - 1][q] for l in levels])
                   for q in range(self.world)]
            return (torch.as_tensor(np.concatenate(snd), device=dev),
                    torch.as_tensor(np.concatenate(rcv), device=dev),
                    [len(a) for a in snd], [len(a) for a in rcv])
        return self._tables(("x",) + levels, make)

    def block_tables(self, lvl: int):
        """The exchange of a level's multigrid arrays (rows
        ``lvl_rows``): the positions sent to each peer and received from
        each, and the split sizes; None when no rank moves a box of the
        level."""
        def make():
            if self.n_moved[lvl - 1] == 0:
                return None
            dev = self.shards.device
            pos = np.full(self.n_rows, -1, np.int64)
            pos[self.lvl_rows[lvl - 1]] = np.arange(
                len(self.lvl_rows[lvl - 1]))
            snd = [pos[a] for a in self.send[lvl - 1]]
            rcv = [pos[a] for a in self.recv[lvl - 1]]
            return (torch.as_tensor(np.concatenate(snd), device=dev),
                    torch.as_tensor(np.concatenate(rcv), device=dev),
                    [len(a) for a in snd], [len(a) for a in rcv])
        return self._tables(("b", lvl), make)

    # ------------------------------------------------------------ exchange
    def exchange(self, x: torch.Tensor, levels, ivs=None,
                 fc: bool = False) -> torch.Tensor:
        """Refresh, in place, the halo rows of the boxes at ``levels`` of
        ``x`` from their owners: x is ``cc [n_var, rows, S]`` or, with
        ``fc``, ``fc [n_fc, ndim, rows, Sf]`` (variables ``ivs``, all by
        default). Every rank must call it with the same arguments."""
        tabs = self.exchange_tables(levels)
        if tabs is None:
            return x
        t0 = time.perf_counter()
        snd, rcv, n_snd, n_rcv = tabs
        dev = x.device
        iv = torch.as_tensor(list(range(x.shape[0])) if ivs is None
                             else [int(i) for i in ivs], device=dev)
        if not fc:           # cc: [n_iv, rows, S] -> rows first
            buf = x[iv[:, None], snd[None, :]].transpose(0, 1)
        else:                # fc: [n_iv, ndim, rows, Sf] -> rows first
            buf = x[iv][:, :, snd].permute(2, 0, 1, 3)
        out = self.shards.all_to_all(buf.contiguous(), n_rcv, n_snd)
        if not fc:
            x[iv[:, None], rcv[None, :]] = out.transpose(0, 1)
        else:
            d = torch.arange(x.shape[1], device=dev)
            x[iv[:, None, None], d[None, :, None], rcv[None, None, :]] = \
                out.permute(1, 2, 0, 3)
        _count(self, "", buf, t0)
        return x

    def exchange_blocks(self, X: torch.Tensor, lvl: int) -> torch.Tensor:
        """A level's multigrid array ``X`` [rows of lvl_rows, ...] with its
        halo rows taken from their owners (a new tensor); X itself where no
        rank moves a box of the level."""
        tabs = self.block_tables(lvl)
        if tabs is None:
            return X
        t0 = time.perf_counter()
        snd, rcv, n_snd, n_rcv = tabs
        buf = X[snd]
        out = self.shards.all_to_all(buf, n_rcv, n_snd)
        X = X.clone()
        X[rcv] = out
        _count(self, "", buf, t0)
        return X

    # --------------------------------------------------------- collectives
    def extremum(self, found: List, largest: bool):
        """The largest (or smallest) of every rank's candidate ``[value,
        level, row among the rank's leaves of the level, index]`` (or []),
        ties to the first (level, position in the tree's leaf list, index)
        as a scan in the tree's order finds them; the row of the result is
        that position. None without a candidate."""
        mine = [np.nan] * 4
        if found:
            v, lvl, row, k = found
            mine = [v, lvl, int(self.lvl_leaves_gpos[lvl - 1][row]), k]
        allv = self.shards.all_gather(torch.tensor(
            mine, dtype=torch.float64)).reshape(-1, 4).numpy()
        allv = allv[~np.isnan(allv[:, 0])]
        if len(allv) == 0:
            return None
        key = -allv[:, 0] if largest else allv[:, 0]
        j = np.lexsort((allv[:, 3], allv[:, 2], allv[:, 1], key))[0]
        v, lvl, pos, k = allv[j]
        return [float(v), int(lvl), int(pos), int(k)]

    def own_rows(self, ids) -> tuple:
        """(mask, rows): which of the tree's boxes ``ids`` the rank owns,
        and their local rows."""
        ids = np.asarray(ids, np.int64)
        mine = self.shards.owner(ids, self.cap) == self.rank
        return mine, self.row_of[ids[mine]]

    def map_boxes(self, ids, fn) -> np.ndarray:
        """``fn(rows, sel)`` on the rank's own boxes among ``ids`` (their
        local rows and a mask of them in ``ids``), the NumPy results (one
        entry per box) gathered on every rank in the order of ``ids``."""
        ids = np.asarray(ids, np.int64)
        owner = self.shards.owner(ids, self.cap)
        mine, rows = self.own_rows(ids)
        vals = np.asarray(fn(rows, mine))
        counts = [int(np.sum(owner == r)) for r in range(self.world)]
        pad = np.zeros((max(counts),) + vals.shape[1:], vals.dtype)
        pad[:len(vals)] = vals
        parts = self.shards.all_gather(torch.as_tensor(pad)).numpy()
        out = np.zeros((len(ids),) + vals.shape[1:], vals.dtype)
        for r in range(self.world):
            out[owner == r] = parts[r, :counts[r]]
        return out

    def whole_level(self, lvl: int, fn, *arrays):
        """``fn`` of the whole of level ``lvl``'s multigrid arrays, in the
        tree's order, gathered on every rank from every rank's own rows
        of ``arrays`` (rows ``lvl_rows``, own first); the rank's rows of
        the result."""
        full = fn(*(self._gather_level(X, lvl) for X in arrays))
        pos = self._tables(("gpos", lvl), lambda: torch.as_tensor(
            self.lvl_gpos[lvl - 1], device=full.device))
        return full[pos]

    def _gather_level(self, X: torch.Tensor, lvl: int) -> torch.Tensor:
        t0 = time.perf_counter()
        n_max, n_own, index = self.lvl_gather[lvl - 1]
        pad = X.new_zeros((n_max,) + tuple(X.shape[1:]))
        pad[:n_own] = X[:n_own]
        full = self.shards.all_gather(pad).reshape(
            (-1,) + tuple(X.shape[1:]))
        idx = self._tables(("gather", lvl), lambda: torch.as_tensor(
            index, device=X.device))
        _count(self, "gather_", pad, t0)
        return full[idx]


def new_stats() -> dict:
    return {"calls": 0, "bytes": 0, "seconds": 0.0, "gather_calls": 0,
            "gather_bytes": 0, "gather_seconds": 0.0}


def _count(layout, kind: str, t, t0):
    st = layout.stats
    st[kind + "calls"] += 1
    st[kind + "bytes"] += t.numel() * t.element_size()
    st[kind + "seconds"] += time.perf_counter() - t0


# --------------------------------------------------------------------------
# the tree in local rows
# --------------------------------------------------------------------------
class LocalTree:
    """The tree as one rank's plan builders see it: box ids are local rows,
    the level lists hold the rank's own boxes in the tree's order, the links
    name local rows (POISON for a box the rank does not hold), and the
    geometry is the tree's. ``epoch`` follows every new layout;
    ``global_tree`` is the replicated tree."""

    _TREE_METHODS = ("lvl_dr", "box_dr", "box_r_min", "cell_coords",
                     "boxes_cell_coords", "child_offset", "has_children")

    def __init__(self, tree: Tree):
        self.global_tree = tree
        for name in ("ndim", "nc", "coord", "domain_len", "r_base",
                     "coarse_grid_size", "dr_base", "periodic", "n1_boxes"):
            setattr(self, name, getattr(tree, name))
        self.epoch = 0
        self.layout: Optional[Layout] = None

    def __getattr__(self, name):
        if name in LocalTree._TREE_METHODS:
            return getattr(Tree, name).__get__(self)
        raise AttributeError(f"LocalTree has no attribute {name!r}")

    def _map(self, a):
        a = np.asarray(a, np.int64)
        safe = np.clip(a, 0, len(self.layout.row_of) - 1)
        rows = np.where(a >= 0, self.layout.row_of[safe], a)
        return np.where((a >= 0) & (rows < 0), POISON, rows).astype(np.int32)

    def refresh(self, layout: Layout) -> None:
        """Take a new layout of the (changed) tree."""
        t = self.global_tree
        self.layout = layout
        g = layout.glob
        self.highest_id = layout.n_rows
        self.highest_lvl = t.highest_lvl
        self.lvl = t.lvl[g]
        self.ix = t.ix[g]
        self.parent = self._map(t.parent[g])
        self.children = self._map(t.children[g])
        self.neighbors = self._map(t.neighbors[g])
        self.in_use = np.ones(len(g), bool)
        own = np.zeros(max(t.highest_id, 1), bool)
        own[layout.own[layout.rank]] = True

        def mine(lst):
            return [self._map(a[own[a]]) for a in
                    (np.asarray(x, np.int64) for x in lst)]
        self.lvl_ids = mine(t.lvl_ids)
        self.lvl_leaves = mine(t.lvl_leaves)
        self.lvl_parents = mine(t.lvl_parents)
        self.epoch += 1

    def neighbor_mat(self, bid: int, offset) -> int:
        nb = self.global_tree.neighbor_mat(int(self.layout.glob[bid]),
                                           offset)
        return int(self._map(np.asarray([nb]))[0])


# --------------------------------------------------------------------------
# moving and gathering the state
# --------------------------------------------------------------------------
def relayout(x: torch.Tensor, old: Layout, new: Layout,
             row_dim: int) -> torch.Tensor:
    """The state ``x`` (rows along ``row_dim``) moved from layout ``old``
    to ``new``: every row of the new layout whose box some rank owned in
    the old one comes from that rank; the other rows are zero."""
    sh = new.shards
    N, me = new.world, new.rank
    dev = x.device
    snd, rcv, n_snd, n_rcv = [], [], [], []
    new_rows = [np.concatenate([new.own[r], new.halo[r]]) for r in range(N)]
    for p in range(N):
        s = np.intersect1d(old.own[me], new_rows[p])
        r = np.intersect1d(new_rows[me], old.own[p])
        snd.append(old.row_of[s])
        rcv.append(new.row_of[r])
    shape = list(x.shape)
    shape[row_dim] = new.n_rows
    out = x.new_zeros(shape)
    xr = x.movedim(row_dim, 0)
    outr = out.movedim(row_dim, 0)
    # this rank's own rows stay, the rest moves between ranks
    keep_s = torch.as_tensor(snd[me], device=dev)
    keep_r = torch.as_tensor(rcv[me], device=dev)
    outr[keep_r] = xr[keep_s]
    n_snd = [0 if p == me else len(snd[p]) for p in range(N)]
    n_rcv = [0 if q == me else len(rcv[q]) for q in range(N)]
    s_idx = torch.as_tensor(np.concatenate(
        [snd[p] for p in range(N) if p != me] or [np.zeros(0, np.int64)]),
        dtype=torch.int64, device=dev)
    r_idx = torch.as_tensor(np.concatenate(
        [rcv[q] for q in range(N) if q != me] or [np.zeros(0, np.int64)]),
        dtype=torch.int64, device=dev)
    moved = sh.all_to_all(xr[s_idx].contiguous(), n_rcv, n_snd)
    outr[r_idx] = moved
    return out


def gather_to_root(x: torch.Tensor, layout: Layout, row_dim: int,
                   cap: int) -> Optional[torch.Tensor]:
    """The whole state on rank 0 (rows of box ids 0..cap-1; zero for a box
    in no rank's rows), None on the other ranks."""
    t0 = time.perf_counter()
    sh = layout.shards
    xr = x.movedim(row_dim, 0)
    mine = xr[:layout.n_own]
    pad = mine.new_zeros((layout.max_own,) + tuple(mine.shape[1:]))
    pad[:layout.n_own] = mine
    parts = sh.gather_root(pad.contiguous())
    _count(layout, "gather_", pad, t0)
    if parts is None:
        return None
    full = x.new_zeros((cap,) + tuple(mine.shape[1:]))
    for r, part in enumerate(parts):
        own = torch.as_tensor(layout.own[r], device=x.device)
        full[own] = part[:len(layout.own[r])].to(x.device)
    return full.movedim(0, row_dim)
