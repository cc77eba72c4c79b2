"""Particle <-> grid transfer of the port (afivo_streamer_tpu_torch/core/
particles.py) against the JAX package's (core/particles.py), on the CPU in
float64: the four tests of tests/test_particles.py, each run through both
packages on the same trees and particles, the port's results held against
the JAX package's (box ids exact, values at rtol 1e-12), as well as against
the properties those tests check."""

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core import particles as jpart
from afivo_streamer_tpu.core.tree import Tree as JTree, DO_REF, KEEP_REF
from afivo_streamer_tpu_torch.core import particles as tpart
from afivo_streamer_tpu_torch.core import spatial as sp
from afivo_streamer_tpu_torch.core.tree import Tree as TTree

RTOL = 1e-12


def refined_tree(cls, ndim=2, nc=8, coord="xyz"):
    """A 16^ndim-cell level 1 on the unit domain, the corner r < 0.4
    refined twice (tests/test_particles.py)."""
    t = cls(ndim, nc, [1.0] * ndim, [2 * nc] * ndim, coord=coord)

    def flags(ids):
        out = []
        for b in ids:
            rmin = t.box_r_min(np.asarray([int(b)]))[0]
            f = DO_REF if np.all(rmin < 0.4) and t.lvl[int(b)] < 3 \
                else KEEP_REF
            out.append(np.full((nc,) * ndim, f))
        return np.asarray(out)

    for _ in range(2):
        t.adjust_refinement(flags)
    return t


def trees(ndim=2, coord="xyz", uniform=False):
    if uniform:
        return (JTree(ndim, 8, [1.0] * ndim, [16] * ndim),
                TTree(ndim, 8, [1.0] * ndim, [16] * ndim))
    return (refined_tree(JTree, ndim, coord=coord),
            refined_tree(TTree, ndim, coord=coord))


def zeros(t):
    return np.zeros((1, t.highest_id + 1, (t.nc + 2) ** t.ndim))


@pytest.mark.parametrize("ndim", [2, 3])
def test_locate_levels(ndim):
    jt, tt = trees(ndim)
    rng = np.random.default_rng(7)
    r = np.concatenate([
        np.array([[0.1] * ndim, [0.9] * ndim, [-0.1] + [0.5] * (ndim - 1),
                  [0.5] * (ndim - 1) + [0.99], [0.25] * ndim,
                  [1.0] * ndim]),
        rng.uniform(-0.05, 1.05, size=(300, ndim))])
    ids = tpart.locate(tt, r)
    np.testing.assert_array_equal(ids, jpart.locate(jt, r))
    np.testing.assert_array_equal(tpart.locate(tt, r, max_lvl=2),
                                  jpart.locate(jt, r, max_lvl=2))
    assert ids[2] == -1 and ids[5] == -1
    assert tt.lvl[ids[0]] == 3 and tt.children[ids[0], 0] < 0
    assert tt.lvl[ids[1]] == 1
    for k in np.nonzero(ids >= 0)[0]:
        r0 = tt.box_r_min(np.asarray([ids[k]]))[0]
        dx = tt.lvl_dr(int(tt.lvl[ids[k]])) * tt.nc
        assert np.all(r[k] >= r0) and np.all(r[k] < r0 + dx)


@pytest.mark.parametrize("order", [0, 1])
def test_deposit_conserves_weight(order):
    jt, tt = trees(uniform=order == 1)
    nc = tt.nc
    rng = np.random.default_rng(3)
    r = rng.uniform(0.05, 0.95, size=(500, 2))
    w = rng.uniform(0.5, 2.0, size=500)
    want = jpart.particles_to_grid(zeros(jt), jt, 0, r, w, order=order,
                                   density=False)
    got = tpart.particles_to_grid(torch.as_tensor(zeros(tt)), tt, 0, r, w,
                                  order=order, density=False).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    leaves = np.concatenate([np.asarray(l) for l in tt.lvl_leaves])
    interior = sp.interior_flat(tt.ndim, nc)
    np.testing.assert_allclose(got[0, leaves[:, None], interior[None, :]]
                               .sum(), w.sum(), rtol=1e-12)


@pytest.mark.parametrize("coord", ["xyz", "cyl"])
def test_density_deposit_integrates_back(coord):
    jt, tt = trees(coord=coord)
    nc = tt.nc
    r = np.array([[0.7, 0.7], [0.12, 0.08]])
    w = np.array([3.0, 5.0])
    want = jpart.particles_to_grid(zeros(jt), jt, 0, r, w, order=0,
                                   density=True)
    got = tpart.particles_to_grid(torch.as_tensor(zeros(tt)), tt, 0, r, w,
                                  order=0, density=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    total = 0.0
    interior = sp.interior_flat(tt.ndim, nc)
    for lvl in range(1, tt.highest_lvl + 1):
        leaves = np.asarray(tt.lvl_leaves[lvl - 1])
        if not len(leaves):
            continue
        dr = tt.lvl_dr(lvl)
        vals = got[0, leaves[:, None], interior[None, :]]
        if coord == "cyl":
            r0 = tt.box_r_min(leaves)[:, 0]
            r_cc = r0[:, None] + (np.arange(nc) + 0.5)[None, :] * dr[0]
            vol = 2 * np.pi * np.repeat(r_cc, nc, 1) * np.prod(dr)
            total += float((vals * vol).sum())
        else:
            total += float(vals.sum()) * float(np.prod(dr))
    np.testing.assert_allclose(total, 8.0, rtol=1e-12)
    if coord == "cyl":
        with pytest.raises(ValueError, match="order 0"):
            tpart.particles_to_grid(torch.as_tensor(zeros(tt)), tt, 0, r, w,
                                    order=1, density=True)


def test_linear_interpolation_exact_for_linear_field():
    jt, tt = trees()
    nc = tt.nc
    cc = zeros(tt)
    for lvl in range(1, tt.highest_lvl + 1):
        ids = np.asarray(tt.lvl_ids[lvl - 1])
        dr = tt.lvl_dr(lvl)
        r0 = tt.box_r_min(ids)
        ax = np.arange(nc + 2) - 0.5
        gx, gy = np.meshgrid(ax, ax, indexing="ij")
        for k, b in enumerate(ids):
            x = r0[k, 0] + gx * dr[0]
            y = r0[k, 1] + gy * dr[1]
            cc[0, int(b)] = (2 * x + 3 * y + 1).ravel()
    rng = np.random.default_rng(5)
    r = np.concatenate([rng.uniform(0.1, 0.9, size=(200, 2)),
                        [[-0.5, 0.5]]])
    want = jpart.grid_to_particles(cc, jt, 0, r)
    got = tpart.grid_to_particles(torch.as_tensor(cc), tt, 0, r).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    np.testing.assert_allclose(got[:-1], 2 * r[:-1, 0] + 3 * r[:-1, 1] + 1,
                               rtol=1e-12)
    assert got[-1] == 0.0
