"""Multigrid cycle benchmark (the V-cycle us/cell metric).

Twin of the JAX package's ``tools/poisson_bench.py``, on this package's
``solvers/multigrid.Multigrid``: ``python -m
afivo_streamer_tpu_torch.tools.poisson_bench [-device=cpu] [-nc 16]
[-cgs 16] [-max_lvl 4] [-n_cycles 10] [-reps 5] [-no_fmg]``.

The analog of the reference's multigrid benchmark
(``afivo/examples/poisson_benchmark.f90:96-143``): a uniformly refined 2D
mesh (box size ``nc``, coarse grid ``cgs``^2, refined to level
``max_lvl``), rhs = 1, Dirichlet-zero boundaries. It runs ``n_cycles``
FAS V-cycles from phi = 0 and records the max leaf residual after each,
then times ``reps`` rounds of ``n_cycles`` V-cycles (and FMG cycles), each
round ended by a ``torch.cuda.synchronize()`` on the card, and reports
the median milliseconds and microseconds per leaf cell per cycle and the
smoother kernels' launches per V-cycle. The state is float32 on the card
and float64 on the CPU, as the JAX tool picks float32 on its accelerator
(the compiled engine's ``compiled%dtype=float32``). Prints one JSON line.
"""

import argparse
import json
import time

import numpy as np
import torch

from ._args import add_device
from ..core import ghostcell as gc
from ..core import spatial as sp
from ..core.levels import MeshPlans
from ..core.tree import Tree
from ..ops import smoother as ks
from ..solvers import mg_blocks as mgb
from ..solvers.multigrid import Multigrid

I_PHI, I_RHS = 0, 1


def _bc(iv, d, coords, params):
    return gc.BC_DIRICHLET, 0.0


def setup(nc=16, cgs=16, max_lvl=4, device="cpu", dtype=None):
    """The uniform mesh, its state [3, boxes + 8, (nc+2)^2] (phi = 0,
    rhs = 1 on every box, the JAX tool's layout) with phi's ghosts filled,
    and its Multigrid."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    t = Tree(2, nc, [1.0, 1.0], [cgs, cgs])
    t.refine_up_to_lvl(max_lvl)
    cc = torch.zeros((3, t.highest_id + 8, (nc + 2) ** 2), dtype=dtype,
                     device=device)
    interior = torch.as_tensor(sp.interior_flat(2, nc), device=device)
    ids = torch.as_tensor(np.concatenate([np.asarray(a) for a in t.lvl_ids]),
                          dtype=torch.int64, device=device)
    cc[I_RHS, ids[:, None], interior[None, :]] = 1.0
    mg = Multigrid(MeshPlans(t, device, dtype=dtype), I_PHI, I_RHS, _bc)
    return t, mg.fill_ghosts_phi(cc, {}), mg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(nc=16, cgs=16, max_lvl=4, n_cycles=10, reps=5, fmg=True,
        device="cuda"):
    """Residuals of ``n_cycles`` V-cycles from phi = 0, then the timings
    (median seconds of ``reps`` rounds of ``n_cycles`` cycles)."""
    t, cc, mg = setup(nc, cgs, max_lvl, device)
    device = cc.device
    n_leaf = sum(len(t.lvl_leaves[l]) for l in range(t.highest_lvl)) \
        * nc * nc
    residuals = []
    ks.reset_launch_counts()
    d = cc
    for _ in range(n_cycles):
        d, res = mg.vcycle(d, {})
        residuals.append(float(res))
    launches = {name: fn.launches / n_cycles
                for name, fn in ks.KERNELS.items() if fn.launches}

    def vcycle(x):
        return mg.vcycle(x, {})

    def fmg_cycle(x):
        P, R = mgb.gather_levels(mg, x)
        P, R = mgb.fas_fmg_blocks(mg, P, R, {})
        res = mgb.max_leaf_residual_blocks(mg, P, R)
        return mgb.scatter_levels(mg, x, P, R), res

    def time_unit(fn, x):
        fn(x)  # warm-up: the level tables are built at the first cycle
        ts = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n_cycles):
                x, res = fn(x)
            _sync(device)
            ts.append((time.perf_counter() - t0) / n_cycles)
        return float(np.median(ts)), float(res)

    t_v, res_v = time_unit(vcycle, d)
    out = {
        "backend": device.type,
        "dtype": str(cc.dtype).replace("torch.", ""),
        "n_leaf_cells": int(n_leaf),
        "levels": int(t.highest_lvl),
        "vcycle_ms": round(t_v * 1e3, 3),
        "vcycle_us_per_cell": round(t_v / n_leaf * 1e6, 4),
        "final_residual": res_v,
        "residuals": residuals,
        "launches_per_vcycle": launches,
    }
    if fmg:
        t_f, _ = time_unit(fmg_cycle, cc)
        out["fmg_ms"] = round(t_f * 1e3, 3)
        out["fmg_us_per_cell"] = round(t_f / n_leaf * 1e6, 4)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("-nc", type=int, default=16)
    ap.add_argument("-cgs", type=int, default=16)
    ap.add_argument("-max_lvl", type=int, default=4)
    ap.add_argument("-n_cycles", type=int, default=10)
    ap.add_argument("-reps", type=int, default=5)
    ap.add_argument("-no_fmg", action="store_true")
    args = ap.parse_args(argv)
    out = run(args.nc, args.cgs, args.max_lvl, args.n_cycles, args.reps,
              not args.no_fmg, args.device)
    out["metric"] = "poisson_benchmark 2D V-cycle (afivo " \
        "examples/poisson_benchmark.f90 analog)"
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
