"""Time decomposition of a production step.

Twin of the JAX package's ``tools/profile_step.py``: ``python -m
afivo_streamer_tpu_torch.tools.profile_step [CONFIG] [-ndim 2]
[-device=cpu] [-key=value ...]`` (CONFIG defaults to the main path's
``data/air_cyl_amr_slice.cfg``; further ``-key=value`` flags go to the
simulation; ``PROF_STEPS``, default 30, sets the warm-up steps as in the
JAX tool). The state is float32 on the card (``-compiled%enabled=T
-compiled%dtype=float32``) and float64 on the CPU, as the JAX tool picks
float32 on its accelerator.

It runs the warm-up steps, timing each step, then times each unit of the
step separately on the warm state, each call ended by a
``torch.cuda.synchronize()`` on the card (the median of 5): a whole step,
the convergence-controlled field solve, one V-cycle, one flux and
chemistry substep, and the refinement epoch's restrict and ghost fill,
then one refinement epoch. Where the JAX tool counts the fusions of each
unit's optimized HLO, this one counts the smoother kernels each unit
launches (ops/smoother.py's counters; none on the CPU, where the plain
versions run). The V-cycle and the substep run on copies of the state.
Prints one ``PROF {...}`` line per unit as it goes and the whole report as
JSON at the end.
"""

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ._args import add_device
from ..core import reductions as red
from ..ops import smoother as ks

CONFIG = Path(__file__).resolve().parent.parent / "data" / \
    "air_cyl_amr_slice.cfg"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device, prep=None, reps=5):
    """Median wall seconds of ``fn(*prep())`` (``prep`` untimed), each
    call synchronised, after one untimed call; and the kernels the first
    timed call launched."""
    prep = prep or (lambda: ())
    fn(*prep())
    ts, launches = [], None
    for _ in range(reps):
        args = prep()
        ks.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
        if launches is None:
            launches = {n: f.launches for n, f in ks.KERNELS.items()
                        if f.launches}
    return float(np.median(ts)), launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=str(CONFIG))
    ap.add_argument("-ndim", type=int, default=2)
    add_device(ap)
    args, extra = ap.parse_known_args(argv)
    from ..driver import Simulation

    device = torch.device(args.device)
    dtype = "float32" if device.type == "cuda" else "float64"
    out_dir = tempfile.mkdtemp(prefix="prof_")
    t0 = time.perf_counter()
    sim = Simulation(argv=[
        args.config, f"-ndim={args.ndim}", f"-device={args.device}",
        f"-output%name={out_dir}/run", "-compiled%enabled=T",
        f"-compiled%dtype={dtype}"] + extra)
    setup_s = time.perf_counter() - t0
    device = sim.device

    steps, refine_steps = [], []

    def per_step(s, tnow):
        _sync(device)
        steps.append(time.perf_counter())
        refine_steps.append(s.it % s.refine_cfg.per_steps == 0)

    sim.user.generic = per_step
    n_warm = int(os.environ.get("PROF_STEPS", "30"))
    t0 = time.perf_counter()
    sim.run(max_steps=n_warm)
    run_s = time.perf_counter() - t0
    sim.user.generic = None
    d = np.diff(np.asarray(steps))
    refine_mask = np.asarray(refine_steps[1:], bool)[:len(d)]

    report = {
        "backend": device.type,
        "dtype": dtype,
        "setup_s": round(setup_s, 1),
        "warmup_steps": n_warm,
        "warmup_wall_s": round(run_s, 1),
        "n_cells": int(red.n_leaf_cells(sim.tree)),
        "levels": int(sim.tree.highest_lvl),
        "step_ms_median": round(float(np.median(d)) * 1e3, 1)
        if len(d) else None,
        "step_ms_p10": round(float(np.percentile(d, 10)) * 1e3, 1)
        if len(d) else None,
        "step_ms_refine_median": round(
            float(np.median(d[refine_mask])) * 1e3, 1)
        if refine_mask.any() else None,
        "step_ms_norefine_median": round(
            float(np.median(d[~refine_mask])) * 1e3, 1)
        if (~refine_mask).any() else None,
    }
    print("PROF " + json.dumps(report), flush=True)

    def put(unit, seconds, launches):
        kv = {f"{unit}_ms": round(seconds * 1e3, 1),
              f"{unit}_launches": launches}
        report.update(kv)
        print("PROF " + json.dumps(kv), flush=True)

    # ---- the units on the warm state
    params = sim.field.solve_params({"voltage": sim.field.current_voltage})
    mg = sim.field.mg

    put("vcycle", *timeit(lambda cc: mg.vcycle(cc, params), device,
                          lambda: (sim.cc.clone(),)))

    def field_solve():
        sim.cc, sim.fc = sim.field.compute(sim.cc, sim.fc, 0,
                                           sim.global_time, True)
    put("field_solve", *timeit(field_solve, device))

    def substep(cc, fc):
        # the first substep of the run's integrator
        sim.fluid.forward_euler(cc, fc, sim.global_dt, None,
                                sim.global_time, 0, [0], [1.0], 1, 1, 2,
                                dict(params, dt_stiff=sim.global_dt))
    put("flux_substep", *timeit(substep, device,
                                lambda: (sim.cc.clone(), sim.fc.clone())))

    put("restrict_gc", *timeit(sim.restrict_and_gc_densities, device))

    def step():
        sim.run(max_steps=sim.it + 1)
    put("step", *timeit(step, device))

    # the refinement epoch on the warm tree: flags, the new mesh, its plans
    ks.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    sim.restrict_and_gc_densities()
    info = sim.adjust_refinement()
    _sync(device)
    report.update(refine_epoch_ms=round((time.perf_counter() - t0) * 1e3, 1),
                  refine_changed=bool(info.n_add or info.n_rm))
    print("PROF " + json.dumps({k: report[k] for k in
                                ("refine_epoch_ms", "refine_changed")}),
          flush=True)
    print(json.dumps(report, indent=1), flush=True)


if __name__ == "__main__":
    main()
