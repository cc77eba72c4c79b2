#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afivo_streamer_tpu_torch) on one
NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, nvcc and nvidia-smi, and imports nothing of JAX. Phases (any
failure exits non-zero):

1. build the smoother kernels from afivo_streamer_tpu_torch/csrc (one nvcc
   per source, started together);
2. hold each kernel (2D: K1 fill_sweep_2d, K2 sweep_2d, K3 fill_2d; 3D:
   K4 sweep_3d, K5 fill_3d) against its plain PyTorch version on the card
   at the slices' shapes (n = 4096 boxes, nc = 8) in float64 and float32,
   and time both;
3. run the committed 2D slice config on the card and on the CPU (plain
   kernels) at 64 x 64 cells for 3 steps and compare the states; 3b. the
   same for the 3D slice config at 32^3 cells;
4. run the full-size 2D slice (uniform 512 x 512 cells, 5460 boxes,
   float64) through Simulation/run, counting the kernel launches;
5. run the full-size 3D slice (uniform 128^3 cells, 4680 boxes, float64,
   10 steps) the same way.

The launch counts are set to 0 just before each full-size run and read
just after it. The line before the last is a JSON object with one entry
per kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
CFG = {2: DATA / "air_cyl_slice.cfg", 3: DATA / "air_3d_slice.cfg"}
TABLE = DATA / "td_air_synthetic.txt"
SOURCE = {2: "afivo_streamer_tpu_torch/csrc/smoother.cu",
          3: "afivo_streamer_tpu_torch/csrc/smoother_3d.cu"}
REPLACES = {"fill_sweep_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:397",
            "sweep_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:229",
            "fill_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:302",
            "sweep_3d": "afivo_streamer_tpu/ops/pallas_smoother.py:574",
            "fill_3d": "afivo_streamer_tpu/ops/pallas_smoother.py:637"}
N_BOXES, NC = 4096, 8
#: kernel vs plain tolerance: float64 to rounding (the kernel may fuse a
#: multiply-add), float32 to its own rounding
TOL = {"float64": 1e-12, "float32": 2e-5}
SMALL_STEPS = 3
#: full-size runs per dimension: refine_max_dx, leaf cells, boxes, steps
FULL = {2: (3.2e-5, 512 ** 2, 5460, 20), 3: (1.25e-4, 128 ** 3, 4680, 10)}
#: the cuda-vs-cpu runs per dimension: refine_max_dx and a label
SMALL = {2: (2.5e-4, "64x64"), 3: (5e-4, "32^3")}
BACKGROUND_FIELD = 1.8e6  # V/m, the configs' field_given_by


def log(msg):
    print(msg, flush=True)


def kernel_inputs(torch, dtype, device, seed, ndim):
    """Random blocks at the slices' shapes, a neighbor table with random
    self-rows, and a stencil with |c0| >= 1."""
    gen = torch.Generator().manual_seed(seed)
    n, nc, C = N_BOXES, NC, NC + 2
    nd = 2 * ndim
    cube = (nc,) * ndim

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)
    g = torch.empty((n, 1 + nd), dtype=torch.int32)
    g[:, 0] = torch.arange(n, dtype=torch.int32)
    g[:, 1:] = torch.randint(0, n, (n, nd), generator=gen, dtype=torch.int32)
    selfrow = torch.rand((n, nd), generator=gen) < 0.25
    g[:, 1:][selfrow] = g[:, :1].expand(n, nd)[selfrow]
    cs = rnd(n, 2 + nd, *cube)
    cs[:, 0] = -(1.0 + torch.rand((n,) + cube, generator=gen,
                                  dtype=torch.float64))
    idx = torch.arange(1, nc + 1)
    parity = sum(torch.meshgrid(*[idx] * ndim, indexing="ij"))
    mask = ((parity % 2) == 1).to(torch.float32)
    x = {"phi3": rnd(n, *(C,) * ndim), "R": rnd(n, *cube),
         "A": rnd(n, nd, *(nc,) * (ndim - 1)), "W": rnd(n, nd, 8), "cs": cs}
    x = {k: v.to(dtype) for k, v in x.items()}
    x.update(mask=mask, g=g)
    return {k: v.to(device).contiguous() for k, v in x.items()}


def ndim_of(name):
    return int(name[-2])


def call(fn, x, name):
    if name in ("sweep_2d", "sweep_3d"):
        return fn(x["phi3"], x["R"], x["mask"], x["g"], x["cs"])
    if name in ("fill_2d", "fill_3d"):
        return fn(x["phi3"], x["A"], x["g"], x["W"])
    return fn(x["phi3"], x["R"], x["mask"], x["A"], x["g"], x["W"], x["cs"])


def time_ms(torch, fn, reps=50):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernels(torch, ks):
    """Phase 2: every kernel against its plain version, float64 and
    float32; returns per-kernel float64 results."""
    results = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        xs = {nd: kernel_inputs(torch, dtype, "cuda", 20261016, nd)
              for nd in (2, 3)}
        for name, fn in ks.KERNELS.items():
            x = xs[ndim_of(name)]
            want = call(ks.PLAIN[name], x, name)
            got = call(fn, x, name)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = err <= TOL[dname] * max(scale, 1.0)
            ms = time_ms(torch, lambda: call(fn, x, name))
            plain_ms = time_ms(torch, lambda: call(ks.PLAIN[name], x, name))
            log(f"phase 2: {name} {dname} max_abs_err={err:.3e} "
                f"(tol {TOL[dname]:.0e} x {max(scale, 1.0):.3g}) "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            if not ok:
                raise RuntimeError(f"{name} {dname} disagrees with its plain "
                                   f"version: {err}")
            if dtype == torch.float64:
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms}
    return results


def slice_argv(out, ndim, refine_max_dx, device):
    return [str(CFG[ndim]), f"-ndim={ndim}", f"-refine_max_dx={refine_max_dx}",
            f"-input_data%file={TABLE}", f"-output%name={out}",
            f"-device={device}"]


def phase_cpu_vs_cuda(torch, Simulation, out_dir, ndim):
    """Phase 3 (2D, 64 x 64 cells) and 3b (3D, 32^3 cells): the port on the
    card against the port on the CPU (plain kernels), float64, 3 steps,
    rtol 1e-9 per variable."""
    phase = "3" if ndim == 2 else "3b"
    refine_max_dx, label = SMALL[ndim]
    sims = {}
    for dev in ("cpu", "cuda"):
        sim = Simulation(argv=slice_argv(out_dir / f"small{ndim}d_{dev}",
                                         ndim, refine_max_dx, dev))
        sim.run(max_steps=SMALL_STEPS)
        sims[dev] = sim
    a = sims["cpu"].cc
    b = sims["cuda"].cc.cpu()
    n = sims["cpu"].tree.highest_id
    worst = 0.0
    for iv, name in enumerate(sims["cpu"].registry.cc_names):
        ref = a[iv, :n]
        scale = float(ref.abs().max())
        err = float((b[iv, :n] - ref).abs().max())
        rel = err / scale if scale > 0 else err
        worst = max(worst, rel)
        if not torch.allclose(b[iv, :n], ref, rtol=1e-9, atol=1e-9 * scale):
            raise RuntimeError(f"cuda vs cpu: cc[{name}] max abs diff {err} "
                               f"(scale {scale})")
    if sims["cpu"].global_dt != sims["cuda"].global_dt:
        dt_rel = abs(sims["cpu"].global_dt / sims["cuda"].global_dt - 1)
        if dt_rel > 1e-9:
            raise RuntimeError(f"cuda vs cpu: dt differs by {dt_rel}")
    log(f"phase {phase}: cuda vs cpu at {label}, {SMALL_STEPS} steps: worst "
        f"variable-scaled deviation {worst:.3e} (limit 1e-9)")


def phase_full_slice(torch, ks, Simulation, mgb, out_dir, ndim):
    """Phase 4 (2D) and 5 (3D): a full-size slice on the card; returns the
    launch counts of that run's kernels."""
    phase = "4" if ndim == 2 else "5"
    refine_max_dx, want_cells, want_boxes, steps = FULL[ndim]
    torch.cuda.reset_peak_memory_stats()
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(argv=slice_argv(out_dir / f"full{ndim}d", ndim,
                                     refine_max_dx, "cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: fn.launches for name, fn in ks.KERNELS.items()
                if ndim_of(name) == ndim}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaf = sum(len(l) for l in sim.tree.lvl_leaves) * sim.tree.nc ** ndim
    n_boxes = sim.tree.highest_id
    log(f"phase {phase}: {n_leaf} leaf cells, {n_boxes} boxes, "
        f"{sim.tree.highest_lvl} levels; setup {t1 - t0:.2f} s, "
        f"{steps} steps {t2 - t1:.2f} s = "
        f"{1e3 * (t2 - t1) / steps:.2f} ms/step; t = "
        f"{sim.global_time:.4e} s, dt = {sim.global_dt:.4e} s; peak memory "
        f"{peak_gb:.3f} GB")
    log(f"phase {phase}: kernel launches {launches}")
    if n_leaf != want_cells or n_boxes != want_boxes:
        raise RuntimeError(f"unexpected mesh: {n_leaf} cells, {n_boxes} boxes")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    if not bool(torch.isfinite(sim.cc[:, :n_boxes]).all()) or \
            not bool(torch.isfinite(sim.fc[:, :, :n_boxes]).all()):
        raise RuntimeError("non-finite state after the full slice")
    emax = float(sim.cc[sim.i_electric_fld, :n_boxes].max())
    log(f"phase {phase}: max(E) = {emax:.4e} V/m (background "
        f"{BACKGROUND_FIELD:.2e})")
    if not emax > BACKGROUND_FIELD:
        raise RuntimeError("max(E) did not rise above the background field")

    # V-cycle time on the final state (gather once, then cycles); these
    # launches are not counted as the run's
    mg = sim.field.mg
    params = {"voltage": sim.field.current_voltage}
    P, R = mgb.gather_levels(mg, sim.cc)
    vc_ms = time_ms(torch, lambda: mgb.fas_vcycle_blocks(mg, P, R, params),
                    reps=10)
    log(f"phase {phase}: {vc_ms:.3f} ms per V-cycle ({sim.tree.highest_lvl} "
        f"levels, float64)")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "afivo_streamer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from afivo_streamer_tpu_torch.ops import smoother as ks
    from afivo_streamer_tpu_torch.driver import Simulation
    from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = ks.build_libraries()
    for entry in built:
        ks._library(entry)
    log(f"phase 1: built {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for _path, build_log in built.values():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 1: ptxas {line.strip()}")

    results = phase_kernels(torch, ks)
    out_dir = ROOT / "out" / "chip_smoke"
    for ndim in (2, 3):
        phase_cpu_vs_cuda(torch, Simulation, out_dir, ndim)
    launches = {}
    for ndim in (2, 3):
        launches.update(phase_full_slice(torch, ks, Simulation, mgb,
                                         out_dir, ndim))

    kernels = [{"name": name, "route": "cuda",
                "source": SOURCE[ndim_of(name)],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]}
               for name in ks.KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
