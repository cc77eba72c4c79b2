#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afivo_streamer_tpu_torch) on one
NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, nvcc and nvidia-smi, and imports nothing of JAX. Phases (any
failure exits non-zero):

1. build the smoother kernels from afivo_streamer_tpu_torch/csrc;
2. hold each kernel (K1 fill_sweep_2d, K2 sweep_2d, K3 fill_2d) against
   its plain PyTorch version on the card at the slice's shapes (n = 4096
   boxes, nc = 8) in float64 and float32, and time both;
3. run the committed slice config on the card and on the CPU (plain
   kernels) at 64 x 64 cells for 3 steps and compare the states;
4. run the full-size slice (uniform 512 x 512 cells, 5460 boxes, float64,
   20 steps) through Simulation/run, counting the kernel launches.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CFG = ROOT / "afivo_streamer_tpu_torch" / "data" / "air_cyl_slice.cfg"
TABLE = ROOT / "afivo_streamer_tpu_torch" / "data" / "td_air_synthetic.txt"
SOURCE = "afivo_streamer_tpu_torch/csrc/smoother.cu"
REPLACES = {"fill_sweep_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:397",
            "sweep_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:229",
            "fill_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:302"}
N_BOXES, NC = 4096, 8
#: kernel vs plain tolerance: float64 to rounding (the kernel may fuse a
#: multiply-add), float32 to its own rounding
TOL = {"float64": 1e-12, "float32": 2e-5}
SMALL_STEPS, BIG_STEPS = 3, 20
BACKGROUND_FIELD = 1.8e6  # V/m, the config's field_given_by


def log(msg):
    print(msg, flush=True)


def kernel_inputs(torch, dtype, device, seed):
    """Random blocks at the slice's shapes, a neighbor table with random
    self-rows, and a stencil with |c0| >= 1."""
    gen = torch.Generator().manual_seed(seed)
    n, nc, C = N_BOXES, NC, NC + 2

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)
    g = torch.empty((n, 5), dtype=torch.int32)
    g[:, 0] = torch.arange(n, dtype=torch.int32)
    g[:, 1:] = torch.randint(0, n, (n, 4), generator=gen, dtype=torch.int32)
    selfrow = torch.rand((n, 4), generator=gen) < 0.25
    g[:, 1:][selfrow] = g[:, :1].expand(n, 4)[selfrow]
    cs = rnd(n, 6, nc, nc)
    cs[:, 0] = -(1.0 + torch.rand((n, nc, nc), generator=gen,
                                  dtype=torch.float64))
    idx = torch.arange(1, nc + 1)
    mask = (((idx[:, None] + idx[None, :]) % 2) == 1).to(torch.float32)
    x = {"phi3": rnd(n, C, C), "R": rnd(n, nc, nc), "A": rnd(n, 4, nc),
         "W": rnd(n, 4, 8), "cs": cs}
    x = {k: v.to(dtype) for k, v in x.items()}
    x.update(mask=mask, g=g)
    return {k: v.to(device).contiguous() for k, v in x.items()}


def call(fn, x, name):
    if name == "sweep_2d":
        return fn(x["phi3"], x["R"], x["mask"], x["g"], x["cs"])
    if name == "fill_2d":
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
        x = kernel_inputs(torch, dtype, "cuda", seed=20261016)
        for name, fn in ks.KERNELS.items():
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


def slice_argv(out, refine_max_dx, device):
    return [str(CFG), "-ndim=2", f"-refine_max_dx={refine_max_dx}",
            f"-input_data%file={TABLE}", f"-output%name={out}",
            f"-device={device}"]


def phase_cpu_vs_cuda(torch, Simulation, out_dir):
    """Phase 3: the port on the card against the port on the CPU (plain
    kernels), 64 x 64 cells, float64, 3 steps, rtol 1e-9 per variable."""
    sims = {}
    for dev in ("cpu", "cuda"):
        sim = Simulation(argv=slice_argv(out_dir / f"small_{dev}", 2.5e-4,
                                         dev))
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
    log(f"phase 3: cuda vs cpu at 64x64, {SMALL_STEPS} steps: worst "
        f"variable-scaled deviation {worst:.3e} (limit 1e-9)")


def phase_full_slice(torch, ks, Simulation, mgb, out_dir):
    """Phase 4: the full-size slice on the card; returns launch counts."""
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(argv=slice_argv(out_dir / "full", 3.2e-5, "cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run(max_steps=BIG_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: fn.launches for name, fn in ks.KERNELS.items()}
    n_leaf = sum(len(l) for l in sim.tree.lvl_leaves) * sim.tree.nc ** 2
    n_boxes = sim.tree.highest_id
    log(f"phase 4: {n_leaf} leaf cells, {n_boxes} boxes, "
        f"{sim.tree.highest_lvl} levels; setup {t1 - t0:.2f} s, "
        f"{BIG_STEPS} steps {t2 - t1:.2f} s = "
        f"{1e3 * (t2 - t1) / BIG_STEPS:.2f} ms/step; t = "
        f"{sim.global_time:.4e} s, dt = {sim.global_dt:.4e} s")
    log(f"phase 4: kernel launches {launches}")
    if n_leaf != 512 * 512 or n_boxes != 5460:
        raise RuntimeError(f"unexpected mesh: {n_leaf} cells, {n_boxes} boxes")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    if not bool(torch.isfinite(sim.cc[:, :n_boxes]).all()) or \
            not bool(torch.isfinite(sim.fc[:, :, :n_boxes]).all()):
        raise RuntimeError("non-finite state after the full slice")
    emax = float(sim.cc[sim.i_electric_fld, :n_boxes].max())
    log(f"phase 4: max(E) = {emax:.4e} V/m (background {BACKGROUND_FIELD:.2e})")
    if not emax > BACKGROUND_FIELD:
        raise RuntimeError("max(E) did not rise above the background field")

    # V-cycle time on the final state (gather once, then cycles)
    mg = sim.field.mg
    params = {"voltage": sim.field.current_voltage}
    P, R = mgb.gather_levels(mg, sim.cc)
    vc_ms = time_ms(torch, lambda: mgb.fas_vcycle_blocks(mg, P, R, params),
                    reps=10)
    log(f"phase 4: {vc_ms:.3f} ms per V-cycle ({sim.tree.highest_lvl} "
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
    path, build_log = ks.build_library()
    ks._library()
    log(f"phase 1: built {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"phase 1: ptxas {line.strip()}")

    results = phase_kernels(torch, ks)
    out_dir = ROOT / "out" / "chip_smoke"
    phase_cpu_vs_cuda(torch, Simulation, out_dir)
    launches = phase_full_slice(torch, ks, Simulation, mgb, out_dir)

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
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
