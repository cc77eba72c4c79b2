"""One run of one cell: set-up, the timed window, the check.

1. **Set-up.** The program's kernels are built into the checkout (or
   found built there; the compile is timed apart too), its
   ``Simulation`` is made from the cell's settings, the seed's stochastic
   background is added, and ``Simulation.run`` starts: its first steps
   warm up until the traffic's ``warmup`` counts are met (photoionization
   updates and epochs that change the mesh, with their plan and table
   builds) or ``max_warmup_steps`` have run. Each probe is then checked to have seen its calls
   (``Probes.check``). What those steps produced is copied to the host for
   the check.
2. **The window.** The same ``run`` call goes on, one step after the
   last, for a fixed number of steps (``window_steps``), a synchronize at
   each edge. A live mesh makes the steps unlike (an epoch that changes the
   mesh and the photoionization update after it cost ten times a plain
   step, and they come irregularly), so the window is fixed work, the
   same steps in every run and every version of the program, and not a
   fixed time, in which a faster program would reach other steps. The
   traffic's ``window_steps`` fill ``run_seconds`` of ``BENCHMARK.json``
   at the program's speed when the cell was added; ``seconds`` scales
   them, in whole ``whole_steps`` (the steps in which the epochs and
   updates repeat). ``step_ms``, the window's wall time over its steps,
   is reported where a cell lists it among its end-to-end metrics.
   With ``trace`` the window's first ``trace_steps`` steps are traced on
   the device (host spans taken on the clock alone), then the rest of the
   window runs with a synchronize at every span's edges for the per-layer
   times.
3. **The check.** Once the window has closed and the peak memory is read,
   the program is freed, and the frozen reference runs the same settings
   from the same seed for the same set-up steps. ``compare`` sets the two
   side by side.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from pathlib import Path

from . import compare as cmp
from .probes import Probes
from .roofline import KERNELS, WRAPPERS, kernel_family
from .sides import Side, StopRun, cell_argv, drive
from .spec import Cell, Spec, read_per_layer
from . import trace as tr

def window_steps(cell: Cell, seconds: float, run_seconds: float) -> int:
    """The steps of a window of ``seconds`` (see the module's docstring)."""
    whole = cell.traffic["whole_steps"]
    blocks = round(cell.traffic["window_steps"] * seconds
                   / (run_seconds * whole))
    return whole * max(1, blocks)


def warmed_up(cell: Cell, probes, done: int) -> bool:
    """Whether set-up ends after the steps so far (``done``): once they meet
    the traffic's ``warmup`` counts, or after ``max_warmup_steps`` in any
    case (a program that never changes the mesh then meets a reference
    that did, and is not correct)."""
    need = cell.traffic["warmup"]
    return ((probes.photoi_updates >= need.get("photoi_updates", 0)
             and probes.mesh_changes >= need.get("mesh_changes", 0))
            or done >= cell.traffic["max_warmup_steps"])


def _free(torch, cuda):
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


class CellRun:
    """One run of ``cell`` with ``seed``; ``run()`` returns the result
    line's object. ``device`` is ``cuda`` for a measured run; the tests
    run the same path on the CPU (``cpu``), where nothing is timed on a
    device and ``trace`` is refused."""

    def __init__(self, spec: Spec, cell: Cell, seed: int, seconds: float,
                 trace: bool, t_start: float, device: str = "cuda",
                 program_flags=()):
        import torch
        self.torch = torch
        self.spec, self.cell, self.seed = spec, cell, seed
        self.seconds, self.trace = float(seconds), bool(trace)
        self.t_start, self.device = t_start, device
        self.cuda = device == "cuda"
        self.program_flags = tuple(program_flags)
        if self.trace and not self.cuda:
            raise ValueError("a traced run needs the card")

    # ------------------------------------------------------------ the run
    def run(self) -> dict:
        torch = self.torch
        work = Path(tempfile.mkdtemp(prefix="bench_run_"))
        try:
            prog = Side("program")
            compile_s = prog.build_kernels() if self.cuda else 0.0
            if self.cuda:
                torch.cuda.reset_peak_memory_stats()
            sim = prog.simulation(
                cell_argv(self.cell, str(work / "program" / "run"),
                          self.device, self.program_flags), self.seed)
            probes = Probes(sim, prog, torch)
            w = self._window(sim, probes)
            peak = (torch.cuda.max_memory_allocated() if self.cuda else 0)
            rec = self._record(w, probes) if self.trace else None
            probes.remove()
            snap = w["snapshot"]
            del sim, probes, w["probes"]
            _free(torch, self.cuda)
            ref = reference_snapshot(self.cell, self.seed, snap["steps"],
                                     self.device, work / "reference")
            numbers = cmp.compare(snap, ref)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        correct, checks = cmp.judge(numbers, self.cell.limits)
        steps, window_s = w["steps"], w["window_s"]
        metrics = {}
        if not self.trace:
            e2e = {"step_ms": 1e3 * window_s / steps,
                   "peak_mem_gb": peak / 1e9,
                   "setup_s": w["setup_s"]}
            for m in self.cell.end_to_end:
                metrics[m.name] = {"value": e2e[m.name], "unit": m.unit}
        else:
            metrics = read_per_layer(self.spec, self.cell, rec)
        out = {"correct": bool(correct), "attempted": steps, "failed": 0,
               "metrics": metrics, "device": self._device(peak, rec),
               "compile_s": compile_s, "warmup_steps": snap["steps"],
               "window_s": window_s, "worst_variable":
                   numbers["worst_variable"]}
        if rec is not None:
            out["breakdown"] = rec["breakdown"]
        out["checks"] = checks
        return out

    def _device(self, peak, rec):
        torch = self.torch
        dev = {"platform": "gpu" if self.cuda else "cpu",
               "kind": (torch.cuda.get_device_name(0) if self.cuda
                        else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
        if rec is not None:
            dev["busy_s"] = rec["device"]["busy_s"]
            dev["window_s"] = rec["device"]["window_s"]
        return dev

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def _window(self, sim, probes) -> dict:
        """Warm up, then the window (see the module's docstring)."""
        trace_steps = self.cell.traffic["trace_steps"]
        steps = window_steps(self.cell, self.seconds, self.spec.run_seconds)
        if self.trace and steps <= trace_steps:
            raise ValueError(f"a traced window of {steps} steps holds no "
                             f"step after the {trace_steps} traced")
        torch = self.torch
        w = {"phase": "warmup", "probes": probes}

        def at_step(done):
            if w["phase"] == "warmup":
                if not warmed_up(self.cell, probes, done):
                    return
                probes.check(done)
                w["snapshot"] = cmp.snapshot(sim, probes, torch)
                w["start_step"] = done
                self._sync()
                w["t0"] = time.perf_counter()
                w["setup_s"] = w["t0"] - self.t_start
                w["phase"] = "window"
                if self.trace:
                    w["dtrace"] = tr.DeviceTrace(torch)
                    probes.spans.clear()
                    probes.launches.clear()
                    probes.mode, probes.record_launches = "mark", True
                    w["dtrace"].start()
                    w["phase"] = "traced"
                return
            n = done - w["start_step"]
            if w["phase"] == "traced" and n >= trace_steps:
                w["dtrace"].stop()
                probes.record_launches = False
                w["trace_spans"] = list(probes.spans)
                w["trace_launches"] = list(probes.launches)
                probes.spans.clear()
                probes.mode = "sync"
                w["span_from"] = self._counters(sim, probes, done)
                w["phase"] = "window"
            if n >= steps:
                self._sync()
                w["t1"] = time.perf_counter()
                w["steps"] = n
                w["window_s"] = w["t1"] - w["t0"]
                w["span_to"] = self._counters(sim, probes, done)
                raise StopRun

        drive(sim, at_step)
        return w

    @staticmethod
    def _counters(sim, probes, done):
        return {"step": done, "t": time.perf_counter(),
                "launches": probes.kernel_launches(),
                "build_s": sim.mesh.build_seconds,
                "vcycles": len(probes.vcycles), "fmg": len(probes.fmg)}

    def _record(self, w, probes) -> dict:
        """What the per-layer readers read from a traced run."""
        a, b = w.get("span_from"), w["span_to"]
        rec = {"steps": b["step"] - a["step"] if a else 0,
               "wall_s": b["t"] - a["t"] if a else 0.0,
               "spans": list(probes.spans) if a else [],
               "launches": b["launches"] - a["launches"] if a else 0,
               "plan_build_s": b["build_s"] - a["build_s"] if a else 0.0,
               "vcycles": probes.vcycles[a["vcycles"]:] if a else [],
               "fmg": probes.fmg[a["fmg"]:] if a else []}
        dt = w["dtrace"]
        t0, t1 = dt.window
        intervals = [(s, e) for _n, s, e in dt.events]
        busy = tr.union_seconds(intervals)
        kernels = {}
        for fam in KERNELS:
            ev = [(n, s, e) for n, s, e in dt.events
                  if kernel_family(n) == fam]
            launches = [x for x in w["trace_launches"]
                        if WRAPPERS[x[0]] == fam]
            # the profiler loses a trace's first events at times: pair the
            # kernels seen with the last launches
            launches = launches[len(launches) - min(len(ev),
                                                    len(launches)):]
            kernels[fam] = {"seconds": sum(e - s for _n, s, e in ev),
                            "events": len(ev), "launches": launches}
        rec["device"] = {"window_s": t1 - t0, "busy_s": busy,
                         "kernels": kernels}
        gaps = tr.idle_gaps(intervals, t0, t1)
        rec["breakdown"] = {
            "device_ops": [[tr.short_name(n), s] for n, s in
                           tr.top_ops(dt.events)],
            "idle_gaps": [[lab, s] for lab, s in
                          tr.idle_by_label(gaps, w["trace_spans"])]}
        return rec


def reference_snapshot(cell: Cell, seed: int, steps: int, device: str,
                       work: Path, extra=()) -> dict:
    """The frozen reference's snapshot after ``steps`` steps of the same
    settings and seed."""
    import torch
    ref = Side("reference")
    sim = ref.simulation(cell_argv(cell, str(work / "run"), device, extra),
                         seed)
    probes = Probes(sim, ref, torch)

    def at_step(done):
        if done >= steps:
            raise StopRun
    drive(sim, at_step)
    snap = cmp.snapshot(sim, probes, torch)
    probes.remove()
    del sim, probes
    _free(torch, device == "cuda")
    return snap


def program_snapshot(cell: Cell, seed: int, steps, device: str,
                     work: Path, flags=()) -> dict:
    """The program's snapshot after ``steps`` steps, or where ``steps`` is
    None after the set-up steps of a benchmark run (no window): the
    calibration's and the tests' reading of the program or of its float32
    control."""
    import torch
    prog = Side("program")
    if device == "cuda":
        prog.build_kernels()
    sim = prog.simulation(cell_argv(cell, str(work / "run"), device, flags),
                          seed)
    probes = Probes(sim, prog, torch)

    def at_step(done):
        if (done >= steps if steps is not None
                else warmed_up(cell, probes, done)):
            raise StopRun
    drive(sim, at_step)
    snap = cmp.snapshot(sim, probes, torch)
    probes.remove()
    del sim, probes
    _free(torch, device == "cuda")
    return snap


def finite(x):
    """A number for the result line: infinity as the string 'inf'."""
    if isinstance(x, float) and not math.isfinite(x):
        return "inf" if x > 0 else "nan"
    return x
