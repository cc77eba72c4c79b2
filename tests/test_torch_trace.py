"""The port's tracer (``afivo_streamer_tpu_torch/trace.py``) on the CPU:

(a) spans nest, their records point at their parents, self time is the
    duration less the nested spans', ``take()`` returns and clears what
    accumulated; with recording off no record is kept but the aggregates
    are, and no span leaves an object for the garbage collector; the clock
    is ``time.perf_counter_ns``;
(b) on the small 2D cell of the benchmark (``benchmark/tests/
    small_cells.py``), run with the benchmark's probes installed and
    recording on, the program's counters equal the probes': V-cycles per
    solve, FMG cycles per update and mode, the dt of every step, epochs
    and mesh changes, and the count of ``field`` and ``photoi`` spans
    (each program span inside the probe's span of the same call);
(c) the same run with recording off gives a bit-identical state and the
    same time steps;
(d) every blocking read of the main path is counted, and the counts of
    every step are the same in both runs of the seed;
(e) the command line's cost breakdown (``Simulation.wc``) is the self time
    of the spans under each step by part, so that the parts add up to no
    more than the steps' time;
(f) the refinement criterion reads its flags once per call
    (``sync.refine_flags``), and ``refine.seed_boxes`` counts the boxes
    its seed rule selected.
"""

import gc
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu_torch import trace
from afivo_streamer_tpu_torch.trace import Tracer

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
for p in (BENCH, BENCH / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from harness.probes import Probes  # noqa: E402
from harness.sides import Side, StopRun, cell_argv, drive  # noqa: E402
from harness.spec import Spec  # noqa: E402
from small_cells import small_cell  # noqa: E402

SEED = 2 ** 31 + 9
#: steps of a run: the first epoch that changes the mesh of this seed is
#: at step 20, after four photoionization updates and two rejected steps
STEPS = 20
#: the blocking reads of the main path without writers
MAIN_PATH_SITES = ("dt_lim_step", "rates", "JdotE", "dt_limits",
                   "tree_maxabs_cc", "extremum_index", "field_residual",
                   "photoi_residual",
                   "refine_flags", "compute_energy")


# ------------------------------------------------------------ (a) unit
def nested(tr):
    with tr.span("a"):
        with tr.span("b"):
            with tr.span("c"):
                pass
        with tr.span("b"):
            pass


@pytest.mark.parametrize("recording", [True, False])
def test_spans_nest_and_aggregate(recording):
    tr = Tracer()
    tr.recording = recording
    tr.step = 7
    nested(tr)
    out = tr.take()
    assert tr.totals["a"][0] == 1 and tr.totals["b"][0] == 2
    assert tr.totals["c"][0] == 1
    a, b, c = (tr.totals[k] for k in "abc")
    # self time: the duration less the nested spans'
    assert a[2] == a[1] - b[1]
    assert b[2] == b[1] - c[1]
    assert c[2] == c[1]
    if not recording:
        assert out["spans"] == [] and out["series"] == {}
        return
    names = [r[0] for r in out["spans"]]
    assert names == ["a", "b", "c", "b"]
    parents = [r[1] for r in out["spans"]]
    assert parents == [-1, 0, 1, 0]
    for name, parent, t0, t1, step in out["spans"]:
        assert 0 < t0 <= t1 and step == 7
        if parent >= 0:
            p = out["spans"][parent]
            assert p[2] <= t0 and t1 <= p[3]
    durations = {}
    for r in out["spans"]:
        durations[r[0]] = durations.get(r[0], 0) + r[3] - r[2]
    assert durations == {k: tr.totals[k][1] for k in "abc"}


def test_take_returns_and_clears():
    tr = Tracer()
    tr.recording = True
    tr.count("n", 2)
    tr.sample("v", 3)
    with tr.span("x"):
        tr.count("n")
    first = tr.take()
    assert first["counters"] == {"n": 3}
    assert first["series"] == {"v": [3]}
    assert [r[0] for r in first["spans"]] == ["x"]
    second = tr.take()
    assert second == {"spans": [], "series": {}, "counters": {}}
    tr.count("n")
    assert tr.take()["counters"] == {"n": 1}
    assert tr.counters == {"n": 4}
    with tr.span("y"):
        with pytest.raises(RuntimeError, match="inside the spans"):
            tr.take()


@pytest.mark.parametrize("recording", [True, False])
def test_spans_leave_nothing_for_the_garbage_collector(recording):
    """A span, recorded or not, leaves no object that Python's collector
    tracks, so recording brings no collection forward."""
    tr = Tracer(groups=("b",))
    tr.recording = recording
    with tr.span("step"):
        nested(tr)  # the span objects, frames and totals of each name
    enabled = gc.isenabled()
    gc.disable()
    try:
        gc.collect()
        before = gc.get_count()[0]
        for _ in range(2000):
            with tr.span("step"):
                nested(tr)
        grew = gc.get_count()[0] - before
    finally:
        if enabled:
            gc.enable()
    assert grew < 10
    assert len(tr.take()["spans"]) == (5 * 2001 if recording else 0)


@pytest.mark.parametrize("convert, value, want", [
    (float, torch.tensor(2.5, dtype=torch.float64), 2.5),
    (trace.to_numpy, torch.arange(3.0), np.arange(3.0)),
    (trace.to_list, torch.tensor([1.0, 2.0]), [1.0, 2.0])])
def test_host_read_returns_the_read_and_counts_it(convert, value, want):
    tr = Tracer()
    tr.recording = True
    got = tr.host_read(value, "here", convert)
    assert type(got) is type(want)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    out = tr.take()
    assert out["counters"] == {"sync.here": 1}
    assert [r[0] for r in out["spans"]] == ["sync.here"]


def test_the_clock_is_perf_counter_ns():
    tr = Tracer()
    tr.recording = True
    before = time.perf_counter_ns()
    with tr.span("x"):
        pass
    after = time.perf_counter_ns()
    (_n, _p, t0, t1, _s), = tr.take()["spans"]
    assert before <= t0 <= t1 <= after
    assert trace.clock_ns is time.perf_counter_ns


def test_groups_count_self_time_under_the_root_only():
    tr = Tracer(groups=("g", "h"))
    tr.recording = True
    with tr.span("g"):  # outside the root: in no group
        pass
    with tr.span("step"):
        with tr.span("g"):
            with tr.span("x"):  # in g's group
                with tr.span("h"):
                    pass
        with tr.span("y"):  # under the root, in no group
            pass
    _g0, _step, g, x, h, _y = [r[3] - r[2] for r in tr.take()["spans"]]
    assert tr.group_ns["h"] == h
    assert tr.group_ns["g"] == (g - x) + (x - h)
    assert tr.group_seconds("g") == pytest.approx(1e-9 * (g - h))
    assert tr.group_seconds("nothing") == 0.0


# --------------------------------------------------- (b)-(e) the cell
def run_cell(recording: bool):
    """The small 2D cell for STEPS steps with the probes (spans on the
    host's clock where recording) and the tracer's recording as given."""
    torch.set_num_threads(1)
    spec = Spec(ROOT / "BENCHMARK.json")
    cell = small_cell(spec, "cyl_amr_2048")
    side = Side("program")
    with tempfile.TemporaryDirectory() as tmp:
        sim = side.simulation(cell_argv(cell, str(Path(tmp) / "run"),
                                        "cpu"), SEED)
        probes = Probes(sim, side, torch)
        probes.mode = "mark" if recording else "off"
        sim.tracer.take()  # the set-up's
        sim.tracer.recording = recording
        per_step, attempts, seed_boxes = [], [], []
        summary = sim.refiner.box_summary

        def criterion(cc, ids, ref_buffer):
            # the boxes the seed rule selects: max_dx > init_fac * width
            r, t = sim.refiner, sim.tree
            max_dx = (t.dr_base[None, :]
                      / 2.0 ** (t.lvl[ids][:, None] - 1.0)).max(axis=1)
            seed_boxes.append(int(np.sum(
                max_dx > r.rs.init_fac * min(r.ic.seed_width)))
                if r.time < r.rs.init_time else 0)
            return summary(cc, ids, ref_buffer)
        sim.refiner.box_summary = criterion

        def at_step(done):
            per_step.append(dict(sim.tracer.counters))
            attempts.append(len(probes.dts))
            if done >= STEPS:
                raise StopRun
        try:
            drive(sim, at_step)
        finally:
            probes.remove()
        out = {"taken": sim.tracer.take(), "per_step": per_step,
               "attempts": attempts, "cc": sim.cc.clone(),
               "dts": list(probes.dts), "vcycles": list(probes.vcycles),
               "fmg": [list(f) for f in probes.fmg],
               "epochs": probes.epochs,
               "mesh_changes": probes.mesh_changes,
               "spans": list(probes.spans), "wc": sim.wc,
               "seed_boxes": seed_boxes,
               "step_s": 1e-9 * sim.tracer.totals["step"][1]}
    return out


@pytest.fixture(scope="module")
def runs():
    return {True: run_cell(True), False: run_cell(False)}


def accepted_dts(run):
    """The dt of each step's last attempt, which the step took."""
    return [run["dts"][n - 1] for n in run["attempts"][1:]]


def test_program_counters_equal_the_probes(runs):
    """(b)."""
    run = runs[True]
    got = run["taken"]
    series, counters = got["series"], got["counters"]
    assert series["vcycles"] == run["vcycles"]
    assert series["fmg_cycles"] == run["fmg"]
    assert series["dt"] == accepted_dts(run)
    assert len(series["dt"]) == STEPS
    assert (len(run["dts"]) - STEPS
            == counters.get("steps_rejected", 0) > 0)
    assert counters["epochs"] == run["epochs"] == STEPS // 2
    assert counters["mesh_changes"] == run["mesh_changes"] == 1
    for name in ("field", "photoi", "epoch"):
        mine = [(s, e) for n, _p, s, e, _st in got["spans"] if n == name]
        theirs = [(s, e) for n, s, e in run["spans"] if n == name]
        assert len(mine) == len(theirs) > 0, name
        for (s, e), (ps, pe) in zip(mine, theirs):
            assert 1e9 * ps - 1e3 <= s <= e <= 1e9 * pe + 1e3, name


def test_recording_changes_no_number(runs):
    """(c)."""
    on, off = runs[True], runs[False]
    assert torch.equal(on["cc"], off["cc"])
    assert on["dts"] == off["dts"]
    assert on["vcycles"] == off["vcycles"] and on["fmg"] == off["fmg"]
    assert off["taken"]["spans"] == [] and off["taken"]["series"] == {}


@pytest.mark.parametrize("site", MAIN_PATH_SITES)
def test_every_host_read_is_counted_and_stable(runs, site):
    """(d)."""
    name = "sync." + site
    on, off = runs[True], runs[False]
    assert on["taken"]["counters"].get(name, 0) >= 1
    steps_on = [c.get(name, 0) for c in on["per_step"]]
    steps_off = [c.get(name, 0) for c in off["per_step"]]
    assert steps_on == steps_off
    # in the records: one span per count
    spans = [r for r in on["taken"]["spans"] if r[0] == name]
    assert len(spans) == on["taken"]["counters"].get(name, 0)


def test_cost_breakdown_is_the_self_time_by_part(runs):
    """(e)."""
    for run in runs.values():
        wc = run["wc"]
        assert list(wc) == ["flux", "source", "advance", "copy", "field",
                            "output", "refine", "photoi"]
        assert wc["advance"] == 0.0 and wc["output"] == 0.0
        assert all(wc[k] > 0 for k in ("flux", "source", "copy", "field",
                                       "refine", "photoi"))
        assert sum(wc.values()) <= run["step_s"]
    on = runs[True]
    taken = on["taken"]["spans"]
    # the solve and the update after the mesh change count under field and
    # photoi: each lies under the step's refine span
    refine = {i for i, r in enumerate(taken) if r[0] == "refine"}
    under = {r[0] for r in taken if r[1] in refine}
    assert {"restrict", "epoch", "field", "photoi"} <= under


def test_criterion_reads_and_seed_boxes_are_counted(runs):
    """(f)."""
    for run in runs.values():
        counters = run["taken"]["counters"]
        calls = run["seed_boxes"]
        assert (len(calls) == counters["sync.refine_flags"]
                == counters["epochs"] == STEPS // 2)
        assert counters["refine.seed_boxes"] == sum(calls) > 0
