"""Tests on the CPU of what the harness reads from the program's own tracer
(``harness/program_trace.py`` and the readers of ``metrics/`` that use it):

the four readers and ``idle_gaps_program`` on synthetic records; a record
without ``rec["program"]`` (a program without a tracer), on which the
readers of the accepted metrics return what they returned before and the
new ones None; and a traced run of the small cell on the CPU with the
device trace replaced by synthetic activity, which passes
``Probes.check``, stays correct and reads every new metric.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))

from harness import program_trace as pt  # noqa: E402
from harness import trace  # noqa: E402
from harness.spec import Spec  # noqa: E402

from small_cells import small_cell  # noqa: E402

MS = 1_000_000  # ns


def spec():
    return Spec(ROOT / "BENCHMARK.json")


def records(base_ms: int = 0):
    """Two steps of synthetic records (name, parent, start_ns, end_ns,
    step): an epoch with its children in the first, a field solve with two
    V-cycles in the second; times in ms from ``base_ms``."""
    def r(name, parent, a, b, step):
        return (name, parent, (base_ms + a) * MS, (base_ms + b) * MS, step)
    return [r("step", -1, 0, 100, 1),                      # 0
            r("refine", 0, 10, 90, 1),                     # 1
            r("epoch", 1, 20, 80, 1),                      # 2
            r("epoch.consistency", 2, 20, 60, 1),          # 3
            r("epoch.flags", 3, 25, 40, 1),                # 4
            r("sync.refine_flags", 4, 35, 40, 1),          # 5
            r("epoch.apply", 2, 60, 70, 1),                # 6
            r("epoch.prolong", 2, 70, 78, 1),              # 7
            r("step", -1, 100, 200, 2),                    # 8
            r("field", 8, 110, 190, 2),                    # 9
            r("field.vcycle", 9, 120, 150, 2),             # 10
            r("sync.field_residual", 10, 140, 150, 2),     # 11
            r("field.vcycle", 9, 150, 180, 2),             # 12
            r("sync.field_residual", 12, 175, 180, 2),     # 13
            r("plans.build", 9, 181, 185, 2)]              # 14


def taken(spans, counters=None):
    return {"spans": spans, "series": {}, "counters": counters or {}}


def program_rec(**kw):
    rec = {"steps": 2, "wall_s": 0.2, "spans": [], "launches": 0,
           "plan_build_s": 0.004, "vcycles": [], "fmg": [],
           "device": {"window_s": 0.2, "busy_s": 0.05,
                      "kernels": {"2d": {"launches": [], "seconds": 0.0}}},
           "program": {"traced": taken(records()),
                       "synced": taken(records(), {
                           "sync.refine_flags": 1,
                           "sync.field_residual": 2, "epochs": 1})}}
    rec.update(kw)
    return rec


# --------------------------------------------------------- arithmetic
def test_paths_and_self_times():
    spans = records()
    paths = pt.paths(spans)
    assert paths[5] == "step/refine/epoch/epoch.consistency/epoch.flags/" \
        "sync.refine_flags"
    assert paths[14] == "step/field/plans.build"
    own = pt.self_ns(spans)
    assert own[3] == 25 * MS  # 40 less the 15 of epoch.flags
    assert own[2] == 60 * MS - 58 * MS
    assert own[9] == 80 * MS - 64 * MS
    assert pt.steps_of(taken(spans)) == 2
    assert pt.epoch_coverage(spans) == pytest.approx(58 / 60)


def test_idle_gaps_by_program_path():
    spans = records(1000)
    gaps = [(1.005, 1.008),   # step alone
            (1.026, 1.030),   # epoch.flags
            (1.036, 1.038),   # sync.refine_flags
            (1.079, 1.0795),  # epoch, between its children
            (1.141, 1.149),   # field.vcycle's sync
            (1.186, 1.189),   # field
            (1.3, 1.4)]       # no span open
    got = dict(pt.idle_gaps_program(gaps, spans, None))
    base = "step/refine/epoch/epoch.consistency/epoch.flags"
    assert got == pytest.approx({
        "step": 0.003, base: 0.004, base + "/sync.refine_flags": 0.002,
        "step/refine/epoch": 0.0005,
        "step/field/field.vcycle/sync.field_residual": 0.008,
        "step/field": 0.003, "driver": 0.1})
    # the labels the harness's own scan gives the same gaps
    labelled = [(p, 1e-9 * r[2], 1e-9 * r[3])
                for p, r in zip(pt.paths(spans), spans)]
    assert dict(trace.idle_by_label(gaps, labelled, None)) == \
        pytest.approx(got)
    assert [lab for lab, _s in pt.idle_gaps_program(gaps, spans, 2)] == \
        ["driver", "step/field/field.vcycle/sync.field_residual"]


def test_edges_against_the_probes():
    spans = records(1000)
    probes = [("epoch", 1.0195, 1.0801), ("field", 1.109, 1.1905)]
    e = pt.edge_gaps_ms(spans, probes, "epoch")
    assert e["program"] == e["probes"] == 1
    assert e["start_ms"] == pytest.approx([0.5, 0.5])
    assert e["end_ms"] == pytest.approx([0.1, 0.1])
    f = pt.edge_gaps_ms(spans, probes, "field")
    assert f["start_ms"][0] == pytest.approx(1.0)
    assert f["end_ms"][0] == pytest.approx(0.5)


# ------------------------------------------------------------ readers
@pytest.mark.parametrize("name, want", [
    ("host_syncs_per_step", 1.5),        # 3 reads over 2 synced steps
    ("host_wait_ms_per_step", 10.0),     # 5 + 10 + 5 ms over 2 steps
    ("epoch_flags_ms", 15.0),            # one epoch
    ("epoch_tree_ms", 35.0)])            # 25 self + 10
def test_program_readers(name, want):
    assert spec().reader(name)(program_rec()) == pytest.approx(want)


@pytest.mark.parametrize("name", pt.PROGRAM_METRICS)
def test_program_readers_without_a_program_record(name):
    read = spec().reader(name)
    rec = program_rec()
    del rec["program"]
    assert read(rec) is None
    rec["program"] = {"traced": taken([]), "synced": taken([])}
    assert read(rec) is None


def test_accepted_readers_unchanged_without_a_program_record():
    """A record as the accepted harness writes it (no ``program``): the
    accepted readers give what their own test holds them to."""
    s = spec()
    spans = [("fluid", 0.0, 1.0), ("field", 0.6, 0.9), ("fluid", 1.0, 1.5),
             ("epoch", 2.0, 2.4), ("photoi", 3.0, 3.2), ("field", 3.5, 3.6)]
    rec = {"steps": 2, "wall_s": 1.5, "spans": spans, "launches": 10,
           "plan_build_s": 0.1, "vcycles": [1, 1, 2],
           "fmg": [[1, 1, 1], [2, 1, 1]],
           "device": {"window_s": 2.0, "busy_s": 0.5,
                      "kernels": {"2d": {"launches": [], "seconds": 0.0}}}}
    want = {"wall_ms_per_step": 750.0, "fluid_ms_per_step": 600.0,
            "field_ms_per_solve": 200.0, "epoch_ms": 400.0,
            "photoi_ms_per_update": 200.0, "launches_per_step": 5.0,
            "plan_build_ms_per_step": 50.0, "vcycles_per_solve": 4 / 3,
            "fmg_cycles_per_update": 3.5, "device_idle_pct": 75.0}
    assert {m.name for m in s.per_layer} == set(want) | {
        "kernel_roofline_pct.2d"}
    with_program = dict(rec, program=program_rec()["program"])
    for r in (rec, with_program):
        got = {m.name: s.reader(m.name)(r) for m in s.per_layer}
        assert got.pop("kernel_roofline_pct.2d") is None
        assert got == pytest.approx(want)


# ------------------------------------------------ the path on the CPU
class SyntheticTrace:
    """Stands in for ``trace.DeviceTrace`` on the CPU: a window on the
    host's clock with device activity for 2 ms of every 10."""

    def __init__(self, torch):
        self.events, self.window = [], (0.0, 0.0)

    def start(self):
        self.t0 = 1e-9 * time.perf_counter_ns()

    def stop(self):
        t1 = 1e-9 * time.perf_counter_ns()
        self.window = (self.t0, t1)
        n = int((t1 - self.t0) / 0.01) + 1
        self.events = [("k", self.t0 + 0.01 * i, self.t0 + 0.01 * i + 0.002)
                       for i in range(n)]


def test_a_small_cell_traced_with_the_program_recording(monkeypatch):
    """The traced path (with synthetic device activity) on the CPU: the
    probes see their calls, the run is correct, the program's spans lie
    inside the probes' and every new metric reads."""
    s = spec()
    cell = small_cell(s, "cyl_amr_2048")
    cell.traffic["trace_steps"] = 4
    monkeypatch.setattr(trace, "DeviceTrace", SyntheticTrace)
    run = pt.ProgramTracedRun(s, cell, 2 ** 31 + 9, 0.3, False,
                              time.perf_counter(), device="cpu")
    run.trace = True  # the traced path, its device trace synthetic
    out = run.run()
    assert out["correct"], out["checks"]
    rec = run.rec
    for name in pt.PROGRAM_METRICS:
        assert s.reader(name)(rec) > 0, name
    idle = dict(out["breakdown"]["idle_gaps_program"])
    assert idle and all(lab == "driver" or lab.startswith("step")
                        for lab in idle)
    checks = rec["program_checks"]
    for name, e in checks["edges"].items():
        assert e["program"] == e["probes"], name
        assert min(e["start_ms"] + e["end_ms"]) >= 0.0, name
        assert max(e["start_ms"] + e["end_ms"]) <= 1.0, name
    assert checks["epoch_children_cover"] > 0.95
    assert pt.steps_of(rec["program"]["traced"]) == 4
    assert pt.steps_of(rec["program"]["synced"]) == rec["steps"]
