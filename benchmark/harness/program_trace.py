"""What the program's own tracer recorded in a traced run, and what is read
from it.

The program (``afivo_streamer_tpu_torch/trace.py``) keeps one ``Tracer``
per simulation, ``sim.tracer``. While its ``recording`` is on, every span
is a record ``(name, parent, start_ns, end_ns, step)`` on
``time.perf_counter_ns``, the clock onto which ``trace.DeviceTrace`` maps
the card's events, and ``take()`` returns the records, the series and the
counters' increments since its last call. A record of a traced run holds
two of those under ``rec["program"]``: ``traced``, the steps traced on
the device, where the probes only take the clock, and ``synced``, the
steps after them, synchronized at the probes' edges. A program without a
tracer leaves ``rec["program"]`` out, and every reader here then returns
None.

``ProgramTracedRun`` is a traced run of a cell with the program's
recording switched on where the device trace starts (``recording``), the
two takes stored, the idle time of the traced window put down to the
innermost program span open over each gap (``idle_gaps_program``), and
the checks that the program's spans and the harness's agree.

Temporary: ``ProgramTracedRun`` and ``benchmark/trace_program.py``, which
runs it, stand in for an edit of ``harness/cell.py`` (recording on where
the device trace starts, the two takes, ``idle_gaps_program`` in the
breakdown), so that ``run.py --trace 1`` reports the four metrics. The
change that makes that edit deletes both, moves the metrics' units into
their ``per_layer`` entries of ``BENCHMARK.json`` and keeps of this module
the helpers ``program``, ``steps_of``, ``self_ns``, ``paths``,
``innermost_paths`` and ``idle_gaps_program``, with their tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from . import trace as tr
from .cell import CellRun

#: readers in ``metrics/`` of the program's spans and counters
PROGRAM_METRICS = ("host_syncs_per_step", "host_wait_ms_per_step",
                   "epoch_flags_ms", "epoch_tree_ms")


def program(rec: dict, part: str) -> Optional[dict]:
    """``rec["program"][part]`` of a traced run's record, None where the
    program recorded nothing."""
    taken = (rec.get("program") or {}).get(part)
    return taken if taken and taken.get("spans") else None


def steps_of(taken: dict) -> int:
    """The steps whose spans ``taken`` holds."""
    return sum(1 for r in taken["spans"] if r[0] == "step")


def self_ns(spans: Sequence[tuple]) -> List[int]:
    """Each record's self time: its duration less its children's (ns)."""
    own = [r[3] - r[2] for r in spans]
    for r in spans:
        if r[1] >= 0:
            own[r[1]] -= r[3] - r[2]
    return own


def paths(spans: Sequence[tuple]) -> List[str]:
    """Each record's path from the outermost span, joined by ``/``."""
    out: List[str] = []
    for r in spans:
        out.append(r[0] if r[1] < 0 else out[r[1]] + "/" + r[0])
    return out


def self_ms_per_step(taken: dict, top: int = 20) -> List[list]:
    """Self ms per step by span name, largest first."""
    sums: Dict[str, int] = {}
    for r, t in zip(taken["spans"], self_ns(taken["spans"])):
        sums[r[0]] = sums.get(r[0], 0) + t
    steps = max(steps_of(taken), 1)
    return [[k, 1e-6 * v / steps] for k, v in
            sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def innermost_paths(spans: Sequence[tuple], times: Sequence[float],
                    default: str = "driver") -> List[str]:
    """The path of the innermost record open at each of ``times`` (seconds,
    inclusive of the edges), ``default`` where none is: one sweep over the
    records' edges, which nest (``trace.label_at`` scans every span for
    every time, too slow for the thousands of records and gaps of a
    traced window)."""
    ps = paths(spans)
    events = ([(1e-9 * r[2], 0, i) for i, r in enumerate(spans)]
              + [(t, 1, k) for k, t in enumerate(times)]
              + [(1e-9 * r[3], 2, i) for i, r in enumerate(spans)])
    out = [default] * len(times)
    stack: List[int] = []
    for _t, kind, i in sorted(events):
        if kind == 0:
            stack.append(i)
        elif kind == 1:
            out[i] = ps[stack[-1]] if stack else default
        else:
            stack.remove(i)
    return out


def idle_gaps_program(gaps, spans, top: Optional[int] = 10):
    """Idle seconds summed by the path of the innermost program span open
    over each gap's middle (``driver`` where none is), largest first, as
    ``trace.idle_by_label`` sums the probes' spans."""
    sums: Dict[str, float] = {}
    labels = innermost_paths(spans, [0.5 * (a + b) for a, b in gaps])
    for lab, (a, b) in zip(labels, gaps):
        sums[lab] = sums.get(lab, 0.0) + (b - a)
    return [[lab, s] for lab, s in
            sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def epoch_coverage(spans: Sequence[tuple]) -> float:
    """The share of the ``epoch`` spans' time that their direct children
    cover."""
    total = sum(r[3] - r[2] for r in spans if r[0] == "epoch")
    kids = sum(r[3] - r[2] for r in spans
               if r[1] >= 0 and spans[r[1]][0] == "epoch")
    return kids / total if total else 0.0


def edge_gaps_ms(program_spans, probe_spans, name: str) -> dict:
    """How far the program's spans ``name`` lie inside the probes' spans
    of the same calls (paired in order): the largest gap at a start and
    at an end in ms, negative where a program span sticks out."""
    mine = [(1e-9 * r[2], 1e-9 * r[3]) for r in program_spans
            if r[0] == name]
    theirs = [(s, e) for n, s, e in probe_spans if n == name]
    start = [1e3 * (s - ps) for (s, _e), (ps, _pe) in zip(mine, theirs)]
    end = [1e3 * (pe - e) for (_s, e), (_ps, pe) in zip(mine, theirs)]
    return {"program": len(mine), "probes": len(theirs),
            "start_ms": [min(start, default=0.0), max(start, default=0.0)],
            "end_ms": [min(end, default=0.0), max(end, default=0.0)]}


class ProgramTracedRun(CellRun):
    """A traced run (``trace`` True, on the card) that also switches the
    program's recording on (where ``recording``) for the window: from
    ``Probes.check``, which opens it, the set-up's records dropped; taken
    when the device trace stops and at the window's end."""

    def __init__(self, *args, recording: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.recording = recording
        self.program: Dict[str, dict] = {}
        self.rec: Optional[dict] = None

    def _window(self, sim, probes):
        check = probes.check
        tracer = getattr(sim, "tracer", None)  # None: a program without

        def check_then_record(done):
            check(done)
            if tracer is not None:
                tracer.take()
                tracer.recording = self.recording
        probes.check = check_then_record
        return super()._window(sim, probes)

    def _counters(self, sim, probes, done):
        tracer = getattr(sim, "tracer", None)
        if tracer is not None:
            part = "synced" if "traced" in self.program else "traced"
            self.program[part] = tracer.take()
        return CellRun._counters(sim, probes, done)

    def _record(self, w, probes) -> dict:
        rec = super()._record(w, probes)
        rec["program"] = dict(self.program)
        traced = program(rec, "traced")
        if traced is not None:
            dt = w["dtrace"]
            gaps = tr.idle_gaps([(s, e) for _n, s, e in dt.events],
                                *dt.window)
            rec["breakdown"]["idle_gaps_program"] = idle_gaps_program(
                gaps, traced["spans"])
            rec["program_checks"] = checks(rec, w, gaps)
        self.rec = rec
        return rec


def checks(rec: dict, w: dict, gaps) -> dict:
    """The agreement of the program's spans with the harness's, and their
    coverage of the traced window's idle time."""
    traced, synced = program(rec, "traced"), program(rec, "synced")
    idle = idle_gaps_program(gaps, traced["spans"], None)
    total = sum(s for _lab, s in idle) or 1.0
    # the epoch's idle time by its direct child and by the innermost span
    child: Dict[str, float] = {}
    innermost: Dict[str, float] = {}
    for lab, s in idle:
        parts = lab.split("/")
        if "epoch" in parts:
            below = parts[parts.index("epoch") + 1:] or ["epoch"]
            child[below[0]] = child.get(below[0], 0.0) + s
            innermost[parts[-1]] = innermost.get(parts[-1], 0.0) + s
    out = {"edges": {name: edge_gaps_ms(traced["spans"], w["trace_spans"],
                                        name)
                     for name in ("epoch", "field", "photoi")},
           "bare_step_idle_share": dict(idle).get("step", 0.0) / total,
           "epoch_children_cover": epoch_coverage(traced["spans"]),
           "epoch_idle_by_child": sorted(child.items(),
                                         key=lambda kv: -kv[1]),
           "epoch_idle_by_innermost": sorted(innermost.items(),
                                             key=lambda kv: -kv[1])}
    out["traced_self_ms_per_step"] = self_ms_per_step(traced)
    if synced is not None:
        out["synced_self_ms_per_step"] = self_ms_per_step(synced)
        out["synced_counters_per_step"] = {
            k: v / max(rec["steps"], 1)
            for k, v in sorted(synced["counters"].items())}
        plans = 1e-9 * sum(r[3] - r[2] for r in synced["spans"]
                           if r[0] == "plans.build")
        out["plans_build_s"] = [plans, rec["plan_build_s"]]
        out["synced_epoch_children_cover"] = epoch_coverage(synced["spans"])
    return out
