"""Spans and counters of one simulation, on the host's clock.

A ``Tracer`` belongs to one ``Simulation`` (``sim.tracer``), which hands it
to the objects that hold spans through their ``MeshPlans``
(``mesh.tracer``). Its clock is
``time.perf_counter_ns``, the clock onto which a device trace of the card
can be mapped, so that an idle gap of the card lies inside the innermost
span that the host had open over it.

* ``span(name)`` times a block. It always adds to the name's count, total
  and self time (its duration less that of the spans nested in it), and to
  the self time of its group (below). While ``recording`` is on it also
  keeps one record ``(name, parent, start_ns, end_ns, step)``: ``parent``
  is the index of the enclosing span's record among those ``take()``
  returns (-1 for none) and ``step`` the simulation's step number
  (``sim.it``, set by the main loop; 0 at set-up).
* ``host_read(x, site, convert)`` is a blocking read of a device value by
  the host: it returns ``convert(x)`` (``float(x)`` by default), counts it
  under ``sync.<site>`` and times it as the span ``sync.<site>``, where the
  host waits for the card.
* ``count(name, k)`` adds to a counter, always; ``sample(name, value)``
  appends to a series while recording (the V-cycles of each solve, the
  time step of each accepted step).
* ``take()`` returns what accumulated since the last call (the records,
  the series and the counters' increments) and clears it.

Groups: the self time of every span under a ``step`` span (``ROOT``) is
summed by the innermost span whose name is one of ``groups``
(``group_seconds``); the main loop's cost breakdown (``Simulation.wc``)
reads them. A span outside the root counts in no group.

Nothing here touches the card: the only synchronizations are the reads
that ``host_read`` performs, which the program made before. Nor does a
span leave an object for Python's garbage collector: the span objects are
made once per name, the open spans' frames once per depth, and the records
are kept in a flat integer array beside a list of the names, so that
recording thousands of spans brings no collection forward.
"""

from __future__ import annotations

import time
from array import array
from typing import Callable, Dict, Iterable, List

#: the clock of every span (integer nanoseconds)
clock_ns = time.perf_counter_ns
#: the span under which the groups count (one step of the main loop)
ROOT = "step"
#: integers per record in ``Tracer._ints``: parent, start, end, step
_REC = 4


def to_numpy(x):
    """A device tensor as a NumPy array on the host."""
    return x.cpu().numpy()


def to_list(x):
    """A device tensor as a (nested) list of Python numbers."""
    return x.tolist()


class _Span:
    """The context manager of the spans of one name (one per tracer and
    name, reused)."""

    __slots__ = ("tracer", "name")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.tracer._open(self.name)

    def __exit__(self, typ, value, tb):
        self.tracer._close()


class Tracer:
    def __init__(self, groups: Iterable[str] = ()):
        #: whether spans keep records and series keep samples
        self.recording = False
        #: the step that records are tagged with (``sim.it``)
        self.step = 0
        #: name -> [count, total ns, self ns]
        self.totals: Dict[str, List[int]] = {}
        self.counters: Dict[str, int] = {}
        self.series: Dict[str, list] = {}
        self.groups = tuple(groups)
        self.group_ns: Dict[str, int] = {g: 0 for g in self.groups}
        self._spans: Dict[str, _Span] = {}
        # the records: their names, and _REC integers each
        self._names: List[str] = []
        self._ints = array("q")
        self._taken: Dict[str, int] = {}
        # the open spans' frames [name, start, nested ns, record, group],
        # one per depth, reused
        self._frames: List[list] = []
        self._depth = 0

    # ------------------------------------------------------------ spans
    def span(self, name: str) -> _Span:
        """The context manager that times a block as the span ``name``."""
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = _Span(self, name)
        return s

    def _open(self, name: str) -> None:
        depth = self._depth
        if depth == len(self._frames):
            self._frames.append([None, 0, 0, -1, None])
        f = self._frames[depth]
        up = self._frames[depth - 1] if depth else None
        rec = -1
        if self.recording:
            rec = len(self._names)
            self._names.append(name)
            ints = self._ints
            ints.append(up[3] if up is not None else -1)
            ints.append(0)
            ints.append(0)
            ints.append(self.step)
        # the group: "" for the root (inside it, no group yet), None
        # outside the root
        if name == ROOT:
            group = ""
        elif up is None or up[4] is None:
            group = None
        else:
            group = name if name in self.groups else up[4]
        f[0] = name
        f[2] = 0
        f[3] = rec
        f[4] = group
        self._depth = depth + 1
        f[1] = clock_ns()

    def _close(self) -> None:
        t1 = clock_ns()
        depth = self._depth = self._depth - 1
        name, t0, nested, rec, group = self._frames[depth]
        dur = t1 - t0
        own = dur - nested
        tot = self.totals.get(name)
        if tot is None:
            tot = self.totals[name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += own
        if group:
            self.group_ns[group] += own
        if depth:
            self._frames[depth - 1][2] += dur
        if rec >= 0:
            self._ints[_REC * rec + 1] = t0
            self._ints[_REC * rec + 2] = t1

    def host_read(self, x, site: str, convert: Callable = float):
        """``convert(x)``, a blocking read of ``x`` by the host, counted
        and timed under ``sync.<site>``."""
        name = "sync." + site
        self.counters[name] = self.counters.get(name, 0) + 1
        with self.span(name):
            return convert(x)

    # --------------------------------------------------------- counters
    def count(self, name: str, k: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + k

    def sample(self, name: str, value) -> None:
        if self.recording:
            self.series.setdefault(name, []).append(value)

    # ---------------------------------------------------------- reading
    def take(self) -> dict:
        """The records (tuples ``(name, parent, start_ns, end_ns, step)``,
        parents indexing this list), the series and the counters'
        increments since the last call; cleared."""
        if self._depth:
            raise RuntimeError("take() inside the spans "
                               f"{[f[0] for f in self._frames[:self._depth]]}")
        ints = self._ints
        out = {"spans": [(n,) + tuple(ints[_REC * i:_REC * i + _REC])
                         for i, n in enumerate(self._names)],
               "series": self.series,
               "counters": {k: v - self._taken.get(k, 0)
                            for k, v in self.counters.items()
                            if v != self._taken.get(k, 0)}}
        self._names, self._ints, self.series = [], array("q"), {}
        self._taken = dict(self.counters)
        return out

    def group_seconds(self, group: str) -> float:
        """Self seconds of the spans of ``group`` under the root so far."""
        return 1e-9 * self.group_ns.get(group, 0)
