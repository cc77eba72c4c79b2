"""Spans and counters around the program's calls, recorded from outside.

``Probes`` wraps, on one simulation and its side's modules:

* ``adjust_refinement`` (span ``epoch``): the epochs that changed the
  mesh;
* ``photoi.set_src`` (span ``photoi``): updates and the FMG cycles of each
  Helmholtz mode;
* ``field.compute`` and the fluid's ``field_compute`` (span ``field``):
  solves and the V-cycles of each (the calls of ``fas_vcycle_blocks``
  without a ``top``, as the FMG cycles' own V-cycles pass one);
* ``_substep`` (span ``fluid``, the field solve of the second substep
  nested in it): the dt of every attempted step and the dt limits that
  each substep computes from the state;
* the program's smoother wrappers: the boxes n, box size nc and item size
  of every kernel launch while ``record_launches`` is set.

``mode`` sets what a span costs: ``off`` counts only, ``mark`` takes the
host's clock at its edges, ``sync`` synchronizes the card at its edges
first, so that a span holds the device work of its calls (the pattern of
the port's chip checks).

The probes lean on the program's call structure (the names above, the
``i_step`` parameter of ``_substep``, the ``dt_limits`` of its result);
``check`` fails a run whose set-up steps left a probe without its calls,
naming it, so that a program that reshapes them stops the run instead of
reading as not correct.
"""

from __future__ import annotations

import inspect
import time
from typing import List, Tuple

from .roofline import WRAPPERS


class _LaunchProbe:
    """A smoother wrapper that records its launches; its ``launches``
    counters are the wrapped function's, so the program's counts stay
    whole when the wrapper counts through this object."""

    def __init__(self, fn, name, probes):
        self.__dict__["_fn"] = fn
        self.__dict__["_name"] = name
        self.__dict__["_probes"] = probes

    def __call__(self, phi3, *args, **kwargs):
        p = self._probes
        p.launch_calls += 1
        if (p.record_launches and phi3.device.type == "cuda"
                and phi3.shape[0] > 0):
            p.launches.append((self._name, int(phi3.shape[0]),
                               int(phi3.shape[1]) - 2,
                               phi3.element_size()))
        return self._fn(phi3, *args, **kwargs)

    def __getattr__(self, key):
        return getattr(self._fn, key)

    def __setattr__(self, key, value):
        setattr(self._fn, key, value)


class Probes:
    def __init__(self, sim, side, torch):
        self.sim, self.side, self.torch = sim, side, torch
        self.cuda = sim.device.type == "cuda"
        self.epochs = 0
        self.launch_calls = 0
        self.mode = "off"
        self.record_launches = False
        self.spans: List[Tuple[str, float, float]] = []
        self.launches: List[tuple] = []
        self.mesh_changes = 0
        self.photoi_updates = 0
        self.fmg: List[List[int]] = []
        self.vcycles: List[int] = []
        self.dts: List[float] = []
        #: the dt limits (cfl, drt, chem, other) of every substep, tensors
        #: on the state's device (no synchronize where they are taken)
        self.dt_limits: List = []
        self._vc = 0
        self._restore = []
        self._install()

    # ------------------------------------------------------------ spans
    def _edge(self):
        if self.mode == "sync" and self.cuda:
            self.torch.cuda.synchronize()
        return time.perf_counter_ns()

    def _span(self, name, fn, after=None):
        def wrapped(*args, **kwargs):
            if self.mode == "off":
                out = fn(*args, **kwargs)
                if after is not None:
                    after(out)
                return out
            t0 = self._edge()
            out = fn(*args, **kwargs)
            t1 = self._edge()
            self.spans.append((name, 1e-9 * t0, 1e-9 * t1))
            if after is not None:
                after(out)
            return out
        return wrapped

    def _set(self, obj, attr, value):
        self._restore.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, value)

    # ---------------------------------------------------------- install
    def _install(self):
        sim, mgb = self.sim, self.side.mgb

        def epoch_done(info):
            self.epochs += 1
            if info.n_add > 0 or info.n_rm > 0:
                self.mesh_changes += 1
        self._set(sim, "adjust_refinement",
                  self._span("epoch", sim.adjust_refinement, epoch_done))

        def photoi_done(_cc):
            self.photoi_updates += 1
            self.fmg.append([int(k) for k in sim.photoi.fmg_cycles])
        self._set(sim.photoi, "set_src",
                  self._span("photoi", sim.photoi.set_src, photoi_done))

        compute = sim.field.compute

        def field_compute(*args, **kwargs):
            before = self._vc
            try:
                return compute(*args, **kwargs)
            finally:
                self.vcycles.append(self._vc - before)
        field_span = self._span("field", field_compute)
        self._set(sim.field, "compute", field_span)
        self._set(sim.fluid, "field_compute", field_span)

        vcycle = mgb.fas_vcycle_blocks

        def count_vcycle(mg, P, R, params, top=None):
            if top is None:
                self._vc += 1
            return vcycle(mg, P, R, params, top)
        self._module_attr(mgb, "fas_vcycle_blocks", count_vcycle)

        substep = sim._substep
        params = list(inspect.signature(substep).parameters)
        if "i_step" not in params:
            raise RuntimeError("probe dt: Simulation._substep has no i_step "
                               f"parameter ({params})")
        i_step = params.index("i_step")

        def record_dt(*args):
            if args[i_step] == 1:  # the step's first substep
                self.dts.append(float(args[2]))
            out = substep(*args)
            try:
                self.dt_limits.append(out[3]["dt_limits"])  # read later
            except (IndexError, KeyError, TypeError) as err:
                raise RuntimeError("probe dt_limits: the result of "
                                   "Simulation._substep holds no "
                                   f"out[3]['dt_limits'] ({err!r})")
            return out
        self._set(sim, "_substep", self._span("fluid", record_dt))

        if self.side.kind == "program":
            ks = self.side.ks
            for name in WRAPPERS:
                if hasattr(ks, name):
                    self._module_attr(ks, name,
                                      _LaunchProbe(getattr(ks, name), name,
                                                   self))

    def _module_attr(self, mod, attr, value):
        self._restore.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    def remove(self):
        """Put back every wrapped attribute (modules are shared by later
        simulations of the process)."""
        for obj, attr, old in reversed(self._restore):
            if isinstance(obj, type(self.side.mgb)):
                setattr(obj, attr, old)
            elif old is None:
                obj.__dict__.pop(attr, None)
            else:
                setattr(obj, attr, old)
        self._restore = []

    def check(self, steps: int) -> None:
        """Raise, naming the probe, where ``steps`` set-up steps left a
        probe without the calls that every step or update makes."""
        per = getattr(getattr(self.sim, "refine_cfg", None), "per_steps", 2)
        missing = []
        if len(self.dts) < steps:
            missing.append(f"dt ({len(self.dts)} steps seen of {steps})")
        if len(self.dt_limits) < len(self.dts):
            missing.append(f"dt_limits ({len(self.dt_limits)} substeps)")
        if len(self.vcycles) < steps or sum(self.vcycles) == 0:
            missing.append(f"vcycles ({len(self.vcycles)} solves, "
                           f"{sum(self.vcycles)} V-cycles)")
        if self.photoi_updates and (len(self.fmg) != self.photoi_updates
                                    or not all(sum(f) for f in self.fmg)):
            missing.append(f"fmg ({self.fmg})")
        if steps >= per and self.epochs == 0:
            missing.append("epoch (no adjust_refinement call)")
        if (self.side.kind == "program" and self.cuda
                and self.launch_calls == 0):
            missing.append("launches (no smoother wrapper called)")
        if missing:
            raise RuntimeError("probes without their calls after "
                               f"{steps} steps: " + "; ".join(missing))

    def kernel_launches(self) -> int:
        """The program's smoother launches so far (its own counters)."""
        ks = self.side.ks
        if self.side.kind != "program":
            return 0
        return sum(getattr(ks, name).launches for name in WRAPPERS
                   if hasattr(ks, name))
