"""User hook registry.

Re-implements the reference's ``src/m_user_methods.f90:12-43``: a set of
optional procedure hooks that program-specific user code can register to
customize initial conditions, refinement, boundary potentials, gas density,
applied field, per-step actions and log output.

User code is a Python module given by ``user%module`` (a file path or
import path) defining ``user_initialize(cfg, sim)``, which sets hooks on
``sim.user`` (this object). Hook signatures:

* ``initial_conditions(sim, ids)`` — set data on (new) boxes
* ``refine(sim, cc, ids) -> cell flags`` — replaces the default criterion
* ``potential_bc(iv, d, coords, params) -> (bc_type, values)``
* ``gas_density(sim, coords) -> N`` (varying gas density via function)
* ``field_amplitude(sim, time) -> E`` (applied field)
* ``new_pulse_conditions(sim)`` — called at the start of a new pulse
* ``generic(sim, time)`` — called every iteration
* ``log_subroutine(sim, file)`` / ``log_variables(sim) -> (names, values)``
* ``lsf(r) -> values`` and ``lsf_bc`` — custom electrode geometry

The simulation calls every hook where the JAX package's host path does:
``initial_conditions`` on the boxes of the initial mesh and on the new
boxes of every setup refinement pass; ``refine`` in place of the default
criterion at every refinement epoch, as documented above (the JAX driver
passes the ids alone); ``potential_bc`` through the field solver's
boundary condition, whose values may be NumPy arrays over the face
coordinates [n_bc, F, ndim] or tensors on the state's device;
``field_amplitude`` at every voltage update (the loop's top and every field
solve); ``generic`` after the status line of every iteration;
``new_pulse_conditions`` where a new pulse resets dt; ``log_variables`` and
``log_subroutine`` in the text log; ``gas_density`` on every cell of a box
once; and, with ``field_electrode_type = user``, ``lsf`` and ``lsf_bc``
(NumPy callables on points [n, ndim]).
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
from typing import Callable, Optional


class UserMethods:
    def __init__(self):
        self.initial_conditions: Optional[Callable] = None
        self.refine: Optional[Callable] = None
        self.potential_bc: Optional[Callable] = None
        self.gas_density: Optional[Callable] = None
        self.field_amplitude: Optional[Callable] = None
        self.new_pulse_conditions: Optional[Callable] = None
        self.generic: Optional[Callable] = None
        self.log_subroutine: Optional[Callable] = None
        self.log_variables: Optional[Callable] = None
        self.lsf: Optional[Callable] = None
        self.lsf_bc: Optional[Callable] = None


def load_user_module(cfg, sim) -> UserMethods:
    """Load the user module and call its user_initialize (m_user pattern)."""
    user = UserMethods()
    path = cfg.add_get("user%module", "UNDEFINED",
                       "Python module (file or import path) with user code")
    if path == "UNDEFINED":
        return user
    if os.path.exists(path):
        spec = importlib.util.spec_from_file_location("af_user_module", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["af_user_module"] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(path)
    sim.user = user
    if hasattr(mod, "user_initialize"):
        mod.user_initialize(cfg, sim)
    return user
