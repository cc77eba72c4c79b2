"""What decides ``correct``: the program's run against the reference's.

Both sides run the same settings from the same seed, through
``Simulation.run``, for the same steps: the program's set-up steps, which
the timed window then continues on the same object (the first
photoionization update and the first epoch that changes the mesh lie among
them). A snapshot holds what those steps produced in every layer they
cross:

* the mesh: the leaves of every level;
* the dt of every attempted step, rejected ones too, and the dt limits
  (CFL, dielectric relaxation, chemistry) that each substep computed;
* the V-cycles of every field solve and the FMG cycles of every
  Helmholtz mode in every photoionization update;
* on the leaves' cells, in float64 on the host: every species density,
  the potential, the field and the photoionization source.

The numbers compared, each against its limit (``limits/<cell>.json``):

* ``mesh_gap``: leaves in one mesh and not in the other (limit 0);
* ``cycles_gap``: solves and updates whose cycle counts differ, and any
  difference in their number (limit 0);
* ``dt_gap``: the largest relative difference of a step's dt or of a
  substep's dt limit (infinite where the sides attempted different
  numbers of steps);
* ``state_gap``: the largest difference in a cell over the reference's
  largest magnitude of that variable, worst over the variables (infinite
  where the meshes differ).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

NUMBERS = ("state_gap", "dt_gap", "mesh_gap", "cycles_gap")


def interior_index(ndim: int, nc: int) -> np.ndarray:
    """Flat indices of a box's interior cells in its ghosted block."""
    block = np.arange((nc + 2) ** ndim).reshape((nc + 2,) * ndim)
    return block[(slice(1, nc + 1),) * ndim].ravel()


def compared_variables(sim) -> Dict[str, int]:
    """Name -> state row of the variables compared."""
    names = sim.registry.cc_names
    rows = list(sim.species_cc) + [sim.i_phi, sim.i_electric_fld]
    if getattr(sim.photoi, "i_photo", -1) >= 0:
        rows.append(sim.photoi.i_photo)
    return {names[i]: i for i in rows}


def snapshot(sim, probes, torch) -> dict:
    """What the steps so far produced (see the module's docstring)."""
    tree = sim.tree
    leaves = [np.asarray(lv, np.int64).copy() for lv in tree.lvl_leaves]
    rows = torch.as_tensor(np.concatenate(leaves), dtype=torch.int64,
                           device=sim.cc.device)
    inner = torch.as_tensor(interior_index(tree.ndim, tree.nc),
                            dtype=torch.int64, device=sim.cc.device)
    state = {}
    for name, iv in compared_variables(sim).items():
        state[name] = (sim.cc[iv].index_select(0, rows).index_select(1, inner)
                       .to(torch.float64).cpu().numpy())
    limits = [float(x) for lim in probes.dt_limits
              for x in lim.to(torch.float64).cpu()]
    return {"leaves": leaves, "state": state, "dts": list(probes.dts),
            "dt_limits": limits,
            "vcycles": list(probes.vcycles),
            "fmg": [list(x) for x in probes.fmg], "steps": sim.it - 1}


def mesh_gap(a, b) -> int:
    n = abs(len(a) - len(b))
    for la, lb in zip(a, b):
        n += len(np.setxor1d(la, lb))
    return n


def cycles_gap(a, b) -> int:
    def gap(x, y):
        return abs(len(x) - len(y)) + sum(u != v for u, v in zip(x, y))
    return gap(a["vcycles"], b["vcycles"]) + gap(a["fmg"], b["fmg"])


#: a dt limit at or above this is the program's "no limit" sentinel
#: (1e100 in float64, 1e30 in float32), not a time
NO_LIMIT = 1e29


def dt_gap(a, b) -> float:
    """The largest relative difference of the steps' dts and of their
    substeps' dt limits (infinite where their numbers differ); a limit
    that both sides leave unset does not count."""
    pairs = []
    for key in ("dts", "dt_limits"):
        if len(a[key]) != len(b[key]) or not b[key]:
            return math.inf
        pairs += [(x, y) for x, y in zip(a[key], b[key])
                  if min(x, y) < NO_LIMIT]
    return max((abs(x - y) / (abs(y) or 1.0) for x, y in pairs),
               default=0.0)


def state_gap(a, b):
    """(worst scaled difference, its variable)."""
    worst, worst_name = 0.0, ""
    for name, ref in b["state"].items():
        got = a["state"].get(name)
        if got is None or got.shape != ref.shape:
            return math.inf, name
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        rel = err / scale if scale > 0 else err
        if not rel <= worst:  # a NaN counts as the worst
            worst, worst_name = (rel if rel == rel else math.inf), name
    return worst, worst_name


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared, program against reference."""
    mg = mesh_gap(prog["leaves"], ref["leaves"])
    if mg == 0:
        sg, worst = state_gap(prog, ref)
    else:
        sg, worst = math.inf, "mesh"
    return {"state_gap": sg, "dt_gap": dt_gap(prog, ref),
            "mesh_gap": mg, "cycles_gap": cycles_gap(prog, ref),
            "worst_variable": worst, "steps": ref["steps"]}


def judge(numbers: dict, limits: dict):
    """(correct, {number: {"value", "limit"}}) against the cell's limits."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
