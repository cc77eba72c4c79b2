"""The two sides of a run: the program under test and the frozen reference.

The program is the port, ``afivo_streamer_tpu_torch``: its simulation, its
smoother kernels (built into the checkout's
``afivo_streamer_tpu_torch/build/``) and nothing else of it. The reference
is ``reference/streamer_ref``, a frozen copy of the port's plain PyTorch
path (no kernel, no code of the program imported), which runs the same
settings from the same seed.

``drive`` runs ``Simulation.run()`` once, as a user does, and calls back at
the start of every iteration of its main loop through the ``generic`` user
hook, which the loop calls there; the callback ends the run by raising
``StopRun``.
"""

from __future__ import annotations

import importlib
import sys
import time
from pathlib import Path
from typing import Callable, List, Sequence

from .spec import BENCH_DIR, Cell

PACKAGES = {"program": "afivo_streamer_tpu_torch", "reference": "streamer_ref"}
#: the float32 path of the program (its own option): the control
FLOAT32_FLAGS = ("-compiled%enabled=T", "-compiled%dtype=float32")


class StopRun(Exception):
    """Raised by a ``drive`` callback to end the run."""


class Side:
    """The modules of one side (``program`` or ``reference``)."""

    def __init__(self, kind: str):
        if kind == "reference":
            ref_dir = str(BENCH_DIR / "reference")
            if ref_dir not in sys.path:
                sys.path.insert(0, ref_dir)
        pkg = PACKAGES[kind]
        self.kind = kind
        self.driver = importlib.import_module(pkg + ".driver")
        self.init_cond = importlib.import_module(pkg + ".physics.init_cond")
        self.mgb = importlib.import_module(pkg + ".solvers.mg_blocks")
        self.ks = importlib.import_module(pkg + ".ops.smoother")

    def build_kernels(self) -> float:
        """Build the program's kernels where they are not built yet;
        returns the seconds spent compiling (0 when every library was
        already in the build directory)."""
        if self.kind != "program":
            return 0.0
        build_dir = Path(self.ks.BUILD_DIR)
        before = set(build_dir.glob("*.so")) if build_dir.exists() else set()
        t0 = time.perf_counter()
        self.ks.build_libraries()
        seconds = time.perf_counter() - t0
        return seconds if set(build_dir.glob("*.so")) - before else 0.0

    def simulation(self, argv: Sequence[str], seed: int):
        """The simulation of ``argv`` with the stochastic background of
        ``seed`` added after the set-up's initial conditions
        (``physics/init_cond.stochastic_density`` of this side)."""
        sim = self.driver.Simulation(argv=list(argv))
        self.init_cond.stochastic_density(sim, noise_seed(seed))
        return sim


def noise_seed(seed: int) -> int:
    """The NumPy seed of a run's ``--seed`` (any whole number)."""
    return int(seed) % (1 << 63)


def cell_argv(cell: Cell, out_name: str, device: str,
              extra: Sequence[str] = ()) -> List[str]:
    """The command-line settings of a cell: its configuration's settings,
    the files a configuration names beside it as paths, the traffic's
    stochastic background amplitude, the output prefix and the device."""
    cfg, tr = cell.config, cell.traffic
    settings = dict(cfg["settings"])
    for key in cfg.get("files", ()):
        settings[key] = str(Path(cfg["_dir"]) / settings[key])
    settings["stochastic_density"] = repr(float(tr["stochastic_density"]))
    settings["output%name"] = out_name
    settings["device"] = device
    return ([f"-ndim={cfg['ndim']}"]
            + [f"-{k}={v}" for k, v in settings.items()] + list(extra))


def drive(sim, at_step: Callable[[int], None]) -> None:
    """Run ``sim.run()`` and call ``at_step(steps_done)`` at the start of
    every iteration of its loop, until ``at_step`` raises StopRun. A user
    hook that was set stays called first."""
    user = sim.user
    orig = user.generic

    def generic(s, t):
        if orig is not None:
            orig(s, t)
        at_step(s.it - 1)

    user.generic = generic
    try:
        sim.run()
    except StopRun:
        return
    finally:
        user.generic = orig
    raise RuntimeError("the simulation reached its end_time inside the run")
