"""The check that decides ``correct`` fails the faults it is there for.

Each test drives a whole run of a small cell on the CPU (the harness's
look for a card skipped), with the program's time step broken underneath
or replaced by its float32 path (the control), and sees ``correct`` come
out false against the cell's own limits. The faults: a step that returns
its state unchanged, a step that leaves half of the boxes out, and a
value altered where the step produces it. A cell on one card has no
exchange between cards to leave out.
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from harness.cell import CellRun  # noqa: E402
from harness.sides import FLOAT32_FLAGS  # noqa: E402
from harness.spec import Spec  # noqa: E402

from small_cells import small_cell  # noqa: E402

SEED = 2 ** 31 + 17


def run_small(flags=()):
    spec = Spec(BENCH.parent / "BENCHMARK.json")
    cell = small_cell(spec, "cyl_amr_2048")
    return CellRun(spec, cell, SEED, 0.3, False, time.perf_counter(),
                   device="cpu", program_flags=flags).run()


def unchanged(real, cc, fc, *args, **kwargs):
    out = real(cc.clone(), fc.clone(), *args, **kwargs)
    return (cc, fc) + tuple(out[2:])


def half_left_out(real, cc, fc, *args, **kwargs):
    old = cc.clone()
    out = real(cc, fc, *args, **kwargs)
    new = out[0]
    new[:, ::2] = old[:, ::2]
    return out


def altered(real, cc, fc, *args, **kwargs):
    out = real(cc, fc, *args, **kwargs)
    inner = math.isqrt(out[0].shape[-1]) + 1  # a 2D box's first own cell
    out[0][0, :, inner] *= 1.001  # the electrons there, in every box
    return out


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=["unchanged", "half_left_out", "altered"])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    from afivo_streamer_tpu_torch.physics import advance
    real = advance.advance
    monkeypatch.setattr(advance, "advance",
                        lambda *a, **k: fault(real, *a, **k))
    out = run_small()
    assert out["correct"] is False, out["checks"]


def test_the_float32_control_is_not_correct():
    out = run_small(FLOAT32_FLAGS)
    assert out["correct"] is False, out["checks"]
    checks = out["checks"]
    assert checks["state_gap"]["value"] > checks["state_gap"]["limit"]


def test_the_program_as_configured_is_correct():
    out = run_small()
    assert out["correct"] is True, out["checks"]
