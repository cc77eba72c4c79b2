"""Helpers of the tests that run one configuration in both packages, the
JAX package's host path and the port on the CPU (float64), and hold the
port against it: the same mesh at setup and after every refinement epoch,
dt at every attempted step, the FMG and V-cycle counts of every
multigrid, every variable of the state, and the files both write."""

from pathlib import Path

import numpy as np
import pytest

from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.io.compare import (compare_outputs, log_scales,
                                                 read_table)
from test_torch_electrode import count_field_cycles
from test_torch_slice import record_dts, record_epochs

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
PROGRAMS = DATA.parent / "programs"
JAX_PROGRAMS = ROOT / "programs"
RTOL = 1e-8


def build_pair(tmp_path, monkeypatch, argv, juser=(), tuser=()):
    """Both packages' simulations of ``argv`` (the JAX one with ``juser``,
    the port with ``tuser`` and -device=cpu), writing to tmp_path/j_* and
    tmp_path/t_*; the counters of field cycles, epochs and dts are on."""
    cycles = count_field_cycles(monkeypatch)
    j = JSim(argv=list(argv) + list(juser)
             + [f"-output%name={tmp_path / 'j'}"])
    t = TSim(argv=list(argv) + list(tuser)
             + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    assert t.registry.cc_names == j.registry.cc_names
    for a, b in zip(j.tree.lvl_ids, t.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    rec = {"epochs": {"j": [], "t": []}, "dts": {"j": [], "t": []},
           "cycles": cycles}
    for side, sim in (("j", j), ("t", t)):
        record_epochs(sim, rec["epochs"][side])
        record_dts(sim, rec["dts"][side])
    return j, t, rec


def assert_runs_agree(j, t, rec, steps, changing_epoch=True):
    """The same mesh after every epoch, dt at every attempted step, the
    same cycle counts, times and every variable of the real boxes at rtol
    1e-8 (with an absolute floor of 1e-8 of the variable's scale)."""
    epochs, dts = rec["epochs"], rec["dts"]
    assert len(epochs["t"]) == len(epochs["j"]) >= steps // 2
    if changing_epoch:
        assert any(a + r for _m, a, r in epochs["j"]), "no epoch changed"
    for (mj, aj, rj), (mt, at, rt) in zip(epochs["j"], epochs["t"]):
        assert (at, rt) == (aj, rj) and len(mt) == len(mj)
        for a, b in zip(mj, mt):
            np.testing.assert_array_equal(a, b)
    assert len(dts["t"]) == len(dts["j"]) >= steps
    np.testing.assert_allclose(dts["t"], dts["j"], rtol=RTOL, atol=0.0)
    assert rec["cycles"]["t"] == rec["cycles"]["j"]
    assert t.global_dt == pytest.approx(j.global_dt, rel=RTOL)
    assert t.global_time == pytest.approx(j.global_time, rel=RTOL)
    assert t.field.current_voltage == pytest.approx(
        j.field.current_voltage, rel=RTOL)
    n = j.tree.highest_id
    use = j.tree.in_use[:n]
    tcc = t.cc.numpy()
    for iv, name in enumerate(j.registry.cc_names):
        if iv == j.i_tmp or name.startswith("surf_"):
            # the JAX host path keeps the surface state off the cc rows
            continue
        a, b = j.cc[iv, :n][use], tcc[iv, :n][use]
        np.testing.assert_allclose(b, a, rtol=RTOL,
                                   atol=RTOL * float(np.abs(a).max()),
                                   err_msg=name)
    if t.surfaces is not None:
        got = interop.surface_data(t)
        want = {s.id_out: s.sd for s in j.surfaces.active()}
        assert got.keys() == want.keys() and want
        scale = max(float(np.abs(v).max()) for v in want.values())
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL,
                                       atol=RTOL * scale)


def assert_files_agree(tmp_path, grids=True, log=True, summary=True):
    """Every file the JAX run (tmp_path/j_*) wrote beside the port's
    (tmp_path/t_*), held by io/compare.compare_outputs at rtol 1e-8: the
    chemistry listings byte for byte; the summary, the rates, the amounts,
    the regression log, the text log (wc_time aside) and the grid files
    (ids, levels and names exact). Returns the count of grid files."""
    for side in "jt":
        assert (tmp_path / f"{side}_summary.txt").exists() == summary
        assert (tmp_path / f"{side}_log.txt").exists() == log
    worst = compare_outputs(tmp_path / "j", tmp_path / "t", RTOL)
    for name in ("rates.txt", "amounts.txt", "rtest.log") + (
            ("log.txt",) if log else ()):
        assert len(read_table(tmp_path / f"t_{name}")[1]) >= 2, name
    n_grids = len([k for k in worst if k.startswith("grid_")])
    assert bool(n_grids) == grids
    return n_grids


def assert_logs_agree(jax_log, port_log):
    """Two text logs of one run: the same header and lines, every column
    but wc_time within 1e-8 of its scale (io/compare.log_scales)."""
    header, ref = read_table(jax_log)
    assert read_table(port_log)[0] == header and len(ref) >= 2
    got = read_table(port_log)[1]
    assert got.shape == ref.shape
    scales = log_scales(header, ref)
    keep = scales > 0
    np.testing.assert_array_less(
        np.abs(got - ref)[keep], RTOL * scales[keep] + 1e-300)
