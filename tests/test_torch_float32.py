"""The float32 state of the compiled engine (``-compiled%enabled=T
-compiled%dtype=float32``, afivo_streamer_tpu_torch/parallel/compiled.py)
on the CPU.

(a) The JAX package's gate (tests/test_compiled_e2e.py
    test_compiled_f32_tracks_f64_trajectory), applied to the port: the
    planar 1D slice on a frozen mesh for 110 steps; the port's float32 run
    against its float64 run and against the JAX package's compiled float32
    run, the regression log's observables within rtol 1e-3, the same
    iteration, the time within 1e-3.
(b) 2D: the cylindrical main path frozen for 8 steps and the Cartesian
    slice for 4, float32 against float64 within rtol 1e-3 (on the same
    mesh). The float64 runs are held against the JAX package by the other
    test files.
(c) The setup runs in float64 (as the JAX package's host path runs it);
    from the first step on the dtype holds through a run with live
    refinement, an epoch that changes the mesh and Helmholtz
    photoionization updates: cc, fc and every array the multigrid's
    smoother sweeps (the level blocks, the rhs, the stencil, the ghost
    weights and constants) are float32.
(d) A checkpoint of a float32 run holds float64 values (the float32 ones,
    exactly); a restart from it equals the uninterrupted float32 run bit
    for bit.
(e) The branches that run in float32 (the electron energy equation, an
    electrode, a dielectric, Monte-Carlo photoionization) agree with their
    float64 runs within rtol 1e-3; gas dynamics raises the named
    NotImplementedError.
(f) The cylindrical main path over two gloo ranks in float32, 4 steps
    across an epoch that adds boxes, equals the unsharded float32 run
    (both in spawned processes whose BLAS runs one thread): the same
    meshes, dts and cycle counts, the state bit for bit.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.ops import smoother as ks
from afivo_streamer_tpu_torch.parallel import compiled
from chip_smoke import record_run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
F32 = ["-compiled%enabled=T", "-compiled%dtype=float32"]
#: the JAX package's gate: 110 steps on a frozen mesh
ONE_D = [str(DATA / "air_1d_slice.cfg"), "-ndim=1",
         "-refine_per_steps=1000000", "-output%dt=2e-12"]
ONE_D_STEPS = 110
CYL = [str(DATA / "air_cyl_amr_slice.cfg"), "-ndim=2", "-output%dt=1e-13"]
FROZEN = {"cyl": (CYL + ["-refine_per_steps=1000000"], 8),
          "cart": ([str(DATA / "air_cyl_slice.cfg"), "-ndim=2",
                    "-cylindrical=f", "-output%dt=1e-13"], 4)}
#: live refinement, photoionization every 2 steps, a checkpoint at every
#: output (steps 0, 4, 5, 6, 7 and 8); the epoch of step 4 removes boxes
LIVE = CYL + ["-photoi%per_steps=2", "-datfile%write=t"]
LIVE_STEPS = 8
NEW_TD = ["-input_data%old_style=f",
          f"-input_data%file={DATA / 'td_air_synthetic_new.txt'}"]
BRANCHES = {
    "ee53": [str(DATA / "air_cyl_ee_slice.cfg"), "-ndim=2"],
    "electrode": [str(DATA / "electrode_cyl_slice.cfg"), "-ndim=2"],
    "dielectric": [str(DATA / "dielectric_cyl_slice.cfg"), "-ndim=2"],
    "montecarlo": CYL + ["-photoi%method=montecarlo",
                         "-photoi_mc%physical_photons=f",
                         "-photoi_mc%num_photons=20000"],
}
BRANCH_STEPS = 4
#: the sharded main path: the epoch of step 4 adds boxes
SHARDED = CYL + ["-photoi%per_steps=2", "-field_rise_time=3e-13",
                 "-device=cpu"] + F32
SHARDED_STEPS = 4


def log(prefix):
    return np.loadtxt(f"{prefix}_rtest.log", skiprows=1, ndmin=2)


def run(prefix, argv, steps, *extra):
    sim = TSim(argv=argv + ["-device=cpu", f"-output%name={prefix}",
                            *extra])
    sim.run(max_steps=steps)
    return sim


def assert_logs_close(got, ref, rtol):
    """The regression logs' rows and observables (the columns after it,
    time and dt)."""
    assert got.shape == ref.shape and len(ref) >= 2
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=rtol)
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], rtol=rtol)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(f): the two spawns, started first; they run beside this process's
    runs and are joined by the test."""
    tmp = tmp_path_factory.mktemp("f32_sharded")
    out = {}

    def go(key, n):
        out[key] = compiled.run_ranks(record_run, n, (
            SHARDED + ["-compiled%shards=2"] * (n > 1)
            + [f"-output%name={tmp / key}"], SHARDED_STEPS))

    threads = [threading.Thread(target=go, args=(key, n))
               for key, n in (("unsharded", 1), ("sharded", 2))]
    for t in threads:
        t.start()
    return threads, out


def test_one_d_gate_matches_float64_and_jax(sharded, tmp_path):
    """(a)."""
    from afivo_streamer_tpu.driver import Simulation as JSim
    s64 = run(tmp_path / "t64", ONE_D, ONE_D_STEPS)
    s32 = run(tmp_path / "t32", ONE_D, ONE_D_STEPS, *F32)
    j32 = JSim(argv=ONE_D + [f"-output%name={tmp_path / 'j32'}"] + F32)
    j32.run(max_steps=ONE_D_STEPS)
    assert s32.cc.dtype == s32.fc.dtype == torch.float32
    for ref in (s64, j32):
        assert s32.it == ref.it
        assert s32.global_time == pytest.approx(ref.global_time, rel=1e-3)
        np.testing.assert_allclose(s32.dt_limits[:3], ref.dt_limits[:3],
                                   rtol=1e-3)
    assert_logs_close(log(tmp_path / "t32"), log(tmp_path / "t64"), 1e-3)
    assert_logs_close(log(tmp_path / "t32"), log(tmp_path / "j32"), 1e-3)
    # the "other" dt limit: the float32 sentinel, as the JAX run's
    assert s32.dt_limits[3] == pytest.approx(1e30, rel=1e-6)
    assert j32.dt_limits[3] == pytest.approx(1e30, rel=1e-6)


@pytest.mark.parametrize("case", list(FROZEN))
def test_two_d_float32_tracks_float64(sharded, tmp_path, case):
    """(b)."""
    argv, steps = FROZEN[case]
    s64 = run(tmp_path / "t64", argv, steps)
    s32 = run(tmp_path / "t32", argv, steps, *F32)
    assert s32.cc.dtype == torch.float32
    for a, b in zip(s64.tree.lvl_ids, s32.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    assert s32.it == s64.it
    assert_logs_close(log(tmp_path / "t32"), log(tmp_path / "t64"), 1e-3)


@pytest.fixture(scope="module")
def live(sharded, tmp_path_factory):
    """The float32 run with live refinement, recording the dtypes of every
    smoother call's inputs (ops/smoother._check runs on every device)."""
    tmp = tmp_path_factory.mktemp("f32_live")
    seen = set()
    check = ks._check

    def spy(ndim, phi3, **inputs):
        seen.update(str(t.dtype) for name, t in inputs.items()
                    if t is not None and name not in ("g", "mask"))
        seen.add(str(phi3.dtype))
        return check(ndim, phi3, **inputs)

    sim = TSim(argv=LIVE + ["-device=cpu", f"-output%name={tmp / 'run'}"]
               + F32)
    # the setup ran in float64, as the JAX package's host path runs it
    assert sim.cc.dtype == torch.float64
    meshes = [[np.asarray(a).copy() for a in sim.tree.lvl_ids]]
    ks._check = spy
    try:
        sim.run(max_steps=LIVE_STEPS)
        meshes.append(sim.tree.lvl_ids)
    finally:
        ks._check = check
    return tmp, sim, seen, meshes


def test_dtype_holds_through_epochs_and_updates(live):
    """(c)."""
    _, sim, seen, meshes = live
    assert sim.cc.dtype == sim.fc.dtype == torch.float32
    assert seen == {"torch.float32"}
    # an epoch changed the mesh and the Helmholtz modes were solved
    assert sum(len(a) for a in meshes[0]) != sum(len(a) for a in meshes[1])
    assert sim.photoi.fmg_cycles and all(k >= 1
                                         for k in sim.photoi.fmg_cycles)
    # the level-1 solve and the plans' float tables in float32
    assert sim.field.mg.coarse_solver().d.A_inv.dtype == torch.float32
    assert sim.mesh.tb(2).d.vol.dtype == torch.float32


def test_checkpoint_holds_float64_and_restarts_bit_for_bit(live, tmp_path):
    """(d): the checkpoint of step 5 (the third output)."""
    tmp, full, _, _ = live
    ckpt = tmp / "run_000002.dat.npz"
    d = np.load(ckpt)
    assert int(d["payload_it"]) == 5
    assert d["cc"].dtype == np.float64
    np.testing.assert_array_equal(d["cc"].astype(np.float32), d["cc"])
    sim = TSim(argv=LIVE + ["-device=cpu", f"-output%name={tmp_path / 'r'}",
                            f"-restart_from_file={ckpt}"] + F32)
    # read in float64, as the setup runs; the run casts it back exactly
    assert sim.cc.dtype == torch.float64
    sim.run(max_steps=LIVE_STEPS)
    assert sim.cc.dtype == torch.float32
    for a, b in zip(full.tree.lvl_ids, sim.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    assert (sim.it, sim.global_time, sim.global_dt) == (
        full.it, full.global_time, full.global_dt)
    n = full.tree.highest_id
    assert torch.equal(sim.cc[:, :n], full.cc[:, :n])
    assert torch.equal(sim.fc[:, :, :n], full.fc[:, :, :n])


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_float32_tracks_float64(sharded, tmp_path, branch):
    """(e): the branches that run in float32."""
    argv = BRANCHES[branch] + ["-output%dt=1e-13"]
    s64 = run(tmp_path / "t64", argv, BRANCH_STEPS)
    s32 = run(tmp_path / "t32", argv, BRANCH_STEPS, *F32)
    assert s32.cc.dtype == s32.fc.dtype == torch.float32
    assert_logs_close(log(tmp_path / "t32"), log(tmp_path / "t64"), 1e-3)


def test_gas_dynamics_under_float32_raises(tmp_path):
    """(e): the branch left unported in float32."""
    with pytest.raises(NotImplementedError,
                       match="physics/gas_dynamics.py under "
                             "compiled%dtype=float32"):
        TSim(argv=[str(DATA / "gas_heating_cyl_slice.cfg"), "-ndim=2",
                   "-device=cpu", f"-output%name={tmp_path / 'g'}"] + F32)


def test_two_ranks_match_the_unsharded_float32_run(sharded):
    """(f)."""
    threads, out = sharded
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    ref, got = out["unsharded"], out["sharded"]
    assert got["epochs"] == ref["epochs"]
    assert any(add for add, _rm in ref["changes"])
    assert got["dts"] == ref["dts"]
    assert got["solves"] == ref["solves"]
    assert got["photoi"] == ref["photoi"]
    assert got["dtype"] == ref["dtype"] == "float32"
    np.testing.assert_array_equal(got["ids"], ref["ids"])
    np.testing.assert_array_equal(got["cc"], ref["cc"])
    np.testing.assert_array_equal(got["fc"], ref["fc"])
