"""The sharded run of the port (``-compiled%enabled=T -compiled%shards=N``,
afivo_streamer_tpu_torch/parallel/) on the CPU in float64: gloo ranks
spawned by parallel/compiled.run_ranks meet through a FileStore in a
temporary directory, one thread each.

(a) The planar 1D slice with live refinement (air_1d_slice.cfg, 144 cells
    on 5 levels) over 4 ranks (chip_smoke.record_run) and over 2
    ranks through the command line: the same mesh at setup and after every
    refinement epoch (at least two of them change it), the same dts, and
    the logs at rtol 1e-8, atol 1e-10 (tests/test_multichip.py:101-131)
    against the unsharded port and the JAX host path.
(b) The cylindrical main path (air_cyl_amr_slice.cfg, 16,960 cells,
    Helmholtz photoionization every 2 steps, a field that rises over 0.3
    ps) over 4 ranks for 8 steps, across an epoch that adds boxes: the
    same mesh, dts, V-cycle and FMG counts of every field solve and FMG
    cycles per Helmholtz mode at every update as unsharded; every variable
    within 1e-12 of its scale; the writers' files (logs, grid files,
    chemistry files, checkpoints) equal to the unsharded run's through
    io/compare.py; the regression log within 1e-8 of the JAX host path's.
(c) A level's same-level ghost copies read boxes of other ranks: the
    counterpart of tests/test_multichip.py test_neighbor_gathers_cross_
    shards.
(d) Each rank's state holds its own boxes and its halo only, fewer rows
    than the unsharded capacity.
(e) A checkpoint written sharded restarts unsharded and in the JAX package,
    and one written unsharded restarts sharded, each continuing as the
    uninterrupted run.
(f) make_step_fn sharded against unsharded for one step (dryrun).
(g) The branches (the electron energy equation with the source factor and
    the plasma region; gas dynamics with slow heating in Cartesian 2D; 3D
    with edge and corner ghosts; the cylindrical needle electrode; the
    cylindrical dielectric on a coarse grid of 8 x 16 boxes, where the
    gas-side and the dielectric-side box of some surfaces lie on two
    ranks; the velocity_control_2d program's hooks; a user module with the
    refine, field_amplitude and log_subroutine hooks; Monte-Carlo
    photoionization) held against the unsharded run as in (b), each over
    4 ranks and the last five also over 2, across an epoch that changes
    the mesh; the electrode's boundary boxes on two or more ranks; the
    surface charge's integral and the user log file as unsharded; a
    sharded configuration outside a process group raises ValueError.
"""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.io.compare import compare_outputs
from afivo_streamer_tpu_torch.parallel import compiled
from chip_smoke import record_run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
TD = f"-input_data%file={DATA / 'td_air_synthetic.txt'}"
NEW_TD = ["-input_data%old_style=f",
          f"-input_data%file={DATA / 'td_air_synthetic_new.txt'}"]
PROGRAMS = DATA.parent / "programs"

#: the field rises over 0.3 ps, so that an epoch adds boxes in 8 steps
CYL = [str(DATA / "air_cyl_amr_slice.cfg"), "-ndim=2", TD,
       "-photoi%per_steps=2", "-field_rise_time=3e-13", "-output%dt=1e-13",
       "-output%log=t", "-silo_write=t", "-datfile%write=t"]
CYL_STEPS = 8
#: the seed's refinement ends at 20 ps, so that the epochs of steps 2 and
#: 10 change the mesh
ONE_D = [str(DATA / "air_1d_slice.cfg"), "-ndim=1", TD, "-output%log=t",
         "-refine_init_time=2e-11", "-output%dt=2e-11"]
ONE_D_STEPS = 12
MC_FLAGS = ["-photoi%method=montecarlo", "-photoi_mc%physical_photons=f",
            "-photoi_mc%num_photons=20000", "-photoi%per_steps=2"]
#: the branches that run sharded, and the steps of their runs (of those in
#: TWO_RANKS each holds an epoch that changes the mesh but "user-module",
#: whose program keeps its mesh for its first ns)
BRANCHES = {
    "ee53-srcfac-plasma-region": (
        [str(DATA / "air_cyl_ee_slice.cfg"), "-ndim=2", "-photoi%per_steps=2",
         "-fixes%source_factor=flux", "-fixes%write_source_factor=t",
         "-plasma_region_enabled=t", "-plasma_region_rmin=0 0.0135",
         "-plasma_region_rmax=0.002 0.0155"] + NEW_TD, 2),
    "gas-dynamics-cart2d": ([str(DATA / "gas_heating_cyl_slice.cfg"),
                             "-ndim=2", "-cylindrical=f",
                             "-gas%fraction_slow_heating=0.3"], 2),
    "3d": ([str(DATA / "air_3d_slice.cfg"), "-ndim=3", TD,
            "-refine_max_dx=5e-4", "-coarse_grid_size=8 8 8"], 2),
    "electrode": ([str(DATA / "electrode_cyl_slice.cfg"), "-ndim=2"], 4),
    "dielectric": ([str(DATA / "dielectric_cyl_slice.cfg"), "-ndim=2",
                    "-coarse_grid_size=8 16"], 4),
    "user-module": ([str(DATA / "velocity_control_2d.cfg"), "-ndim=2"], 2),
    "user-refine-hook": ([str(DATA / "velocity_control_2d.cfg"), "-ndim=2",
                          TD, "-output%dt=1e-13", "-hooks%which=refine"], 6),
    "montecarlo": ([str(DATA / "air_cyl_amr_slice.cfg"), "-ndim=2", TD]
                   + MC_FLAGS, 4),
}
#: the branches that ran unsharded only before, also over 2 ranks
TWO_RANKS = ("electrode", "dielectric", "user-module", "user-refine-hook",
             "montecarlo")


def shard(n):
    return ["-compiled%enabled=T", f"-compiled%shards={n}"]


def _rank_jobs(jobs):
    """Every rank: run the jobs in turn; rank 0 returns their results."""
    out = {}
    for name, kind, argv, steps in jobs:
        if kind == "run":
            out[name] = record_run(argv, steps)
        else:
            out[name] = compiled._dryrun_rank(*argv)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unsharded cylindrical run, then every sharded job on 4 ranks in
    one spawn while this process runs the other unsharded runs and the JAX
    package's runs of (a) and (b)."""
    from afivo_streamer_tpu.driver import Simulation as JSim
    tmp = tmp_path_factory.mktemp("sharded")
    dev = ["-device=cpu"]
    # the hooks' module of tests/test_torch_hooks.py (imported here: it
    # imports the JAX package, which the ranks need not)
    from test_torch_hooks import HOOKS
    (tmp / "hooks.py").write_text(HOOKS)
    hooks = [f"-user%module={tmp / 'hooks.py'}"]

    def branch(name):
        argv, steps = BRANCHES[name]
        return argv + (hooks if name == "user-refine-hook" else []), steps
    # in a process of its own, whose BLAS runs one thread as the ranks'
    # do, so that its dense level-1 inverses round as theirs
    unsharded = {"cyl": compiled.run_ranks(record_run, 1, (
        CYL + dev + [f"-output%name={tmp / 'u_cyl'}"], CYL_STEPS))}
    s4 = dev + shard(4)
    jobs = [("cyl", "run", CYL + s4 + [f"-output%name={tmp / 's_cyl'}"],
             CYL_STEPS),
            ("1d", "run", ONE_D + s4 + [f"-output%name={tmp / 's_1d'}"],
             ONE_D_STEPS),
            ("restart", "run", CYL + s4 + [
                f"-output%name={tmp / 's_restart'}",
                f"-restart_from_file={tmp / 'u_cyl_000002.dat.npz'}"],
             CYL_STEPS),
            ("step", "step", (4, str(tmp)), 0)]
    jobs += [(name, "run", branch(name)[0] + s4
              + [f"-output%name={tmp / name}"], branch(name)[1])
             for name in BRANCHES]
    jobs2 = [(name, "run", branch(name)[0] + dev + shard(2)
              + [f"-output%name={tmp / ('two_' + name)}"], branch(name)[1])
             for name in TWO_RANKS]
    sharded, two = {}, {}
    spawns = [threading.Thread(target=lambda: sharded.update(
                  compiled.run_ranks(_rank_jobs, 4, (jobs,)))),
              threading.Thread(target=lambda: two.update(
                  compiled.run_ranks(_rank_jobs, 2, (jobs2,))))]
    for spawn in spawns:
        spawn.start()
    try:
        unsharded["1d"] = record_run(
            ONE_D + dev + [f"-output%name={tmp / 'u_1d'}"], ONE_D_STEPS)
        for name in BRANCHES:
            argv, steps = branch(name)
            unsharded[name] = record_run(
                argv + dev + [f"-output%name={tmp / ('u_' + name)}"], steps)
        JSim(argv=[a for a in CYL if a != "-datfile%write=t"]
             + ["-silo_write=f", f"-output%name={tmp / 'j_cyl'}"]
             ).run(max_steps=CYL_STEPS)
        JSim(argv=ONE_D + [f"-output%name={tmp / 'j_1d'}"]).run(
            max_steps=ONE_D_STEPS)
    finally:
        for spawn in spawns:
            spawn.join()
    assert set(sharded) == {name for name, *_r in jobs}, "a rank failed"
    assert set(two) == set(TWO_RANKS), "a rank of the 2-rank runs failed"
    sharded["two"] = two
    return tmp, unsharded, sharded


def assert_same_run(u, s, state_rtol=1e-12):
    """The same mesh at every epoch, dts, cycle counts, iteration and time,
    and every variable within ``state_rtol`` of its scale."""
    assert len(s["epochs"]) == len(u["epochs"])
    for mu, ms in zip(u["epochs"], s["epochs"]):
        assert len(mu) == len(ms)
        for a, b in zip(mu, ms):
            np.testing.assert_array_equal(a, b)
    assert len(s["dts"]) == len(u["dts"]) > 0
    np.testing.assert_allclose(s["dts"], u["dts"], rtol=1e-12, atol=0.0)
    assert s["solves"] == u["solves"] and s["photoi"] == u["photoi"]
    assert (s["it"], s["time"]) == (u["it"], u["time"])
    np.testing.assert_array_equal(s["ids"], u["ids"])
    for x in ("cc", "fc"):
        for iv, name in enumerate(u["names"] if x == "cc"
                                  else range(len(u["fc"]))):
            a, b = u[x][iv], s[x][iv]
            scale = max(float(np.abs(a).max()), 1e-300)
            np.testing.assert_allclose(b, a, rtol=0.0,
                                       atol=state_rtol * scale,
                                       err_msg=f"{x} {name}")


def test_cyl_main_path_over_four_ranks(runs):
    """(b): the same mesh, dts, cycle counts and state as unsharded, with
    an epoch that adds boxes and the photoionization updates."""
    _tmp, u, s = runs
    u, s = u["cyl"], s["cyl"]
    assert any(n_add > 0 for n_add, _n_rm in u["changes"])
    assert len(u["photoi"]) >= CYL_STEPS // 2 + 1
    assert_same_run(u, s)
    assert s["n_leaf_cells"] == sum(s["leaf_cells"])
    # both runs' BLAS run one thread: the same bits
    for x in ("cc", "fc"):
        np.testing.assert_array_equal(s[x], u[x])


def test_cyl_files_equal_unsharded_and_jax(runs):
    """(b): the files of the sharded run equal the unsharded run's, and its
    regression log is the JAX host path's at rtol 1e-8."""
    tmp, _u, _s = runs
    worst = compare_outputs(tmp / "u_cyl", tmp / "s_cyl", 1e-12)
    for kind in ("rtest.log", "log.txt", "grid_000001.npz",
                 "000002.dat.npz", "species.txt"):
        assert any(name.endswith(kind) for name in worst), kind
    rows_j = np.loadtxt(tmp / "j_cyl_rtest.log", skiprows=1)
    rows_s = np.loadtxt(tmp / "s_cyl_rtest.log", skiprows=1)
    assert rows_j.shape == rows_s.shape and rows_j.shape[0] >= 3
    np.testing.assert_allclose(rows_s, rows_j, rtol=1e-8, atol=0.0)


def test_1d_live_refinement_over_four_ranks(runs):
    """(a): two or more epochs that change the mesh, the same meshes and
    dts, the logs at rtol 1e-8, atol 1e-10 against the unsharded port and
    the JAX host path."""
    tmp, u, s = runs
    assert sum(n_add + n_rm > 0 for n_add, n_rm in u["1d"]["changes"]) >= 2
    assert_same_run(u["1d"], s["1d"])
    ref = np.loadtxt(tmp / "j_1d_rtest.log", skiprows=1)
    for side in ("u_1d", "s_1d"):
        got = np.loadtxt(tmp / f"{side}_rtest.log", skiprows=1)
        assert got.shape == ref.shape and len(ref) >= 2
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)


def test_1d_over_two_ranks_from_the_command_line(runs, tmp_path):
    """(a): ``python -m afivo_streamer_tpu_torch ... -compiled%shards=2``
    starts its two gloo ranks and writes the unsharded run's files."""
    tmp, _u, _s = runs
    out = subprocess.run(
        [sys.executable, "-m", "afivo_streamer_tpu_torch"] + ONE_D
        + ["-device=cpu", f"-output%name={tmp_path / 'cli'}",
           f"-end_time={u_time(runs)}"] + shard(2),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "2 ranks, backend gloo" in out.stdout
    worst = compare_outputs(tmp / "u_1d", tmp_path / "cli", 1e-12)
    assert any(name.endswith("log.txt") for name in worst)
    rows_u = np.loadtxt(tmp / "u_1d_rtest.log", skiprows=1)
    rows_s = np.loadtxt(tmp_path / "cli_rtest.log", skiprows=1)
    np.testing.assert_allclose(rows_s, rows_u, rtol=1e-8, atol=1e-10)


def u_time(runs):
    """The time the unsharded 1D run reached, as an end time."""
    return repr(runs[1]["1d"]["time"])


def test_halo_crosses_ranks_and_memory_is_sharded(runs):
    """(c) and (d): on some level a rank's same-level ghost copies read
    another rank's boxes; every rank's state holds its own boxes and its
    halo, fewer rows than the unsharded capacity, and its halo moves
    bytes."""
    _tmp, u, s = runs
    ranks = s["cyl"]["ranks"]
    assert len(ranks) == 4
    assert any(sum(r["cross"]) > 0 for r in ranks)
    cap = u["cyl"]["ranks"][0]["rows"]
    for r in ranks:
        assert r["rows"] == r["own"] + r["halo"] < cap
        assert r["exchange"]["calls"] > 0 and r["exchange"]["bytes"] > 0
    assert sum(r["own"] for r in ranks) == len(s["cyl"]["ids"])


def test_checkpoints_restart_across_sharded_unsharded_and_jax(runs,
                                                               tmp_path):
    """(e): the sharded run's checkpoint of step 5 restarts unsharded and in
    the JAX package, the unsharded one restarts over 4 ranks, and each
    continues as the uninterrupted run."""
    from afivo_streamer_tpu.driver import Simulation as JSim
    tmp, u, s = runs
    its = [int(np.load(tmp / f"s_cyl_{k:06d}.dat.npz")["payload_it"])
           for k in range(6)]
    assert its == [0, 4, 5, 6, 7, 8]
    ckpt = f"-restart_from_file={tmp / 's_cyl_000002.dat.npz'}"
    t = record_run(CYL + ["-device=cpu", ckpt,
                                   f"-output%name={tmp_path / 't'}"],
                            CYL_STEPS)
    for got in (t, s["restart"]):
        assert got["it"] == u["cyl"]["it"]
        np.testing.assert_array_equal(got["ids"], u["cyl"]["ids"])
        a, b = u["cyl"]["cc"], got["cc"]
        for iv, name in enumerate(u["cyl"]["names"]):
            scale = max(float(np.abs(a[iv]).max()), 1e-300)
            np.testing.assert_allclose(b[iv], a[iv], rtol=0.0,
                                       atol=1e-12 * scale, err_msg=name)
    j = JSim(argv=[a for a in CYL if a != "-silo_write=t"]
             + ["-silo_write=f", ckpt, f"-output%name={tmp_path / 'j'}"])
    j.run(max_steps=CYL_STEPS)
    assert j.it == u["cyl"]["it"]
    jcc = j.cc[:, u["cyl"]["ids"]]
    for iv, name in enumerate(u["cyl"]["names"]):
        if name == "tmp":
            continue
        a = u["cyl"]["cc"][iv]
        np.testing.assert_allclose(jcc[iv], a, rtol=1e-8,
                                   atol=1e-8 * float(np.abs(a).max()),
                                   err_msg=name)


def test_step_fn_sharded_matches_unsharded(runs):
    """(f): one make_step_fn step on 4 ranks equals the unsharded step."""
    _tmp, _u, s = runs
    out = s["step"]
    assert out["setup_equal"]
    assert np.isfinite(out["dt_lim"])
    assert out["dt_lim"] == out["dt_lim_unsharded"]
    assert out["max_scaled_err"] <= 1e-12
    assert len(out["leaf_cells"]) == 4


@pytest.mark.parametrize("name", list(BRANCHES))
def test_branch_runs_sharded(runs, name):
    """(g): every branch over 4 ranks equals its unsharded run."""
    _tmp, u, s = runs
    assert_same_run(u[name], s[name])


@pytest.mark.parametrize("name", TWO_RANKS)
def test_branch_runs_over_two_ranks(runs, name):
    """(g): the branches that ran unsharded only before equal their
    unsharded runs over 2 ranks too, across an epoch that changes the
    mesh (the velocity_control_2d program keeps its mesh in its steps:
    the other user module's refine hook changes it)."""
    _tmp, u, s = runs
    assert_same_run(u[name], s["two"][name])
    if name != "user-module":
        assert any(a + r > 0 for a, r in u[name]["changes"]), name


def test_electrode_and_dielectric_boundaries_straddle_ranks(runs):
    """(g): the electrode's boundary boxes lie on two or more of the 4
    ranks, and on 2 and on 4 ranks some surface's gas-side box and
    dielectric-side box lie on two ranks (the dielectric side reads the
    surface charge through the halo); the surface charge's integral is
    the unsharded one."""
    _tmp, u, s = runs
    ranks = s["electrode"]["ranks"]
    assert sum(r["lsf_bnd"] > 0 for r in ranks) >= 2
    assert sum(r["lsf_bnd"] for r in ranks) > 0
    for run in (s["dielectric"], s["two"]["dielectric"]):
        assert sum(r["surf_cross"] for r in run["ranks"]) > 0
        assert sum(r["surf_own"] for r in run["ranks"]) > 0
        assert run["surf_integral"] == u["dielectric"]["surf_integral"]
    assert u["dielectric"]["surf_integral"] != 0.0


def test_user_log_file_equals_unsharded(runs):
    """(g): the log_subroutine hook writes its file on rank 0 only, as
    unsharded."""
    tmp, _u, _s = runs
    want = (tmp / "u_user-refine-hook_user_log.txt").read_text()
    assert want.count("\n") >= 3
    for name in ("user-refine-hook", "two_user-refine-hook"):
        assert (tmp / f"{name}_user_log.txt").read_text() == want


def test_shards_outside_a_process_group_raise(tmp_path):
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        TSim(argv=ONE_D + ["-device=cpu", f"-output%name={tmp_path}/r"]
             + shard(2))


def test_shards_round_down_to_a_power_of_two(capsys):
    from afivo_streamer_tpu_torch.utils.config import CFG
    cfg = CFG()
    cfg.update_from_arguments(shard(6))
    assert compiled.CompiledSettings(cfg).n_shards == 4
    assert "using 4" in capsys.readouterr().out
    assert compiled.pad_capacity_to(130, 4) == 132
