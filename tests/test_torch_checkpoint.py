"""Checkpoints and restart of the port (afivo_streamer_tpu_torch/io/
checkpoint.py) against the JAX package's (io/checkpoint.py), on the CPU in
float64.

The cylindrical slice with live refinement and Helmholtz photoionization
every 2 steps (air_cyl_amr_slice.cfg, output every 0.1 ps) runs 8 steps and
writes a checkpoint at every output; they fall at steps 0, 4, 5, 6, 7 and 8,
refinement epochs at the even steps.

(a) A port run restarted from the checkpoint of step 5 (or of the setup)
    continues as the uninterrupted run: the same mesh, time, dt, iteration
    and every variable at rtol 1e-12.
(b) Each package restarts from the other's checkpoint and continues as the
    other's uninterrupted run does, at rtol 1e-8; the two packages' files
    of one run hold the same values (io/compare.py).
(c) A checkpoint written at an epoch's step (step 4) holds the state before
    that epoch, and a restart from it skips the epoch, in both packages
    alike (ROADMAP queue C).
(d) The mismatch errors of the JAX package's test_checkpoint_mismatch_
    errors and the other checks of read_checkpoint, raised alike by both
    packages; a missing file; the refusal with dielectrics.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.io.compare import compare_outputs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
STEPS = 8
BASE = [str(DATA / "air_cyl_amr_slice.cfg"), "-ndim=2",
        "-photoi%per_steps=2", "-output%dt=1e-13"]
DIELECTRIC = ["-user%module="
              f"{DATA.parent / 'programs' / 'dielectric_2d.py'}"]


def make(side, prefix, *extra):
    if side == "t":
        return TSim(argv=BASE + [f"-output%name={prefix}", "-device=cpu",
                                 *extra])
    return JSim(argv=BASE + [f"-output%name={prefix}", *extra])


def state(sim):
    cc = sim.cc.numpy() if isinstance(sim.cc, torch.Tensor) else sim.cc
    return cc[:, :sim.tree.highest_id]


def assert_same_run(ref, got, rtol):
    """The same mesh, iteration, time, dt and every variable but the
    scratch one of the boxes in use."""
    assert len(ref.tree.lvl_ids) == len(got.tree.lvl_ids)
    for a, b in zip(ref.tree.lvl_ids, got.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    assert got.it == ref.it
    assert got.global_time == pytest.approx(ref.global_time, rel=rtol)
    assert got.global_dt == pytest.approx(ref.global_dt, rel=rtol)
    use = ref.tree.in_use[:ref.tree.highest_id]
    a, b = state(ref), state(got)
    for iv, name in enumerate(ref.registry.cc_names):
        if name == "tmp":
            continue
        scale = float(np.abs(a[iv][use]).max())
        np.testing.assert_allclose(b[iv][use], a[iv][use], rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' uninterrupted runs with a checkpoint at every
    output."""
    tmp = tmp_path_factory.mktemp("ckpt")
    out = {}
    for side in "jt":
        sim = make(side, tmp / side, "-datfile%write=t")
        sim.run(max_steps=STEPS)
        out[side] = sim
    return tmp, out


def checkpoint(tmp, side, cnt):
    return tmp / f"{side}_{cnt:06d}.dat.npz"


def test_checkpoints_at_the_outputs(runs):
    """The checkpoints' steps and times, the same in both packages, and
    their files the same within 1e-8 (io/compare.py: the tree exact)."""
    tmp, _ = runs
    for side in "jt":
        its = [int(np.load(checkpoint(tmp, side, k))["payload_it"])
               for k in range(6)]
        assert its == [0, 4, 5, 6, 7, 8]
    worst = compare_outputs(tmp / "j", tmp / "t", 1e-8)
    assert sum(name.endswith(".dat.npz") for name in worst) == 6


@pytest.mark.parametrize("cnt", [0, 2], ids=["setup", "step-5"])
def test_restart_equals_uninterrupted_run(runs, tmp_path, cnt):
    tmp, full = runs
    sim = make("t", tmp_path / "r",
               f"-restart_from_file={checkpoint(tmp, 't', cnt)}")
    d = np.load(checkpoint(tmp, "t", cnt))
    assert sim.it == int(d["payload_it"])
    assert sim.out_cnt == cnt
    np.testing.assert_array_equal(state(sim), d["cc"])
    sim.run(max_steps=STEPS)
    assert_same_run(full["t"], sim, 1e-12)


@pytest.mark.parametrize("reader, writer", [("t", "j"), ("j", "t")],
                         ids=["port-from-jax", "jax-from-port"])
def test_restart_from_the_other_package(runs, tmp_path, reader, writer):
    tmp, full = runs
    sim = make(reader, tmp_path / "r",
               f"-restart_from_file={checkpoint(tmp, writer, 2)}")
    sim.run(max_steps=STEPS)
    assert_same_run(full[writer], sim, 1e-8)


def test_restart_at_an_epoch_step_skips_the_epoch(runs, tmp_path):
    """The checkpoint of step 4 is written before that step's epoch; both
    packages restart after it, so the epoch of step 4 never runs: the
    restarted runs agree with each other and not with the uninterrupted
    one."""
    tmp, full = runs
    sims = {side: make(side, tmp_path / side,
                       f"-restart_from_file={checkpoint(tmp, 'j', 1)}")
            for side in "jt"}
    for sim in sims.values():
        assert sim.it == 4
        sim.run(max_steps=STEPS)
    assert_same_run(sims["j"], sims["t"], 1e-8)
    with pytest.raises(AssertionError):
        assert_same_run(full["t"], sims["t"], 1e-8)


def rewrite(path, out, **changes):
    d = dict(np.load(path, allow_pickle=False))
    d.update(changes)
    np.savez_compressed(out, **d)
    return out


@pytest.mark.parametrize("case, match", [
    ("box_size", "box size"), ("variables", "variable list"),
    ("domain_len", "domain_len"), ("coord", "coordinate system"),
    ("coarse_grid", "coarse_grid_size"), ("version", "version"),
    ("ndim", "ndim"), ("r_base", "r_base"), ("periodic", "periodicity")])
def test_checkpoint_mismatch_errors(runs, tmp_path, case, match):
    tmp, _ = runs
    ckpt = checkpoint(tmp, "t", 1)
    extra = {"box_size": ["-box_size=16"],
             "variables": ["-compute_power_density=t"],
             "domain_len": ["-domain_len=2e-2 2e-2"],
             "coord": ["-cylindrical=f"],
             "coarse_grid": ["-coarse_grid_size=32 32"],
             "periodic": ["-cylindrical=f", "-periodic=t f"]}.get(case, [])
    if case == "version":
        ckpt = rewrite(ckpt, tmp_path / "v.dat.npz",
                       payload_version=np.asarray(999))
    elif case == "ndim":
        ckpt = rewrite(ckpt, tmp_path / "n.dat.npz", ndim=np.asarray(3))
    elif case == "r_base":
        ckpt = rewrite(ckpt, tmp_path / "r.dat.npz",
                       r_base=np.asarray([0.0, 1e-3]))
    elif case == "periodic":
        ckpt = rewrite(ckpt, tmp_path / "p.dat.npz",
                       coord=np.asarray("xyz"))
    for side in "jt":
        with pytest.raises(ValueError, match=match):
            make(side, tmp_path / side, f"-restart_from_file={ckpt}",
                 *extra)


def test_missing_checkpoint_and_dielectric_refusal(tmp_path):
    for side in "jt":
        with pytest.raises(FileNotFoundError):
            make(side, tmp_path / side,
                 f"-restart_from_file={tmp_path / 'none.dat.npz'}")
    argv = [str(DATA / "dielectric_cyl_slice.cfg"), "-ndim=2",
            f"-restart_from_file={tmp_path / 'none.dat.npz'}"]
    with pytest.raises(ValueError, match="Restarting not support"):
        JSim(argv=argv + DIELECTRIC + [f"-output%name={tmp_path / 'j'}"])
    with pytest.raises(ValueError, match="Restarting not support"):
        TSim(argv=argv + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
