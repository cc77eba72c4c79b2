"""The programs of the port (afivo_streamer_tpu_torch/programs/) against
the JAX package's programs (programs/<name>/user.py, loaded unchanged), each
on its committed configuration in afivo_streamer_tpu_torch/data/, both
packages on the CPU in float64, 8 steps with the stock writers on:

* velocity_control_2d (the hooks generic and field_amplitude; both
  simulations are moved past 1 ns after setup, so that the controller
  acts from the first step);
* stability_3d (field_amplitude through analysis.zmin_zmax_threshold, the
  decay active from the first step);
* comparison_air_2d (potential_bc from the tabulated electrode potentials;
  the JAX program reads its tables beside its own file, so the test runs a
  copy of it in tmp_path beside the committed tables);
* gas_gradient_2d with a line and with a sphere;
* 2d_sprite and 3d_sprite (the altitude density and the Wait-Spies
  profile);
* animation_2d and parameter_study_2d, templates that set no hook, on the
  committed cylindrical slice with live refinement and photoionization
  (air_cyl_amr_slice.cfg) and the stock writers turned on.

Each holds the same mesh at every epoch, dt at every attempted step, the
FMG and V-cycle counts, the recorded calls of the field_amplitude and
generic hooks (time and value), every variable at rtol 1e-8 and every
file both packages write (tests/torch_pairs.py). The committed voltage
tables of comparison_air_2d are held to their generator."""

import shutil

import numpy as np
import pytest
import torch

from torch_pairs import (DATA, JAX_PROGRAMS, PROGRAMS, RTOL,
                         assert_files_agree, assert_runs_agree, build_pair)

torch.set_num_threads(1)

STEPS = 8
#: the stock writers on air_cyl_amr_slice.cfg, with an output every 0.05 ps
WRITERS = ["-output%log=t", "-silo_write=t", "-output%dt=5e-14"]
#: case (the program, then "-" and a variant) -> (configuration, ndim,
#: extra flags)
CASES = {
    "velocity_control_2d": ("velocity_control_2d", 2, []),
    "stability_3d": ("stability_3d", 3, []),
    "comparison_air_2d": ("comparison_air_2d", 2, []),
    "gas_gradient_2d-line": ("gas_gradient_2d", 2, []),
    "gas_gradient_2d-sphere": ("gas_gradient_2d", 2,
                               ["-gradient_type=sphere"]),
    "2d_sprite": ("2d_sprite", 2, []),
    "3d_sprite": ("3d_sprite", 3, []),
    "animation_2d": ("air_cyl_amr_slice", 2, WRITERS),
    "parameter_study_2d": ("air_cyl_amr_slice", 2, WRITERS),
}
#: the time both simulations of velocity_control_2d start from
PAST_ONE_NS = 1.1e-9


def record_hooks(sim, calls):
    """Record every call of the field_amplitude and generic hooks of
    ``sim`` with its time (and the amplitude returned)."""
    user = sim.user
    for name in ("field_amplitude", "generic"):
        hook = getattr(user, name)
        if hook is None:
            continue

        def wrapped(s, time, hook=hook, name=name):
            out = hook(s, time)
            calls.append((name, time, 0.0 if out is None else float(out)))
            return out
        setattr(user, name, wrapped)


def jax_module(tmp_path, program):
    """The unchanged JAX program; comparison_air_2d as a copy beside the
    committed voltage tables."""
    src = JAX_PROGRAMS / program / "user.py"
    if program != "comparison_air_2d":
        return src
    for name in ("applied_voltage_upper.txt", "applied_voltage_lower.txt"):
        shutil.copy(DATA / name, tmp_path / name)
    shutil.copy(src, tmp_path / "user.py")
    return tmp_path / "user.py"


@pytest.mark.parametrize("case", list(CASES))
def test_program_matches_jax(tmp_path, monkeypatch, case):
    cfg, ndim, extra = CASES[case]
    program = case.split("-")[0]
    argv = [str(DATA / f"{cfg}.cfg"), f"-ndim={ndim}",
            f"-input_data%file={DATA / table_of(cfg)}"] + extra
    j, t, rec = build_pair(
        tmp_path, monkeypatch, argv,
        [f"-user%module={jax_module(tmp_path, program)}"],
        [f"-user%module={PROGRAMS / f'{program}.py'}"])
    if program == "velocity_control_2d":
        j.global_time = t.global_time = PAST_ONE_NS
    calls = {"j": [], "t": []}
    record_hooks(j, calls["j"])
    record_hooks(t, calls["t"])
    j.run(max_steps=STEPS)
    t.run(max_steps=STEPS)
    assert_runs_agree(j, t, rec, STEPS, changing_epoch=False)
    assert [c[0] for c in calls["t"]] == [c[0] for c in calls["j"]]
    np.testing.assert_allclose(np.array([c[1:] for c in calls["t"]]),
                               np.array([c[1:] for c in calls["j"]]),
                               rtol=RTOL, atol=0.0)
    assert_files_agree(tmp_path, summary=t.gas.constant_density)
    check_program(program, t, calls["t"])


def table_of(cfg):
    text = (DATA / f"{cfg}.cfg").read_text()
    line = [ln for ln in text.splitlines()
            if ln.strip().startswith("input_data%file")][0]
    return line.split("/")[-1].strip()


def check_program(program, t, calls):
    """What each program must have done in the run."""
    amps = [a for name, _t, a in calls if name == "field_amplitude"]
    if program == "velocity_control_2d":
        # the controller changed the field at every new time (a voltage
        # update at the time of the last one leaves it) and read max(E) at
        # every step
        assert len(set(amps)) > STEPS
        assert sum(name == "generic" for name, *_ in calls) == STEPS
    elif program == "stability_3d":
        # the streamer is below decay_start_z from the start: the field
        # decayed from the initial one
        assert max(amps) < -5e5 and min(amps) > -2e6
        assert all(a != -2e6 for a in amps)
    elif program == "comparison_air_2d":
        # the boundary potential varies along the electrode planes
        coords = t.mesh.gc(1).dirs[3].bc_coords
        _kind, val = t.field.phi_bc(t.i_phi, 3, coords,
                                    {"voltage": t.field.current_voltage})
        val = val.numpy()
        assert val.max() > val.min() > 0.85 * t.field.current_voltage
    elif program == "gas_gradient_2d":
        M = t.cc[t.registry.cc_names.index("M"), :t.tree.highest_id]
        N = t.gas.number_density
        assert float(M.min()) == pytest.approx(0.8 * N, rel=1e-6)
        assert float(M.max()) == pytest.approx(N, rel=1e-6)
    elif program in ("animation_2d", "parameter_study_2d"):
        # templates: no hook, so the run is the stock one
        assert not calls
        assert all(v is None for v in vars(t.user).values())
    else:  # the sprites: density falls with altitude, ambient electrons
        M = t.cc[t.registry.cc_names.index("M"), :t.tree.highest_id]
        assert float(M.max()) / float(M.min()) > 100.0
        assert float(t.cc[t.i_electron].min()) >= 0.0


def test_voltage_tables_match_their_generator():
    """The committed electrode potential tables of comparison_air_2d are
    what data/make_voltage_tables.py writes, and both packages read them
    alike."""
    import importlib.util
    from afivo_streamer_tpu.utils.table_data import table_from_file as jread
    from afivo_streamer_tpu_torch.utils.table_data import table_from_file
    spec = importlib.util.spec_from_file_location(
        "make_voltage_tables", DATA / "make_voltage_tables.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    for name, text in gen.tables().items():
        assert (DATA / name).read_text() == text, name
        x, y = table_from_file(str(DATA / name), "location[m]_vs_potential[V]")
        jx, jy = jread(str(DATA / name), "location[m]_vs_potential[V]")
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x[-1] == pytest.approx(1.25e-2) and np.ptp(y) > 0.04
