"""The user hooks of the port against the JAX package's, in short runs of
the committed data/velocity_control_2d.cfg mesh (a cylindrical streamer on
2,560 cells with live refinement, no photoionization) in both packages on
the CPU, float64, with one user module that runs unchanged in either (it
reads the state through NumPy):

* potential_bc (a Dirichlet potential that varies along both electrode
  planes), generic, log_variables and new_pulse_conditions, in a pulse
  train whose second pulse starts within the run (the hook raises the
  electron density by half);
* field_amplitude (a field that varies in time), refine (a criterion on
  the electron density, with a region refined from 0.2 ps on) and
  log_subroutine (a log file of its own in place of the text log).

Each run holds the same mesh after every epoch, dt at every attempted
step, the FMG and V-cycle counts, every recorded hook call, every
variable at rtol 1e-8 and every file both packages write. The JAX driver
calls ``refine`` with the box ids alone (``driver.py:1492-1494``,
``core/tree.py:295-304``), though its docstring documents
``refine(sim, cc, ids)`` (``physics/user_methods.py:13``): the JAX side of
the test registers ``lambda ids: hook(sim, sim.cc, ids)``, and a last test
shows the JAX fault (ROADMAP queue C)."""

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.driver import Simulation as JSim
from torch_pairs import (DATA, RTOL, assert_files_agree, assert_runs_agree,
                         build_pair)

torch.set_num_threads(1)

HOOKS = '''
import numpy as np

BC_DIRICHLET, BC_NEUMANN = 1, 2
RM_REF, KEEP_REF, DO_REF = -1, 0, 1


def user_initialize(cfg, sim):
    which = cfg.add_get("hooks%which", "field", "field or refine")
    jax_refine = cfg.add_get("hooks%jax_refine", False,
                             "Register refine with the ids alone")
    calls = []
    sim.hook_calls = calls

    def potential_bc(iv, d, coords, params):
        ndim = coords.shape[-1]
        if d // 2 != ndim - 1:
            return BC_NEUMANN, 0.0
        s = (coords[..., 0] / 16e-3) ** 2
        prof = 0.05 * s if d % 2 == 0 else 1.0 - 0.2 * s
        return BC_DIRICHLET, params.get("voltage", 0.0) * prof

    def generic(s, time):
        calls.append(("generic", s.it, time))

    def new_pulse_conditions(s):
        calls.append(("new_pulse_conditions", s.it, s.global_time))
        s.cc[s.i_electron] *= 1.5

    def log_variables(s):
        calls.append(("log_variables", s.it, s.global_time))
        return ["hook_it", "hook_t_ps"], [s.it, s.global_time * 1e12]

    def field_amplitude(s, time):
        amp = -1.8e6 * (1.0 + 0.1 * np.sin(time / 1e-12))
        calls.append(("field_amplitude", time, amp))
        return amp

    def refine(s, cc, ids):
        ids = np.asarray(ids, np.int64)
        t = s.tree
        nc, ndim = t.nc, t.ndim
        calls.append(("refine", len(ids), int(ids.sum())))
        ne = np.asarray(cc[s.i_electron][ids]).reshape(
            (len(ids),) + (nc + 2,) * ndim)[(slice(None),)
                                             + (slice(1, nc + 1),) * ndim]
        dx = t.dr_base[0] / 2.0 ** (t.lvl[ids] - 1.0)
        shape = (len(ids),) + (1,) * ndim
        flags = np.where(ne > 1e17, DO_REF, RM_REF)
        flags = np.where((ne > 1e15) & (flags != DO_REF), KEEP_REF, flags)
        fine = (dx < 1e-4).reshape(shape)
        flags = np.where(fine & (flags == DO_REF), KEEP_REF, flags)
        coarse = (dx > 4e-4).reshape(shape)
        flags = np.where(coarse & (flags == RM_REF), KEEP_REF, flags)
        if s.global_time > 2e-13:
            # a region on the axis at mid-height, refined to 2.5e-4 m
            r0 = t.box_r_min(ids)
            inside = ((r0[:, 0] < 2e-3) & (r0[:, 1] > 6e-3)
                      & (r0[:, 1] < 1e-2)).reshape(shape)
            flags = np.where(inside & (dx > 3e-4).reshape(shape), DO_REF,
                             np.where(inside & (flags == RM_REF), KEEP_REF,
                                      flags))
        return flags

    def log_subroutine(s, out_cnt):
        calls.append(("log_subroutine", out_cnt, s.global_time))
        with open(s.output.name + "_user_log.txt", "a") as f:
            f.write(f"{out_cnt} {s.global_time:.8E} {s.global_dt:.8E} "
                    f"{s.velocity:.8E}\\n")

    if which == "field":
        sim.user.potential_bc = potential_bc
        sim.user.generic = generic
        sim.user.new_pulse_conditions = new_pulse_conditions
        sim.user.log_variables = log_variables
    else:
        sim.user.field_amplitude = field_amplitude
        sim.user.log_subroutine = log_subroutine
        if jax_refine:
            sim.user.refine = lambda ids: refine(sim, sim.cc, ids)
        else:
            sim.user.refine = refine
'''

#: a pulse train: 0.05 ps rise, 0.2 ps at the voltage, then the fall and
#: nothing until the second pulse at 0.5 ps
PULSES = ["-field_rise_time=5e-14", "-field_pulse_width=2e-13",
          "-field_num_pulses=2", "-field_pulse_period=5e-13"]
RUNS = {"field": (12, PULSES + ["-field_given_by=field -1.8e6"]),
        "refine": (8, [])}


def argv(tmp_path, which, hooks_file):
    steps, extra = RUNS[which]
    return steps, [str(DATA / "velocity_control_2d.cfg"), "-ndim=2",
                   f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
                   "-output%dt=1e-13", f"-user%module={hooks_file}",
                   f"-hooks%which={which}"] + extra


@pytest.fixture
def hooks_file(tmp_path):
    path = tmp_path / "hooks.py"
    path.write_text(HOOKS)
    return path


@pytest.mark.parametrize("which", list(RUNS))
def test_hooks_match_jax(tmp_path, monkeypatch, hooks_file, which):
    steps, base = argv(tmp_path, which, hooks_file)
    j, t, rec = build_pair(tmp_path, monkeypatch, base,
                           juser=["-hooks%jax_refine=t"])
    j.run(max_steps=steps)
    t.run(max_steps=steps)
    assert_runs_agree(j, t, rec, steps)
    names = [c[0] for c in t.hook_calls]
    assert names == [c[0] for c in j.hook_calls]
    np.testing.assert_allclose(np.array([c[1:] for c in t.hook_calls]),
                               np.array([c[1:] for c in j.hook_calls]),
                               rtol=RTOL, atol=0.0)
    log = which == "field"
    assert_files_agree(tmp_path, log=log)
    if log:
        assert names.count("generic") == steps
        assert names.count("new_pulse_conditions") == 1
        assert names.count("log_variables") == j.out_cnt >= 3
        header = (tmp_path / "t_log.txt").read_text().split("\n")[0]
        assert header.endswith("highest(lvl) hook_it hook_t_ps")
        # the potential varies along the electrode plane
        coords = t.mesh.gc(1).dirs[3].bc_coords
        _kind, val = t.field.phi_bc(t.i_phi, 3, coords, {"voltage": 1.0})
        assert np.ptp(np.asarray(val)) > 0.1
    else:
        assert "refine" in names and names.count("log_subroutine") >= 3
        assert len({c[2] for c in t.hook_calls
                    if c[0] == "field_amplitude"}) > steps
        assert (tmp_path / "t_user_log.txt").read_text() == \
            (tmp_path / "j_user_log.txt").read_text()


def test_jax_refine_hook_signature_fault(tmp_path, hooks_file):
    """The JAX package documents refine(sim, cc, ids) but calls the hook
    with the ids alone: a hook of the documented signature stops its
    setup with a TypeError. The port calls it as documented."""
    _steps, base = argv(tmp_path, "refine", hooks_file)
    with pytest.raises(TypeError, match="missing 2 required positional"):
        JSim(argv=base + [f"-output%name={tmp_path / 'j'}"])
