"""The port's tools (afivo_streamer_tpu_torch/tools/) against the JAX
package's (tools/), on the CPU in float64, on committed inputs.

(a) absorption_function: the fitted coefficients and decay rates within
    rtol 1e-8 and the printed fit the same.
(b) chemistry_inspect on data/td_air_synthetic_reactions.txt: the printed
    summary identical.
(c) chemistry_reaction_parser on a small CSV: the reaction lines, the
    failures and the converted LaTeX file identical.
(d) poisson_bench at nc = 8, cgs = 8, max_lvl = 2: the residual after each
    V-cycle within rtol 1e-8 of the JAX package's Multigrid host path on
    the same problem; the JSON's keys.
(e) chaos_floor on air_cyl_amr_slice.cfg and electrode_sensitivity on
    electrode_cyl_slice.cfg, each to 0.3 ps (a few steps), the reference's
    case files replaced by the committed config, table and a golden log
    written here: the same JSON keys and values within rtol 1e-6, the same
    table rows with values within rtol 1e-6.
(f) profile_step for 2 steps on the CPU prints its JSON with every unit.
(g) Both spellings of the device flag.
(h) sensitivity_generate_commands: the command file of the JAX tool with
    this package as the runner, and -device passed on when given.
"""

import importlib.util
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import golden_cases
from afivo_streamer_tpu_torch.tools import (
    absorption_function, chaos_floor, chemistry_inspect,
    chemistry_reaction_parser, electrode_sensitivity, poisson_bench,
    profile_step, sensitivity_generate_commands)
from afivo_streamer_tpu_torch.tools._args import add_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
TABLE = DATA / "td_air_synthetic.txt"
END_NS = 3e-4  # 0.3 ps
NUM = re.compile(r"[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)|nan|inf)")


def jax_tool(name):
    """The JAX package's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(mod, monkeypatch, capsys, args):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(args))
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def run_port(mod, capsys, args):
    capsys.readouterr()
    mod.main(list(args))
    return capsys.readouterr().out


def config(tmp_path, name):
    """A committed config with an output every 0.1 ps."""
    lines = [ln for ln in (DATA / name).read_text().splitlines()
             if not ln.strip().startswith("output%dt")]
    path = tmp_path / name
    path.write_text("\n".join(lines + [" output%dt = 1e-13", ""]))
    return path


def golden(tmp_path, cfg, name):
    """A golden log for ``cfg``: this package's run scaled by 1 + 1e-4 in
    its observables, so that the golden comparison finds deviations."""
    from afivo_streamer_tpu_torch.driver import Simulation
    sim = Simulation(argv=[str(cfg), "-ndim=2", "-device=cpu",
                           f"-input_data%file={TABLE}",
                           f"-output%name={tmp_path / 'gold'}"])
    sim.run(end_time=END_NS * 1e-9)
    src = tmp_path / "gold_rtest.log"
    rows = np.loadtxt(src, skiprows=1, ndmin=2)
    rows[:, 3:] *= 1.0 + 1e-4
    path = tmp_path / name
    np.savetxt(path, rows, header=src.read_text().splitlines()[0],
               comments="")
    return path


def assert_numbers_close(got: str, ref: str, rtol: float):
    """The same text with every number within rtol."""
    assert NUM.sub("#", got) == NUM.sub("#", ref)
    a = np.array([float(x) for x in NUM.findall(got)])
    b = np.array([float(x) for x in NUM.findall(ref)])
    np.testing.assert_allclose(a, b, rtol=rtol, equal_nan=True)


def test_absorption_function(monkeypatch, capsys):
    """(a)."""
    import scipy.optimize
    fits = []
    orig = scipy.optimize.curve_fit

    def spy(*args, **kw):
        out = orig(*args, **kw)
        fits.append(np.exp(out[0]))
        return out

    monkeypatch.setattr(scipy.optimize, "curve_fit", spy)
    args = ["-n_modes", "2", "-n_points", "200"]
    ref = run_jax(jax_tool("absorption_function"), monkeypatch, capsys, args)
    got = run_port(absorption_function, capsys, args)
    assert len(fits) == 2
    np.testing.assert_allclose(fits[1], fits[0], rtol=1e-8)
    assert got == ref and "photoi_helmh%coeffs" in got


def test_chemistry_inspect(monkeypatch, capsys):
    """(b)."""
    args = [str(DATA / "td_air_synthetic_reactions.txt"), "-reactions"]
    ref = run_jax(jax_tool("chemistry_inspect"), monkeypatch, capsys, args)
    got = run_port(chemistry_inspect, capsys, args)
    assert got == ref and "Reactions:" in got


def test_chemistry_reaction_parser(monkeypatch, capsys, tmp_path):
    """(c)."""
    csv = tmp_path / "reactions.csv"
    csv.write_text(
        "reaction,rate,comment\n"
        "# a comment line\n"
        "e + N2 -> e + e + N2_plus,1.5e-16*exp(-(Td/420.)**2),ionization\n"
        "e + O2 -> O2_min,2.4e-7,attachment\n"
        "N2_plus + O2 -> O2_plus + N2,6e-11*(300/Tg)**0.5,transfer\n"
        "e + X -> Y,foo(Td),unmatched\n")
    tex = tmp_path / "tex.csv"
    tex.write_text("reaction,rate\n"
                   r"e + O2 \to O2_min,2.4\times10^{-7}" "\n")
    jax_mod = jax_tool("chemistry_reaction_parser")
    for args in ([str(csv), "--comment"], [str(csv), "--length-unit", "m"]):
        ref = run_jax(jax_mod, monkeypatch, capsys, args)
        got = run_port(chemistry_reaction_parser, capsys, args)
        assert got == ref and got.count("\n") == 3 + ("--comment" in args) * 3
    outs = []
    for run, mod in ((lambda m, a: run_jax(m, monkeypatch, capsys, a),
                      jax_mod),
                     (lambda m, a: run_port(m, capsys, a),
                      chemistry_reaction_parser)):
        out = tmp_path / f"out_{len(outs)}.csv"
        run(mod, [str(tex), "--convert-tex", str(out)])
        outs.append(out.read_text())
    assert outs[0] == outs[1] and "->" in outs[0]


def test_poisson_bench_matches_jax_host_path():
    """(d)."""
    from afivo_streamer_tpu.core import ghostcell as jgc
    from afivo_streamer_tpu.core import spatial as jsp
    from afivo_streamer_tpu.core.batch import BoxBatch
    from afivo_streamer_tpu.core.tree import Tree
    from afivo_streamer_tpu.solvers.multigrid import Multigrid
    nc, cgs, max_lvl, n = 8, 8, 2, 4
    out = poisson_bench.run(nc, cgs, max_lvl, n_cycles=n, reps=1,
                            device="cpu")
    t = Tree(2, nc, [1.0, 1.0], [cgs, cgs])
    t.refine_up_to_lvl(max_lvl)
    cc = np.array(BoxBatch(t, 3, 0).cc)
    cc = np.concatenate([cc, np.zeros((3, 8, cc.shape[2]))], axis=1)
    interior = jsp.interior_flat(2, nc)
    for ids in t.lvl_ids:
        cc[1, np.asarray(ids)[:, None], interior[None, :]] = 1.0
    mg = Multigrid(t, 0, 1, 2, lambda iv, d, c, p: (jgc.BC_DIRICHLET, 0.0))
    cc = mg.fill_ghosts_phi(cc, {})
    ref = []
    for _ in range(n):
        cc = mg.fas_vcycle(cc, {})
        ref.append(float(mg.max_abs_residual(cc)))
    np.testing.assert_allclose(out["residuals"], ref, rtol=1e-8)
    assert ref[-1] < ref[0] / 1e3
    assert out["dtype"] == "float64" and out["backend"] == "cpu"
    for key in ("n_leaf_cells", "levels", "vcycle_ms", "vcycle_us_per_cell",
                "final_residual", "fmg_ms", "fmg_us_per_cell"):
        assert key in out


def test_chaos_floor_matches_jax(monkeypatch, capsys, tmp_path):
    """(e): chaos_floor."""
    cfg = config(tmp_path, "air_cyl_amr_slice.cfg")
    gold = golden(tmp_path, cfg, "gold.log")
    entry = {"prog": "-", "case": "slice", "ndim": 2, "user": False}
    paths = (str(cfg), str(gold), str(TABLE), None)
    args = ["slice", "--eps", "1e-4", "--end-time", str(END_NS * 1e-9)]
    monkeypatch.setattr(golden_cases, "CASES", [entry])
    monkeypatch.setattr(golden_cases, "case_paths", lambda c: paths)
    ref = run_jax(jax_tool("chaos_floor"), monkeypatch, capsys, args)
    monkeypatch.setattr(chaos_floor, "CASES", [entry])
    monkeypatch.setattr(chaos_floor, "case_paths", lambda c: paths)
    got = run_port(chaos_floor, capsys, args + ["-device=cpu"])
    # the JSON is the last line, after the runs' status lines
    ref, got = (json.loads(out.strip().splitlines()[-1]) for out in (ref, got))
    assert got.keys() == ref.keys()
    assert ref["self_bad_at_ref_tol"] > 0 and ref["golden_bad_at_ref_tol"] > 0
    for key in ref:
        if isinstance(ref[key], dict):
            assert got[key].keys() == ref[key].keys()
            np.testing.assert_allclose(list(got[key].values()),
                                       list(ref[key].values()), rtol=1e-6)
        else:
            assert got[key] == ref[key], key


def test_electrode_sensitivity_matches_jax(monkeypatch, capsys, tmp_path):
    """(e): electrode_sensitivity."""
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    cfg = config(ref_dir, "electrode_cyl_slice.cfg")
    shutil.copy(TABLE, ref_dir / "td_air_siglo_swarm.txt")
    golden(tmp_path, cfg, ref_dir / "electrode_cyl_slice_rtest.log")
    args = [str(END_NS), "electrode_cyl_slice"]
    jax_mod = jax_tool("electrode_sensitivity")
    monkeypatch.setattr(jax_mod, "REF", str(ref_dir))
    ref = run_jax(jax_mod, monkeypatch, capsys, args)
    monkeypatch.setattr(electrode_sensitivity, "REF", str(ref_dir))
    got = run_port(electrode_sensitivity, capsys, args + ["--device", "cpu"])
    # the table, after the runs' status lines
    ref, got = (out[out.index("electrode_cyl_slice: max"):]
                for out in (ref, got))
    assert len(got.splitlines()) >= 8
    assert_numbers_close(got, ref, 1e-6)


def test_profile_step_prints_every_unit(monkeypatch, capsys):
    """(f)."""
    monkeypatch.setenv("PROF_STEPS", "2")
    out = run_port(profile_step, capsys, ["-device=cpu"])
    report = json.loads(out[out.rindex("\n{") + 1:])
    for unit in ("vcycle", "field_solve", "flux_substep", "restrict_gc",
                 "step"):
        assert report[f"{unit}_ms"] > 0
        assert report[f"{unit}_launches"] == {}  # none on the CPU
    for key in ("setup_s", "warmup_steps", "n_cells", "levels",
                "step_ms_median", "refine_epoch_ms", "refine_changed"):
        assert key in report
    assert report["dtype"] == "float64" and report["warmup_steps"] == 2


@pytest.mark.parametrize("argv", [["-device=cpu"], ["--device", "cpu"],
                                  ["-device", "cpu"]])
def test_device_flag_spellings(argv):
    """(g)."""
    import argparse
    ap = argparse.ArgumentParser()
    add_device(ap)
    assert ap.parse_args(argv).device == "cpu"
    assert ap.parse_args([]).device == "cuda"


@pytest.mark.parametrize("device", [None, "cpu"])
def test_sensitivity_commands_match_jax(monkeypatch, capsys, tmp_path,
                                        device):
    """(h)."""
    args = [str(DATA / "air_cyl_amr_slice.cfg"), "-ix_range", "2", "4",
            "-rate_factors", "0.5", "2.0"]
    monkeypatch.chdir(tmp_path)
    ref = run_jax(jax_tool("sensitivity_generate_commands"), monkeypatch,
                  capsys, args + ["-command_file", "j.txt"])
    got = run_port(sensitivity_generate_commands, capsys,
                   args + ["-command_file", "t.txt"]
                   + ([f"-device={device}"] if device else []))
    assert ref == "wrote 7 commands to j.txt\n"
    assert got.replace("t.txt", "j.txt") == ref
    want = (tmp_path / "j.txt").read_text().replace(
        "python -m afivo_streamer_tpu ", "python -m afivo_streamer_tpu_torch ")
    if device:
        want = want.replace(" -ndim=2", f" -ndim=2 -device={device}")
    assert (tmp_path / "t.txt").read_text() == want
    assert want.count("afivo_streamer_tpu_torch ") == 7
