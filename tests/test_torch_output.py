"""The port's writers against the JAX package's, both packages on the CPU
in float64 (tests/torch_pairs.py holds the files): the chemistry files
(_species.txt, _reactions.txt and _stoich_matrix.txt byte for byte; at
constant gas density _summary.txt; at every output a line of _rates.txt
and of _amounts.txt), the text log _log.txt (every column but wc_time)
and the per-box grid files _grid_<cnt>.npz (the same keys, box ids and
levels, values at rtol 1e-8) on

* the cylindrical slice (air_cyl_slice.cfg, frozen 32 x 32 cells) and the
  main path's slice with live refinement (air_cyl_amr_slice.cfg on a
  coarser mesh, without photoionization), the latter with output%max_lvl,
  output%only and silo%per_outputs;
* the gas slice (gas_heating_cyl_slice.cfg, gas dynamics: the gas species
  lead the species and have no amounts, and there is no _summary.txt);
* the cylindrical dielectric slice (dielectric_cyl_slice.cfg: the surface
  charge enters the log's net charge).

A stock configuration (air_cyl_slice.cfg without its ``output%log = f``
and ``silo_write = f`` lines) builds and runs in the port and writes every
file; the writers the port does not hold still raise. A JAX run carried
into the port by interop, output state included, writes the same log
lines as the JAX run goes on to write."""

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.core import reductions as red
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.io.compare import LISTINGS, compare_outputs
from torch_pairs import (DATA, PROGRAMS, RTOL, assert_files_agree,
                         assert_logs_agree, assert_runs_agree, build_pair)

torch.set_num_threads(1)

WRITERS = ["-output%log=t", "-silo_write=t", "-output%dt=3e-14"]
#: a coarser mesh of the live-refinement slices, without photoionization
SMALL = ["-refine_max_dx=5e-4", "-refine_min_dx=1.25e-4",
         "-refine_regions_dr=2.5e-4", "-photoi%enabled=f"]
CASES = {
    "cyl": ("air_cyl_slice.cfg", "td_air_synthetic.txt",
            ["-refine_max_dx=5e-4"], 5),
    "cyl-amr-selection": ("air_cyl_amr_slice.cfg", "td_air_synthetic.txt",
                          SMALL + ["-output%max_lvl=3",
                                   "-output%only=e",
                                   "-silo%per_outputs=2"], 6),
    "gas": ("gas_heating_cyl_slice.cfg", "td_air_synthetic_reactions.txt",
            SMALL, 6),
    "dielectric": ("dielectric_cyl_slice.cfg", "td_air_synthetic.txt",
                   SMALL, 6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_writers_match_jax(tmp_path, monkeypatch, case):
    cfg, table, extra, steps = CASES[case]
    argv = [str(DATA / cfg), "-ndim=2", f"-input_data%file={DATA / table}",
            *WRITERS, *extra]
    juser, tuser = [], []
    if case == "dielectric":
        juser = [f"-user%module={DATA.parent.parent}/programs/dielectric_2d"
                 "/user.py"]
        tuser = [f"-user%module={PROGRAMS / 'dielectric_2d.py'}"]
    j, t, rec = build_pair(tmp_path, monkeypatch, argv, juser, tuser)
    if j.coupling is not None and j.coupling.i_vib >= j.cc.shape[0]:
        # the row the JAX package does not allocate (ROADMAP queue C)
        j.cc = np.concatenate([j.cc, np.zeros((1,) + j.cc.shape[1:])])
    j.run(max_steps=steps)
    t.run(max_steps=steps)
    assert_runs_agree(j, t, rec, steps, changing_epoch=False)
    n_grids = assert_files_agree(tmp_path,
                                 summary=t.gas.constant_density)
    assert j.out_cnt >= 3
    if case == "cyl-amr-selection":
        assert n_grids == j.out_cnt // 2 + 1
        grid = np.load(tmp_path / "t_grid_000002.npz")
        assert list(grid["var_names"]) == ["e"]
        assert grid["box_lvl"].max() == 3 < t.tree.highest_lvl
    else:
        assert n_grids == j.out_cnt + 1
    if case == "gas":
        ngas = t.chem.n_gas_species
        assert t.chem.species_list[:ngas] == ["N2", "O2", "M"]
        amounts = np.loadtxt(tmp_path / "t_amounts.txt")
        assert (amounts[:, 1:1 + ngas] == 0).all()
    if case == "dielectric":
        # the surface charge is part of the net charge in the log
        sigma = t.surfaces.get_integral(t.cc)
        assert sigma != 0.0
        names = (tmp_path / "t_log.txt").read_text().split("\n")[0].split()
        row = np.loadtxt(tmp_path / "t_log.txt", skiprows=1)[-1]
        ngas = t.chem.n_gas_species
        q = sum(t.chem.species_charge[n] * red.tree_sum_cc(
            t.cc, t.mesh, t.species_cc[n - ngas])
            for n in range(ngas, len(t.chem.species_list))
            if t.chem.species_charge[n] != 0)
        assert row[names.index("sum(charge)")] == pytest.approx(
            q + sigma, rel=1e-7)  # the log's 8 digits


def test_stock_configuration_runs(tmp_path):
    """air_cyl_slice.cfg without the two lines that turned the default
    writers off: the port builds, runs and writes the log, the grid files
    and all six chemistry files, and they are the JAX package's."""
    text = (DATA / "air_cyl_slice.cfg").read_text()
    stock = "\n".join(ln for ln in text.splitlines()
                      if ln.split("=")[0].strip() not in ("output%log",
                                                          "silo_write"))
    assert "silo_write" not in stock and "output%log" not in stock
    cfg = tmp_path / "stock.cfg"
    cfg.write_text(stock)
    argv = [str(cfg), "-ndim=2", "-refine_max_dx=5e-4", "-output%dt=3e-14",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}"]
    sim = TSim(argv=argv + ["-device=cpu", f"-output%name={tmp_path / 't'}"])
    sim.run(max_steps=4)
    assert sim.output.write_log and sim.output.silo_write
    for name in LISTINGS + ("summary", "rates", "amounts", "log"):
        assert (tmp_path / f"t_{name}.txt").stat().st_size > 0, name
    assert len(np.loadtxt(tmp_path / "t_log.txt", skiprows=1)) == \
        sim.out_cnt >= 3
    JSim(argv=argv + [f"-output%name={tmp_path / 'j'}"]).run(max_steps=4)
    assert assert_files_agree(tmp_path) == sim.out_cnt + 1


@pytest.mark.parametrize("key", ["output%npz", "output%vtk", "cross%write",
                                 "dielectric%write"])
def test_opt_in_writers_still_raise(tmp_path, key):
    """The opt-in writers the port refused until it held them (the name is
    kept from then): each now runs in the port as in the JAX package, and
    the files of two steps with an output at each are the JAX package's
    (tests/test_torch_writers.py holds them all on more configurations)."""
    argv = [str(DATA / "air_cyl_slice.cfg"), "-ndim=2", "-refine_max_dx=5e-4",
            f"-{key}=t", "-output%dt=1e-14", "-silo_write=t",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}"]
    t = TSim(argv=argv + ["-device=cpu", f"-output%name={tmp_path / 't'}"])
    t.run(max_steps=2)
    JSim(argv=argv + [f"-output%name={tmp_path / 'j'}"]).run(max_steps=2)
    assert t.out_cnt == 2
    worst = compare_outputs(tmp_path / "j", tmp_path / "t", RTOL)
    mark = {"output%npz": "000002.npz", "output%vtk": "000002.vtk",
            "cross%write": "cross_000002.txt",
            "dielectric%write": "grid_000002.npz"}[key]
    assert mark in worst


def test_resumed_port_run_writes_the_jax_log(tmp_path):
    """3 steps of the JAX package, its state and output state carried into
    the port, then 3 more steps in each: the port's log lines are those of
    the JAX run (its velocity from the position of max(E) at the JAX run's
    last log line)."""
    argv = [str(DATA / "air_cyl_amr_slice.cfg"), "-ndim=2",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            *WRITERS, *SMALL]
    j = JSim(argv=argv + [f"-output%name={tmp_path / 'j'}"])
    j.run(max_steps=3)
    t = TSim(argv=argv + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    interop.state_from_numpy(t, j.cc, j.fc, interop.tree_arrays(j.tree),
                             it=j.it, global_time=j.global_time,
                             global_dt=j.global_dt,
                             output=interop.output_state(j))
    assert t.out_cnt == j.out_cnt >= 2 and t.prev_emax_pos is not None
    back = interop.state_to_numpy(t)["output"]
    np.testing.assert_array_equal(back["global_rates"], j.global_rates)
    np.testing.assert_array_equal(back["prev_emax_pos"], j.prev_emax_pos)
    jlog = tmp_path / "j_log.txt"
    (tmp_path / "t_log.txt").write_text(jlog.read_text())
    j.run(max_steps=6)
    t.run(max_steps=6)
    assert j.out_cnt >= 4
    assert_logs_agree(jlog, tmp_path / "t_log.txt")
    assert t.velocity == pytest.approx(j.velocity, rel=1e-8)
