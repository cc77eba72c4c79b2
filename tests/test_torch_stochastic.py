"""The stochastic background density (init_cond.stochastic_density,
``m_init_cond.f90:146-198``) of the port against the JAX package's, both
on the CPU in float64 from the same committed configuration and rng seed:
the cylindrical slice with live refinement and photoionization
(air_cyl_amr_slice.cfg, 16,960 cells on 6 levels) and the planar 1D slice
(air_1d_slice.cfg), each with ``-stochastic_density=1e15``.

Right after the call, the electron, first positive ion and rhs rows of
every box in use (leaves and parents, ghost cells included) agree at rtol
1e-12; then 4 steps of both agree as tests/torch_pairs.assert_runs_agree
holds them (mesh, dts, cycle counts, every variable at rtol 1e-8). With
the density 0 the call leaves the state as it was. The sharded case is
tests/test_torch_sharded.py (h)."""

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.physics.init_cond import \
    stochastic_density as jax_stochastic_density
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.physics.init_cond import stochastic_density
from torch_pairs import DATA, assert_runs_agree, build_pair

torch.set_num_threads(1)

SEED = 3
DENSITY = 1e15
STEPS = 4
#: case -> (configuration, ndim, whether an epoch of the run changes the
#: mesh)
CASES = {"cyl": ("air_cyl_amr_slice", 2, True),
         "1d": ("air_1d_slice", 1, False)}


def argv(cfg, ndim, density=DENSITY):
    return [str(DATA / f"{cfg}.cfg"), f"-ndim={ndim}",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            f"-stochastic_density={density}"]


@pytest.mark.parametrize("case", list(CASES))
def test_stochastic_density_matches_jax(tmp_path, monkeypatch, case):
    cfg, ndim, changing = CASES[case]
    j, t, rec = build_pair(tmp_path, monkeypatch, argv(cfg, ndim))
    before = t.cc.clone()
    jax_stochastic_density(j, SEED)
    stochastic_density(t, SEED)
    n = j.tree.highest_id
    use = j.tree.in_use[:n]
    tcc = t.cc.numpy()
    for iv in (j.i_electron, j.i_1pos_ion, j.i_rhs):
        np.testing.assert_allclose(tcc[iv, :n][use], j.cc[iv, :n][use],
                                   rtol=1e-12, atol=0.0,
                                   err_msg=j.registry.cc_names[iv])
    # noise below DENSITY, added to both species on every leaf
    assert 0.9 * DENSITY < tcc[t.i_rhs, :n][use].max() < DENSITY
    for lvl in range(1, t.tree.highest_lvl + 1):
        leaves = np.asarray(t.tree.lvl_leaves[lvl - 1], np.int64)
        if len(leaves):
            added = t.cc[t.i_electron, leaves] - before[t.i_electron, leaves]
            assert float(added.max()) > 0.0, lvl
    j.run(max_steps=STEPS)
    t.run(max_steps=STEPS)
    assert_runs_agree(j, t, rec, STEPS, changing_epoch=changing)


def test_zero_density_leaves_the_state(tmp_path):
    t = TSim(argv=argv("air_1d_slice", 1, 0.0)
             + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    before = t.cc.clone()
    stochastic_density(t, SEED)
    assert torch.equal(t.cc, before)
