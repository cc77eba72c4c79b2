"""The opt-in writers of the port (afivo_streamer_tpu_torch/io/output.py,
io/vtk.py, io/checkpoint.py and the power density of the driver) against
the JAX package's, on the CPU in float64.

Each configuration runs in both packages with writers turned on; the runs
agree (mesh, dt, cycle counts, every variable, the power density among
them, at rtol 1e-8) and every file the JAX run wrote is held against the
port's by io/compare.py at rtol 1e-8: the uniform-grid npz with the extra
variables (eV, sigma, Je_i, src_e), the VTK grid, the checkpoints, the
line, the plane, the cross sections, the field maxima (above the
background field, where maxima are not set by rounding) and the surfaces'
data in the grid files (``dielectric%write``)."""

import re

import numpy as np
import pytest
import torch

from afivo_streamer_tpu_torch.io.compare import compare_outputs
from afivo_streamer_tpu_torch.io.output import interp
from torch_pairs import DATA, RTOL, assert_runs_agree, build_pair

torch.set_num_threads(1)

NEW_TABLE = ["-input_data%old_style=f",
             f"-input_data%file={DATA / 'td_air_synthetic_new.txt'}"]
ALL = ["-output%npz=t", "-output%vtk=t", "-lineout%write=t",
       "-lineout%npoints=60", "-plane%write=t", "-plane%npixels=24 20",
       "-datfile%write=t", "-compute_power_density=t"]
CASES = {
    # config, ndim, flags, steps, the kinds of file every output writes
    "cyl": ("air_cyl_amr_slice.cfg", 2,
            ALL + ["-photoi%per_steps=2", "-output%dt=1e-13",
                   "-cross%write=t", "-cross%npoints=30",
                   "-field_maxima%write=t", "-field_maxima%threshold=1.9e6",
                   "-output%conductivity=t", "-output%electron_current=t",
                   "-output%write_source=e", "-silo_write=t"], 4,
            ("N.npz", "N.vtk", "N.dat.npz", "line_N.txt", "plane_N.vtk",
             "cross_N.txt", "Emax_N.txt", "grid_N.npz")),
    "electron-energy": ("air_cyl_slice.cfg", 2,
                        NEW_TABLE + ["-output%dt=2e-14", "-output%npz=t",
                                     "-output%electron_energy=t"], 4,
                        ("N.npz",)),
    "dielectric-surfaces": ("dielectric_cyl_slice.cfg", 2,
                            ["-output%dt=1e-13", "-silo_write=t",
                             "-dielectric%write=t", "-output%vtk=t",
                             "-field_maxima%write=t",
                             "-field_maxima%threshold=1.9e6"], 4,
                            ("grid_N.npz", "N.vtk", "Emax_N.txt")),
    "3d": ("air_3d_slice.cfg", 3,
           ALL + ["-refine_max_dx=5e-4", "-output%dt=1e-14",
                  "-plane%rmin=0 0 0.45", "-plane%rmax=1 1 0.45",
                  "-output%electron_current=t"], 2,
           ("N.npz", "N.vtk", "N.dat.npz", "line_N.txt", "plane_N.vtk")),
    "1d": ("air_1d_slice.cfg", 1,
           ["-output%dt=1e-12", "-output%npz=t", "-output%vtk=t",
            "-lineout%write=t", "-field_maxima%write=t",
            "-field_maxima%threshold=1.85e6", "-compute_power_density=t",
            "-output%electron_current=t", "-output%conductivity=t"], 8,
           ("N.npz", "N.vtk", "line_N.txt", "Emax_N.txt")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_writers_match_jax(tmp_path, monkeypatch, case):
    cfg, ndim, extra, steps, kinds = CASES[case]
    juser = (["-user%module=programs/dielectric_2d/user.py"]
             if "dielectric" in cfg else ())
    j, t, rec = build_pair(tmp_path, monkeypatch,
                           [str(DATA / cfg), f"-ndim={ndim}"] + extra,
                           juser=juser)
    j.run(max_steps=steps)
    t.run(max_steps=steps)
    assert_runs_agree(j, t, rec, steps, changing_epoch=False)
    worst = compare_outputs(tmp_path / "j", tmp_path / "t", RTOL)
    written = {}
    for name in worst:
        kind = re.sub(r"\d{6}", "N", name)
        written[kind] = written.get(kind, 0) + 1
    for kind in kinds:
        assert written.get(kind, 0) >= 2, (kind, sorted(written))
    if "power_density" in t.registry.cc_names:
        iv = t.registry.cc_names.index("power_density")
        assert float(t.cc[iv].abs().max()) > 0.0
    if case == "dielectric-surfaces":
        # [surface, photon flux and sigma states, face cells] and each
        # surface's (gas-side box, dielectric-side box, direction)
        grid = np.load(sorted(tmp_path.glob("t_grid_*.npz"))[-1])
        sd, info = grid["surface_sd"], grid["surface_info"]
        assert sd.shape == (len(info), 1 + t.surfaces.n_sigma,
                            t.surfaces.face_cells) and len(info) > 0
        assert np.all(t.tree.neighbors[info[:, 0], info[:, 2]] == info[:, 1])
        assert np.abs(sd[:, 1]).max() > 0.0


def test_interp_is_numpy_interp():
    rng = np.random.default_rng(2)
    xp = np.sort(rng.uniform(0.0, 10.0, 40))
    fp = rng.normal(size=40)
    x = np.concatenate([rng.uniform(-2.0, 12.0, 500), xp, [xp[0], xp[-1]]])
    got = interp(torch.as_tensor(x), xp, fp).numpy()
    np.testing.assert_allclose(got, np.interp(x, xp, fp), rtol=1e-14,
                               atol=1e-14)
