"""The port stands alone: importing any module of afivo_streamer_tpu_torch
loads no JAX and nothing of afivo_streamer_tpu; -device=cuda without a
card raises; configurations that ask for unported modules (the compiled
engine's float32 state, a per-cell coarse grid above 32,768 unknowns) raise
NotImplementedError naming the module, those the port once refused
(Monte-Carlo photoionization, the VTK and npz writers, a restart, the
lineout) run, and those for the modules that are
ported (one dimension, the electron energy equation, new-style tables, the
source factor, the plasma region, electrodes, dielectrics, gas dynamics,
a user gas density, the other user hooks and the compiled engine's
ordinary path) build a simulation. The same holds for
chip_smoke.py and the scripts beside the data files."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from afivo_streamer_tpu_torch.driver import Simulation
from afivo_streamer_tpu_torch.solvers.coarse import UniformCoarseMG

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"

CHECK = """
import pkgutil, importlib, sys
import afivo_streamer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# the scripts beside the data files and the card's smoke test are no
# modules of the package: load them by path (their main() does not run)
import importlib.util, pathlib
scripts = sorted(pathlib.Path(pkg.__path__[0], "data").glob("*.py"))
scripts.append(pathlib.Path(pkg.__path__[0]).parent / "chip_smoke.py")
for path in scripts:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
names += [p.name for p in scripts]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "afivo_streamer_tpu"))
print(len(names), bad)
"""


def argv(tmp_path, *extra):
    return [str(DATA / "air_cyl_slice.cfg"), "-ndim=2",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            f"-output%name={tmp_path}/run", *extra]


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout.split(maxsplit=1)
    assert int(out[0]) > 20  # every module of the package was imported
    assert out[1].strip() == "[]"


def test_port_sources_name_no_jax_import():
    """No import statement anywhere in the package's sources, its data
    scripts or chip_smoke.py (imports inside functions included) names
    jax or the JAX package."""
    sources = sorted((ROOT / "afivo_streamer_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 40
    assert DATA / "make_td_table.py" in sources
    bad = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [(path.name, m) for m in mods if m.split(".")[0] in (
                "jax", "jaxlib", "afivo_streamer_tpu")]
    assert not bad


def test_committed_data_files_are_present():
    """The configurations and tables the tests, README and chip_smoke.py
    name; every configuration names a committed table."""
    for name in ("air_1d_slice.cfg", "air_cyl_ee_slice.cfg",
                 "gas_heating_cyl_slice.cfg", "gas_channel_cyl_slice.cfg",
                 "td_air_synthetic_new.txt", "td_air_synthetic.txt",
                 "td_air_synthetic_reactions.txt",
                 "velocity_control_2d.cfg", "stability_3d.cfg",
                 "comparison_air_2d.cfg", "gas_gradient_2d.cfg",
                 "2d_sprite.cfg", "3d_sprite.cfg",
                 "applied_voltage_upper.txt", "applied_voltage_lower.txt"):
        assert (DATA / name).is_file(), name
    for cfg in DATA.glob("*.cfg"):
        table = [line.split("=")[1].strip() for line in
                 cfg.read_text().splitlines()
                 if line.strip().startswith("input_data%file")]
        assert len(table) == 1 and (ROOT / table[0]).is_file(), cfg.name


def test_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulation(argv=argv(tmp_path, "-device=cuda"))


@pytest.mark.parametrize("extra, module", [
    (["-compiled%enabled=t", "-compiled%dtype=float32", "-gas%dynamics=t"],
     "physics/gas_dynamics.py under compiled%dtype=float32"),
    (["-use_dielectric=t", "-coarse_grid_size=256 256",
      "-dielectric_type=bottom", "-cylindrical=f", "-user%module="
      f"{DATA.parent / 'programs' / 'dielectric_2d.py'}"], "per-cell"),
])
def test_unported_configuration_raises(tmp_path, extra, module):
    """Modules the port does not hold raise NotImplementedError naming the
    JAX module; as in the JAX package, a level-1 grid above 32,768
    unknowns with a per-cell operator (eps, a level set) raises at the
    first field solve."""
    with pytest.raises(NotImplementedError, match=module):
        Simulation(argv=argv(tmp_path, "-device=cpu", *extra))


@pytest.mark.parametrize("extra, written", [
    (["-photoi%enabled=t", "-photoi%species=M_plus",
      "-photoi%method=montecarlo", "-photoi%per_steps=1",
      "-photoi_mc%physical_photons=f", "-photoi_mc%num_photons=2000"], ""),
    (["-output%vtk=t"], "_000001.vtk"),
    (["-output%npz=t"], "_000001.npz"),
    (["-restart_from_file=RESTART"], ""),
    (["-lineout%write=t"], "_line_000001.txt"),
], ids=["montecarlo", "vtk", "npz", "restart", "lineout"])
def test_formerly_refused_configuration_runs(tmp_path, extra, written):
    """The configurations the port refused before it held Monte-Carlo
    photoionization, the opt-in writers and checkpoints build and run one
    step on the CPU (with an output at that step). The restart reads the
    checkpoint of a run's setup; a missing checkpoint raises what the JAX
    package raises."""
    if extra == ["-restart_from_file=RESTART"]:
        from afivo_streamer_tpu.driver import Simulation as JaxSimulation
        missing = f"-restart_from_file={tmp_path / 'none.dat.npz'}"
        with pytest.raises(FileNotFoundError):
            JaxSimulation(argv=argv(tmp_path / "j", missing))
        with pytest.raises(FileNotFoundError):
            Simulation(argv=argv(tmp_path / "t", "-device=cpu", missing))
        Simulation(argv=argv(tmp_path / "w", "-device=cpu",
                             "-datfile%write=t"))
        extra = [f"-restart_from_file={tmp_path / 'w' / 'run_000000.dat.npz'}"]
    sim = Simulation(argv=argv(tmp_path, "-device=cpu", "-output%dt=1e-14",
                               *extra))
    sim.run(max_steps=1)
    assert sim.it == 2 and sim.global_time > 0.0
    if written:
        assert (tmp_path / f"run{written}").is_file()
    if sim.photoi.enabled:
        assert sim.photoi.mc.n_photons > 0
        assert float(sim.cc[sim.photoi.i_photo].abs().max()) > 0.0


@pytest.mark.parametrize("integrator", ["imex_euler", "imex_trapezoidal"])
def test_implicit_integrator_needs_a_solver(tmp_path, integrator):
    """The streamer model has no implicit part: the driver raises the JAX
    package's ValueError (physics/advance.py) for an IMEX integrator, which
    needs an implicit solver (programs/reaction_diffusion.py passes one)."""
    with pytest.raises(ValueError, match="requires an implicit_solver"):
        Simulation(argv=argv(tmp_path, "-device=cpu",
                             f"-time_integrator={integrator}"))


NEW_TABLE = ["-input_data%old_style=f",
             f"-input_data%file={DATA / 'td_air_synthetic_new.txt'}"]
#: the new-style table with a reaction list over N2, O2 and M, which a
#: varying gas density needs
REACTIONS = ["-input_data%old_style=f", "-photoi%species=O2_plus",
             f"-input_data%file={DATA / 'td_air_synthetic_reactions.txt'}"]
GAS_DENSITY = ["-user%module="
               f"{DATA.parent / 'programs' / 'gas_density_2d.py'}",
               "-density_profile_r=gaussian"]


def test_gas_dynamics_with_old_style_table_raises(tmp_path):
    """Both packages refuse a varying gas density with an old-style table
    (transport_data.py:54 in each)."""
    from afivo_streamer_tpu.driver import Simulation as JaxSimulation
    extra = ["-gas%dynamics=t", "-input_data%old_style=t"]
    with pytest.raises(ValueError, match="varying gas density"):
        JaxSimulation(argv=argv(tmp_path, *extra))
    with pytest.raises(ValueError, match="varying gas density"):
        Simulation(argv=argv(tmp_path, "-device=cpu", *extra))


#: an electrode on the axis of the cylindrical slice (two for the types
#: that take two), the user's own through the committed user module
ELECTRODE = ["-use_electrode=t", "-seed_density=0",
             "-field_rod_r0=0.0 1.0", "-field_rod_r1=0.0 0.85",
             "-field_rod_radius=8e-4", "-field_rod2_r0=0.0 0.0",
             "-field_rod2_r1=0.0 0.15", "-field_rod2_radius=8e-4",
             "-field_electrode2_grounded=t", "-cone_tip_radius=4e-4",
             "-cone_length_frac=0.3", "-cone2_tip_radius=4e-4",
             "-cone2_length_frac=0.3", "-user%module="
             f"{DATA.parent / 'programs' / 'electrode_user.py'}"]
#: the dielectric slab of programs/dielectric_2d.py
DIELECTRIC = ["-use_dielectric=t", "-dielectric_type=bottom", "-user%module="
              f"{DATA.parent / 'programs' / 'dielectric_2d.py'}"]
ELECTRODE_TYPES = ("sphere", "rod", "rod_rod", "rod_cone_top",
                   "two_rod_cone_electrodes", "user")
#: user modules with one hook each, written by the test where a flag names
#: them
HOOK_MODULES = {
    "GENERIC_HOOK": "sim.user.generic = lambda sim, time: None",
    # the homogeneous boundary: Dirichlet in z (the voltage on top),
    # Neumann in r
    "POTENTIAL_BC_HOOK": "sim.user.potential_bc = lambda iv, d, coords, p: "
                         "(1, p.get('voltage', 0.0) * (d == 3)) if d // 2 "
                         "else (2, 0.0)",
}


@pytest.mark.parametrize("cfg, extra", [
    ("air_1d_slice.cfg", ["-ndim=1"]),
    ("air_1d_slice.cfg", ["-ndim=1", "-model%type=ee53"] + NEW_TABLE),
    ("air_cyl_slice.cfg", ["-model%type=ee"] + NEW_TABLE),
    ("air_cyl_slice.cfg", NEW_TABLE),
    ("air_cyl_slice.cfg", ["-fixes%source_factor=flux"]),
    ("air_cyl_slice.cfg", ["-plasma_region_enabled=t",
                           "-plasma_region_rmax=0.008 0.016"]),
    ("air_cyl_slice.cfg", ["-refine_electrode_dx=1e-4"]),
    ("air_1d_slice.cfg", ["-ndim=1"] + DIELECTRIC + ["-dielectric_type=left"]),
    ("air_3d_slice.cfg", ["-ndim=3"] + DIELECTRIC),
    ("air_cyl_slice.cfg", ["-cylindrical=f", "-coarse_grid_size=256 256"]),
    ("air_cyl_slice.cfg", ["-gas%dynamics=t"] + REACTIONS),
    ("air_cyl_slice.cfg", ["-gas%dynamics=t", "-gas%fraction_slow_heating=0.3",
                           "-cylindrical=f"] + REACTIONS),
    ("air_cyl_slice.cfg", GAS_DENSITY + REACTIONS),
    ("air_cyl_slice.cfg", ["-user%module=GENERIC_HOOK"]),
    ("air_cyl_slice.cfg", ["-user%module=POTENTIAL_BC_HOOK"]),
    ("air_cyl_slice.cfg", ["-compiled%enabled=t"]),
    ("air_cyl_slice.cfg", ["-compiled%enabled=t", "-compiled%dtype=float32"]),
] + [("air_cyl_slice.cfg", ELECTRODE + [f"-field_electrode_type={kind}"])
     for kind in ELECTRODE_TYPES],
    ids=["1d", "1d-ee53", "cyl-ee-alias", "new-style-table", "source-factor",
         "plasma-region", "electrode-dx-without-electrode", "dielectric-1d",
         "dielectric-3d", "coarse-grid-65536", "gas-dynamics",
         "gas-dynamics-slow-heating", "gas-density-user", "generic-hook",
         "potential-bc-hook", "compiled-enabled", "compiled-float32"]
    + [f"electrode-{kind}" for kind in ELECTRODE_TYPES])
def test_ported_configuration_builds(tmp_path, cfg, extra):
    for key, hook in HOOK_MODULES.items():
        if f"-user%module={key}" in extra:
            path = tmp_path / "hooks.py"
            path.write_text(f"def user_initialize(cfg, sim):\n    {hook}\n")
            extra = [f"-user%module={path}"]
    sim = Simulation(argv=[str(DATA / cfg), "-ndim=2",
                           f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
                           f"-output%name={tmp_path}/run", "-device=cpu",
                           "-refine_max_dx=5e-4", *extra])
    # the setup runs in float64; run() switches to compiled%dtype
    assert sim.cc.dtype == sim.fc.dtype == torch.float64
    assert sim.compiled.state_dtype == (
        torch.float32 if "-compiled%dtype=float32" in extra
        else torch.float64)
    assert sim.model.has_energy_equation == any("model%type" in a
                                                for a in extra)
    assert (sim.fluid.mask_provider is not None) == (
        sim.st.plasma_region_enabled or sim.st.use_electrode
        or sim.st.use_dielectric)
    if sim.st.use_dielectric:
        # the permittivity and the surface state in the JAX order, surfaces
        # on the slab's face in every dimension
        names = sim.registry.cc_names
        assert names[sim.i_eps:sim.i_eps + 3] == ["eps", "surf_photon",
                                                  "surf_sigma"]
        assert sim.surfaces.face_cells == sim.tree.nc ** (sim.ndim - 1)
        assert len(sim.surfaces.active()) > 0
    if sim.tree.coarse_grid_size[0] == 256:
        assert isinstance(sim.field.mg.coarse_solver(), UniformCoarseMG)
    if sim.st.use_electrode:
        # the level set is a variable of the state, behind the source
        # factor's and before the permittivity, as in the JAX package
        assert sim.registry.cc_names[sim.i_lsf] == "lsf"
        data = sim.field.lsf_data.level_data(sim.tree.highest_lvl)
        assert data["has_bnd"].any()
        assert sim.refiner.lsf_data is sim.field.lsf_data
    if not sim.gas.constant_density:
        # the gas species lead the chemistry and are not stored; M holds
        # the gas density on every cell of the initial mesh
        ngas = sim.chem.n_gas_species
        assert sim.chem.species_list[:ngas] == ["N2", "O2", "M"]
        names = sim.registry.cc_names
        assert "N2" not in names and names.count("M") == 1
        M = sim.cc[names.index("M"), :sim.tree.highest_id]
        assert float(M.min()) > 0.0
        if sim.gas.dynamics:
            assert names[sim.gasdyn.gas_vars[0]] == "gas_rho"
            assert (names[-1] == "vibrational_energy") == (
                sim.gas.fraction_slow_heating > 0)
        else:
            # the Gaussian profile halves the density on the axis
            assert float(M.min()) < 0.55 * sim.gas.number_density
    if sim.user.generic is not None:
        sim.run(max_steps=1)
        assert sim.it == 2
    if sim.user.potential_bc is not None:
        # the field solver takes the user's sides, which equal the
        # default ones here
        assert sim.field.user_potential_bc is sim.user.potential_bc
        sim.run(max_steps=1)
        assert sim.field.current_voltage > 0


def test_ndim_3_raises(tmp_path):
    """3D runs in Cartesian coordinates only, as in the JAX package."""
    with pytest.raises(ValueError, match="only in 2D"):
        Simulation(argv=[str(DATA / "air_3d_slice.cfg"), "-ndim=3",
                         "-device=cpu", "-cylindrical=t",
                         f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
                         f"-output%name={tmp_path}/run"])
