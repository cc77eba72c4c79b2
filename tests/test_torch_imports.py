"""The port stands alone: importing any module of afivo_streamer_tpu_torch
loads no JAX and nothing of afivo_streamer_tpu; -device=cuda without a
card raises; configurations that ask for unported modules raise
NotImplementedError naming the module."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from afivo_streamer_tpu_torch.driver import Simulation

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"

CHECK = """
import pkgutil, importlib, sys
import afivo_streamer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
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


def test_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulation(argv=argv(tmp_path, "-device=cuda"))


@pytest.mark.parametrize("extra, module", [
    (["-refine_electrode_dx=1e-4"], "physics/refine.py"),
    (["-photoi%enabled=t", "-photoi%method=montecarlo"],
     "physics/photoi_mc.py"),
    (["-use_electrode=t"], "solvers/lsf.py"),
    (["-model%type=ee53"], "physics/model.py"),
    (["-output%npz=t"], "io/output.py"),
])
def test_unported_configuration_raises(tmp_path, extra, module):
    with pytest.raises(NotImplementedError, match=module):
        Simulation(argv=argv(tmp_path, "-device=cpu", *extra))


def test_ndim_3_raises(tmp_path):
    """3D runs in Cartesian coordinates only, as in the JAX package."""
    with pytest.raises(ValueError, match="only in 2D"):
        Simulation(argv=[str(DATA / "air_3d_slice.cfg"), "-ndim=3",
                         "-device=cpu", "-cylindrical=t",
                         f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
                         f"-output%name={tmp_path}/run"])
