"""The port's configuration keys and command line against the JAX
package's, on the CPU:

(a) on five committed configurations the port registers the keys the
    JAX package registers, and one more, ``device``;
(b) a malformed ``dielectric%preset_charge`` raises ValueError in both
    packages (the key is read and, as in the reference, never applied);
(c) ``python -m afivo_streamer_tpu_torch`` prints the JAX package's cost
    breakdown after its steps: the same header and row of keys, and
    percentages that add up to 100 within their rounding."""

import re

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.__main__ import main as jmain
from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu_torch.__main__ import main as tmain
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from torch_pairs import DATA, JAX_PROGRAMS

torch.set_num_threads(1)

#: configuration -> ndim
CONFIGS = {"air_cyl_amr_slice": 2, "electrode_cyl_slice": 2,
           "gas_heating_cyl_slice": 2, "air_1d_slice": 1,
           "dielectric_2d_slice": 2}
#: the JAX package's module for the dielectric slice (its config names the
#: port's)
JAX_DIELECTRIC = f"-user%module={JAX_PROGRAMS / 'dielectric_2d' / 'user.py'}"


def sims(tmp_path, cfg, ndim, extra=()):
    """The JAX and the port's Simulation of a committed configuration."""
    argv = [str(DATA / f"{cfg}.cfg"), f"-ndim={ndim}", *extra]
    juser = [JAX_DIELECTRIC] if cfg.startswith("dielectric") else []
    return (JSim(argv=argv + juser + [f"-output%name={tmp_path / 'j'}"]),
            TSim(argv=argv + [f"-output%name={tmp_path / 't'}",
                              "-device=cpu"]))


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_configuration_keys_match_jax(tmp_path, cfg):
    """(a)."""
    j, t = sims(tmp_path, cfg, CONFIGS[cfg])
    assert set(t.cfg._order) == set(j.cfg._order) | {"device"}
    if cfg.startswith("dielectric"):
        assert t.cfg.get("dielectric%preset_charge") == [0.0]
        assert t.cfg.get("dielectric%preset_charge_distribution") == [0.0]


def test_malformed_preset_charge_raises_in_both(tmp_path):
    """(b)."""
    for side in (0, 1):
        with pytest.raises(ValueError, match="preset_charge"):
            sims(tmp_path, "dielectric_2d_slice", 2,
                 ["-dielectric%preset_charge=1 2"])[side]


def breakdown(out):
    """The three lines of the cost breakdown at the end of ``out``."""
    lines = out.splitlines()
    i = lines.index("Computational cost breakdown (%)")
    return lines[i:i + 3]


def test_cli_prints_the_cost_breakdown(tmp_path, capsys):
    """(c)."""
    args = [str(DATA / "air_cyl_slice.cfg"), "-ndim=2", "-end_time=3e-13"]
    jmain(args + [f"-output%name={tmp_path / 'j'}"])
    ref = breakdown(capsys.readouterr().out)
    tmain(args + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    out = capsys.readouterr().out
    got = breakdown(out)
    assert got[:2] == ref[:2]
    assert got[1].split() == ["flux", "source", "advance", "copy", "field",
                              "output", "refine", "photoi"]
    assert all(len(line) == 80 for line in got[1:])
    shares = np.array([float(x) for x in got[2].split()])
    assert abs(shares.sum() - 100.0) <= 0.005 * len(shares)
    assert shares[0] > 0 and shares[4] > 0  # flux and field
    # the port's line of steps and seconds comes first
    steps_line = out.splitlines()[out.splitlines().index(got[0]) - 1]
    assert re.fullmatch(r"[1-9]\d* steps in \d+\.\d{3} s on cpu", steps_line)
