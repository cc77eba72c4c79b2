"""The port's physics inputs against the JAX package's host (NumPy) path:
lookup tables (torch index + lerp), the old-style transport table, and the
chemistry engine (parser, rates and derivatives) for the standard e/M+/M-
model of the committed synthetic table and for a hand-written reaction
list with tabulated and analytic rates. float64, rtol 1e-13 (the lookups
and rate forms are the same arithmetic; only exp/pow may differ in the
last bit between NumPy and PyTorch).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.physics.chemistry import Chemistry as JChem
from afivo_streamer_tpu.physics.gas import Gas as JGas
from afivo_streamer_tpu.physics.transport_data import TransportData as JTD
from afivo_streamer_tpu.utils.config import CFG as JCFG
from afivo_streamer_tpu.utils.lookup_table import LookupTable as JLT
from afivo_streamer_tpu.utils.table_data import TableDataSettings as JTS

from afivo_streamer_tpu_torch.physics.chemistry import Chemistry as TChem
from afivo_streamer_tpu_torch.physics.gas import Gas as TGas
from afivo_streamer_tpu_torch.physics.transport_data import TransportData as TTD
from afivo_streamer_tpu_torch.utils.config import CFG as TCFG
from afivo_streamer_tpu_torch.utils.lookup_table import LookupTable as TLT
from afivo_streamer_tpu_torch.utils.table_data import TableDataSettings as TTS

torch.set_num_threads(1)

TABLE = (Path(__file__).resolve().parent.parent / "afivo_streamer_tpu_torch"
         / "data" / "td_air_synthetic.txt")
RTOL = 1e-13

REACTIONS = """
reaction_list
-----------------------
e + M -> e + e + M+,field_table,efield_table_alpha
e + O2 + O2 -> O2- + O2,c1,2.0e-41
@x = A, B
e + @x+ -> @x,c1*(Td-c2),1.0e-20 40.0
M- + M+ -> M,c1*exp(-(c2/(c3+Td))**2),1.0e-13 50.0 10.0
O2- + M -> e + M,c1*(300/Tg)**c2,1.0e-18 0.5
M+ + M -> M+,c1*exp(-(Td/c2)**c3),2.0e-16 300.0 1.5,cm
-----------------------

efield_table_alpha
COMMENT: rate coefficient (m3/s) versus E/N (Td), made up
-----------------------
0.0 0.0
100.0 1.0e-18
500.0 4.0e-16
1500.0 2.0e-15
-----------------------
"""


def setups(td_file):
    out = []
    for CFG, TS, Gas, TD, Chem in ((JCFG, JTS, JGas, JTD, JChem),
                                   (TCFG, TTS, TGas, TTD, TChem)):
        cfg = CFG()
        cfg.update_from_arguments([f"-input_data%file={td_file}",
                                   "-input_data%old_style=t"])
        ts = TS(cfg)
        gas = Gas(cfg)
        td = TD(cfg, gas, ts)
        out.append((td, Chem(gas, td, td.file, ts, cfg=cfg)))
    return out


@pytest.mark.parametrize("xspacing", [1, 2, 3])
@pytest.mark.parametrize("extrapolate", [False, True])
def test_lookup_table_matches(xspacing, extrapolate):
    rng = np.random.default_rng(xspacing)
    args = (-5.0, 120.0, 257, 3, xspacing, extrapolate)
    j, t = JLT(*args), TLT(*args)
    xd = np.sort(rng.uniform(-10.0, 130.0, 40))
    for c in range(3):
        y = rng.standard_normal(40)
        j.set_col(c, xd, y)
        t.set_col(c, xd, y)
    x = rng.uniform(-20.0, 140.0, (7, 11))  # includes both clamped ends
    want = j.get_cols((2, 0), x)
    got = t.get_cols((2, 0), torch.as_tensor(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-15)


def test_transport_table_matches():
    (jtd, _), (ttd, _) = setups(TABLE)
    np.testing.assert_array_equal(ttd.tbl.x, jtd.tbl.x)
    np.testing.assert_array_equal(ttd.tbl.rows_cols, jtd.tbl.rows_cols)


@pytest.mark.parametrize("reactions", [False, True],
                         ids=["standard-model", "reaction-list"])
def test_chemistry_rates_and_derivatives_match(reactions, tmp_path):
    td_file = TABLE
    if reactions:
        td_file = tmp_path / "td_with_reactions.txt"
        td_file.write_text(TABLE.read_text() + REACTIONS)
    (_, jc), (_, tc) = setups(td_file)
    assert tc.species_list == jc.species_list
    assert tc.species_charge == jc.species_charge
    assert [r.description for r in tc.reactions] == \
        [r.description for r in jc.reactions]
    np.testing.assert_array_equal(tc.stoich, jc.stoich)
    rng = np.random.default_rng(11)
    fields = rng.uniform(0.0, 1300.0, 500)
    want = jc.get_rates(fields)
    got = tc.get_rates(torch.as_tensor(fields)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    dens = rng.uniform(0.0, 1e18, (500, len(jc.species_list)))
    full_w, der_w = jc.get_derivatives(dens, want)
    full_g, der_g = tc.get_derivatives(torch.as_tensor(dens),
                                       torch.as_tensor(want))
    np.testing.assert_allclose(full_g.numpy(), full_w, rtol=RTOL, atol=0.0)
    np.testing.assert_allclose(der_g.numpy(), der_w, rtol=1e-12,
                               atol=1e-12 * np.abs(der_w).max())
    assert tc.get_breakdown_field_td(1e3) == jc.get_breakdown_field_td(1e3)
