"""Reaction-network chemistry engine.

Re-designs the reference's ``src/m_chemistry.f90`` for batched evaluation
on the device (the parser and the table building run on the host):

* the reaction-file grammar — ``reaction_list`` blocks of
  ``A + B -> C + 2 D, rate_spec, data [, length_unit]`` with ``@x=...``
  group substitutions, ignored species, gas-species elimination at constant
  density, and 20+ rate forms (field/energy tables + analytic k1..k15) —
  is parsed on the host (read_reactions ``:741-1022``, parse_reaction
  ``:1036-1158``, to_simple_ascii ``:1239-1279``);
* the network is lowered to dense index/stoichiometry arrays so that rate
  evaluation is a batched lookup-table gather and the species derivatives
  are one matmul ``derivs = rates @ S`` (get_rates ``:565-653``,
  get_derivatives ``:657-688``); under the electron energy equation the
  field-tabulated ionization and attachment rates become energy-tabulated
  ones and ``e_energy`` joins the species;
* the fallback "standard model" (e, M+, M- with ionization/attachment from
  the alpha/eta tables) when no reaction list is found
  (chemistry_initialize ``:202-240``);
* charge-conservation check (``:503-515``) and the breakdown-field
  estimator (``:518-560``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as uc
from ..utils.lookup_table import LookupTable
from ..utils.table_data import table_from_file, table_set_column
from .transport_data import (TD_ALPHA, TD_DIFFUSION, TD_ENERGY_EV, TD_ETA,
                             TD_MOBILITY)

# Rate types (m_chemistry.f90:57-118)
RATE_TABULATED_ENERGY = 0
RATE_TABULATED_FIELD = 1
RATE_ANALYTIC = {  # how_to_get string -> (type id, n_coeff)
    "c1": (2, 1),
    "c1*(Td-c2)": (3, 2),
    "c1*exp(-(c2/(c3+Td))**2)": (4, 3),
    "c1*exp(-(Td/c2)**2)": (5, 2),
    "c1*(300/Te)**c2": (6, 2),
    "(c1*(kB_eV*Te+c2)**2-c3)*c4": (8, 4),
    "c1*(Tg/300)**c2*exp(-c3/Tg)": (9, 3),
    "c1*exp(-c2/Tg)": (10, 2),
    "c1*Tg**c2": (11, 2),
    "c1*(Tg/c2)**c3": (12, 3),
    "c1*(300/Tg)**c2": (13, 2),
    "c1*exp(-c2*Tg)": (14, 2),
    "10**(c1+c2*(Tg-300))": (15, 2),
    "c1*(300/Tg)**c2*exp(-c3/Tg)": (16, 3),
    "c1*Tg**c2*exp(-c3/Tg)": (17, 3),
    "c1*exp(-(c2/(c3+Td))**c4)": (18, 4),
    "c1*exp(-(Td/c2)**c3)": (19, 3),
    "c1*exp(-(c2/(kb*(Tg+Td/c3)))**c4)": (20, 4),
}

# Reaction categories (m_chemistry.f90:10-26)
IONIZATION_REACTION = 1
ATTACHMENT_REACTION = 2
RECOMBINATION_REACTION = 3
DETACHMENT_REACTION = 4
GENERAL_REACTION = 5
REACTION_NAMES = {1: "ionization", 2: "attachment", 3: "recombination",
                  4: "detachment", 5: "general"}


def to_simple_ascii(text: str) -> Tuple[str, int]:
    """Convert a species name to plain ascii and derive its charge
    (to_simple_ascii, ``m_chemistry.f90:1239-1279``)."""
    charge = 0
    out = []
    in_brackets = False
    for ch in text:
        if ch == "(":
            in_brackets = True
            out.append("_")
        elif ch == ")":
            in_brackets = False
        elif ch == "*":
            out.append("_star")
        elif ch == "+":
            if not in_brackets:
                charge += 1
            out.append("_plus")
        elif ch == "-":
            if not in_brackets:
                charge -= 1
            out.append("_min")
        elif ch == "^":
            out.append("_hat")
        elif ch == "'":
            out.append("p")
        else:
            out.append(ch)
    simple = "".join(out)
    if simple == "e":
        charge = -1
    return simple, charge


@dataclass
class Reaction:
    ix_in: List[int]
    ix_out: List[int]
    multiplicity_out: List[int]
    n_species_in: int
    rate_type: int = RATE_TABULATED_FIELD
    reaction_type: int = GENERAL_REACTION
    rate_factor: float = 1.0
    rate_data: List[float] = field(default_factory=list)
    lookup_table_index: int = -1
    x_data: Optional[np.ndarray] = None
    y_data: Optional[np.ndarray] = None
    description: str = ""


def _read_ignored_species(filename: str) -> List[str]:
    """Read an optional ``ignored_species`` block (read_ignored_species)."""
    out: List[str] = []
    with open(filename) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines) and lines[i].strip() != "ignored_species":
        i += 1
    if i >= len(lines):
        return out
    i += 1
    if i >= len(lines) or not lines[i].strip().startswith("-----"):
        raise ValueError("ignored_species not followed by -----")
    i += 1
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line.startswith("-----"):
            return out
        if line and not line.startswith("#"):
            out.append(line.split()[0])
    raise ValueError("ignored_species: no closing dashes")


class Chemistry:
    """Species + reaction network with batched rate/derivative kernels."""

    def __init__(self, gas, transport, reaction_file: Optional[str],
                 table_settings, model_has_energy_equation: bool = False,
                 cfg=None):
        self.gas = gas
        self.td = transport
        self.has_energy_equation = model_has_energy_equation
        self.species_list: List[str] = []
        self.species_charge: List[int] = []
        self.reactions: List[Reaction] = []
        self.gas_temperature = gas.temperature

        if not gas.constant_density:
            # gas components are the first species (chemistry_initialize)
            for name in gas.components:
                self.species_list.append(name)
                self.species_charge.append(0)
        self.n_gas_species = len(self.species_list)

        success = False
        if reaction_file is not None:
            success = self._read_reactions(reaction_file)
        if not success:
            self._standard_model()
        if model_has_energy_equation:
            self.species_list.append("e_energy")
            self.species_charge.append(0)

        # convert species names to simple ascii + charges
        simple = []
        charges = []
        for name in self.species_list:
            s, q = to_simple_ascii(name)
            simple.append(s)
            charges.append(q)
        self.species_list = simple
        self.species_charge = charges

        if cfg is not None:
            self._modify_rates(cfg)
        self._classify_reactions()
        self._check_charge_conservation()
        self._build_tables(table_settings)
        self._build_arrays()

    # ----------------------------------------------------------- parsing
    def species_index(self, name: str) -> int:
        try:
            return self.species_list.index(name)
        except ValueError:
            return -1

    def _get_or_add_species(self, name: str) -> int:
        ix = self.species_index(name)
        if ix < 0:
            ix = len(self.species_list)
            self.species_list.append(name)
            self.species_charge.append(0)
        return ix

    def _parse_reaction(self, text: str, ignored: Sequence[str]):
        """Parse 'A + B -> C + 2 D' (parse_reaction,
        ``m_chemistry.f90:1036-1158``). Returns (Reaction | None)."""
        comps = text.split()
        left = True
        n_in: List[int] = []
        out_ix: List[int] = []
        out_mult: List[int] = []
        rfactor = 1.0
        n_species_in = 0
        for comp in comps:
            if comp == "+":
                continue
            if comp == "->":
                left = False
                continue
            if comp[0].isdigit():
                multiplicity = int(comp[0])
                comp = comp[1:]
            else:
                multiplicity = 1
            if left:
                n_species_in += multiplicity
            if self.gas.constant_density:
                gix = self.gas.index(comp)
                if gix != -1:
                    if left:
                        rfactor *= self.gas.densities[gix]
                    continue
                if comp == "M":
                    if left:
                        rfactor *= self.gas.number_density
                    continue
            if comp in ignored:
                is_gas = self.gas.index(comp) >= 0 or comp == "M"
                if left and not is_gas:
                    return None, 1.0, 0  # drop the whole reaction
                continue
            ix = self._get_or_add_species(comp)
            if left:
                n_in.extend([ix] * multiplicity)
            else:
                if ix in out_ix:
                    out_mult[out_ix.index(ix)] += multiplicity
                else:
                    out_ix.append(ix)
                    out_mult.append(multiplicity)
        if not n_in:
            raise ValueError(f"No input species in reaction: {text}")
        return (Reaction(ix_in=n_in, ix_out=out_ix,
                         multiplicity_out=out_mult,
                         n_species_in=n_species_in,
                         rate_factor=rfactor, description=text),
                rfactor, n_species_in)

    def _read_reactions(self, filename: str) -> bool:
        """Read the reaction_list block (read_reactions,
        ``m_chemistry.f90:741-1022``)."""
        ignored = _read_ignored_species(filename)
        with open(filename) as f:
            lines = f.read().splitlines()
        i = 0
        n = len(lines)
        while i < n and lines[i].strip() != "reaction_list":
            i += 1
        if i >= n:
            return False
        i += 1
        if i >= n or not lines[i].strip().startswith("-----"):
            raise ValueError("reaction_list not followed by -----")
        i += 1
        entries: List[Tuple[str, str, str, str]] = []
        groups: List[Tuple[str, List[str]]] = []
        group_size = 0
        while i < n:
            line = lines[i].strip()
            i += 1
            if not line or line.startswith("#"):
                continue
            if line.startswith("-----"):
                break
            if line.startswith("@"):
                # group definition @x = a, b, c
                name, _, rest = line.partition("=")
                members = [m.strip() for m in rest.split(",")]
                if groups and len(members) != group_size:
                    raise ValueError(
                        "Groups for a reaction should have the same size")
                group_size = len(members)
                groups.append((name.strip(), members))
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 3 or len(parts) > 4:
                raise ValueError(f"Invalid chemistry syntax: {line}")
            unit = parts[3] if len(parts) > 3 else "m"
            if groups:
                for k in range(group_size):
                    r, h, dv = parts[0], parts[1], parts[2]
                    for gname, members in groups:
                        r = r.replace(gname, members[k])
                        h = h.replace(gname, members[k])
                        dv = dv.replace(gname, members[k])
                    entries.append((r, h, dv, unit))
                groups = []
                group_size = 0
            else:
                entries.append((parts[0], parts[1], parts[2], unit))

        for reaction_text, how_to_get, data_value, unit in entries:
            parsed, _, _ = self._parse_reaction(reaction_text, ignored)
            if parsed is None:
                continue
            r = parsed
            if how_to_get == "field_table":
                r.rate_type = RATE_TABULATED_FIELD
                r.x_data, r.y_data = table_from_file(filename, data_value)
            elif how_to_get == "energy_table":
                r.rate_type = RATE_TABULATED_ENERGY
                r.x_data, r.y_data = table_from_file(filename, data_value)
            elif how_to_get in RATE_ANALYTIC:
                rtype, ncoeff = RATE_ANALYTIC[how_to_get]
                r.rate_type = rtype
                vals = [float(x) for x in data_value.split()]
                if len(vals) < ncoeff:
                    raise ValueError(
                        f"need {ncoeff} coefficients for {how_to_get}: "
                        f"{reaction_text}")
                r.rate_data = vals[:ncoeff]
            else:
                raise ValueError(
                    f"Unknown rate type {how_to_get!r} for {reaction_text!r}")
            if unit == "cm":
                r.rate_factor *= (1e-6) ** (r.n_species_in - 1)
            elif unit != "m":
                raise ValueError(f"Invalid length unit {unit}")
            self.reactions.append(r)
        return len(self.reactions) > 0

    def _standard_model(self):
        """Fallback e/M+/M- model from alpha & eta tables
        (chemistry_initialize, ``m_chemistry.f90:202-240``)."""
        if not self.gas.constant_density:
            raise ValueError("standard chemistry requires constant gas density")
        self.species_list += ["e", "M+", "M-"]
        self.species_charge += [0, 0, 0]  # recomputed by to_simple_ascii
        tbl = self.td.tbl
        x = tbl.x.copy()
        mu = tbl.rows_cols[:, TD_MOBILITY]
        alpha = tbl.rows_cols[:, TD_ALPHA]
        eta = tbl.rows_cols[:, TD_ETA]
        N = self.gas.number_density
        e, mp, mm = 0, 1, 2
        r1 = Reaction(ix_in=[e], ix_out=[e, mp], multiplicity_out=[2, 1],
                      n_species_in=2, rate_type=RATE_TABULATED_FIELD,
                      rate_factor=1.0, x_data=x,
                      y_data=alpha * mu * x * uc.Townsend_to_SI * N,
                      description="e + M -> e + e + M+")
        r2 = Reaction(ix_in=[e], ix_out=[mm], multiplicity_out=[1],
                      n_species_in=2, rate_type=RATE_TABULATED_FIELD,
                      rate_factor=1.0, x_data=x,
                      y_data=eta * mu * x * uc.Townsend_to_SI * N,
                      description="e + M -> M-")
        self.reactions = [r1, r2]

    def _modify_rates(self, cfg):
        """Sensitivity analysis rate modification (chemistry_modify_rates)."""
        ixs = cfg.add_get("input_data%modified_reaction_ix", [],
                          "Indices of reactions to be modified", dynamic=True)
        facs = cfg.add_get("input_data%modified_rate_factors", [],
                           "Reaction rate factors for modified reactions",
                           dynamic=True)
        for ix, f in zip(ixs, facs):
            self.reactions[int(ix) - 1].rate_factor *= float(f)

    def _classify_reactions(self):
        """Set reaction types (chemistry_initialize, ``:287-310``)."""
        i_elec = self.species_index("e")
        for r in self.reactions:
            chg = self.species_charge
            in_has_e = i_elec in r.ix_in
            out_e_mult2 = any(ix == i_elec and m == 2
                              for ix, m in zip(r.ix_out, r.multiplicity_out))
            if in_has_e and i_elec not in r.ix_out and \
                    not any(chg[ix] > 0 for ix in r.ix_in):
                r.reaction_type = ATTACHMENT_REACTION
            elif in_has_e and out_e_mult2:
                r.reaction_type = IONIZATION_REACTION
            elif any(chg[ix] != 0 for ix in r.ix_in) and \
                    not any(chg[ix] != 0 for ix in r.ix_out):
                r.reaction_type = RECOMBINATION_REACTION
            elif i_elec not in r.ix_in and i_elec in r.ix_out:
                r.reaction_type = DETACHMENT_REACTION

    def _check_charge_conservation(self):
        for r in self.reactions:
            q_in = sum(self.species_charge[ix] for ix in r.ix_in)
            q_out = sum(self.species_charge[ix] * m
                        for ix, m in zip(r.ix_out, r.multiplicity_out))
            if q_in != q_out:
                raise ValueError(
                    f"Charge not conserved in reaction: {r.description}")

    def _build_tables(self, ts):
        """Create the field/energy rate lookup tables
        (chemistry_initialize, ``:312-363``)."""
        td_x = self.td.tbl.x
        n_fld = 0
        n_ee = 0
        for r in self.reactions:
            if r.rate_type == RATE_TABULATED_FIELD:
                if self.has_energy_equation and r.reaction_type in (
                        IONIZATION_REACTION, ATTACHMENT_REACTION):
                    # tabulated against the mean energy at the same field
                    r.rate_type = RATE_TABULATED_ENERGY
                    r.x_data = self.td.tbl.host_col(TD_ENERGY_EV, r.x_data)
                    n_ee += 1
                else:
                    n_fld += 1
            elif r.rate_type == RATE_TABULATED_ENERGY:
                n_ee += 1
        self.chemtbl_fld = LookupTable(td_x[0], td_x[-1], ts.table_size,
                                       max(n_fld, 1), ts.xspacing)
        self.chemtbl_ee = LookupTable(0.0, max(self.td.max_eV, 1e-10),
                                      ts.table_size, max(n_ee, 1),
                                      ts.xspacing)
        i = j = 0
        for r in self.reactions:
            if r.rate_type == RATE_TABULATED_FIELD:
                r.lookup_table_index = i
                table_set_column(self.chemtbl_fld, i, r.x_data, r.y_data, ts)
                i += 1
            elif r.rate_type == RATE_TABULATED_ENERGY:
                r.lookup_table_index = j
                table_set_column(self.chemtbl_ee, j, r.x_data, r.y_data, ts)
                j += 1

    def _build_arrays(self):
        """Lower the network to dense arrays for batched evaluation."""
        ns = len(self.species_list)
        nr = len(self.reactions)
        self.n_species = ns
        self.n_reactions = nr
        max_in = max((len(r.ix_in) for r in self.reactions), default=1)
        # input species indices, padded with ns -> a virtual 'ones' column
        self.in_idx = np.full((nr, max_in), ns, dtype=np.int32)
        S = np.zeros((nr, ns))
        for n, r in enumerate(self.reactions):
            self.in_idx[n, :len(r.ix_in)] = r.ix_in
            for ix in r.ix_in:
                S[n, ix] -= 1.0
            for ix, m in zip(r.ix_out, r.multiplicity_out):
                S[n, ix] += float(m)
        self.stoich = S  # derivs = rates @ S
        self.rate_factor = np.array([r.rate_factor for r in self.reactions])
        self.reaction_types = np.array([r.reaction_type
                                        for r in self.reactions])
        self.rate_type = np.array([r.rate_type for r in self.reactions])
        self._dev = {}  # (name, device, dtype) -> device copy

    # ---------------------------------------------------------- evaluation
    def _device(self, name: str, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.device, like.dtype)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(getattr(self, name),
                                             dtype=like.dtype,
                                             device=like.device)
        return self._dev[key]

    def get_rates(self, fields: torch.Tensor,
                  energy_eV: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rate coefficients [n_cells, n_reactions] (get_rates,
        ``m_chemistry.f90:565-653``) at the fields (in Townsend) and, for
        the energy-tabulated rates, at the mean electron energies."""
        Tg = self.gas_temperature
        electron_eV_to_K = 2 * uc.elec_volt / (3 * uc.boltzmann_const)
        Te = None

        def tabulated(rate_type, tbl, x):
            # all lookups of one table share one interpolation location
            tab = {n: r.lookup_table_index
                   for n, r in enumerate(self.reactions)
                   if r.rate_type == rate_type}
            if tab and x is None:
                raise ValueError("energy-tabulated rates need energy_eV")
            return (dict(zip(tab, tbl.get_cols(list(tab.values()), x)))
                    if tab else {})
        tab_vals = tabulated(RATE_TABULATED_FIELD, self.chemtbl_fld, fields)
        ee_vals = tabulated(RATE_TABULATED_ENERGY, self.chemtbl_ee,
                            energy_eV)
        ones = torch.ones_like(fields)
        cols = []
        for n, r in enumerate(self.reactions):
            c0 = float(r.rate_factor)
            c = [float(v) for v in np.atleast_1d(r.rate_data)]
            rt = r.rate_type
            if rt == RATE_TABULATED_FIELD:
                v = c0 * tab_vals[n]
            elif rt == RATE_TABULATED_ENERGY:
                v = c0 * ee_vals[n]
            elif rt == 2:
                v = ones * (c0 * c[0])
            elif rt == 3:
                v = c0 * c[0] * (fields - c[1])
            elif rt == 4:
                v = c0 * c[0] * torch.exp(-(c[1] / (c[2] + fields)) ** 2)
            elif rt == 5:
                v = c0 * c[0] * torch.exp(-(fields / c[1]) ** 2)
            elif rt in (6, 8):
                # the electron temperature from the mean energy at the field
                if Te is None:
                    Te = electron_eV_to_K * self.td.tbl.get_col(
                        TD_ENERGY_EV, fields)
                if rt == 6:
                    v = c0 * c[0] * (300.0 / Te) ** c[1]
                else:
                    kB_eV = uc.boltzmann_const / uc.elec_volt
                    v = c0 * (c[0] * (kB_eV * Te + c[1]) ** 2 - c[2]) * c[3]
            elif rt == 9:
                v = ones * (c0 * c[0] * (Tg / 300.0) ** c[1]
                            * np.exp(-c[2] / Tg))
            elif rt == 10:
                v = ones * (c0 * c[0] * np.exp(-c[1] / Tg))
            elif rt == 11:
                v = ones * (c0 * c[0] * Tg ** c[1])
            elif rt == 12:
                v = ones * (c0 * c[0] * (Tg / c[1]) ** c[2])
            elif rt == 13:
                v = ones * (c0 * c[0] * (300.0 / Tg) ** c[1])
            elif rt == 14:
                v = ones * (c0 * c[0] * np.exp(-c[1] * Tg))
            elif rt == 15:
                v = ones * (c0 * 10.0 ** (c[0] + c[1] * (Tg - 300.0)))
            elif rt == 16:
                v = ones * (c0 * c[0] * (300.0 / Tg) ** c[1]
                            * np.exp(-c[2] / Tg))
            elif rt == 17:
                v = ones * (c0 * c[0] * Tg ** c[1] * np.exp(-c[2] / Tg))
            elif rt == 18:
                v = c0 * c[0] * torch.exp(-(c[1] / (c[2] + fields)) ** c[3])
            elif rt == 19:
                v = c0 * c[0] * torch.exp(-(fields / c[1]) ** c[2])
            elif rt == 20:
                v = c0 * c[0] * torch.exp(-(c[1] / (uc.boltzmann_const * (
                    Tg + fields / c[2]))) ** c[3])
            else:
                raise ValueError(f"unknown rate type {rt}")
            cols.append(v)
        return torch.stack(cols, dim=-1)

    def get_derivatives(self, dens: torch.Tensor, rates: torch.Tensor):
        """Actual reaction rates and species derivatives (get_derivatives,
        ``m_chemistry.f90:657-688``). dens: [n_cells, n_species]; returns
        (full_rates, derivs)."""
        dpad = torch.cat([dens, torch.ones_like(dens[:, :1])], dim=1)
        in_idx = self._device("in_idx", dens).long()
        prod = dpad[:, in_idx[:, 0]]
        for k in range(1, in_idx.shape[1]):
            prod = prod * dpad[:, in_idx[:, k]]
        full = rates * prod
        return full, full @ self._device("stoich", dens)

    def _swarm_rates(self):
        """(fields, ionization rate, attachment rate) on the host at the
        transport table's fields; under the energy equation at the mean
        energy the table gives for each field."""
        fields = self.td.tbl.x
        f_t = torch.as_tensor(fields, dtype=torch.float64, device="cpu")
        energies = (self.td.tbl.get_col(TD_ENERGY_EV, f_t)
                    if self.has_energy_equation else None)
        rates = self.get_rates(f_t, energy_eV=energies).numpy()
        src = np.zeros_like(fields)
        loss = np.zeros_like(fields)
        for n, r in enumerate(self.reactions):
            if r.reaction_type == ATTACHMENT_REACTION:
                loss += rates[:, n]
            elif r.reaction_type == IONIZATION_REACTION:
                src += rates[:, n]
        return fields, src, loss

    def stoich_matrix(self) -> np.ndarray:
        """Net stoichiometry [n_reactions, n_species]
        (output_stoichiometric_matrix writes its transpose row-wise)."""
        return np.asarray(self.stoich)

    def write_summary(self, fname: str) -> None:
        """Swarm-parameter summary vs E/N (chemistry_write_summary,
        ``m_chemistry.f90:428-501``): mobility, diffusion, alpha, eta and
        ionization/attachment rates at the transport-table fields."""
        if not self.gas.constant_density:
            return
        fields, src, loss = self._swarm_rates()
        diff = self.td.tbl.host_col(TD_DIFFUSION, fields)
        mu = self.td.tbl.host_col(TD_MOBILITY, fields)
        v = mu * fields * uc.Townsend_to_SI
        eta = np.zeros(len(fields))
        alpha = np.zeros(len(fields))
        eta[1:] = loss[1:] / v[1:]
        eta[0] = 2 * eta[1] - eta[2]
        alpha[1:] = src[1:] / v[1:]
        alpha[0] = 2 * alpha[1] - alpha[2]
        N = self.gas.number_density
        with open(fname, "w") as f:
            f.write("E/N[Td] E[V/m] Electron_mobility[m^2/(Vs)] "
                    "Electron_diffusion[m^2/s] "
                    "Townsend_ioniz._coef._alpha[1/m] "
                    "Townsend_attach._coef._eta[1/m] Ionization_rate[1/s] "
                    "Attachment_rate[1/s]\n")
            for n in range(len(fields)):
                f.write(" ".join(f"{x:.8E}" for x in [
                    fields[n], fields[n] * uc.Townsend_to_SI * N,
                    mu[n] / N, diff[n] / N, alpha[n], eta[n],
                    src[n], loss[n]]) + "\n")
            f.write("\n")

    def get_breakdown_field_td(self, min_growth_rate: float = 1e3) -> float:
        """Estimate the breakdown field (chemistry_get_breakdown_field,
        ``m_chemistry.f90:518-560``)."""
        fields, src, loss = self._swarm_rates()
        growth = src - loss
        idx = 0
        for n in range(len(fields) - 1, -1, -1):
            if growth[n] < min_growth_rate:
                idx = n
                break
        return float(fields[idx]) if idx > 0 else 0.0

    @property
    def charged_species(self):
        """(indices, charges) of charged species."""
        ix = [i for i, q in enumerate(self.species_charge) if q != 0]
        return np.array(ix, np.int32), np.array(
            [self.species_charge[i] for i in ix], np.int32)
