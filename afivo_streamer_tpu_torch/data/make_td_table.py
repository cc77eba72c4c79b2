"""Write the synthetic air transport tables td_air_synthetic.txt (old
style), td_air_synthetic_new.txt (new style, with a mean-energy block) and
td_air_synthetic_reactions.txt (the new-style table with a reaction list
over the gas components N2, O2 and M).

The old-style table has the four blocks the old-style input path reads
(``efield[V/m]_vs_{mu,dif,alpha,eta}``, quantities at 1 bar and 300 K
versus the field in V/m, fields 0 to 3e7 V/m):

* alpha(E) = A p exp(-B p / E), the Townsend form with the constants for
  air A = 15 /(cm Torr) and B = 365 V/(cm Torr) from Raizer, "Gas
  Discharge Physics" (Springer, 1991), Table 4.1, at p = 1 bar;
* a small constant attachment eta = 100 /m;
* constant mobility mu = 0.04 m2/(V s) and diffusion D = 0.1 m2/s, round
  values of the order of electron swarm data in air near 3 MV/m.

The new-style table has the five blocks the new-style input path reads,
versus the reduced field in Td at the same 301 fields, scaled with the gas
number density N at 1 bar and 300 K:

* ``Townsend ioniz. coef. alpha/N (m2)`` and ``Townsend attach. coef. eta/N
  (m2)``: the same alpha and eta as above, divided by N;
* ``Mobility *N (1/m/V/s)`` and ``Diffusion coefficient *N (1/m/s)``: the
  constants above times a mild monotone dependence on the field (the
  mobility falls from 1.2 to 0.8 of MU, the diffusion rises from 0.7 to 1.3
  of DIF, both equal to the old-style value at 3 MV/m), so that a lookup by
  the mean energy is no constant;
* ``Mean energy (eV)``: eps = 0.04 + 10 x / (x + 150) eV with x in Td, a
  synthetic form and no measured swarm datum. It is strictly increasing:
  the energy model tabulates rates against it, and a block that is not
  monotone would fold those tables.

The reaction table appends a ``reaction_list`` to the new-style blocks, so
that a varying gas density (gas dynamics, a user gas density) can run: the
standard chemistry and the old-style input refuse one. Its reactions, in
m3/s (m6/s for the three-body one):

* ``e + N2 -> e + e + N2+`` and ``e + O2 -> e + e + O2+``, each with the
  field table k(E/N) = alpha(E) mu(E) E / N (the alpha and mobility above),
  so that the total ionization rate equals the old-style alpha v;
* ``e + O2 + M -> O2- + M``, a three-body attachment with the constant
  1e-43 m6/s (about 1e7 /s at 1 bar, of the order of the eta v above);
* ``e + N2+ -> N2`` and ``e + O2+ -> O2`` at 2e-13, ``O2- + N2+ -> O2 + N2``
  and ``O2- + O2+ -> O2 + O2`` at 1e-13: round constants of the order of
  dissociative and ion-ion recombination in air.

They are synthetic and no measured rate; the gas species enter the
chemistry's densities as fractions of the local gas density.

Run from anywhere: ``python make_td_table.py`` rewrites the three tables
next to this script. The first two contain no reaction list, so the
chemistry falls back to the standard e / M+ / M- model built from alpha
and eta.
"""

from pathlib import Path

import numpy as np

A_PER_CM_TORR = 15.0
B_V_PER_CM_TORR = 365.0
P_TORR = 1e5 / 133.322368  # 1 bar
ETA = 100.0  # 1/m
MU = 0.04  # m2/(V s)
DIF = 0.1  # m2/s
FIELDS = np.linspace(0.0, 3e7, 301)  # V/m
E_REF = 3e6  # V/m, where the new-style mu and D equal MU and DIF
# 1/m3 at 1 bar, 300 K, with the package's Boltzmann constant
N_GAS = 1e5 / (1.3806503e-23 * 300.0)
TOWNSEND = 1e-21  # V m2

SOURCE = ("Townsend form alpha = A p exp(-B p/E), A = 15 /(cm Torr), "
          "B = 365 V/(cm Torr) (Raizer, Gas Discharge Physics, 1991, "
          "Table 4.1), p = 1 bar")


def alpha(E):
    Ap = A_PER_CM_TORR * P_TORR * 100.0      # 1/m
    Bp = B_V_PER_CM_TORR * P_TORR * 100.0    # V/m
    with np.errstate(divide="ignore"):
        return np.where(E > 0.0, Ap * np.exp(-Bp / np.maximum(E, 1e-300)),
                        0.0)


def mobility(E):
    """Falls from 1.2 MU at zero field through MU at E_REF to 0.8 MU."""
    return MU * (0.8 + 0.4 / (1.0 + E / E_REF))


def diffusion(E):
    """Rises from 0.7 DIF at zero field through DIF at E_REF to 1.3 DIF."""
    s = E / E_REF
    return DIF * (0.7 + 0.6 * s / (1.0 + s))


def mean_energy(td):
    """Synthetic strictly increasing mean energy (eV) versus E/N (Td)."""
    return 0.04 + 10.0 * td / (td + 150.0)


def block(name, comments, y, x=FIELDS, fmt="{:.6E}"):
    lines = [name] + [f"COMMENT: {c}" for c in comments] + ["-" * 25]
    lines += [f"{fmt} {fmt}".format(e, v) for e, v in zip(x, y)]
    lines += ["-" * 25, ""]
    return lines


def new_style():
    td = FIELDS / (N_GAS * TOWNSEND)
    scaled = "at 1 bar, 300 K, scaled with N = 1e5 / (k_B 300 K)"
    mild = "synthetic, mildly field dependent: "
    lines = ["Synthetic new-style transport data for air "
             "(afivo_streamer_tpu_torch/data/make_td_table.py)", ""]

    def add(name, comments, y):
        lines.extend(block(name, comments, y, x=td, fmt="{:.10E}"))
    add("Mobility *N (1/m/V/s)",
        [mild + "mu = 0.04 (0.8 + 0.4 / (1 + E / 3 MV/m)) m2/(V s), "
         + scaled], mobility(FIELDS) * N_GAS)
    add("Diffusion coefficient *N (1/m/s)",
        [mild + "D = 0.1 (0.7 + 0.6 s / (1 + s)) m2/s, s = E / 3 MV/m, "
         + scaled], diffusion(FIELDS) * N_GAS)
    add("Townsend ioniz. coef. alpha/N (m2)", [SOURCE + ", divided by N"],
        alpha(FIELDS) / N_GAS)
    add("Townsend attach. coef. eta/N (m2)",
        ["synthetic small constant attachment, 100 /m divided by N"],
        np.full_like(FIELDS, ETA) / N_GAS)
    add("Mean energy (eV)",
        ["synthetic monotone form eps = 0.04 + 10 x / (x + 150) eV, x in "
         "Td; no measured swarm datum; strictly increasing so that rates "
         "tabulated against it do not fold"], mean_energy(td))
    return lines


REACTIONS = [
    "e + N2 -> e + e + N2+,field_table,efield[Td]_vs_rate_ionization_N2",
    "e + O2 -> e + e + O2+,field_table,efield[Td]_vs_rate_ionization_O2",
    "e + O2 + M -> O2- + M,c1,1.0e-43",
    "e + N2+ -> N2,c1,2.0e-13",
    "e + O2+ -> O2,c1,2.0e-13",
    "O2- + N2+ -> O2 + N2,c1,1.0e-13",
    "O2- + O2+ -> O2 + O2,c1,1.0e-13",
]


def with_reactions():
    """The new-style table with the reaction list and its field tables."""
    td = FIELDS / (N_GAS * TOWNSEND)
    k_ion = alpha(FIELDS) * mobility(FIELDS) * FIELDS / N_GAS
    lines = new_style()
    lines[0] = ("Synthetic new-style transport data and reactions for air "
                "(afivo_streamer_tpu_torch/data/make_td_table.py)")
    lines += ["reaction_list", "-" * 25] + REACTIONS + ["-" * 25, ""]
    for gas in ("N2", "O2"):
        lines += block(f"efield[Td]_vs_rate_ionization_{gas}",
                       [f"k = alpha mu E / N (m3/s) of e + {gas} -> e + e "
                        f"+ {gas}+, from the alpha and mobility above"],
                       k_ion, x=td, fmt="{:.10E}")
    return lines


def main():
    const = "synthetic constant value at 1 bar, 300 K"
    lines = ["Synthetic old-style transport data for air "
             "(afivo_streamer_tpu_torch/data/make_td_table.py)", ""]
    lines += block("efield[V/m]_vs_mu[m2/Vs]", [const],
                   np.full_like(FIELDS, MU))
    lines += block("efield[V/m]_vs_dif[m2/s]", [const],
                   np.full_like(FIELDS, DIF))
    lines += block("efield[V/m]_vs_alpha[1/m]", [SOURCE], alpha(FIELDS))
    lines += block("efield[V/m]_vs_eta[1/m]",
                   ["synthetic small constant attachment"],
                   np.full_like(FIELDS, ETA))
    here = Path(__file__).resolve().parent
    (here / "td_air_synthetic.txt").write_text("\n".join(lines))
    (here / "td_air_synthetic_new.txt").write_text("\n".join(new_style()))
    (here / "td_air_synthetic_reactions.txt").write_text(
        "\n".join(with_reactions()))


if __name__ == "__main__":
    main()
