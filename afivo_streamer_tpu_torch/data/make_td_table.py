"""Write the synthetic old-style air transport table td_air_synthetic.txt.

The table has the four blocks the old-style input path reads
(``efield[V/m]_vs_{mu,dif,alpha,eta}``, quantities at 1 bar and 300 K
versus the field in V/m, fields 0 to 3e7 V/m):

* alpha(E) = A p exp(-B p / E), the Townsend form with the constants for
  air A = 15 /(cm Torr) and B = 365 V/(cm Torr) from Raizer, "Gas
  Discharge Physics" (Springer, 1991), Table 4.1, at p = 1 bar;
* a small constant attachment eta = 100 /m;
* constant mobility mu = 0.04 m2/(V s) and diffusion D = 0.1 m2/s, round
  values of the order of electron swarm data in air near 3 MV/m.

Run from anywhere: ``python make_td_table.py`` rewrites the table next to
this script. The table contains no reaction list, so the chemistry falls
back to the standard e / M+ / M- model built from alpha and eta.
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

SOURCE = ("Townsend form alpha = A p exp(-B p/E), A = 15 /(cm Torr), "
          "B = 365 V/(cm Torr) (Raizer, Gas Discharge Physics, 1991, "
          "Table 4.1), p = 1 bar")


def alpha(E):
    Ap = A_PER_CM_TORR * P_TORR * 100.0      # 1/m
    Bp = B_V_PER_CM_TORR * P_TORR * 100.0    # V/m
    with np.errstate(divide="ignore"):
        return np.where(E > 0.0, Ap * np.exp(-Bp / np.maximum(E, 1e-300)),
                        0.0)


def block(name, comments, y):
    lines = [name] + [f"COMMENT: {c}" for c in comments] + ["-" * 25]
    lines += [f"{e:.6E} {v:.6E}" for e, v in zip(FIELDS, y)]
    lines += ["-" * 25, ""]
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
    out = Path(__file__).resolve().parent / "td_air_synthetic.txt"
    out.write_text("\n".join(lines))


if __name__ == "__main__":
    main()
