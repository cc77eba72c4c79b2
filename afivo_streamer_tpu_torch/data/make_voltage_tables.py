"""Write the synthetic electrode potential tables of the comparison_air_2d
program, applied_voltage_upper.txt and applied_voltage_lower.txt, in the
``location[m]_vs_potential[V]`` block format that
utils/table_data.table_from_file reads.

Each table gives the boundary potential along the radial coordinate of one
electrode plane as a fraction of the applied voltage (the program scales
it by the voltage at each solve), at 101 points from the axis to 1.25 cm,
the radius of data/comparison_air_2d.cfg:

* upper electrode: 1 - 0.1 (r / R)^2, a potential that falls off by a
  tenth toward the domain's edge;
* lower electrode: 0.05 (r / R)^2, a small potential that rises toward the
  edge.

They are smooth synthetic profiles and no measured datum: they make the
boundary values vary along the face, which is what the program's hook has
to carry into the field solve.

Run from anywhere: ``python make_voltage_tables.py`` rewrites both tables
next to this script.
"""

from pathlib import Path

import numpy as np

RADIUS = 1.25e-2  # m
POINTS = np.linspace(0.0, RADIUS, 101)


def block(profile, comment):
    lines = ["location[m]_vs_potential[V]", f"COMMENT: {comment}",
             "-" * 25]
    lines += [f"{x:.10E} {y:.10E}" for x, y in zip(POINTS, profile)]
    return lines + ["-" * 25, ""]


def tables():
    """{file name: text} of both tables."""
    s = (POINTS / RADIUS) ** 2
    return {
        "applied_voltage_upper.txt": "\n".join(block(
            1.0 - 0.1 * s, "synthetic: 1 - 0.1 (r/R)^2 of the applied "
            "voltage, R = 1.25 cm")),
        "applied_voltage_lower.txt": "\n".join(block(
            0.05 * s, "synthetic: 0.05 (r/R)^2 of the applied voltage, "
            "R = 1.25 cm"))}


def main():
    here = Path(__file__).resolve().parent
    for name, text in tables().items():
        (here / name).write_text(text)


if __name__ == "__main__":
    main()
