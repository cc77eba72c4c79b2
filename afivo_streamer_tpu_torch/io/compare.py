"""Compare the output files of two runs of one configuration (the
reference's and another's, e.g. the JAX package's and this package's, or a
run on the CPU and one on the card).

``compare_outputs(ref, got)`` takes the two runs' ``output%name`` prefixes
and holds every file the reference wrote against the other's:

* the chemistry listings (``_species.txt``, ``_reactions.txt``,
  ``_stoich_matrix.txt``) byte for byte;
* the tables (``_summary.txt``, ``_rates.txt``, ``_amounts.txt``,
  ``_rtest.log``, ``_log.txt``): the same header and shape, every value
  within ``rtol`` of its scale. The scale is the value itself, except in
  the text log: the net charge, a difference of the species sums, is
  measured against their magnitude, the radial field's extrema, values
  near the axis, against max(E), and the wall-clock column is skipped;
* the grid files (``_grid_<cnt>.npz``): the same keys, box ids, levels and
  names, every value within ``rtol`` of its variable's largest magnitude.

It returns the worst scaled deviation of each file and raises
``AssertionError`` naming the first difference. Run as a script:
``python -m afivo_streamer_tpu_torch.io.compare REF_PREFIX PREFIX``.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

LISTINGS = ("species", "reactions", "stoich_matrix")
TABLES = ("summary.txt", "rates.txt", "amounts.txt", "rtest.log", "log.txt")


def read_table(path) -> Tuple[Optional[str], np.ndarray]:
    """The header line (None where the first line is numbers) and the
    numeric rows of a text table."""
    lines = [ln for ln in Path(path).read_text().splitlines() if ln.strip()]
    first = lines[0].split()[0]
    try:
        float(first)
        header = None
    except ValueError:
        header = lines[0]
    rows = np.array([[float(x) for x in ln.split()]
                     for ln in lines[1 if header else 0:]])
    return header, rows


def log_scales(header: str, rows: np.ndarray) -> np.ndarray:
    """The scale of every value of the text log's rows, and 0 for the
    wall-clock column, which is not compared."""
    names = header.split()
    scales = np.abs(rows)
    scales[:, names.index("sum(charge)")] = (
        np.abs(rows[:, names.index("sum(n_e)")])
        + np.abs(rows[:, names.index("sum(n_i)")]))
    for name in ("max(E_r)", "min(E_r)"):
        if name in names:
            scales[:, names.index(name)] = np.abs(
                rows[:, names.index("max(E)")])
    scales[:, names.index("wc_time")] = 0.0
    return scales


def _table_deviation(ref_path, got_path, name: str) -> float:
    h_ref, ref = read_table(ref_path)
    h_got, got = read_table(got_path)
    if h_got != h_ref or got.shape != ref.shape:
        raise AssertionError(f"{name}: header or shape differs: "
                             f"{got.shape} against {ref.shape}")
    scales = log_scales(h_ref, ref) if name == "log.txt" else np.abs(ref)
    diff = np.abs(got - ref)
    rel = np.where(scales > 0, diff / np.where(scales > 0, scales, 1.0),
                   np.where(diff == 0, 0.0, np.inf))
    if name == "log.txt":
        rel[:, h_ref.split().index("wc_time")] = 0.0
    return float(rel.max()) if rel.size else 0.0


def _grid_deviation(ref_path, got_path) -> float:
    ref, got = np.load(ref_path), np.load(got_path)
    if sorted(ref.files) != sorted(got.files):
        raise AssertionError(f"{ref_path.name}: keys {sorted(got.files)} "
                             f"against {sorted(ref.files)}")
    worst = 0.0
    names = set(str(x) for x in ref["var_names"])
    for key in ref.files:
        a, b = ref[key], got[key]
        if key in names or key == "time":
            scale = float(np.abs(a).max()) if a.size else 0.0
            err = float(np.abs(b - a).max()) if a.size else 0.0
            worst = max(worst, err / scale if scale > 0 else
                        (0.0 if err == 0 else np.inf))
        elif not np.array_equal(a, b):
            raise AssertionError(f"{ref_path.name}: {key} differs")
    return worst


def compare_outputs(ref_prefix, got_prefix, rtol: float = 1e-8
                    ) -> Dict[str, float]:
    """Hold the output files of ``got_prefix`` against those of
    ``ref_prefix`` (module docstring); returns the worst scaled deviation
    of each file."""
    ref_prefix, got_prefix = Path(ref_prefix), Path(got_prefix)

    def path(prefix, suffix):
        return prefix.parent / f"{prefix.name}_{suffix}"

    out = {}
    for name in LISTINGS:
        a, b = path(ref_prefix, f"{name}.txt"), path(got_prefix, f"{name}.txt")
        if a.read_bytes() != b.read_bytes():
            raise AssertionError(f"{name}.txt differs")
        out[f"{name}.txt"] = 0.0
    for name in TABLES:
        a, b = path(ref_prefix, name), path(got_prefix, name)
        if a.exists() != b.exists():
            raise AssertionError(f"{name}: written by one run only")
        if a.exists():
            out[name] = _table_deviation(a, b, name)
    refs = sorted(ref_prefix.parent.glob(f"{ref_prefix.name}_grid_*.npz"))
    gots = sorted(got_prefix.parent.glob(f"{got_prefix.name}_grid_*.npz"))
    if [p.name[len(ref_prefix.name):] for p in refs] != \
            [p.name[len(got_prefix.name):] for p in gots]:
        raise AssertionError("the runs wrote grid files of other outputs")
    for a, b in zip(refs, gots):
        out[a.name[len(ref_prefix.name) + 1:]] = _grid_deviation(a, b)
    bad = {k: v for k, v in out.items() if not v <= rtol}
    if bad:
        raise AssertionError(f"deviations above {rtol}: {bad}")
    return out


if __name__ == "__main__":
    worst = compare_outputs(sys.argv[1], sys.argv[2])
    for name, dev in worst.items():
        print(f"{name}: {dev:.3e}")
