"""Compare the output files of two runs of one configuration (the
reference's and another's, e.g. the JAX package's and this package's, or a
run on the CPU and one on the card).

``compare_outputs(ref, got)`` takes the two runs' ``output%name`` prefixes
and holds every file the reference wrote against the other's:

* the chemistry listings (``_species.txt``, ``_reactions.txt``,
  ``_stoich_matrix.txt``) byte for byte, where the runs wrote them (a
  restarted run does not);
* the tables (``_summary.txt``, ``_rates.txt``, ``_amounts.txt``,
  ``_rtest.log``, ``_log.txt``): the same header and shape, every value
  within ``rtol`` of its scale. The scale is the value itself, except in
  the text log: the net charge, a difference of the species sums, is
  measured against their magnitude, the radial field's extrema, values
  near the axis, against max(E), and the wall-clock column is skipped;
* the grid files (``_grid_<cnt>.npz``): the same keys, box ids, levels and
  names, every value within ``rtol`` of its variable's largest magnitude
  (the surfaces' data of ``dielectric%write`` within ``rtol`` of its
  largest magnitude, their boxes exact);
* the opt-in writers' files of every output: the samples along a line, the
  cross sections and the field maxima (``_line_``, ``_cross_``,
  ``_Emax_<cnt>.txt``) as tables; the plane and the unstructured grid
  (``_plane_<cnt>.vtk``, ``_<cnt>.vtk``) line by line, the words exact and
  each block of numbers within ``rtol`` of its largest magnitude; the
  uniform grids (``_<cnt>.npz``) array by array; the checkpoints
  (``_<cnt>.dat.npz``) with the tree, the names and the payload's integers
  exact, and every other number within ``rtol`` of its variable's largest
  magnitude over the boxes in use (the scratch row ``tmp`` and the
  surface rows aside, which the JAX package's host path does not keep in
  its state).

It returns the worst scaled deviation of each file and raises
``AssertionError`` naming the first difference. Run as a script:
``python -m afivo_streamer_tpu_torch.io.compare REF_PREFIX PREFIX``.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

LISTINGS = ("species", "reactions", "stoich_matrix")
TABLES = ("summary.txt", "rates.txt", "amounts.txt", "rtest.log", "log.txt")
#: the opt-in writers' files of each output: (pattern after the prefix's
#: name, how they are compared)
SERIES = ((r"grid_\d{6}\.npz", "grid"), (r"line_\d{6}\.txt", "table"),
          (r"cross_\d{6}\.txt", "table"), (r"Emax_\d{6}\.txt", "table"),
          (r"plane_\d{6}\.vtk", "vtk"), (r"\d{6}\.vtk", "vtk"),
          (r"\d{6}\.npz", "npz"), (r"\d{6}\.dat\.npz", "checkpoint"))
#: the tree's arrays of a checkpoint, compared exactly
CHECKPOINT_EXACT = ("ndim", "nc", "coord", "coarse_grid_size", "periodic",
                    "highest_id", "lvl", "ix", "parent", "children",
                    "neighbors", "in_use", "removed_ids", "cc_names",
                    "payload_version", "payload_it", "payload_out_cnt")


def read_table(path) -> Tuple[Optional[str], np.ndarray]:
    """The header line (None where the first line is numbers) and the
    numeric rows of a text table."""
    lines = [ln for ln in Path(path).read_text().splitlines() if ln.strip()]
    if not lines:
        return None, np.zeros((0, 0))
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
        if key in names or key in ("time", "surface_sd"):
            scale = float(np.abs(a).max()) if a.size else 0.0
            err = float(np.abs(b - a).max()) if a.size else 0.0
            worst = max(worst, err / scale if scale > 0 else
                        (0.0 if err == 0 else np.inf))
        elif not np.array_equal(a, b):
            raise AssertionError(f"{ref_path.name}: {key} differs")
    return worst


def _scaled(a, b) -> float:
    """The largest deviation of ``b`` from ``a`` over a's largest
    magnitude (0 for two empty or equal arrays)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {b.shape} against {a.shape}")
    if a.size == 0:
        return 0.0
    scale = float(np.abs(a).max())
    err = float(np.abs(b - a).max())
    return err / scale if scale > 0 else (0.0 if err == 0 else np.inf)


def _is_number(word: str) -> bool:
    try:
        float(word)
        return True
    except ValueError:
        return False


def _vtk_deviation(ref_path, got_path, names=("", "")) -> float:
    """Two ASCII VTK files: the same words (each run's output name, in a
    plane's title, read as the other's), and each block of numbers between
    two lines of words within its largest magnitude."""
    ref = ref_path.read_text().split("\n")
    got = got_path.read_text().replace(names[1], names[0]).split("\n")
    if len(ref) != len(got):
        raise AssertionError(f"{ref_path.name}: {len(got)} lines against "
                             f"{len(ref)}")
    worst = 0.0
    block_a, block_b = [], []
    for la, lb in zip(ref + ["END"], got + ["END"]):
        wa, wb = la.split(), lb.split()
        if len(wa) != len(wb):
            raise AssertionError(f"{ref_path.name}: {lb!r} against {la!r}")
        if wa and all(_is_number(w) for w in wa):
            block_a += [float(w) for w in wa]
            block_b += [float(w) for w in wb]
            continue
        worst = max(worst, _scaled(block_a, block_b))
        block_a, block_b = [], []
        for a, b in zip(wa, wb):
            if _is_number(a) != _is_number(b) or (
                    not _is_number(a) and a != b):
                raise AssertionError(f"{ref_path.name}: {lb!r} against "
                                     f"{la!r}")
            if _is_number(a):
                worst = max(worst, _scaled([float(a)], [float(b)]))
    return worst


def _npz_deviation(ref_path, got_path) -> float:
    ref, got = np.load(ref_path), np.load(got_path)
    if sorted(ref.files) != sorted(got.files):
        raise AssertionError(f"{ref_path.name}: keys {sorted(got.files)} "
                             f"against {sorted(ref.files)}")
    return max(_scaled(ref[k], got[k]) for k in ref.files)


def _checkpoint_deviation(ref_path, got_path) -> float:
    ref, got = np.load(ref_path), np.load(got_path)
    if sorted(ref.files) != sorted(got.files):
        raise AssertionError(f"{ref_path.name}: keys {sorted(got.files)} "
                             f"against {sorted(ref.files)}")
    for key in CHECKPOINT_EXACT:
        if key in ref.files and not np.array_equal(ref[key], got[key]):
            raise AssertionError(f"{ref_path.name}: {key} differs")
    use = ref["in_use"]
    names = [str(x) for x in ref["cc_names"]]
    worst = 0.0
    for iv, name in enumerate(names):
        if name != "tmp" and not name.startswith("surf_"):
            worst = max(worst, _scaled(ref["cc"][iv][use], got["cc"][iv][use]))
    for iv in range(ref["fc"].shape[0]):
        worst = max(worst, _scaled(ref["fc"][iv][:, use],
                                   got["fc"][iv][:, use]))
    for key in ref.files:
        if key not in CHECKPOINT_EXACT and key not in ("cc", "fc"):
            worst = max(worst, _scaled(ref[key], got[key]))
    return worst


def _series_deviation(kind: str, a: Path, b: Path, names) -> float:
    if kind == "grid":
        return _grid_deviation(a, b)
    if kind == "table":
        h_ref, ref = read_table(a)
        h_got, got = read_table(b)
        if h_got != h_ref:
            raise AssertionError(f"{a.name}: header {h_got!r} against "
                                 f"{h_ref!r}")
        return _scaled(ref, got)
    if kind == "vtk":
        return _vtk_deviation(a, b, names)
    if kind == "npz":
        return _npz_deviation(a, b)
    return _checkpoint_deviation(a, b)


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
        if a.exists() != b.exists():
            raise AssertionError(f"{name}.txt: written by one run only")
        if not a.exists():  # a restarted run writes no setup listings
            continue
        if a.read_bytes() != b.read_bytes():
            raise AssertionError(f"{name}.txt differs")
        out[f"{name}.txt"] = 0.0
    for name in TABLES:
        a, b = path(ref_prefix, name), path(got_prefix, name)
        if a.exists() != b.exists():
            raise AssertionError(f"{name}: written by one run only")
        if a.exists():
            out[name] = _table_deviation(a, b, name)
    for pattern, kind in SERIES:
        names = []
        for prefix in (ref_prefix, got_prefix):
            rx = re.compile(re.escape(prefix.name) + "_" + pattern + "$")
            names.append(sorted(p.name[len(prefix.name) + 1:]
                                for p in prefix.parent.iterdir()
                                if rx.match(p.name)))
        if names[0] != names[1]:
            raise AssertionError(f"the runs wrote other files {pattern}: "
                                 f"{names[1]} against {names[0]}")
        for name in names[0]:
            out[name] = _series_deviation(
                kind, path(ref_prefix, name), path(got_prefix, name),
                (str(ref_prefix), str(got_prefix)))
    bad = {k: v for k, v in out.items() if not v <= rtol}
    if bad:
        raise AssertionError(f"deviations above {rtol}: {bad}")
    return out


if __name__ == "__main__":
    worst = compare_outputs(sys.argv[1], sys.argv[2])
    for name, dev in worst.items():
        print(f"{name}: {dev:.3e}")
