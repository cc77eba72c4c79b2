"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``. The run needs
an NVIDIA card (it exits with code 2, printing no result, where
``torch.cuda`` finds none or fewer than the cell asks for). It prints, as
the last line of its standard output, one JSON object: ``correct``,
``attempted`` (time steps in the window), ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, last, ``checks``: each number that decided ``correct``
beside its limit, which also close its standard error. See
``harness/cell.py`` for the stages of a run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: build and kernel caches inside the checkout, at fixed paths
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": HERE / ".cache" / "torch_extensions",
              "TRITON_CACHE_DIR": HERE / ".cache" / "triton"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    args = parse(argv)
    for key, path in CACHE_DIRS.items():
        os.environ.setdefault(key, str(path))
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    from harness.spec import Spec
    spec = Spec(ROOT / "BENCHMARK.json")
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the card and does "
             "not fall back to the CPU")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell asks for {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")

    from harness.cell import CellRun, finite
    from harness.isolation import loaded_forbidden
    result = CellRun(spec, cell, args.seed, args.seconds, bool(args.trace),
                     T_START).run()
    found = loaded_forbidden()
    if found:
        fail("forbidden modules loaded in the run: " + ", ".join(found), 3)
    checks = {k: {"value": finite(v["value"]), "limit": v["limit"]}
              for k, v in result["checks"].items()}
    result["checks"] = checks
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
