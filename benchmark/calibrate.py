"""The readings that a cell's correctness limits are set from.

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--device cuda|cpu]

For each seed: the program runs the cell's set-up steps (the warm-up of a
benchmark run), the frozen reference runs the same, and
the numbers that decide ``correct`` are printed (the lower reading is the
largest over sound seeds). For each control seed, the program's float32
path (``-compiled%enabled=T -compiled%dtype=float32``, the step below the
float64 that the configuration states) runs the same steps against the
same reference (its smallest reading is the upper one). One JSON line per
reading; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell, seeds, control_seeds, device, emit):
    """Emit one reading per seed and side (``emit(dict)``)."""
    from harness import compare as cmp
    from harness.cell import finite, program_snapshot, reference_snapshot
    from harness.sides import FLOAT32_FLAGS
    for seed in sorted(set(seeds) | set(control_seeds)):
        work = Path(tempfile.mkdtemp(prefix="bench_cal_"))
        try:
            snaps = []
            n = None
            if seed in seeds:
                snap = program_snapshot(cell, seed, n, device,
                                        work / "program")
                n = snap["steps"]
                snaps.append(("program", snap))
            if seed in control_seeds:
                if n is None:
                    n = program_snapshot(cell, seed, None, device,
                                         work / "count")["steps"]
                snaps.append(("control_float32", program_snapshot(
                    cell, seed, n, device, work / "control",
                    FLOAT32_FLAGS)))
            t0 = time.perf_counter()
            ref = reference_snapshot(cell, seed, n, device, work / "ref")
            t_ref = time.perf_counter() - t0
            for label, snap in snaps:
                nums = cmp.compare(snap, ref)
                emit({"workload": cell.name, "seed": seed, "side": label,
                      "steps": n, "reference_s": t_ref,
                      **{k: finite(v) for k, v in nums.items()}})
        finally:
            shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    from harness.spec import Spec
    cell = Spec(ROOT / "BENCHMARK.json").cell(args.workload)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    def emit(d):
        print(json.dumps(d), flush=True)
    readings(cell, ints(args.seeds), ints(args.control_seeds), args.device,
             emit)


if __name__ == "__main__":
    main()
