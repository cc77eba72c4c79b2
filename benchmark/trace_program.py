"""A traced run of one cell with the program's own tracer recording.

    python3 benchmark/trace_program.py --workload NAME --seed N --seconds S
        [--recording 0|1]

from the root of a checkout, on the card: ``run.py --trace 1`` with the
program's recording switched on for the window
(``harness/program_trace.ProgramTracedRun``; with ``--recording 0`` left
off, the same run otherwise, for the cost of recording). The last line of
its standard output is the traced run's JSON object, whose ``metrics``
also hold the readers of the program's spans and counters
(``program_trace.PROGRAM_METRICS``), whose ``breakdown`` also holds
``idle_gaps_program`` (the traced window's idle seconds by the innermost
program span's path) and whose ``program_checks`` hold the agreement of
the program's spans with the harness's probes and their coverage of the
idle time. It exits with code 2 where no card is found.

Temporary, with ``harness/program_trace.ProgramTracedRun``: it goes when
``harness/cell.py`` switches the program's recording on itself and
``run.py --trace 1`` reports the four metrics (see that module).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (benchmark/run.py: paths and caches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recording", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    for key, path in run.CACHE_DIRS.items():
        run.os.environ.setdefault(key, str(path))
    sys.path.insert(0, str(run.HERE))
    sys.path.insert(0, str(run.ROOT))
    from harness.spec import Spec
    spec = Spec(run.ROOT / "BENCHMARK.json")
    cell = spec.cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        run.fail("no CUDA device: a traced run needs the card")
    from harness.cell import finite
    from harness.program_trace import PROGRAM_METRICS, ProgramTracedRun
    traced = ProgramTracedRun(spec, cell, args.seed, args.seconds, True,
                              T_START, recording=bool(args.recording))
    result = traced.run()
    units = {"host_syncs_per_step": "syncs", "host_wait_ms_per_step": "ms",
             "epoch_flags_ms": "ms", "epoch_tree_ms": "ms"}
    for name in PROGRAM_METRICS:
        value = spec.reader(name)(traced.rec)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": units[name]}
    result["recording"] = bool(args.recording)
    result["program_checks"] = traced.rec.get("program_checks")
    result["checks"] = {k: {"value": finite(v["value"]),
                            "limit": v["limit"]}
                        for k, v in result.pop("checks").items()}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
