#!/usr/bin/env python3
"""ms per V-cycle of the main path's field solve on one NVIDIA card, for one
or more checkouts of this repository, each in a process of its own, in the
order given.

    python3 vcycle_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (another commit unpacked with
``git archive`` into a directory that .gitignore lists, say). Name two
checkouts as A B B A to see the host's drift between the runs. Each run
builds its checkout's kernels, sets up the configuration of that
checkout's ``chip_smoke.py`` phase 7 (the cylindrical slice with live
refinement, 340,864 leaf cells on 8 levels after setup), gathers the
field solve's level arrays once and times ``fas_vcycle_blocks`` on them
with CUDA events: 10 rounds of 10 cycles, each after 5 warm-up cycles.
The host's load only adds time, so compare the least round of each run.
Prints the card's name and power limit, then one JSON line per run.
"""

import json
import subprocess
import sys
from pathlib import Path


def one(root: Path) -> dict:
    """Time the V-cycle with the package and chip_smoke.py of ``root``."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from afivo_streamer_tpu_torch.driver import Simulation
    from afivo_streamer_tpu_torch.ops import smoother as ks
    from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
    for entry in ks.build_libraries():
        ks._library(entry)
    sim = Simulation(argv=cs.amr_argv(root / "out" / "vcycle_ab" / "run", 2,
                                      "cuda", cs.AMR_FULL[2][0]))
    mg = sim.field.mg
    params = {"voltage": sim.field.current_voltage}
    P, R = mgb.gather_levels(mg, sim.cc)
    rounds = [cs.time_ms(torch, lambda: mgb.fas_vcycle_blocks(mg, P, R,
                                                              params),
                         reps=10) for _ in range(10)]
    t = sim.tree
    return {"root": str(root), "ms_per_vcycle": rounds, "min": min(rounds),
            "median": sorted(rounds)[5], "levels": t.highest_lvl,
            "leaf_cells": sum(len(x) for x in t.lvl_leaves) * t.nc ** 2}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
