#!/usr/bin/env python3
"""Device time of one smoother kernel at several box sizes on one NVIDIA
card, for one or more checkouts of this repository, each in a process of
its own, in the order given.

    python3 kernel_ab.py NAME DTYPE N NC[,NC...] ROOT [ROOT ...]

NAME is a kernel of ``ops/smoother.KERNELS`` (fill_3d, say), DTYPE float64
or float32, N the boxes of a call and NC the box sizes. Each ROOT is the
root of a checkout (another commit, or a copy with one source changed,
unpacked into a directory that .gitignore lists). Name two checkouts as
A B B A to see the card's drift between the runs. Each run builds its
checkout's kernels and, at every box size, holds the kernel against its
plain version on random inputs (``chip_smoke.box_inputs``) and times it
with that checkout's ``chip_smoke.measure``: cold from two or more input
sets, each larger than the L2. Prints the card's name and power limit,
then one JSON line per run.
"""

import json
import subprocess
import sys
from pathlib import Path


def one(root: Path, name: str, dname: str, n: int, ncs) -> dict:
    """Time kernel ``name`` with the package and chip_smoke.py of ``root``."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from afivo_streamer_tpu_torch.ops import smoother as ks
    for entry in ks.build_libraries():
        ks._library(entry)
    dtype = getattr(torch, dname)
    out = {"root": str(root), "kernel": name, "dtype": dname, "n": n}
    for nc in ncs:
        x = cs.box_inputs(torch, name, dtype, n, nc, 20261020 + nc)
        err = cs.check_against_plain(torch, ks, name, x)[0]
        r = cs.measure(torch, ks, name, x, "", min_sets=2)
        out[nc] = {"cold_us": r["cold_us"], "bound_us": r["bound_us"],
                   "share": r["share"], "max_abs_err": err}
        del x
        cs.free_earlier_runs(torch)
    return out


def main(argv) -> int:
    if len(argv) >= 6 and argv[0] == "--one":
        out = one(Path(argv[1]).resolve(), argv[2], argv[3], int(argv[4]),
                  [int(v) for v in argv[5].split(",")])
        print(json.dumps(out), flush=True)
        return 0
    if len(argv) < 5:
        print(__doc__, file=sys.stderr)
        return 2
    name, dname, n, ncs = argv[:4]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for root in argv[4:]:
        out = subprocess.run([sys.executable, __file__, "--one", root, name,
                              dname, n, ncs], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
