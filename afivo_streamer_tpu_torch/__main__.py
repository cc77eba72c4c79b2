"""Command-line entry point.

Usage (mirrors the JAX package's CLI):

    python -m afivo_streamer_tpu_torch config.cfg -ndim=1|2|3 [-key=value ...]

Any configuration key can be overridden on the command line; ``-device``
selects the device of the state (``cuda``, the default, or ``cpu``). The
resolved configuration is written to ``<output%name>_out.cfg``. After the
run it prints the steps and their seconds, then the cost breakdown of the
JAX package's command line (the host seconds by part of the step, in %).

With ``-compiled%enabled=T -compiled%shards=N`` (N > 1) the command starts
N ranks and runs the simulation over them (parallel/compiled.launch):
under torchrun in its ranks, else in N spawned processes.
"""

import sys
import time

import torch
import torch.distributed as dist

from .driver import Simulation
from .parallel.compiled import CompiledSettings, launch
from .utils.config import CFG


def run_simulation(argv):
    """Build and run the simulation of the command line in this
    process (one rank of a sharded run)."""
    sim = Simulation(argv=argv)
    if sim.is_root:
        sim.cfg.write(sim.output.name + "_out.cfg")
        bf = sim.chem.get_breakdown_field_td(1.0e3)
        print(f" Estimated breakdown field (Td): {bf:12.4E}")
    t0 = time.perf_counter()
    sim.run()
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    wall = time.perf_counter() - t0
    if sim.is_root:
        print(f"{sim.it - 1} steps in {wall:.3f} s on {sim.device}")
        # the JAX package's cost breakdown (its __main__.py:22-26)
        total = max(sum(sim.wc.values()), 1e-300)
        print("Computational cost breakdown (%)")
        print("".join(f"{k:>10}" for k in sim.wc))
        print("".join(f"{100 * v / total:10.2f}" for v in sim.wc.values()))


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    cfg = CFG()
    cfg.update_from_arguments(argv)
    n = CompiledSettings(cfg).n_shards
    if n > 1 and not dist.is_initialized():
        launch(argv, n, cfg.add_get("device", "cuda"))
        return
    run_simulation(argv)


if __name__ == "__main__":
    main()
