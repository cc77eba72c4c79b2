"""Command-line entry point.

Usage (mirrors the JAX package's CLI):

    python -m afivo_streamer_tpu_torch config.cfg -ndim=1|2|3 [-key=value ...]

Any configuration key can be overridden on the command line; ``-device``
selects the device of the state (``cuda``, the default, or ``cpu``). The
resolved configuration is written to ``<output%name>_out.cfg``.
"""

import sys
import time

import torch

from .driver import Simulation


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    sim = Simulation(argv=argv)
    sim.cfg.write(sim.output.name + "_out.cfg")
    bf = sim.chem.get_breakdown_field_td(1.0e3)
    print(f" Estimated breakdown field (Td): {bf:12.4E}")
    t0 = time.perf_counter()
    sim.run()
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    wall = time.perf_counter() - t0
    print(f"{sim.it - 1} steps in {wall:.3f} s on {sim.device}")


if __name__ == "__main__":
    main()
