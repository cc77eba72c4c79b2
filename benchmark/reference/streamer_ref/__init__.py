"""The benchmark's frozen reference: a plain PyTorch copy of the port.

A copy of ``afivo_streamer_tpu_torch`` (its driver, physics, solvers, mesh
and writers) in which every multigrid smoother kernel is replaced by its
plain PyTorch version (ops/smoother.py) and nothing of the program is
imported. The benchmark runs it with the settings and seed of a cell and
compares the program's set-up steps with it (benchmark/harness/compare.py);
later changes of the program do not change it.
"""

__version__ = "0.1.0"
