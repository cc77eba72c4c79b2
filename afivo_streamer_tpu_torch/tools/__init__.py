"""Command-line tools of the port, one twin for each tool of the JAX
package's ``tools/`` that imports that package. Run one with
``python -m afivo_streamer_tpu_torch.tools.<name> ...``; each takes the
arguments of its JAX counterpart and prints the same format. The tools
that run the simulation or the multigrid on a device (``chaos_floor``,
``electrode_sensitivity``, ``poisson_bench``, ``profile_step``) run on the
card unless ``-device=cpu`` (or ``--device cpu``) is given; the others
work on the host. Importing a tool does nothing."""
