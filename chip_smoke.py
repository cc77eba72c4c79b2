#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (afivo_streamer_tpu_torch) on one
NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, nvcc and nvidia-smi, and imports nothing of JAX. Phases (any
failure exits non-zero):

1. build the smoother kernels from afivo_streamer_tpu_torch/csrc (one nvcc
   per source, started together);
2. hold each kernel (2D: K1 fill_sweep_2d, K2 sweep_2d, K3 fill_2d,
   K3-swap fill_2d_swap; 3D: K4 sweep_3d, K5 fill_3d) against its plain
   PyTorch version on the card at the slices' shapes (n = 4096 boxes,
   nc = 8, random ghost weights with the parity-swap columns nonzero) in
   float64 and float32, and time both: wall (CUDA events around 50
   back-to-back calls), device time (the device events under
   torch.profiler) with a warm L2 (the same inputs every call) and with a
   cold one (the inputs taken in turn from copies that hold four times
   the L2), the host's enqueue time per call, and each kernel's bound
   (ops/smoother.min_bytes over the memory rate) and share of it;
2c. every kernel against its plain version at the box sizes past 48 KB of
   shared memory, nc = 32 and nc = 64 (K1 and K3 opt in past 48 KB; K2
   and K5 past 48 KB take kernels that stage less), in float64
   and float32, at n = 3 and n = 33 boxes, then each timed at nc = 32 and
   n = 4096 as in phase 2 (cold from two input sets: one holds more than
   the L2);
3. run the committed 2D slice config on the card and on the CPU (plain
   kernels) at 64 x 64 cells for 3 steps and compare the states; 3b. the
   same for the 3D slice config at 32^3 cells; 3c. the dielectric slice
   with live refinement (52,480 cells on 6 levels) for 8 steps: the same
   mesh at every refinement epoch, the densities, phi and the surface
   charge, and K3-swap launched; 3d, 3e. the cylindrical and the 3D slice
   with live refinement and Helmholtz photoionization (16,960 cells on 6
   levels for 4 steps; 219,136 cells on 4 levels for 4 steps;
   photoionization every 2 steps): the same mesh at every epoch, one of
   which removes boxes, the same FMG cycle count of every Helmholtz mode
   at every update, and every variable;
4. run the full-size 2D slice (uniform 512 x 512 cells, 5460 boxes,
   float64, 5 steps) through Simulation/run, counting the kernel launches,
   then time K1 and K3 on its finest level (4096 boxes) with that level's own
   tables and inputs, each held against its plain version there;
5. run the full-size 3D slice (uniform 128^3 cells, 4680 boxes, float64,
   5 steps) the same way, then time K5 on its finest level (4096
   boxes);
6. run the dielectric slice at the card's size (uniform level 6 and
   refinement to level 8 around the seed and in the regions, live, 6
   steps) the same way, with the time of each refinement epoch and of the
   host plan rebuilds, and the device busy share of two more steps, then
   time K3-swap on its largest level that runs it;
7. the main path at full size: the cylindrical slice with live refinement
   (a uniform level 6, 262,144 cells, refined to level 8 around the seed
   and in a region that expires) and Helmholtz photoionization every 5
   steps, 6 steps, with the time of each step, refinement epoch and
   photoionization update, the FMG cycles of each mode, the launches of
   each kernel in the run and inside the updates, the V-cycle time of the
   field solve and of a Helmholtz mode, and the device busy share; then
   (2b) K1, K2 and K3 held against their plain versions and timed on the
   finest and on the largest level of the Helmholtz mode with the largest
   lambda, with that mode's own stencil, ghost weights and inputs;
8. the 3D slice with live refinement (a uniform level 4, 128^3 cells,
   refined to level 6) and photoionization, 6 steps, the same way, then
   (2b) K4 and K5 on the finest and the largest level of that mode;
3f-3h. the fluid-model variants on the card and on the CPU at the committed
   sizes: the planar 1D slice (air_1d_slice.cfg, live refinement) under the
   local field approximation and under the electron energy equation (ee53,
   new-style table) for 16 steps, and the cylindrical slice under ee53
   (air_cyl_ee_slice.cfg, live refinement and photoionization every 2
   steps) for 4 steps: the same mesh at every epoch, the same FMG cycles,
   every variable; 3i. the physics of the energy equation on the card: the
   1D slice without a seed in its uniform field to 0.3 ns, where the mean
   energy in mid-domain must relax to the table's value at the local
   reduced field within 5 %, the energy density stay >= 0 and the
   energy-loss time-step limit be active;
9. the main path under ee53 at full size: air_cyl_ee_slice.cfg with phase
   7's refinement flags, 6 steps: K1, K2 and K3 launched, the energy
   density finite, a finite energy-loss time-step limit, the four limits,
   how many attempted steps each limit held, and the launches per step.
   (With a seed the model itself, in both packages, drives the energy
   density below zero in cells at the seed's edge, where the electron flux
   runs against the drift and the Joule term is a loss: the run reports
   the smallest value and the share of such leaf cells, and phase 3i holds
   the sign where the model keeps it);
10. the planar 1D slice at a size a user would run (uniform 1 um cells,
   16,384 of them on 11 levels) under ee53 for 10 steps. One dimension has
   no kernel in either package: its smoother is tensor operations, so this
   phase launches none.
2 (level set). K1, K2 and K4 once more against their plain versions, and
   timed, on the inputs an electrode gives them: the stencil blocks cs and
   the factor of the boundary potential in R from the real operator of a
   4096-box level that a rod electrode runs through (neighbor coefficients
   0 toward the electrode and up to 1e4 times the plain ones beside it), the
   level's own neighbor table and ghost weights; K3 and K5 are then held
   against their plain versions on the blocks those sweeps produce;
3j-3l. the electrode slices on the card and on the CPU at the committed
   sizes: the Cartesian rod as cathode (electrode_2d_slice.cfg with the
   field reversed), the cylindrical needle with photoionization
   (electrode_cyl_slice.cfg) and the 3D rod (electrode_3d_slice.cfg): the
   same mesh at every epoch, the same dt at every attempted step, the same
   FMG and V-cycle counts of the field solves, every variable;
11. the cylindrical needle at full size (phase 7's refinement limits, the
   electrode resolved to the finest level, 6 steps): ms per step, seconds
   per epoch and the host seconds spent on the level set's distances,
   V-cycles per field solve, launches per step of K1-K3, max(E) at the tip
   against the background field; then (2b) K1 and K2 on the finest level
   that holds the electrode's boundary;
12. the 3D rod at full size (a uniform level 4, 128^3 cells, the rod's
   boundary boxes on level 5), 4 steps, the same for K4 and K5.
2 (eps). K4 and K5 once more against their plain versions, and timed, on
   a real 3D variable-eps level of 4096 boxes (an eps = 2 slab, refinement
   boundaries at boxes with variable eps: the stencil, ghost weights and
   the extrapolating ghost's constants), and K2 and K3-swap on a 2D one
   that also holds a rod's level set;
3m-3p. the field solver's last branches on the card and on the CPU at the
   committed sizes: the cylindrical dielectric with photoionization
   (dielectric_cyl_slice.cfg), the 3D slab (dielectric_3d_slice.cfg), the
   needle above the plate (electrode_dielectric_cyl_slice.cfg) and a
   256 x 256-cell level-1 grid (the uniform coarse multigrid): as 3j-3l,
   and the surface data per surface, the V-cycles of every coarse-grid
   solve and the kernels of each path launched (K3-swap on the pair);
3q. the IMEX integrators on the stiff reaction-diffusion problem
   (programs/reaction_diffusion.py) at 32^2 and 512^2 cells: the bounds of
   tests/test_imex.py against the solution, the FMG cycles per implicit
   solve, the K1-K3 launches, and the card against the CPU;
13. the 3D slab at full size (phase 8's refinement limits), 4 steps: ms
   per step, seconds per epoch, the surfaces, V-cycles per field solve,
   K4/K5 launches per step; then (2b) K4 and K5 on the finest
   variable-eps level;
14. the needle above the plate at full size (phase 11's refinement
   limits), 10 steps: the same, K3-swap launches per step, the surface
   charge and max(E) at the tip; then (2b) K2 and K3-swap on the finest
   level with the level set and extrapolating ghosts of eps;
3r, 3s. gas dynamics and a varying gas density on the card and on the CPU
   at the committed sizes, 6 steps each, photoionization every 2 steps:
   gas_heating_cyl_slice.cfg (the Euler equations of the gas, Joule
   heating and the EHD force) plain, with slow heating
   (-gas%fraction_slow_heating=0.3) and from a pre-heated channel on the
   axis (programs/heated_channel.py), and gas_channel_cyl_slice.cfg (the
   main path in a channel of half the density, programs/gas_density_2d.py):
   the same mesh at every epoch, dt at every attempted step, cycle counts,
   every variable, and the gas's increments over its initial state (which
   are about 1e-10 of the state itself) against their own scale;
15. the heated main path at full size: gas_heating_cyl_slice.cfg with
   phase 7's refinement flags, 6 steps: ms per step, the host seconds of
   the gas advance and the coupling per step, the gas dt limit against the
   plasma's dt, V-cycles per field solve, K1-K3 launches per step, peak
   memory, the Joule energy deposited and the largest temperature rise
   p / (N k_B) - T0; then (2b) K1, K2 and K3 on the finest level.
3t. the programs with the stock writers (the text log, the grid files, the
   chemistry files) on the card and on the CPU at the committed sizes:
   (a) air_cyl_amr_slice.cfg under programs/velocity_control_2d.py (both
   simulations past 1 ns, so that the controller acts; photoionization
   every 2 steps) for 4 steps, (b) comparison_air_2d.cfg (potential_bc: the
   tabulated electrode potentials in the ghost constants A) for 8 steps,
   (c) stability_3d.cfg (field_amplitude from the streamer's z-extent) for
   4 steps: the same mesh at every epoch, dt at every attempted step, the
   (FMG, V-cycle) counts of every field solve, every recorded hook call,
   every variable within 1e-9 of its scale, every written file
   (io/compare.py) within 1e-8 (the last of the 9 digits the text files
   print), K1-K3 launched in (a) and (b), K4-K5 in (c);
16. the stock writers on the main path at phase 7's size, under
   velocity_control_2d with output%dt = 0.15 ps (3 outputs in 6 steps):
   ms per step against phase 7's, seconds per output of the log, the grid
   file and the chemistry files (synchronised), the grid file's bytes, the
   hooks' host ms per step, V-cycles per field solve, K1-K3 launches per
   step against phase 7's and inside the writers and hooks (none), peak
   memory; fails if a writer wrote nothing. It runs just before phase 7.
3u. Monte-Carlo photoionization (photoi%method = montecarlo, physical
   photons off, 20,000 photons every 2 steps) on the card and on the CPU:
   air_cyl_amr_slice.cfg for 4 steps, air_3d_amr_slice.cfg for 4 and
   dielectric_cyl_slice.cfg with both photoemission coefficients 0.1 for 6
   (photons absorbed on the surfaces): as 3m-3p, with the surfaces' photon
   fluxes among the surface data; the photons come from one NumPy stream
   on the host, so the card's and the CPU's runs make the same ones;
3v. checkpoints and restart on the card: air_cyl_amr_slice.cfg for 8 steps
   on the card and on the CPU with a checkpoint at every output; runs
   restarted from the first checkpoint between two epochs (on the card
   from the card's and from the CPU's, on the CPU from the card's) end with
   the uninterrupted run's mesh, time, dt and state within 1e-9;
3w. the opt-in writers on the card and on the CPU, every file held by
   io/compare.py within 1e-8: on air_cyl_amr_slice.cfg the uniform-grid
   npz with the extra variables, the VTK grid, the checkpoints, the line,
   the plane, the cross sections, the field maxima and the power density;
   the mean energy on air_cyl_slice.cfg with the new-style table; the
   surfaces' data on the cylindrical dielectric; the 3D slice's npz, VTK,
   plane, line and checkpoints;
17. the Monte-Carlo main path at full size: phase 7's configuration and
   flags with photoi%method = montecarlo at the default 5,000,000 photons
   per update (physical photons off), 6 steps: ms per step and the busy
   share, photons per update, ms per update split into the host's
   generation and flight, the locate, the copy to the card, the deposit and
   the prolongation, peak device and host memory, K1-K3 launches per step;
   then one checkpoint of the final state written and read back onto the
   card (seconds, bytes, the state restored exactly). It runs after phase
   15; after phase 7 a line sets its ms per update beside phase 7's
   Helmholtz updates.
3x. the sharded run (parallel/, -compiled%enabled=T -compiled%shards=N)
   with its ranks sharing the card over gloo: air_cyl_amr_slice.cfg at
   the committed size (16,960 cells) with a field that rises over 0.3 ps,
   so that an epoch adds boxes, over 2 and over 4 ranks for 8 steps, and
   air_3d_amr_slice.cfg (219,136 cells) over 2 ranks for 2 steps, the
   three started together, each against the unsharded card run: the same
   mesh at every epoch, dt at every attempted step, (FMG, V-cycle) counts
   and FMG cycles per mode, every variable within 1e-12 of its scale (and
   whether bit for bit), the regression logs at rtol 1e-8, atol 1e-10,
   K1-K3 (K4-K5) launched on every rank, each rank's rows, cells and
   exchanges; the 2-rank run's ranks also probe which gloo collectives take
   CUDA tensors (the port passes them to every collective). The branches
   that ran unsharded only before (SHARDED_BRANCHES: the cylindrical needle
   electrode, the cylindrical dielectric on 8 x 16 coarse boxes, where some
   surfaces' two boxes lie on two ranks, the velocity_control_2d program's
   hooks, Monte-Carlo photoionization) over 2 ranks against their
   unsharded card runs the same way, with each rank's exchanges (calls,
   bytes, host ms) per step;
3z. the committed cylindrical and 3D slices with live refinement at
   -box_size=32, the coarse grid of two boxes a side as committed (64^2
   and 64^3 cells; the 3D one with a refinement region of 1.25e-4 m, so
   that an epoch changes its mesh), on the card and on the CPU as 3d and
   3e: the same meshes, dts and cycle counts, every variable within 1e-9;
18. the sharded main path at full size: phase 7's configuration and flags
   over 2 ranks sharing the card, 6 steps: ms per step against phase 7's,
   each rank's leaf cells, rows, K1-K3 launches per step, halo exchanges
   and level gathers per step (calls, bytes, host ms), peak device memory
   and the device busy share of two more steps. It runs last.
3y. the compiled engine's float32 state (-compiled%enabled=T
   -compiled%dtype=float32; the setup runs in float64, as the JAX
   package's host path runs it, and the first step casts the state) at the
   committed sizes: air_cyl_amr_slice.cfg and air_3d_amr_slice.cfg with
   refinement frozen, photoionization every 2 steps, 4 steps each, on the
   card against the CPU (every variable within 1e-4 of its scale, rhs on
   the leaves) and against the card's float64 run (the regression log's
   observables within 1e-3), every launch of the run float32; then the
   cylindrical slice with live refinement in float32 and in float64 on the
   card, whether the meshes are the same (reported);
19. the main path at full size in float32: phase 7's flags and the
   float32 state, 6 steps, right after phase 7: ms per step against phase
   7's, seconds per epoch, ms per photoionization update, FMG and V-cycle
   counts, K1-K3 float32 launches per step, peak memory and memory in use
   against phase 7's, the busy share; it fails unless every launch of the
   run is float32, the state float32 and the regression log's observables
   after the run within 1e-2 of phase 7's (the JAX package's limit for its
   live-refinement float32 run, tests/test_tpu_hardware.py:110-135); the
   meshes are reported. Then (2b) K1, K2 and K3 in float32 on the finest
   and the largest level of the Helmholtz mode with the largest lambda,
   held against their plain versions (tolerance 2e-5) and timed.
The cuda-vs-cpu phases 3 to 3z run right after phase 2c in five worker
processes (WORKER_GROUPS: this script with ``--worker K``, WORKER_THREADS
threads each), together and beside phase 3x's ranks; each worker's log
is printed when it ends. Every measurement (phases 2 and 4 to 19) runs
alone on the card. Phases 9 to 15 and 17 run after phase 3x and before
phase 4: after the long profiler traces of phases 6 to 8 the host has been
seen to run slower for the rest of the process. Phases 3e, 3h and the
cylindrical run of 3u take 4 steps, so that the script stays well within
its time.

The launch counts are set to 0 just before each full-size run and read
just after it. The line before the last is a JSON object with one entry
per kernel (``ms`` and ``plain_ms`` are the cold float64 device times;
``launches`` is the count of the main path's run, phase 7 for the 2D
kernels and phase 8 for the 3D ones, K3-swap's that of phase 6, and
``launches_by_phase`` holds every full-size run's, those of phases 9 and
11 to 19 among them (phase 19's are float32 launches), and phase 3x's; a
sharded phase's count is summed over its runs and ranks);
the last line is ``{"ok": true, "device": {...}}``.
"""

import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
CFG = {2: DATA / "air_cyl_slice.cfg", 3: DATA / "air_3d_slice.cfg"}
DIELECTRIC_CFG = DATA / "dielectric_2d_slice.cfg"
USER_MODULE = ROOT / "afivo_streamer_tpu_torch" / "programs" / "dielectric_2d.py"
TABLE = DATA / "td_air_synthetic.txt"
#: the new-style table with its mean-energy block, and the flags that put
#: a configuration under the electron energy equation on it
TABLE_NEW = DATA / "td_air_synthetic_new.txt"
EE_FLAGS = ["-model%type=ee53", "-input_data%old_style=f"]
ONED_CFG = DATA / "air_1d_slice.cfg"
EE_CFG = DATA / "air_cyl_ee_slice.cfg"
#: cuda-vs-cpu runs of the fluid-model variants (phases 3f-3h): phase,
#: config, ndim, table, flags, steps
VARIANTS_SMALL = [
    ("3f", ONED_CFG, 1, TABLE, [], 16),
    ("3g", ONED_CFG, 1, TABLE_NEW, EE_FLAGS, 16),
    ("3h", EE_CFG, 2, TABLE_NEW, ["-photoi%per_steps=2"], 4)]
#: the electrode slices; cuda-vs-cpu runs (phases 3j-3l) in the form of
#: VARIANTS_SMALL, and at the card's size (phases 11, 12): config, ndim,
#: flags, steps, least leaf cells
ELECTRODE_CFG = {"2d": DATA / "electrode_2d_slice.cfg",
                 "cyl": DATA / "electrode_cyl_slice.cfg",
                 "3d": DATA / "electrode_3d_slice.cfg"}
ELECTRODES_SMALL = [
    ("3j", ELECTRODE_CFG["2d"], 2, TABLE, ["-field_given_by=field 1.8e6"], 8),
    ("3k", ELECTRODE_CFG["cyl"], 2, TABLE, ["-photoi%per_steps=2"], 6),
    ("3l", ELECTRODE_CFG["3d"], 3, TABLE, [], 4)]
ELECTRODES_FULL = {
    "11": (ELECTRODE_CFG["cyl"], 2,
           ["-refine_max_dx=3.2e-5", "-refine_min_dx=4e-6",
            "-refine_electrode_dx=8e-6", "-refine_regions_dr=7.8125e-6"],
           6, 512 ** 2),
    "12": (ELECTRODE_CFG["3d"], 3,
           ["-refine_max_dx=1.25e-4", "-refine_min_dx=6e-5",
            "-refine_electrode_dx=6.3e-5", "-refine_regions_dr=6.25e-5"],
           4, 128 ** 3),
    # the field solver's last branches at the card's size: the 3D slab
    # with phase 8's refinement limits, the needle above the plate with
    # phase 11's
    "13": (DATA / "dielectric_3d_slice.cfg", 3,
           ["-refine_max_dx=1.25e-4", "-refine_min_dx=3.125e-5",
            "-refine_regions_dr=3.125e-5", f"-user%module={USER_MODULE}"],
           4, 128 ** 3),
    "14": (DATA / "electrode_dielectric_cyl_slice.cfg", 2,
           ["-refine_max_dx=3.2e-5", "-refine_min_dx=4e-6",
            "-refine_electrode_dx=8e-6", "-refine_regions_dr=7.8125e-6",
            f"-user%module={USER_MODULE}"], 10, 512 ** 2)}
#: cuda-vs-cpu runs of the field solver's last branches (phases 3m-3p) in
#: the form of VARIANTS_SMALL, with the kernels that must be launched
BRANCHES_SMALL = [
    ("3m", DATA / "dielectric_cyl_slice.cfg", 2, TABLE,
     ["-photoi%per_steps=2", f"-user%module={USER_MODULE}"], 6,
     ("fill_2d_swap",)),
    ("3n", DATA / "dielectric_3d_slice.cfg", 3, TABLE,
     [f"-user%module={USER_MODULE}"], 6, ("sweep_3d", "fill_3d")),
    ("3o", DATA / "electrode_dielectric_cyl_slice.cfg", 2, TABLE,
     ["-photoi%per_steps=2", f"-user%module={USER_MODULE}"], 6,
     ("sweep_2d", "fill_2d_swap")),
    # one level: the uniform coarse multigrid solves it and K3 fills it
    ("3p", DATA / "air_cyl_slice.cfg", 2, TABLE,
     ["-cylindrical=f", "-coarse_grid_size=256 256"], 4, ("fill_2d",))]
#: gas dynamics and a varying gas density (phases 3r, 3s, 15): the
#: configurations, their table (a new-style table with a reaction list over
#: N2, O2 and M, which a varying density needs), and the cuda-vs-cpu runs
#: in the form of VARIANTS_SMALL
PROGRAMS = ROOT / "afivo_streamer_tpu_torch" / "programs"
GAS_CFG = DATA / "gas_heating_cyl_slice.cfg"
TABLE_REACTIONS = DATA / "td_air_synthetic_reactions.txt"
GAS_SMALL = [
    ("3r", GAS_CFG, 2, TABLE_REACTIONS, ["-photoi%per_steps=2"], 6),
    ("3r", GAS_CFG, 2, TABLE_REACTIONS,
     ["-photoi%per_steps=2", "-gas%fraction_slow_heating=0.3"], 6),
    ("3r", GAS_CFG, 2, TABLE_REACTIONS,
     ["-photoi%per_steps=2", f"-user%module={PROGRAMS / 'heated_channel.py'}"],
     6),
    ("3s", DATA / "gas_channel_cyl_slice.cfg", 2, TABLE_REACTIONS,
     ["-photoi%per_steps=2", f"-user%module={PROGRAMS / 'gas_density_2d.py'}"],
     6)]
GAS_FULL_STEPS = 6
#: Monte-Carlo photoionization without physical photons (phases 3u, 17):
#: the cuda-vs-cpu runs in the form of BRANCHES_SMALL, 20,000 photons per
#: update; phase 17 at the default 5,000,000
MC_FLAGS = ["-photoi%method=montecarlo", "-photoi_mc%physical_photons=f"]
MC_SMALL = [
    ("3u", DATA / "air_cyl_amr_slice.cfg", 2, TABLE,
     MC_FLAGS + ["-photoi_mc%num_photons=20000", "-photoi%per_steps=2"], 4,
     ("fill_sweep_2d", "sweep_2d", "fill_2d")),
    ("3u", DATA / "air_3d_amr_slice.cfg", 3, TABLE,
     MC_FLAGS + ["-photoi_mc%num_photons=20000", "-photoi%per_steps=2"], 4,
     ("sweep_3d", "fill_3d")),
    ("3u", DATA / "dielectric_cyl_slice.cfg", 2, TABLE,
     MC_FLAGS + ["-photoi_mc%num_photons=20000", "-photoi%per_steps=2",
                 "-dielectric%gamma_se_ph_highenergy=0.1",
                 "-dielectric%gamma_se_ph_lowenergy=0.1",
                 f"-user%module={USER_MODULE}"], 6, ("fill_2d_swap",))]
#: phase 3z: the slices with live refinement at -box_size=32, in the form
#: of BRANCHES_SMALL; the coarse grid is two boxes a side, as committed
BOX32_SMALL = [
    ("3z", DATA / "air_cyl_amr_slice.cfg", 2, TABLE,
     ["-photoi%per_steps=2", "-box_size=32", "-coarse_grid_size=64 64"], 4,
     ("fill_sweep_2d", "sweep_2d", "fill_2d")),
    ("3z", DATA / "air_3d_amr_slice.cfg", 3, TABLE,
     ["-photoi%per_steps=2", "-box_size=32", "-coarse_grid_size=64 64 64",
      "-refine_regions_dr=1.25e-4"], 4, ("sweep_3d", "fill_3d"))]
#: phase 2c: the box sizes, the box counts of the checks, and the box size
#: and count of the timings
BOX_SIZES, BOX_COUNTS, BOX_TIMED = (32, 64), (3, 33), (32, 4096)
#: the IMEX problem (phase 3q): uniform meshes (level-1 cells a side, level)
#: and the runs of tests/test_imex.py (integrator, dt, steps)
IMEX_MESHES = ((16, 2), (16, 6))
IMEX_RUNS = (("imex_euler", 2.0e-3, 10), ("imex_euler", 1.0e-3, 20),
             ("imex_trapezoidal", 2.0e-3, 10))
#: the rod of phase 2's level-set inputs, in a 16 mm domain: from the top
#: plate down to 0.2 of the height, 0.4 mm radius, its lower end 0.37 mm
#: off the axis (tilted, its surface passes the cell centres at every
#: distance); and the boundary potential in R
LSF_ROD = (1.0, 0.2, 4e-4, 0.37e-3)
LSF_PHI_B = 2.88e4
#: the rod of phase 2's eps inputs in 2D: down to 0.28 of the height, just
#: above the slab, 0.6 mm left of the middle, its lower end tilted
EPS_ROD = (1.0, 0.28, 4e-4, 0.37e-3)
#: the main path under ee53 at the card's size (phase 9): steps
EE_FULL_STEPS = 6
#: the 1D slice at a user's size (phase 10): flags and steps
ONED_FULL = (["-refine_max_dx=1e-6", "-refine_min_dx=1e-6"], 10)
DT_LIMIT_NAMES = ("cfl", "drt", "chem", "energy loss")
#: the compiled engine's float32 state (phases 3y and 19)
F32_FLAGS = ["-compiled%enabled=T", "-compiled%dtype=float32"]
#: phase 3y: steps of each run, and its limits: the card against the CPU
#: in float32 (each variable's deviation over its scale), the card's
#: float32 run against its float64 run (the regression log's observables)
F32_SMALL_STEPS = 4
F32_CPU_TOL, F32_F64_RTOL = 1e-4, 1e-3
#: phase 19: the regression log's observables against phase 7's (the JAX
#: package's limit for its live-refinement float32 run against float64,
#: tests/test_tpu_hardware.py:110-135), and phase 7's peak memory of PR 13
F32_MAIN_RTOL = 1e-2
P7_PEAK_GB = 0.338
SOURCE = {2: "afivo_streamer_tpu_torch/csrc/smoother.cu",
          3: "afivo_streamer_tpu_torch/csrc/smoother_3d.cu"}
REPLACES = {"fill_sweep_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:397",
            "sweep_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:229",
            "fill_2d": "afivo_streamer_tpu/ops/pallas_smoother.py:302",
            "fill_2d_swap": "afivo_streamer_tpu/ops/pallas_smoother.py:276",
            "sweep_3d": "afivo_streamer_tpu/ops/pallas_smoother.py:574",
            "fill_3d": "afivo_streamer_tpu/ops/pallas_smoother.py:637"}
N_BOXES, NC = 4096, 8
#: kernel vs plain tolerance: float64 to rounding (the kernel may fuse a
#: multiply-add), float32 to its own rounding
TOL = {"float64": 1e-12, "float32": 2e-5}
#: the parity-swap fill is held to float32 1e-5
TOL_SWAP_F32 = 1e-5
SMALL_STEPS = 3
#: full-size runs per dimension: refine_max_dx, leaf cells, boxes, steps
FULL = {2: (3.2e-5, 512 ** 2, 5460, 5), 3: (1.25e-4, 128 ** 3, 4680, 5)}
#: the kernels of each full-size run's path (phases 4, 5 and 6)
PATH_KERNELS = {2: ("fill_sweep_2d", "sweep_2d", "fill_2d"),
                3: ("sweep_3d", "fill_3d"),
                "dielectric": ("fill_sweep_2d", "sweep_2d", "fill_2d",
                               "fill_2d_swap")}
#: the kernels timed on the finest level of each full-size frozen slice
#: (phases 4 and 5), with that level's own inputs
LEVEL_KERNELS = {2: ("fill_sweep_2d", "fill_2d"), 3: ("fill_3d",)}
#: the cuda-vs-cpu runs per dimension: refine_max_dx and a label
SMALL = {2: (2.5e-4, "64x64"), 3: (5e-4, "32^3")}
#: the dielectric slice: steps on the card and the CPU (phase 3c), and the
#: card's size (phase 6): overrides and steps
DIELECTRIC_SMALL_STEPS = 8
DIELECTRIC_FULL = (["-refine_max_dx=3.2e-5",
                    "-refine_regions_dr=7.8125e-6 7.8125e-6",
                    "-refine_min_dx=4e-6"], 6)
#: the slices with live refinement and photoionization per dimension:
#: config, steps of the cuda-vs-cpu run (phases 3d, 3e; photoionization
#: every 2 steps there), and at the card's size (phases 7, 8) the
#: overrides, the steps and the least leaf cells (the frozen slice's)
AMR_CFG = {2: DATA / "air_cyl_amr_slice.cfg", 3: DATA / "air_3d_amr_slice.cfg"}
AMR_SMALL_STEPS = {2: 4, 3: 4}
AMR_FULL = {2: (["-refine_max_dx=3.2e-5", "-refine_min_dx=4e-6",
                 "-refine_regions_dr=7.8125e-6"], 6, 512 ** 2),
            3: (["-refine_max_dx=1.25e-4", "-refine_min_dx=3.125e-5",
                 "-refine_regions_dr=3.125e-5"], 6, 128 ** 3)}
BACKGROUND_FIELD = 1.8e6  # V/m, the configs' field_given_by
#: the H100 SXM's device memory rate and its peak rates outside the tensor
#: cores (NVIDIA's data sheet, at the full 700 W), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
#: a cold-L2 timing takes its inputs in turn from copies that together
#: hold at least this many bytes (four times the 50 MB L2), and at least
#: this many copies
COLD_BYTES, COLD_MIN_SETS = 200e6, 8
#: spin kernels that open and close each profiled window, doubled with
#: every retry (see device_us)
PAD_SPINS = 8
#: why no PyTorch call serves as a kernel's yardstick (library_ms is null)
NO_LIBRARY_CALL = {
    "sweep": "a red-black update with per-cell coefficients",
    "fill": "a gather of neighbor blocks by a table summed with per-box "
            "weights"}


#: a worker's log counts from its parent's start (perf_counter reads the
#: system's monotonic clock, the same in every process)
T_START = float(os.environ.get("CHIP_SMOKE_T0", time.perf_counter()))


def log(msg):
    """A line of the log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def kernel_inputs(torch, dtype, device, seed, ndim):
    """Random blocks at the slices' shapes, a neighbor table with random
    self-rows, and a stencil with |c0| >= 1."""
    gen = torch.Generator().manual_seed(seed)
    n, nc, C = N_BOXES, NC, NC + 2
    nd = 2 * ndim
    cube = (nc,) * ndim

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)
    g = torch.empty((n, 1 + nd), dtype=torch.int32)
    g[:, 0] = torch.arange(n, dtype=torch.int32)
    g[:, 1:] = torch.randint(0, n, (n, nd), generator=gen, dtype=torch.int32)
    selfrow = torch.rand((n, nd), generator=gen) < 0.25
    g[:, 1:][selfrow] = g[:, :1].expand(n, nd)[selfrow]
    cs = rnd(n, 2 + nd, *cube)
    cs[:, 0] = -(1.0 + torch.rand((n,) + cube, generator=gen,
                                  dtype=torch.float64))
    idx = torch.arange(1, nc + 1)
    parity = sum(torch.meshgrid(*[idx] * ndim, indexing="ij"))
    mask = ((parity % 2) == 1).to(torch.float32)
    x = {"phi3": rnd(n, *(C,) * ndim), "R": rnd(n, *cube),
         "A": rnd(n, nd, *(nc,) * (ndim - 1)), "W": rnd(n, nd, 8), "cs": cs}
    x = {k: v.to(dtype) for k, v in x.items()}
    x.update(mask=mask, g=g)
    return {k: v.to(device).contiguous() for k, v in x.items()}


def ndim_of(name):
    return int(re.search(r"_(\d)d", name).group(1))


def call(fn, x, name):
    if name in ("sweep_2d", "sweep_3d"):
        return fn(x["phi3"], x["R"], x["mask"], x["g"], x["cs"])
    if name in ("fill_2d", "fill_2d_swap", "fill_3d"):
        return fn(x["phi3"], x["A"], x["g"], x["W"])
    return fn(x["phi3"], x["R"], x["mask"], x["A"], x["g"], x["W"], x["cs"])


def time_ms(torch, fn, reps=50):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(torch, fns, reps=20, tries=10):
    """Device time per call in microseconds under torch.profiler (the
    device events only, no launch gaps) of max(reps, len(fns)) calls that
    take the callables ``fns`` in turn, after one warm-up pass over them:
    for each kernel in the trace, its mean duration times its launches per
    call (its count over the calls, at least 1). The profiler on the card
    drops events from a trace at times (after a long trace, the first few
    of every later one): PAD_SPINS spin kernels before and after the calls
    take that loss and are not counted. A trace that still holds less than
    three quarters of the launches so counted is taken again with twice
    the spin kernels (after the long trace of a 3D step the loss was 17
    events in every try), up to ``tries`` times (empty traces come in runs
    of up to three)."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    reps = max(reps, len(fns))
    for attempt in range(tries):
        pads = PAD_SPINS << min(attempt, 6)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pads):
                torch.cuda._sleep(1000)
            for i in range(reps):
                fns[i % len(fns)]()
            for _ in range(pads):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        dev = [(key, n, us) for key, (n, us) in device_events(torch, prof)
               if "spin_kernel" not in key]
        per_call = [max(1, round(n / reps)) for _key, n, _us in dev]
        seen = sum(n for _key, n, _us in dev)
        if dev and seen >= 0.75 * reps * sum(per_call):
            return sum(us / n * k for (_key, n, us), k in zip(dev, per_call))
        log(f"device time: the trace of {reps} calls holds "
            f"{[(key[:50], n) for key, n, _us in dev]}; tracing again")
        time.sleep(0.2)
    raise RuntimeError("torch.profiler dropped device events in every try")


def device_events(torch, prof):
    """(kernel name, (events, microseconds)) of the device events of a
    trace, read from the profiler's raw events: key_averages builds the
    tree of every event first, which took 31 s for a trace of two steps of
    the main path on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            n, us = out.get(e.name(), (0, 0.0))
            out[e.name()] = (n + 1, us + 1e-3 * e.duration_ns())
    return out.items()


def enqueue_us(torch, fn, reps=200):
    """Host time per call in microseconds of ``reps`` calls with no
    synchronise between them: what the wrapper costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def cold_sets(x, nbytes, min_sets=COLD_MIN_SETS):
    """Copies of the inputs ``x``, enough that one pass over them moves at
    least COLD_BYTES: called in turn, each call finds its inputs evicted
    from the 50 MB L2 by the calls since its last turn."""
    k = max(min_sets, math.ceil(COLD_BYTES / nbytes))
    return [{key: v.clone() for key, v in x.items()} for _ in range(k)]


def min_flops(name, n, nc):
    """Floating-point operations of kernel ``name`` on n boxes: 6 per side
    ghost (10 with the parity-swap terms) and, for a sweep, 3 nd + 4 per
    cell the red-black mask updates (half of them)."""
    ndim = ndim_of(name)
    nd = 2 * ndim
    flops = 0
    if name.startswith("fill"):
        flops += n * nd * nc ** (ndim - 1) * (10 if name == "fill_2d_swap"
                                               else 6)
    if "sweep" in name:
        flops += n * nc ** ndim // 2 * (3 * nd + 4)
    return flops


def measure(torch, ks, name, x, smi, min_sets=COLD_MIN_SETS):
    """The kernel ``name`` and its plain version on the inputs ``x``: wall
    time of 50 back-to-back calls (CUDA events), device time with a warm
    L2 (the same inputs every call) and with a cold L2 (cold_sets, at
    least ``min_sets`` input sets), host enqueue time, and the bound: the
    larger of min_bytes over the memory rate and min_flops over the peak
    rate of the dtype."""
    fn, plain = ks.KERNELS[name], ks.PLAIN[name]
    phi3 = x["phi3"]
    n, nc = phi3.shape[0], phi3.shape[-1] - 2
    dname = str(phi3.dtype).split(".")[1]
    nbytes = ks.min_bytes(name, n, nc, phi3.dtype)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = min_flops(name, n, nc) / PEAK_FLOPS[dname]
    sets = cold_sets(x, nbytes, min_sets)
    r = {"bytes": nbytes, "bound_us": 1e6 * max(by_bytes, by_ops),
         "bound_by": "bytes" if by_bytes >= by_ops else "operations",
         "sets": len(sets),
         "wall_ms": time_ms(torch, lambda: call(fn, x, name)),
         "plain_wall_ms": time_ms(torch, lambda: call(plain, x, name)),
         "warm_us": device_us(torch, [lambda: call(fn, x, name)]),
         "plain_warm_us": device_us(torch, [lambda: call(plain, x, name)]),
         "cold_us": device_us(torch, [functools.partial(call, fn, s, name)
                                      for s in sets]),
         "plain_cold_us": device_us(torch, [
             functools.partial(call, plain, s, name) for s in sets]),
         "enqueue_us": enqueue_us(torch, lambda: call(fn, x, name))}
    # a cold time below the bound is a trace that lost or merged events
    # (seen once after the long traces of the full-size phases): measure
    # again, and fail if it persists
    for _ in range(2):
        if r["cold_us"] >= r["bound_us"]:
            break
        log(f"device time: {name} cold {r['cold_us']:.3f} us is below the "
            f"bound {r['bound_us']:.3f} us; measuring again")
        r["cold_us"] = device_us(torch, [functools.partial(call, fn, s, name)
                                         for s in sets])
    del sets
    r["share"] = r["bound_us"] / r["cold_us"]
    r["text"] = (
        f"{nbytes} bytes, bound {r['bound_us']:.3f} us (by {r['bound_by']}:"
        f" {HBM_BYTES_PER_S / 1e12} TB/s, {PEAK_FLOPS[dname] / 1e12:.0f} "
        f"TFLOP/s; {smi}); device cold {r['cold_us']:.3f} us ({r['sets']} "
        f"input sets), share of bound {r['share']:.3f}; device warm "
        f"{r['warm_us']:.3f} us; host enqueue {r['enqueue_us']:.2f} us per "
        f"call; plain cold {r['plain_cold_us']:.3f} us, warm "
        f"{r['plain_warm_us']:.3f} us; wall (CUDA events over 50 calls) "
        f"kernel {r['wall_ms']:.4f} ms plain {r['plain_wall_ms']:.4f} ms; "
        f"library call none (no single PyTorch call does "
        f"{NO_LIBRARY_CALL['sweep' if 'sweep' in name else 'fill']})")
    if r["share"] > 1.0:
        raise RuntimeError(f"{name} {dname}: the cold device time is below "
                           f"the memory bound: {r['text']}")
    return r


def check_against_plain(torch, ks, name, x):
    """Max abs deviation of the kernel from its plain version on ``x``,
    held to TOL (TOL_SWAP_F32 for K3-swap in float32) times the scale."""
    want = call(ks.PLAIN[name], x, name)
    got = call(ks.KERNELS[name], x, name)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1.0)
    dname = str(x["phi3"].dtype).split(".")[1]
    tol = (TOL_SWAP_F32 if name == "fill_2d_swap" and dname == "float32"
           else TOL[dname])
    text = f"max_abs_err={err:.3e} (tol {tol:.0e} x {scale:.3g})"
    if err > tol * scale:
        raise RuntimeError(f"{name} {dname} disagrees with its plain "
                           f"version: {text}")
    return err, text


def free_earlier_runs(torch):
    """Free the simulations of earlier phases (they hold reference
    cycles), so the next phase's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_kernels(torch, ks, smi):
    """Phase 2: every kernel against its plain version, float64 and
    float32, and its times (measure); returns per-kernel float64
    results."""
    results = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        xs = {nd: kernel_inputs(torch, dtype, "cuda", 20261016, nd)
              for nd in (2, 3)}
        for name in ks.KERNELS:
            x = xs[ndim_of(name)]
            err, err_text = check_against_plain(torch, ks, name, x)
            r = measure(torch, ks, name, x, smi)
            log(f"phase 2: {name} {dname} {err_text}; {r['text']}")
            if dtype == torch.float64:
                results[name] = dict(r, max_abs_err=err)
        free_earlier_runs(torch)
    return results


def box_inputs(torch, name, dtype, n, nc, seed):
    """Random inputs of kernel ``name`` (those it reads) on n boxes of
    nc^ndim cells, made on the card: as kernel_inputs, with a stencil with
    |c0| >= 1 and the red cells of a checkerboard."""
    ndim = ndim_of(name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nd, C = 2 * ndim, nc + 2
    cube = (nc,) * ndim

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device="cuda")
    g = torch.randint(0, n, (n, 1 + nd), generator=gen, dtype=torch.int32,
                      device="cuda")
    g[:, 0] = torch.arange(n, dtype=torch.int32, device="cuda")
    selfrow = torch.rand((n, nd), generator=gen, device="cuda") < 0.25
    g[:, 1:][selfrow] = g[:, :1].expand(n, nd)[selfrow]
    x = {"phi3": rnd(n, *(C,) * ndim), "g": g}
    if name.startswith("fill"):
        x.update(A=rnd(n, nd, *(nc,) * (ndim - 1)), W=rnd(n, nd, 8))
    if "sweep" in name:
        cs = rnd(n, 2 + nd, *cube)
        cs[:, 0] = -(1.0 + torch.rand((n,) + cube, generator=gen,
                                      dtype=dtype, device="cuda"))
        idx = torch.arange(1, nc + 1, device="cuda")
        parity = sum(torch.meshgrid(*[idx] * ndim, indexing="ij"))
        x.update(R=rnd(n, *cube), cs=cs,
                 mask=((parity % 2) == 1).to(torch.float32))
    return x


def phase_kernels_box_sizes(torch, ks, smi):
    """Phase 2c: every kernel against its plain version at nc in
    BOX_SIZES and n in BOX_COUNTS, float64 and float32, then timed at
    BOX_TIMED (measure; a cold time from two input sets, each larger than
    the L2). Returns {kernel: {dtype name: measure's result}}."""
    results = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for nc in BOX_SIZES:
            for n in BOX_COUNTS:
                errs = {}
                for name in ks.KERNELS:
                    x = box_inputs(torch, name, dtype, n, nc, 20261018 + n)
                    errs[name] = check_against_plain(torch, ks, name, x)[1]
                log(f"phase 2c: {dname} nc = {nc}, n = {n} against the plain "
                    f"versions: {errs}")
        nc, n = BOX_TIMED
        for name in ks.KERNELS:
            x = box_inputs(torch, name, dtype, n, nc, 20261019)
            err, err_text = check_against_plain(torch, ks, name, x)
            r = measure(torch, ks, name, x, smi, min_sets=2)
            del x
            log(f"phase 2c: {name} {dname} nc = {nc}, n = {n} {err_text}; "
                f"{r['text']}")
            results.setdefault(name, {})[dname] = dict(r, max_abs_err=err)
            free_earlier_runs(torch)
    return results


def lsf_level_inputs(torch, ndim, seed):
    """Kernel inputs at the slices' shapes on which everything an electrode
    changes is real: a uniform level of N_BOXES boxes (level 6 of the 2D
    domain, level 4 of the 3D one) that the rod LSF_ROD runs through, its
    multigrid operator's stencil blocks cs, the level's neighbor table g
    and ghost weights W, and R of the scale of L(phi) plus the boundary
    term f bc_coeff phi_b; phi3 and A stay random. Returns the inputs and
    a description of the stencil."""
    import numpy as np
    from afivo_streamer_tpu_torch.core import ghostcell as tgc
    from afivo_streamer_tpu_torch.core.levels import MeshPlans
    from afivo_streamer_tpu_torch.core.tree import Tree
    from afivo_streamer_tpu_torch.solvers.lsf import LsfData
    from afivo_streamer_tpu_torch.solvers.multigrid import Multigrid
    from afivo_streamer_tpu_torch.utils import geometry
    length = 16e-3
    lvl = {2: 6, 3: 4}[ndim]
    tree = Tree(ndim, NC, [length] * ndim, [16] * ndim)
    tree.refine_up_to_lvl(lvl)
    if len(tree.lvl_ids[lvl - 1]) != N_BOXES:
        raise RuntimeError(f"level {lvl} holds {len(tree.lvl_ids[lvl - 1])} "
                           f"boxes")
    mesh = MeshPlans(tree, "cuda")
    top, bottom, radius, tilt = LSF_ROD
    mid = [0.5 * length] * (ndim - 1)
    r0, r1 = np.array(mid + [top * length]), np.array(mid + [bottom * length])
    r1[0] += tilt

    def bc(iv, d, coords, params):
        return ((tgc.BC_DIRICHLET, 0.0) if d // 2 == ndim - 1
                else (tgc.BC_NEUMANN, 0.0))

    mg = Multigrid(mesh, 0, 1, bc)
    mg.lsf_data = LsfData(
        mesh, lambda r: geometry.dist_line(r, r0, r1) - radius,
        length_scale=radius)
    x = kernel_inputs(torch, torch.float64, "cuda", seed, ndim)
    sm = mg.smoother(lvl)
    cs, corr = mg.cs(lvl, torch.float64), mg.corr(lvl, torch.float64)
    plain = 2.0 * ndim / float(tree.lvl_dr(lvl)[0]) ** 2
    x.update(g=sm.g, W=sm.W(torch.float64), cs=cs.contiguous(),
             R=(x["R"] * plain + corr * LSF_PHI_B).contiguous())
    n_bnd = int(mg.lsf_data.level_data(lvl)["has_bnd"].sum())
    text = (f"level {lvl} of a {ndim}D mesh, {N_BOXES} boxes, {n_bnd} hold "
            f"the rod's boundary; max|c0| = "
            f"{float(cs[:, 0].abs().max()) / plain:.4g} times the plain "
            f"{plain:.4g}, {int((cs[:, 1:1 + 2 * ndim] == 0).sum())} neighbor "
            f"coefficients 0, max|c_sum| = "
            f"{float(cs[:, 1 + 2 * ndim].abs().max()):.4g}, phi_b = "
            f"{LSF_PHI_B:g} V")
    if n_bnd == 0 or not float(cs[:, 0].abs().max()) > 10 * plain:
        raise RuntimeError(f"no electrode boundary in the stencil: {text}")
    return x, text


def phase_kernels_level_set(torch, ks, smi):
    """Phase 2 (level set): the sweeping kernels K1, K2 and K4 against
    their plain versions, and timed, on lsf_level_inputs; then K3 and K5
    against theirs on the blocks K1 and K4 produced there. The tolerance
    is TOL of the largest magnitude of the result (the boundary potential
    sets it), as in phase 2."""
    for ndim, sweeps, fill in ((2, ("fill_sweep_2d", "sweep_2d"), "fill_2d"),
                               (3, ("sweep_3d",), "fill_3d")):
        t0 = time.perf_counter()
        x, text = lsf_level_inputs(torch, ndim, 20261017)
        log(f"phase 2 (level set): {text}; built on the host in "
            f"{time.perf_counter() - t0:.2f} s")
        for name in sweeps:
            _, err_text = check_against_plain(torch, ks, name, x)
            r = measure(torch, ks, name, x, smi)
            log(f"phase 2 (level set): {name} float64 {err_text}; "
                f"{r['text']}")
        swept = call(ks.KERNELS[sweeps[0]], x, sweeps[0])
        _, err_text = check_against_plain(torch, ks, fill,
                                          dict(x, phi3=swept))
        log(f"phase 2 (level set): {fill} float64 on the blocks "
            f"{sweeps[0]} produced: {err_text}")
        del x, swept
        free_earlier_runs(torch)


def eps_level_inputs(torch, ndim, seed):
    """Kernel inputs at the slices' shapes from a real variable-eps level:
    a 16 mm domain with an eps = 2 slab below y = 4 mm (the rule of
    programs/dielectric_2d.py, ``bottom``), refined uniformly to the level
    of 4096 boxes and then, for x below 8 mm and y below 8 mm (2D) or for
    x below 8 mm and y from 2 to 6 mm (3D), once more; the finer level has
    N_BOXES boxes, refinement boundaries at x = 8 mm and boxes with
    variable eps at them, which take the extrapolating ghost. In 2D the rod
    EPS_ROD of an electrode also runs through it. Returns the inputs of
    that level (its multigrid stencil cs, neighbor table g, ghost weights W
    and ghost constants A from a random potential, with the coarse level's
    parent copies; R of the scale of L(phi) plus the boundary term of the
    electrode) and a description."""
    import numpy as np
    from afivo_streamer_tpu_torch.core import ghostcell as tgc
    from afivo_streamer_tpu_torch.core.levels import MeshPlans
    from afivo_streamer_tpu_torch.core.tree import DO_REF, KEEP_REF, Tree
    from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
    from afivo_streamer_tpu_torch.solvers.lsf import LsfData
    from afivo_streamer_tpu_torch.solvers.multigrid import Multigrid
    from afivo_streamer_tpu_torch.utils import geometry
    length = 16e-3
    base = {2: 6, 3: 4}[ndim]
    lvl = base + 1
    ylim = {2: (0.0, 8e-3), 3: (2e-3, 6e-3)}[ndim]
    tree = Tree(ndim, NC, [length] * ndim, [16] * ndim)
    tree.refine_up_to_lvl(base)

    def flags(ids):
        r0 = tree.box_r_min(np.asarray(ids))
        inside = ((r0[:, 0] < 8e-3) & (r0[:, 1] >= ylim[0] - 1e-9)
                  & (r0[:, 1] < ylim[1] - 1e-9)
                  & (tree.lvl[np.asarray(ids)] == base))
        out = np.full((len(ids),) + (NC,) * ndim, KEEP_REF, np.int64)
        out[inside] = DO_REF
        return out
    tree.adjust_refinement(flags, ref_buffer=0)
    if len(tree.lvl_ids[lvl - 1]) != N_BOXES:
        raise RuntimeError(f"level {lvl} holds {len(tree.lvl_ids[lvl - 1])} "
                           f"boxes")
    mesh = MeshPlans(tree, "cuda")

    def bc(iv, d, coords, params):
        return ((tgc.BC_DIRICHLET, 0.0) if d // 2 == ndim - 1
                else (tgc.BC_NEUMANN, 0.0))

    mg = Multigrid(mesh, 0, 1, bc)
    mg.eps_data = lambda l: np.where(
        tree.boxes_cell_coords(tree.lvl_ids[l - 1])[..., 1] < 0.25 * length,
        2.0, 1.0).reshape(len(tree.lvl_ids[l - 1]), -1)
    if ndim == 2:
        top, bottom, radius, tilt = EPS_ROD
        r0 = np.array([0.5 * length - 0.6e-3, top * length])
        r1 = np.array([0.5 * length - 0.6e-3 + tilt, bottom * length])
        mg.lsf_data = LsfData(
            mesh, lambda r: geometry.dist_line(r, r0, r1) - radius,
            length_scale=radius)
    rng = np.random.default_rng(seed)
    cc = torch.as_tensor(rng.standard_normal(
        (2, tree.highest_id, (NC + 2) ** ndim)), device="cuda")
    P, R = mgb.gather_levels(mg, cc)
    sm = mg.smoother(lvl)
    dtype = torch.float64
    x = kernel_inputs(torch, dtype, "cuda", seed, ndim)
    cs = mg.cs(lvl, dtype)
    plain = 2.0 * ndim / float(tree.lvl_dr(lvl)[0]) ** 2
    Rl = R[lvl - 1] * plain
    corr = mg.corr(lvl, dtype)
    if corr is not None:
        Rl = Rl + corr * LSF_PHI_B
    x.update(phi3=P[lvl - 1].contiguous(), g=sm.g, W=sm.W(dtype),
             cs=cs.contiguous(), R=Rl.contiguous(),
             A=mgb.build_A_blocks(mg, lvl, P[lvl - 2], {}, dtype))
    n_extrap = sum(int(m.sum()) for m in sm.rb_extrap if m is not None)
    veps = int(mg.op(lvl).veps.sum())
    n_bnd = (0 if mg.lsf_data is None
             else int(mg.lsf_data.level_data(lvl)["has_bnd"].sum()))
    text = (f"level {lvl} of a {ndim}D mesh, {N_BOXES} boxes, {veps} with "
            f"variable eps, {n_extrap} extrapolating ghost faces (K3-swap: "
            f"{sm.has_swap}), {n_bnd} boxes hold a rod's boundary; c0 from "
            f"{float(cs[:, 0].min()):.4g} to {float(cs[:, 0].max()):.4g} "
            f"(plain -{plain:.4g})")
    if not n_extrap or (ndim == 2 and not (sm.has_swap and n_bnd)):
        raise RuntimeError(f"not a variable-eps level: {text}")
    return x, text


def phase_kernels_eps(torch, ks, smi):
    """Phase 2 (eps): K4 and K5 against their plain versions, and timed, on
    a real 3D variable-eps level (eps_level_inputs), and K2 and K3-swap on
    a real 2D level with a level set and eps; the tolerance is TOL of the
    largest magnitude of the result, as in phase 2."""
    for ndim, names in ((3, ("sweep_3d", "fill_3d")),
                        (2, ("sweep_2d", "fill_2d_swap"))):
        t0 = time.perf_counter()
        x, text = eps_level_inputs(torch, ndim, 20261018)
        log(f"phase 2 (eps): {text}; built on the host in "
            f"{time.perf_counter() - t0:.2f} s")
        for name in names:
            _, err_text = check_against_plain(torch, ks, name, x)
            r = measure(torch, ks, name, x, smi)
            log(f"phase 2 (eps): {name} float64 {err_text}; {r['text']}")
        del x
        free_earlier_runs(torch)


def time_on_level(torch, ks, mgb, sim, name, lvl, phase, smi, mg=None,
                  what="the field solve"):
    """The kernel ``name`` held against its plain version and timed on
    level ``lvl`` of the multigrid ``mg`` (the simulation's field solve by
    default), with what a V-cycle hands it there: the level's blocks phi3,
    ghost constants A and tables g and W, and for a sweep its rhs R,
    stencil cs and the mask of the second half sweep (the first that K1
    does), R with the boundary term of an electrode; after the run's
    launch counts were read."""
    mg = mg or sim.field.mg
    P, R = mgb.gather_levels(mg, sim.cc)
    sm = mg.smoother(lvl)
    dtype = P[0].dtype
    params = sim.field.solve_params()
    A = mgb.build_A_blocks(mg, lvl, P[lvl - 2] if lvl > 1 else None, params,
                           dtype)
    x = {"phi3": P[lvl - 1], "A": A, "g": sm.g, "W": sm.W(dtype)}
    if "sweep" in name:
        x.update(R=mgb.rhs_with_boundary(mg, lvl, R[lvl - 1],
                                         params).contiguous(),
                 cs=mg.cs(lvl, dtype), mask=mg.parity_masks(2)[1])
    _, err_text = check_against_plain(torch, ks, name, x)
    r = measure(torch, ks, name, x, smi)
    log(f"phase {phase}: {name} on level {lvl} of {what} "
        f"({x['phi3'].shape[0]} boxes, the level's own tables and inputs): "
        f"{err_text}; {r['text']}")


def slice_argv(out, ndim, refine_max_dx, device):
    return [str(CFG[ndim]), f"-ndim={ndim}", f"-refine_max_dx={refine_max_dx}",
            f"-input_data%file={TABLE}", f"-output%name={out}",
            f"-device={device}"]


def phase_cpu_vs_cuda(torch, Simulation, out_dir, ndim):
    """Phase 3 (2D, 64 x 64 cells) and 3b (3D, 32^3 cells): the port on the
    card against the port on the CPU (plain kernels), float64, 3 steps,
    rtol 1e-9 per variable."""
    phase = "3" if ndim == 2 else "3b"
    refine_max_dx, label = SMALL[ndim]
    sims = {}
    for dev in ("cpu", "cuda"):
        sim = Simulation(argv=slice_argv(out_dir / f"small{ndim}d_{dev}",
                                         ndim, refine_max_dx, dev))
        sim.run(max_steps=SMALL_STEPS)
        sims[dev] = sim
    a = sims["cpu"].cc
    b = sims["cuda"].cc.cpu()
    n = sims["cpu"].tree.highest_id
    worst = 0.0
    for iv, name in enumerate(sims["cpu"].registry.cc_names):
        ref = a[iv, :n]
        scale = float(ref.abs().max())
        err = float((b[iv, :n] - ref).abs().max())
        rel = err / scale if scale > 0 else err
        worst = max(worst, rel)
        if not torch.allclose(b[iv, :n], ref, rtol=1e-9, atol=1e-9 * scale):
            raise RuntimeError(f"cuda vs cpu: cc[{name}] max abs diff {err} "
                               f"(scale {scale})")
    if sims["cpu"].global_dt != sims["cuda"].global_dt:
        dt_rel = abs(sims["cpu"].global_dt / sims["cuda"].global_dt - 1)
        if dt_rel > 1e-9:
            raise RuntimeError(f"cuda vs cpu: dt differs by {dt_rel}")
    log(f"phase {phase}: cuda vs cpu at {label}, {SMALL_STEPS} steps: worst "
        f"variable-scaled deviation {worst:.3e} (limit 1e-9)")


def dielectric_argv(out, device, extra=()):
    return [str(DIELECTRIC_CFG), "-ndim=2", f"-input_data%file={TABLE}",
            f"-user%module={USER_MODULE}", f"-output%name={out}",
            f"-device={device}", *extra]


def record_epochs(sim, epochs, torch):
    """Record each refinement epoch of ``sim``: the level id lists, the
    boxes added and removed, its seconds (synchronised) and the seconds of
    plan building so far."""
    orig = sim.adjust_refinement

    def wrapped():
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = orig()
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        epochs.append({"ids": [list(map(int, x)) for x in sim.tree.lvl_ids],
                       "add": info.n_add, "rm": info.n_rm,
                       "s": time.perf_counter() - t0})
        return info
    sim.adjust_refinement = wrapped


def phase_dielectric_cpu_vs_cuda(torch, ks, Simulation, out_dir):
    """Phase 3c: the dielectric slice with live refinement on the card and
    on the CPU for 8 steps: the same mesh at every epoch, the densities,
    phi and the surface charge within rtol 1e-9 of their scale."""
    sims, epochs = {}, {}
    before = ks.fill_2d_swap.launches
    for dev in ("cpu", "cuda"):
        sim = Simulation(argv=dielectric_argv(out_dir / f"diel_{dev}", dev))
        epochs[dev] = [{"ids": [list(map(int, x)) for x in sim.tree.lvl_ids],
                        "add": 0, "rm": 0, "s": 0.0}]
        record_epochs(sim, epochs[dev], torch)
        sim.run(max_steps=DIELECTRIC_SMALL_STEPS)
        sims[dev] = sim
    swaps = ks.fill_2d_swap.launches - before
    if [e["ids"] for e in epochs["cpu"]] != [e["ids"] for e in epochs["cuda"]]:
        raise RuntimeError("dielectric slice: the meshes differ")
    changed = sum(1 for e in epochs["cpu"] if e["add"] or e["rm"])
    a, b = sims["cpu"], sims["cuda"]
    n = a.tree.highest_id
    use = torch.as_tensor(a.tree.in_use[:n])
    check = {"densities": [iv for iv in a.all_densities],
             "phi": [a.i_phi],
             "surface charge": [a.i_surf_sigma]}
    worst = {}
    for label, ivs in check.items():
        w = 0.0
        for iv in ivs:
            ref = a.cc[iv, :n][use]
            got = b.cc[iv, :n].cpu()[use]
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            w = max(w, err / scale if scale > 0 else err)
        worst[label] = w
    log(f"phase 3c: dielectric slice cuda vs cpu, {DIELECTRIC_SMALL_STEPS} "
        f"steps: same mesh at {len(epochs['cpu'])} epochs "
        f"({changed} changed it, {n} box rows); worst scaled deviation "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (limit 1e-9); fill_2d_swap launches {swaps}")
    if max(worst.values()) > 1e-9:
        raise RuntimeError(f"dielectric slice: cuda vs cpu {worst}")
    if swaps <= 0:
        raise RuntimeError("dielectric slice: K3-swap was not launched")
    if a.global_dt != b.global_dt and abs(a.global_dt / b.global_dt - 1) > 1e-9:
        raise RuntimeError("dielectric slice: dt differs")


def phase_dielectric_full(torch, ks, Simulation, mgb, out_dir, smi):
    """Phase 6: the dielectric slice at the card's size for 6 steps;
    returns the launch counts of the run's kernels."""
    extra, steps = DIELECTRIC_FULL
    free_earlier_runs(torch)
    torch.cuda.reset_peak_memory_stats()
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(argv=dielectric_argv(out_dir / "diel_full", "cuda",
                                          extra))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    setup_build = sim.mesh.build_seconds
    epochs = []
    record_epochs(sim, epochs, torch)
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: ks.KERNELS[name].launches
                for name in PATH_KERNELS["dielectric"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t = sim.tree
    n_leaf = sum(len(l) for l in t.lvl_leaves) * t.nc ** 2
    per_lvl = [len(x) for x in t.lvl_ids]
    changed = [k for k, e in enumerate(epochs) if e["add"] or e["rm"]]
    ep_s = [e["s"] for e in epochs]
    log(f"phase 6: {n_leaf} leaf cells, {sum(per_lvl)} boxes, boxes per "
        f"level {per_lvl}, {len(sim.surfaces.active())} surfaces; setup "
        f"{t1 - t0:.2f} s (plan building {setup_build:.2f} s); {steps} "
        f"steps {t2 - t1:.2f} s = {1e3 * (t2 - t1) / steps:.2f} ms/step; "
        f"t = {sim.global_time:.4e} s, dt = {sim.global_dt:.4e} s; peak "
        f"memory {peak_gb:.3f} GB")
    log(f"phase 6: {len(epochs)} refinement epochs, {len(changed)} changed "
        f"the mesh (epochs {changed}, boxes added/removed "
        f"{[(epochs[k]['add'], epochs[k]['rm']) for k in changed]}); "
        f"seconds per epoch (criterion, new mesh, prolongation) "
        f"{[round(x, 3) for x in ep_s]}; host plan rebuilds in the run "
        f"{sim.mesh.build_seconds - setup_build:.2f} s")
    log(f"phase 6: kernel launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    n = t.highest_id
    if not bool(torch.isfinite(sim.cc[:, :n]).all()) or \
            not bool(torch.isfinite(sim.fc[:, :, :n]).all()):
        raise RuntimeError("non-finite state after the dielectric slice")
    emax = float(sim.cc[sim.i_electric_fld, :n].max())
    log(f"phase 6: max(E) = {emax:.4e} V/m (background "
        f"{BACKGROUND_FIELD:.2e})")
    if not emax > BACKGROUND_FIELD:
        raise RuntimeError("max(E) did not rise above the background field")
    mg = sim.field.mg
    params = {"voltage": sim.field.current_voltage}
    P, R = mgb.gather_levels(mg, sim.cc)
    vc_ms = time_ms(torch, lambda: mgb.fas_vcycle_blocks(mg, P, R, params),
                    reps=10)
    swap_lvls = [l for l in range(1, t.highest_lvl + 1)
                 if mg.smoother(l).has_swap]
    log(f"phase 6: {vc_ms:.3f} ms per V-cycle ({t.highest_lvl} levels, "
        f"K3-swap on levels {swap_lvls}, float64)")
    log(f"phase 6: device busy share: "
        f"{busy_share(torch, sim, 1e3 * (t2 - t1) / steps)}")
    time_on_level(torch, ks, mgb, sim, "fill_2d_swap",
                  max(swap_lvls, key=lambda l: mg.smoother(l).n), "6", smi)
    return launches


def amr_argv(out, ndim, device, extra=(), cfg=None, table=TABLE):
    return [str(cfg or AMR_CFG[ndim]), f"-ndim={ndim}",
            f"-input_data%file={table}", f"-output%name={out}",
            f"-device={device}", *extra]


def record_photoi(sim, ks, updates, torch):
    """Record each photoionization update of ``sim``: the step, the FMG
    cycles of each mode, its seconds (synchronised), the seconds of host
    plan building among them (the first update builds the modes' tables
    and dense level-1 inverses, an update after a changing epoch those of
    the changed levels) and the kernel launches inside it."""
    orig = sim.photoi.set_src

    def wrapped(cc, dt=None, params=None):
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        before = {k: fn.launches for k, fn in ks.KERNELS.items()}
        built = sim.mesh.build_seconds
        t0 = time.perf_counter()
        cc = orig(cc, dt, params)
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        updates.append({
            "it": sim.it, "cycles": list(sim.photoi.fmg_cycles),
            "s": time.perf_counter() - t0,
            "build_s": sim.mesh.build_seconds - built,
            "launches": {k: fn.launches - before[k]
                         for k, fn in ks.KERNELS.items()}})
        return cc
    sim.photoi.set_src = wrapped


def record_dts(sim, dts):
    """Record dt of every attempted step of ``sim`` (rejected ones too)."""
    orig = sim._substep

    def wrapped(cc, fc, dt, dt_lim, time_, s_deriv, s_prev, w_prev, s_out,
                i_step, n_steps, params):
        if i_step == 1:
            dts.append(dt)
        return orig(cc, fc, dt, dt_lim, time_, s_deriv, s_prev, w_prev, s_out,
                    i_step, n_steps, params)
    sim._substep = wrapped


def record_field_cycles(mgb, sim, solves):
    """Record (FMG cycles, V-cycles over all levels) of every field solve
    of ``sim`` from now on."""
    orig = sim.field.compute

    def wrapped(*args, **kwargs):
        n = {"fmg": 0, "vcycle": 0}
        vcycle, fmg = mgb.fas_vcycle_blocks, mgb.fas_fmg_blocks

        def count_vcycle(mg, P, R, params, top=None):
            if top is None:
                n["vcycle"] += 1
            return vcycle(mg, P, R, params, top)

        def count_fmg(mg, P, R, params):
            n["fmg"] += 1
            return fmg(mg, P, R, params)
        mgb.fas_vcycle_blocks, mgb.fas_fmg_blocks = count_vcycle, count_fmg
        try:
            return orig(*args, **kwargs)
        finally:
            mgb.fas_vcycle_blocks, mgb.fas_fmg_blocks = vcycle, fmg
            solves.append((n["fmg"], n["vcycle"]))
    sim.field.compute = sim.fluid.field_compute = wrapped


def record_run(argv, max_steps, after=None):
    """Run ``Simulation(argv)`` for ``max_steps`` steps, sharded or not,
    and record what a sharded run must reproduce (with the helpers above):
    the mesh after setup and after every refinement epoch with its boxes
    added and removed, dt of every attempted step, the (FMG, V-cycle)
    counts of every field solve, the Helmholtz modes' FMG cycles at every
    photoionization update, and at the end the whole state of the boxes in
    use (gathered on rank 0) and the surface charge's integral. Per rank:
    its rows, own boxes and leaf cells, the kernel launches, the exchanges
    (calls, bytes, seconds), the same-level ghost copies that read another
    rank's box, what it holds of an electrode's or a dielectric's boundary
    (boundary_boxes), and what
    ``after(sim, seconds of the run)``, called on every rank after the
    run, returns. Returns the record on rank 0 (every rank when
    unsharded), None on the other ranks. Runs on the CPU too (the tests
    use it)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from afivo_streamer_tpu_torch.driver import Simulation
    from afivo_streamer_tpu_torch.ops import smoother as ks
    from afivo_streamer_tpu_torch.parallel import halo
    from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb

    sim = Simulation(argv=list(argv))
    mesh0 = [list(map(int, x)) for x in sim.tree.lvl_ids]
    epochs, dts, solves, updates = [], [], [], []
    record_epochs(sim, epochs, torch)
    record_dts(sim, dts)
    record_field_cycles(mgb, sim, solves)
    if sim.photoi.enabled and sim.photoi.method == "helmholtz":
        record_photoi(sim, ks, updates, torch)
    ks.reset_launch_counts()
    layout = sim.layout
    if layout is not None:
        layout.stats.update(halo.new_stats())
    cuda = sim.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(sim.device)
        torch.cuda.reset_peak_memory_stats(sim.device)
    t0 = time.perf_counter()
    sim.run(max_steps=max_steps)
    if cuda:
        torch.cuda.synchronize(sim.device)
    seconds = time.perf_counter() - t0
    # copies: the steps of ``after`` would extend the lists
    out = {"epochs": [mesh0] + [e["ids"] for e in epochs],
           "changes": [(e["add"], e["rm"]) for e in epochs],
           "dts": [float(d) for d in dts], "solves": list(solves),
           "photoi": [(u["it"], u["cycles"]) for u in updates]}
    layout = sim.layout
    per_rank = {
        "launches": {name: fn.launches for name, fn in ks.KERNELS.items()},
        "launches_f32": {name: fn.launches_by_dtype[torch.float32]
                         for name, fn in ks.KERNELS.items()},
        "rows": sim.cc.shape[1], "seconds": seconds,
        "peak_bytes": (torch.cuda.max_memory_allocated(sim.device)
                       if cuda else 0),
        "leaf_cells_own": sum(len(a) for a in sim.mesh.tree.lvl_leaves)
        * sim.tree.nc ** sim.tree.ndim}
    if layout is not None:
        # per level, the same-level ghost copies whose source box another
        # rank owns (a halo row)
        cross = [int(sum(np.sum(p.copy_nb >= layout.n_own)
                         for p in sim.mesh.gc(lvl).dirs))
                 for lvl in range(1, sim.tree.highest_lvl + 1)]
        per_rank.update(own=layout.n_own, halo=layout.n_rows - layout.n_own,
                        cap=layout.cap, exchange=dict(layout.stats),
                        cross=cross, **boundary_boxes(sim))
    if after is not None:
        per_rank["after"] = after(sim, seconds)
    ranks = [per_rank]
    if layout is not None:
        ranks = [None] * layout.world
        dist.all_gather_object(ranks, per_rank)
    with sim.full_view() as root:
        if not root:
            return None
        ids = np.nonzero(sim.tree.in_use[:sim.tree.highest_id])[0]
        out.update(
            ranks=ranks, it=sim.it, time=sim.global_time,
            dtype=str(sim.dtype).replace("torch.", ""),
            dt=sim.global_dt, ids=ids, names=list(sim.registry.cc_names),
            cc=sim.cc[:, ids].cpu().numpy(),
            fc=sim.fc[:, :, ids].cpu().numpy(),
            leaf_cells=(sim.layout.leaf_cells(sim.tree)
                        if sim.layout is not None else None),
            surf_integral=(sim.surfaces.get_integral(sim.cc)
                           if sim.surfaces is not None else None),
            n_leaf_cells=sum(len(a) for a in sim.tree.lvl_leaves)
            * sim.tree.nc ** sim.tree.ndim)
        return out


def boundary_boxes(sim):
    """What of an electrode's or a dielectric's boundary the rank holds:
    ``lsf_bnd`` its own boxes that hold the level set's boundary,
    ``surf_own`` the surfaces whose gas-side box it owns and
    ``surf_cross`` those among them whose solid-side box another rank
    owns."""
    import numpy as np
    out = {}
    lsf = sim.field.lsf_data
    if lsf is not None:
        out["lsf_bnd"] = int(sum(
            np.sum(lsf.level_data(lvl)["has_bnd"][
                :lsf.level_data(lvl)["n_own"]])
            for lvl in range(1, sim.tree.highest_lvl + 1)))
    if sim.surfaces is not None:
        layout = sim.layout
        active = sim.surfaces.active()
        gas = np.asarray([sf.id_out for sf in active], np.int64)
        solid = np.asarray([sf.id_in for sf in active], np.int64)
        mine = layout.shards.owner(gas, layout.cap) == layout.rank
        out["surf_own"] = int(np.sum(mine))
        out["surf_cross"] = int(np.sum(
            mine & (layout.shards.owner(solid, layout.cap) != layout.rank)))
    return out


def record_coarse_cycles(sim, counts):
    """Record the V-cycles of every level-1 solve of ``sim``'s field solve
    when that is the uniform coarse-grid multigrid."""
    from afivo_streamer_tpu_torch.solvers.coarse import UniformCoarseMG
    solver = sim.field.mg.coarse_solver()
    if not isinstance(solver, UniformCoarseMG):
        return
    orig = solver.solve_blocks

    def wrapped(*args):
        out = orig(*args)
        counts.append(solver.last_vcycles)
        return out
    solver.solve_blocks = wrapped


def phase_amr_cpu_vs_cuda(torch, ks, Simulation, out_dir, ndim, phase=None,
                          cfg=None, table=TABLE, extra=None, steps=None,
                          must_launch=()):
    """Phase 3d (cylindrical) and 3e (3D): the slice with live refinement
    and photoionization every 2 steps on the card and on the CPU: the same
    mesh at every epoch (one of them changing it), the same FMG cycle
    counts of every mode at every update, and every variable but the
    scratch one within rtol 1e-9 of its scale. Phases 3f-3h: the same for
    a fluid-model variant (``cfg``, ``table``, ``extra`` flags, ``steps``);
    a configuration without photoionization has no update to compare.
    Phases 3j-3l: the same for an electrode slice; 3m-3p for the field
    solver's last branches (dielectrics, the electrode-plus-dielectric
    pair, the uniform coarse grid), which also hold the surface data per
    surface, the V-cycles of every uniform coarse-grid solve and that the
    kernels ``must_launch`` were launched on the card. Every phase also
    holds dt of every attempted step (rtol 1e-9) and the FMG and V-cycle
    counts of every field solve of the run."""
    from afivo_streamer_tpu_torch import interop
    from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
    phase = phase or ("3d" if ndim == 2 else "3e")
    cfg = cfg or AMR_CFG[ndim]
    steps = steps or AMR_SMALL_STEPS[ndim]
    extra = ["-photoi%per_steps=2"] if extra is None else extra
    sims, epochs, updates, dts, solves, coarse = {}, {}, {}, {}, {}, {}
    gas0 = {}
    for dev in ("cpu", "cuda"):
        sim = Simulation(argv=amr_argv(out_dir / f"p{phase}_{dev}", ndim,
                                       dev, extra, cfg, table))
        if sim.gasdyn is not None:
            gas0[dev] = gas_setup_state(torch, sim)
        epochs[dev] = [{"ids": [list(map(int, x)) for x in sim.tree.lvl_ids],
                        "add": 0, "rm": 0, "s": 0.0}]
        updates[dev], dts[dev], solves[dev], coarse[dev] = [], [], [], []
        record_epochs(sim, epochs[dev], torch)
        record_photoi(sim, ks, updates[dev], torch)
        record_dts(sim, dts[dev])
        record_field_cycles(mgb, sim, solves[dev])
        record_coarse_cycles(sim, coarse[dev])
        before = {k: fn.launches for k, fn in ks.KERNELS.items()}
        sim.run(max_steps=steps)
        launched = {k: fn.launches - before[k]
                    for k, fn in ks.KERNELS.items()}
        sims[dev] = sim
    if [e["ids"] for e in epochs["cpu"]] != [e["ids"] for e in epochs["cuda"]]:
        raise RuntimeError(f"phase {phase}: the meshes differ")
    if solves["cpu"] != solves["cuda"]:
        raise RuntimeError(f"phase {phase}: the cycle counts of the field "
                           f"solves differ: {solves}")
    if coarse["cpu"] != coarse["cuda"]:
        raise RuntimeError(f"phase {phase}: the V-cycles of the coarse-grid "
                           f"solves differ: {coarse}")
    if any(launched[k] <= 0 for k in must_launch):
        raise RuntimeError(f"phase {phase}: not launched on the card: "
                           f"{launched}")
    if len(dts["cpu"]) != len(dts["cuda"]) or any(
            abs(a / b - 1) > 1e-9 for a, b in zip(dts["cpu"], dts["cuda"])):
        raise RuntimeError(f"phase {phase}: dt differs: {dts}")
    changed = sum(1 for e in epochs["cpu"] if e["add"] or e["rm"])
    cycles = {dev: [(u["it"], u["cycles"]) for u in updates[dev]]
              for dev in updates}
    if cycles["cpu"] != cycles["cuda"]:
        raise RuntimeError(f"phase {phase}: the FMG cycle counts differ: "
                           f"{cycles}")
    a, b = sims["cpu"], sims["cuda"]
    n = a.tree.highest_id
    use = torch.as_tensor(a.tree.in_use[:n])
    worst, worst_name = 0.0, ""
    for iv, name in enumerate(a.registry.cc_names):
        if iv == a.i_tmp:
            continue
        ref = a.cc[iv, :n][use]
        got = b.cc[iv, :n].cpu()[use]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        rel = err / scale if scale > 0 else err
        if rel > worst:
            worst, worst_name = rel, name
    n_leaf = sum(len(l) for l in a.tree.lvl_leaves) * a.tree.nc ** ndim
    photo = (f"; max|photo| = "
             f"{float(b.cc[b.photoi.i_photo, :n].abs().max()):.4e}"
             if b.photoi.enabled else "")
    if a.surfaces is not None:
        sa, sb = interop.surface_data(a), interop.surface_data(b)
        if sa.keys() != sb.keys():
            raise RuntimeError(f"phase {phase}: the surfaces differ")
        scale = max(abs(v).max() for v in sa.values())
        surf_err = max(abs(sb[k] - sa[k]).max() for k in sa) / scale
        photo += (f"; {len(sa)} surfaces, surface data worst scaled "
                  f"deviation {surf_err:.3e} (scale {scale:.4e}), surface "
                  f"charge integral {b.surfaces.get_integral(b.cc):.6e}")
        if surf_err > 1e-9:
            raise RuntimeError(f"phase {phase}: surface data cuda vs cpu "
                               f"{surf_err}")
    if coarse["cpu"]:
        photo += (f"; {len(coarse['cpu'])} uniform coarse-grid solves with "
                  f"the same V-cycles {coarse['cpu']}")
    if must_launch:
        photo += f"; launches on the card {launched}"
    log(f"phase {phase}: {cfg.name} {' '.join(extra)} ({a.model.type}) cuda "
        f"vs cpu, {steps} steps, "
        f"{n_leaf} leaf cells at the end: same mesh at {len(epochs['cpu'])} "
        f"epochs ({changed} changed it), {len(updates['cpu'])} "
        f"photoionization updates with the same FMG cycles per mode "
        f"{[c for _it, c in cycles['cpu']]}; the same dt at "
        f"{len(dts['cpu'])} attempted steps and the same (FMG, V-cycle) "
        f"counts at {len(solves['cpu'])} field solves "
        f"{sorted(set(solves['cpu']))}; worst scaled deviation "
        f"{worst:.3e} ({worst_name}; limit 1e-9; below 1e-12: "
        f"{worst < 1e-12}); dt limits (cfl, drt, chem, other) "
        f"{[float(f'{v:.6g}') for v in b.dt_limits]}{photo}")
    if worst > 1e-9:
        raise RuntimeError(f"phase {phase}: cuda vs cpu {worst} {worst_name}")
    if (changed < 1 and not coarse["cpu"]) or (
            b.photoi.enabled and len(updates["cpu"]) < 2):
        raise RuntimeError(f"phase {phase}: needs a changing epoch and two "
                           f"photoionization updates")
    if a.global_dt != b.global_dt and abs(a.global_dt / b.global_dt - 1) > 1e-9:
        raise RuntimeError(f"phase {phase}: dt differs")
    if a.gasdyn is not None:
        gas_increments(torch, a, b, gas0, phase)
    if b.photoi.mc is not None:
        check_mc_photons(b, phase)


#: the gas variables whose increments the gas phases compare
GAS_VARS = ("gas_rho", "gas_mom_x", "gas_mom_y", "gas_e",
            "vibrational_energy")


def gas_setup_state(torch, sim):
    """What the increments of the gas are taken against: the gas rows of
    the state after setup (on the CPU) and the boxes' levels and
    positions then."""
    n = sim.tree.highest_id
    rows = [sim.registry.cc_names.index(k) for k in GAS_VARS
            if k in sim.registry.cc_names]
    return {"rows": rows, "cc": sim.cc[rows, :n].cpu().clone(),
            "lvl": sim.tree.lvl[:n].copy(), "ix": sim.tree.ix[:n].copy(),
            "in_use": sim.tree.in_use[:n].copy()}


def gas_increments(torch, a, b, gas0, phase):
    """The gas's increments over its state after setup on the CPU (``a``)
    and the card (``b``), on the interior cells of the leaves that were
    boxes at setup (the increments of the others hold the interpolation
    of new boxes): each nonzero and the card's within 1e-9 of the CPU's
    largest; then the gas's face fluxes within 1e-9 of their scale, and
    the gas dt limit. The density's increment is at the level of its
    rounding (1e-15 of it in 8 steps), so its comparison holds bit
    equality; the mass flux carries its physics."""
    import numpy as np
    from afivo_streamer_tpu_torch.core import spatial as sp
    base = gas0["cpu"]
    t = a.tree
    n0 = len(base["lvl"])
    leaves = np.concatenate([np.asarray(l) for l in t.lvl_leaves])
    keep = leaves[leaves < n0]
    keep = keep[base["in_use"][keep]
                & (base["lvl"][keep] == t.lvl[keep])
                & np.all(base["ix"][keep] == t.ix[keep], axis=1)]
    ids = torch.as_tensor(keep, dtype=torch.int64)
    inner = torch.as_tensor(sp.interior_flat(a.ndim, t.nc), dtype=torch.int64)
    out = {}
    for k, iv in enumerate(base["rows"]):
        name = a.registry.cc_names[iv]
        ref = base["cc"][k][ids][:, inner]
        inc_a = a.cc[iv, ids][:, inner] - ref
        inc_b = b.cc[iv, ids].cpu()[:, inner] - \
            gas0["cuda"]["cc"][k][ids][:, inner]
        scale = float(inc_a.abs().max())
        out[name] = (scale, float((inc_b - inc_a).abs().max()) / scale
                     if scale > 0 else math.inf)
    for f_iv in a.gasdyn.gas_fluxes:
        ref = a.fc[f_iv, :, :t.highest_id]
        scale = float(ref.abs().max())
        out[a.registry.fc_names[f_iv]] = (scale, float(
            (b.fc[f_iv, :, :t.highest_id].cpu() - ref).abs().max()) / scale
            if scale > 0 else math.inf)
    log(f"phase {phase}: gas increments over the state after setup on the "
        f"{len(keep)} leaves that were boxes then, and the gas's face "
        f"fluxes (largest, worst scaled deviation cuda vs cpu): "
        + ", ".join(f"{k} {v[0]:.4e} {v[1]:.3e}" for k, v in out.items())
        + f"; gas dt limit {a.dt_gas_lim:.6e} s / {b.dt_gas_lim:.6e} s")
    if any(not v[1] <= 1e-9 for v in out.values()):
        raise RuntimeError(f"phase {phase}: the gas increments or fluxes "
                           f"differ, or are zero: {out}")
    if abs(a.dt_gas_lim / b.dt_gas_lim - 1) > 1e-9:
        raise RuntimeError(f"phase {phase}: the gas dt limit differs")


def record_dt_limits(sim, limits):
    """Record the four time-step limits (0-d tensors, no sync) of the last
    substep of every attempted step of ``sim``."""
    orig = sim.fluid.forward_euler

    def wrapped(cc, fc, dt, dt_lim, time_, s_deriv, s_prev, w_prev, s_out,
                i_step, n_steps, params):
        out = orig(cc, fc, dt, dt_lim, time_, s_deriv, s_prev, w_prev, s_out,
                   i_step, n_steps, params)
        if i_step == n_steps:
            limits.append(out[3]["dt_limits"])
        return out
    sim.fluid.forward_euler = wrapped


def leaf_interiors(torch, sim, iv):
    """Variable ``iv`` on the interior cells of all leaves, flattened."""
    from afivo_streamer_tpu_torch.core import spatial as sp
    inner = torch.as_tensor(sp.interior_flat(sim.ndim, sim.tree.nc),
                            dtype=torch.int64, device=sim.device)
    return torch.cat([
        sim.cc[iv, sim.mesh.tb(l).d.leaves[:, None], inner[None, :]].reshape(-1)
        for l in range(1, sim.tree.highest_lvl + 1)
        if len(sim.mesh.tb(l).leaves)])


def check_energy_model(torch, sim, limits, phase, nonnegative=False):
    """The checks of the electron energy equation after a run: the energy
    density finite on the leaves (and, where the model keeps its sign,
    ``nonnegative``), a finite energy-loss limit, and which limit was the
    smallest in each attempted step."""
    en = leaf_interiors(torch, sim, sim.i_electron_energy)
    ne = leaf_interiors(torch, sim, sim.i_electron)
    lims = torch.stack(limits).cpu()
    held = torch.bincount(lims.argmin(dim=1), minlength=4).tolist()
    log(f"phase {phase}: {sim.model.type}: species {sim.chem.species_list}; "
        f"on {en.numel()} leaf cells min(e_energy) = {float(en.min()):.4e}, "
        f"max(e_energy) = {float(en.max()):.4e} eV/m3, "
        f"{int((en < 0).sum())} cells below zero, max mean energy "
        f"{float((en / ne.clamp(min=1.0)).max()):.4f} eV; dt limits of the "
        f"last step (cfl, drt, chem, energy loss) "
        f"{[float(f'{v:.6g}') for v in sim.dt_limits]}, dt = "
        f"{sim.global_dt:.4e} s; the smallest limit over {len(limits)} "
        f"attempted steps: {dict(zip(DT_LIMIT_NAMES, held))}")
    if not bool(torch.isfinite(en).all()):
        raise RuntimeError("the energy density is not finite")
    if nonnegative and float(en.min()) < 0.0:
        raise RuntimeError("the energy density is negative")
    if not sim.dt_limits[3] < 1e99:
        raise RuntimeError("the energy-loss time-step limit is not active")
    if "e_energy" not in sim.chem.species_list:
        raise RuntimeError("e_energy is no species")


def phase_amr_full(torch, ks, Simulation, mgb, out_dir, ndim, smi,
                   phase=None, cfg=None, table=TABLE, steps=None,
                   record=None, against=None):
    """Phase 7 (the main path: cylindrical) and 8 (3D): the slice with live
    refinement and photoionization at the card's size; returns the launch
    counts of the run's kernels, and fills ``record`` (when given) with ms
    per step, the launches per step, the (FMG, V-cycle) counts of the field
    solves, the FMG cycles of the photoionization updates, the meshes and
    dt at every attempted step. Then phase 2b: the run's kernels on the
    finest level of the Helmholtz mode with the largest lambda. Phase 9:
    the same run of ``cfg`` (the cylindrical slice under ee53) with the
    checks of the energy model, without phase 2b and the busy share.
    Phase 19: phase 7 with the float32 state (F32_FLAGS), held against
    phase 7's record ``against`` (check_float32_main_path), with phase 2b
    in float32. ``record`` also gets a last row of the regression log: the
    state after the run."""
    variant = phase not in (None, "19")
    phase = phase or ("7" if ndim == 2 else "8")
    cfg = cfg or AMR_CFG[ndim]
    extra, full_steps, min_cells = AMR_FULL[ndim]
    if phase == "19":
        extra = extra + F32_FLAGS
    steps = steps or full_steps
    names = PATH_KERNELS[ndim]
    free_earlier_runs(torch)
    torch.cuda.reset_peak_memory_stats()
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(argv=amr_argv(out_dir / f"p{phase}_full", ndim, "cuda",
                                   extra, cfg, table))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    limits = []
    if sim.model.has_energy_equation:
        record_dt_limits(sim, limits)
    setup_launches = {k: ks.KERNELS[k].launches for k in names}
    setup_by_dtype = {k: dict(fn.launches_by_dtype)
                      for k, fn in ks.KERNELS.items()}
    setup_build = sim.mesh.build_seconds
    t = sim.tree
    cells0 = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    boxes0 = [len(x) for x in t.lvl_ids]
    mesh0 = [list(map(int, x)) for x in t.lvl_ids]
    epochs, updates, solves, dts = [], [], [], []
    record_epochs(sim, epochs, torch)
    record_photoi(sim, ks, updates, torch)
    if record is not None:
        record_field_cycles(mgb, sim, solves)
        record_dts(sim, dts)
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: ks.KERNELS[k].launches for k in names}
    # the run's launches by dtype (the setup runs in float64)
    by_dtype = {k: {d: c - setup_by_dtype[k][d]
                    for d, c in fn.launches_by_dtype.items()}
                for k, fn in ks.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if record is not None:
        # the state after the run as a last row of the regression log
        with sim.full_view():
            sim.output.regression_log(sim, sim.out_cnt + 1)
        # copies: the busy share's steps below would extend the lists
        record.update(
            rtest=f"{sim.output.name}_rtest.log", peak_gb=peak_gb,
            in_use_gb=torch.cuda.memory_allocated() / 1e9,
            dtype=str(sim.cc.dtype), by_dtype=by_dtype,
            ms_step=1e3 * (t2 - t1) / steps, solves=list(solves),
            dts=[float(d) for d in dts],
            per_step={k: round((launches[k] - setup_launches[k]) / steps, 2)
                      for k in names},
            updates=[u["cycles"] for u in updates],
            update_ms=[1e3 * u["s"] for u in updates],
            epochs=[e["ids"] for e in epochs],
            meshes=[mesh0] + [e["ids"] for e in epochs])
    n_leaf = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    per_lvl = [len(x) for x in t.lvl_ids]
    changed = [k for k, e in enumerate(epochs) if e["add"] or e["rm"]]
    ms_step = 1e3 * (t2 - t1) / steps
    log(f"phase {phase}: {cfg.name} {' '.join(extra)}: {cells0} "
        f"leaf cells and boxes per level {boxes0} after setup, {n_leaf} and "
        f"{per_lvl} ({sum(per_lvl)} boxes) after {steps} steps; setup "
        f"{t1 - t0:.2f} s (plan building {setup_build:.2f} s); {steps} steps "
        f"{t2 - t1:.2f} s = {ms_step:.2f} ms/step, of which the epochs "
        f"{sum(e['s'] for e in epochs):.2f} s and the photoionization "
        f"updates {sum(u['s'] for u in updates):.2f} s; t = "
        f"{sim.global_time:.4e} s, dt = {sim.global_dt:.4e} s; peak memory "
        f"{peak_gb:.3f} GB")
    log(f"phase {phase}: {len(epochs)} refinement epochs, {len(changed)} "
        f"changed the mesh (epochs {changed}, boxes added/removed "
        f"{[(epochs[k]['add'], epochs[k]['rm']) for k in changed]}); seconds "
        f"per epoch {[round(e['s'], 3) for e in epochs]}; host plan rebuilds "
        f"in the run {sim.mesh.build_seconds - setup_build:.2f} s")
    log(f"phase {phase}: {len(updates)} photoionization updates at steps "
        f"{[u['it'] for u in updates]}: ms per update "
        f"{[round(1e3 * u['s'], 1) for u in updates]}, of which host plan "
        f"building {[round(1e3 * u['build_s'], 1) for u in updates]}, FMG "
        f"cycles per mode "
        f"{[u['cycles'] for u in updates]} (one host sync per cycle and "
        f"mode), kernel launches per update "
        f"{[{k: u['launches'][k] for k in names} for u in updates]}")
    in_updates = {k: sum(u["launches"][k] for u in updates) for k in names}
    log(f"phase {phase}: kernel launches {launches} (setup "
        f"{setup_launches}); per step of the run "
        + str({k: round((launches[k] - setup_launches[k]) / steps, 2)
               for k in names})
        + ", of which inside photoionization updates "
        + str({k: round(in_updates[k] / steps, 2) for k in names}))
    if min(cells0, n_leaf) < min_cells:
        raise RuntimeError(f"fewer leaf cells than the frozen slice: "
                           f"{cells0}, {n_leaf} < {min_cells}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    if not changed or len(updates) < 2:
        raise RuntimeError("needs a changing epoch and two photoionization "
                           "updates")
    n = t.highest_id
    if not bool(torch.isfinite(sim.cc[:, :n]).all()) or \
            not bool(torch.isfinite(sim.fc[:, :, :n]).all()):
        raise RuntimeError("non-finite state after the run")
    emax = float(sim.cc[sim.i_electric_fld, :n].max())
    photo_max = float(sim.cc[sim.photoi.i_photo, :n].max())
    log(f"phase {phase}: max(E) = {emax:.4e} V/m (background "
        f"{BACKGROUND_FIELD:.2e}), max(photo) = {photo_max:.4e} 1/(m3 s)")
    if not emax > BACKGROUND_FIELD or not photo_max > 0.0:
        raise RuntimeError("max(E) did not rise above the background field "
                           "or the photoionization source is empty")
    if sim.model.has_energy_equation:
        check_energy_model(torch, sim, limits, phase)
    if variant:
        return launches
    if phase == "19":
        check_float32_main_path(torch, sim, record, against)

    # V-cycle times on the final state: the field solve, and the Helmholtz
    # mode with the largest lambda on the photoionization source (set_src
    # writes it into rhs; the field solve of the next step rewrites rhs)
    params = {"voltage": sim.field.current_voltage}
    mode = max(range(sim.photoi.n_modes), key=lambda k: sim.photoi.lambdas[k])
    mg_h = sim.photoi.mgs[mode]
    P, R = mgb.gather_levels(sim.field.mg, sim.cc)
    vc_ms = time_ms(torch, lambda: mgb.fas_vcycle_blocks(sim.field.mg, P, R,
                                                         params), reps=10)
    sim.cc = sim.photoi.set_src(sim.cc, 0.0, params)
    P, R = mgb.gather_levels(mg_h, sim.cc)
    vc_h_ms = time_ms(torch, lambda: mgb.fas_vcycle_blocks(mg_h, P, R,
                                                           params), reps=10)
    fmg_h_ms = time_ms(torch, lambda: mgb.fas_fmg_blocks(mg_h, P, R, params),
                       reps=5)
    log(f"phase {phase}: {vc_ms:.3f} ms per V-cycle of the field solve, "
        f"{vc_h_ms:.3f} ms per V-cycle and {fmg_h_ms:.3f} ms per FMG cycle "
        f"of Helmholtz mode {mode + 1} (lambda = "
        f"{sim.photoi.lambdas[mode]:.6g} 1/m; {t.highest_lvl} levels, "
        f"{str(sim.cc.dtype).split('.')[1]})")
    largest = max(range(1, t.highest_lvl + 1),
                  key=lambda l: len(t.lvl_ids[l - 1]))
    for lvl in sorted({t.highest_lvl, largest}, reverse=True):
        lam2dx2 = (sim.photoi.lambdas[mode] * float(t.lvl_dr(lvl)[0])) ** 2
        for name in names:
            time_on_level(torch, ks, mgb, sim, name, lvl, "2b", smi, mg=mg_h,
                          what=f"Helmholtz mode {mode + 1} of phase {phase} "
                          f"(lambda^2 dx^2 = {lam2dx2:.4g})")
    # last: the long trace of these steps makes the next traces lose events
    log(f"phase {phase}: device busy share: "
        f"{busy_share(torch, sim, ms_step)}")
    return launches


def check_float32_main_path(torch, sim, rec, p7):
    """Phase 19's gate: every smoother launch of the run float32 (K1-K3
    launched; the setup runs in float64, as the JAX package's host path
    runs it), the state float32, the regression log's observables after
    the run within F32_MAIN_RTOL of phase 7's; and its report against
    phase 7's: ms per step, peak memory, the meshes, the cycle counts."""
    import numpy as np
    f64 = {k: c[torch.float64] for k, c in rec["by_dtype"].items()
           if c[torch.float64]}
    f32 = {k: c[torch.float32] for k, c in rec["by_dtype"].items()}
    a = np.loadtxt(p7["rtest"], skiprows=1, ndmin=2)
    b = np.loadtxt(rec["rtest"], skiprows=1, ndmin=2)
    rel = (np.abs(b[:, 1:] - a[:, 1:])
           / np.maximum(np.abs(a[:, 1:]), 1e-300)).max() if \
        a.shape == b.shape else float("inf")
    same_meshes = rec["meshes"] == p7["meshes"]
    log(f"phase 19: float32 against phase 7 (float64) in this call: "
        f"{rec['ms_step']:.2f} against {p7['ms_step']:.2f} ms per step "
        f"({rec['ms_step'] / p7['ms_step']:.3f} times); peak memory "
        f"{rec['peak_gb']:.3f} GB against {p7['peak_gb']:.3f} GB (PR 13: "
        f"{P7_PEAK_GB} GB; both from before the setup, which runs in "
        f"float64), memory in use after the run {rec['in_use_gb']:.3f} GB "
        f"against {p7['in_use_gb']:.3f} GB; launches by dtype float32 "
        f"{f32}, float64 "
        f"{f64 or 'none'}; K1-K3 float32 per step of the run "
        f"{rec['per_step']} against phase 7's {p7['per_step']}; (FMG, "
        f"V-cycle) counts of the field solves {rec['solves']} against "
        f"{p7['solves']}; FMG cycles per mode at the updates "
        f"{rec['updates']} against {p7['updates']}; the same meshes as "
        f"phase 7 at {len(p7['meshes'])} meshes: {same_meshes} (reported, "
        f"not required: live refinement may flip a marginal flag); the "
        f"regression log's observables (time, dt, sums, maxima) at setup "
        f"and after the run, worst relative deviation {rel:.3e} (limit "
        f"{F32_MAIN_RTOL:.0e})")
    if f64 or not all(f32[k] > 0 for k in PATH_KERNELS[2]):
        raise RuntimeError(f"phase 19: a float64 launch or a kernel not "
                           f"launched in float32: {rec['by_dtype']}")
    if sim.cc.dtype != torch.float32 or sim.fc.dtype != torch.float32:
        raise RuntimeError(f"phase 19: the state is {sim.cc.dtype}")
    if not rel <= F32_MAIN_RTOL:
        raise RuntimeError(f"phase 19: the observables deviate from phase "
                           f"7's by {rel:.3e}: {a} {b}")


def phase_float32_small(torch, ks, Simulation, out_dir):
    """Phase 3y: the compiled engine's float32 state at the committed sizes
    (air_cyl_amr_slice.cfg, 16,960 cells; air_3d_amr_slice.cfg, 219,136
    cells), refinement frozen after setup, photoionization every 2 steps,
    an output every 0.1 ps, F32_SMALL_STEPS steps: the card's float32 run
    against the CPU's (every variable but the scratch one within
    F32_CPU_TOL of its scale, rhs on the leaves: its rows of the other
    boxes hold the FAS coarse-grid right-hand sides, whose float32
    rounding follows phi / dx^2 there, not the charge density; the same
    meshes) and against the card's
    float64 run (the regression log's observables within F32_F64_RTOL);
    every smoother launch of the card's float32 run float32, K1-K3 (K4-K5)
    among them (the setup, in float64 as the JAX package's host path runs
    it, is not counted). Then the cylindrical slice with live refinement in float32
    and in float64 on the card: whether the meshes after every epoch are
    the same (reported)."""
    import numpy as np
    phase = "3y"
    flags = ["-photoi%per_steps=2", "-output%dt=1e-13"]
    for ndim in (2, 3):
        runs = {}
        for key, dev, extra in (("cuda32", "cuda", F32_FLAGS),
                                ("cpu32", "cpu", F32_FLAGS),
                                ("cuda64", "cuda", [])):
            t0 = time.perf_counter()
            sim = Simulation(argv=amr_argv(
                out_dir / f"p3y_{ndim}d_{key}", ndim, dev,
                flags + ["-refine_per_steps=1000000"] + extra))
            # the run's launches (the setup runs in float64)
            ks.reset_launch_counts()
            sim.run(max_steps=F32_SMALL_STEPS)
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[key] = (sim, time.perf_counter() - t0,
                         {k: dict(fn.launches_by_dtype)
                          for k, fn in ks.KERNELS.items()})
        a, b, c = (runs[k][0] for k in ("cpu32", "cuda32", "cuda64"))
        by_dtype = runs["cuda32"][2]
        f32 = {k: v[torch.float32] for k, v in by_dtype.items()
               if v[torch.float32]}
        f64 = {k: v[torch.float64] for k, v in by_dtype.items()
               if v[torch.float64]}
        if f64 or not all(f32.get(k, 0) > 0 for k in PATH_KERNELS[ndim]):
            raise RuntimeError(f"phase 3y: float64 launches or a kernel not "
                               f"launched in float32: {by_dtype}")
        if not (b.cc.dtype == b.fc.dtype == a.cc.dtype == torch.float32):
            raise RuntimeError(f"phase 3y: the state is {b.cc.dtype}")
        meshes = [[list(map(int, x)) for x in s.tree.lvl_ids]
                  for s in (a, b, c)]
        if not meshes[0] == meshes[1] == meshes[2]:
            raise RuntimeError("phase 3y: the meshes differ")
        n = a.tree.highest_id
        use = torch.as_tensor(a.tree.in_use[:n])
        leaves = torch.zeros(n, dtype=torch.bool)
        for ids in a.tree.lvl_leaves:
            leaves[torch.as_tensor(np.asarray(ids, np.int64))] = True
        worst, worst_name = 0.0, ""
        for iv, name in enumerate(a.registry.cc_names):
            if iv == a.i_tmp:
                continue
            rows = leaves if iv == a.i_rhs else use
            ref = a.cc[iv, :n][rows].double()
            got = b.cc[iv, :n].cpu()[rows].double()
            scale = float(ref.abs().max())
            rel = float((got - ref).abs().max()) / (scale if scale > 0
                                                    else 1.0)
            if rel > worst:
                worst, worst_name = rel, name
        l32, l64 = (np.loadtxt(out_dir / f"p3y_{ndim}d_{k}_rtest.log",
                               skiprows=1, ndmin=2)
                    for k in ("cuda32", "cuda64"))
        obs = (np.abs(l32[:, 3:] - l64[:, 3:])
               / np.maximum(np.abs(l64[:, 3:]), 1e-300)).max() \
            if l32.shape == l64.shape else float("inf")
        n_leaf = sum(len(l) for l in a.tree.lvl_leaves) * a.tree.nc ** ndim
        log(f"phase 3y: {AMR_CFG[ndim].name} {' '.join(flags)} frozen, "
            f"float32, {F32_SMALL_STEPS} steps, {n_leaf} leaf cells: the "
            f"same meshes in the card's float32, the CPU's float32 and the "
            f"card's float64 runs; cuda vs cpu in float32: worst scaled "
            f"deviation {worst:.3e} ({worst_name}; limit {F32_CPU_TOL:.0e})"
            f"; cuda float32 vs cuda float64: the regression log's "
            f"observables at {len(l64)} outputs, worst relative deviation "
            f"{obs:.3e} (limit {F32_F64_RTOL:.0e}); dt {b.global_dt:.6e} "
            f"against {c.global_dt:.6e}; launches of the float32 card run "
            f"{f32} (float64: none); seconds cuda32 {runs['cuda32'][1]:.2f}, "
            f"cpu32 {runs['cpu32'][1]:.2f}, cuda64 {runs['cuda64'][1]:.2f}")
        if worst > F32_CPU_TOL:
            raise RuntimeError(f"phase 3y: cuda vs cpu in float32 {worst} "
                               f"{worst_name}")
        if not obs <= F32_F64_RTOL:
            raise RuntimeError(f"phase 3y: float32 vs float64 {obs}: {l32} "
                               f"{l64}")
        del runs, a, b, c
        free_earlier_runs(torch)
    epochs = {}
    for key, extra in (("live32", F32_FLAGS), ("live64", [])):
        sim = Simulation(argv=amr_argv(out_dir / f"p3y_{key}", 2, "cuda",
                                       flags + extra))
        epochs[key] = [[list(map(int, x)) for x in sim.tree.lvl_ids]]
        found = []
        record_epochs(sim, found, torch)
        sim.run(max_steps=F32_SMALL_STEPS)
        epochs[key] += [x["ids"] for x in found]
    same = [x == y for x, y in zip(epochs["live32"], epochs["live64"])]
    log(f"phase 3y: {AMR_CFG[2].name} with live refinement, {F32_SMALL_STEPS}"
        f" steps on the card: the float32 run's meshes after setup and each "
        f"of {len(same) - 1} epochs equal the float64 run's: {same}")
    free_earlier_runs(torch)


def phase_electrode_full(torch, ks, Simulation, mgb, out_dir, phase, smi):
    """Phase 11 (the cylindrical needle) and 12 (the 3D rod): an electrode
    slice at the card's size; returns the launch counts of the run's
    kernels. Then phase 2b: the run's sweeping kernels (and K5) on the
    finest level that holds the electrode's boundary, with that level's
    own stencil and boundary term. Phase 13 (the 3D dielectric slab) and
    14 (the cylindrical needle above the dielectric plate): the same with
    the surfaces, their charge and, with the plate, K3-swap; phase 2b then
    runs on the mesh after setup (the regions across the surface expire in
    the run, and with them the refinement boundaries at boxes with variable
    eps), with the launch counts restored after it, on the finest level
    with extrapolating ghosts of eps (in 2D one that also holds the
    electrode's boundary where there is one: K2 and K3-swap)."""
    cfg, ndim, extra, steps, min_cells = ELECTRODES_FULL[phase]
    names = PATH_KERNELS[ndim]
    if ndim == 2 and "dielectric" in cfg.name:
        names = PATH_KERNELS["dielectric"]
    free_earlier_runs(torch)
    torch.cuda.reset_peak_memory_stats()
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(argv=amr_argv(out_dir / f"p{phase}_full", ndim, "cuda",
                                   extra, cfg))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = {k: ks.KERNELS[k].launches for k in names}
    setup_build = sim.mesh.build_seconds
    lsf = sim.field.lsf_data
    setup_lsf = lsf.build_seconds if lsf is not None else 0.0
    if sim.surfaces is not None:
        counts = {k: fn.launches for k, fn in ks.KERNELS.items()}
        time_on_eps_level(torch, ks, mgb, sim, phase, smi)
        for k, fn in ks.KERNELS.items():
            fn.launches = counts[k]
    t1 = time.perf_counter()
    t = sim.tree
    cells0 = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    boxes0 = [len(x) for x in t.lvl_ids]
    mesh0 = [list(map(int, x)) for x in t.lvl_ids]
    surfaces0 = sim.surfaces.active() if sim.surfaces is not None else []
    epochs, updates, solves, dts = [], [], [], []
    record_epochs(sim, epochs, torch)
    if sim.photoi.enabled:
        record_photoi(sim, ks, updates, torch)
    record_field_cycles(mgb, sim, solves)
    record_dts(sim, dts)
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: ks.KERNELS[k].launches for k in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaf = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    per_lvl = [len(x) for x in t.lvl_ids]
    bnd_lvls = {l: (int(lsf.level_data(l)["has_bnd"].sum()) if lsf
                    else 0) for l in range(1, t.highest_lvl + 1)}
    changed = [k for k, e in enumerate(epochs) if e["add"] or e["rm"]]
    ms_step = 1e3 * (t2 - t1) / steps
    surf = ""
    if sim.surfaces is not None:
        charge = sim.surfaces.get_integral(sim.cc)
        unit = ("elementary charges" if ndim == 3 or sim.st.cylindrical
                else "elementary charges per m")
        surf = (f"; {len(sim.surfaces.active())} surfaces (of "
                f"{len(surfaces0)} after setup), surface charge integral "
                f"{charge:.6e} {unit}")
    log(f"phase {phase}: {cfg.name} {' '.join(extra)}: {cells0} leaf cells "
        f"and boxes per level {boxes0} after setup, {n_leaf} and {per_lvl} "
        f"({sum(per_lvl)} boxes) after {steps} steps{surf}; boxes that hold "
        f"the electrode's boundary per level {bnd_lvls}; setup {setup_s:.2f} s "
        f"(plan building {setup_build:.2f} s, of which the level set's "
        f"distances {setup_lsf:.2f} s); {steps} steps {t2 - t1:.2f} s = "
        f"{ms_step:.2f} ms/step, of which the epochs "
        f"{sum(e['s'] for e in epochs):.2f} s and the photoionization "
        f"updates {sum(u['s'] for u in updates):.2f} s; t = "
        f"{sim.global_time:.4e} s, dt = {sim.global_dt:.4e} s, "
        f"{len(dts) - steps} rejected steps; peak memory {peak_gb:.3f} GB")
    log(f"phase {phase}: {len(epochs)} refinement epochs, {len(changed)} "
        f"changed the mesh (epochs {changed}, boxes added/removed "
        f"{[(epochs[k]['add'], epochs[k]['rm']) for k in changed]}); seconds "
        f"per epoch {[round(e['s'], 3) for e in epochs]}; host plan rebuilds "
        f"in the run {sim.mesh.build_seconds - setup_build:.2f} s, of which "
        f"the level set's distances "
        f"{(lsf.build_seconds if lsf else 0.0) - setup_lsf:.3f} s "
        f"(made at the first solve after a changing epoch, for the changed "
        f"levels only)")
    n_fmg = sum(f for f, _v in solves)
    n_v = sum(v for _f, v in solves)
    log(f"phase {phase}: {len(solves)} field solves in the run: {n_v} "
        f"V-cycles = {n_v / len(solves):.2f} per solve (the electrode's "
        f"residual factor is 1e-8 of the voltage scale, 1e-10 without), "
        f"{n_fmg} FMG cycles; {len(updates)} photoionization updates at "
        f"steps {[u['it'] for u in updates]}, FMG cycles per mode "
        f"{[u['cycles'] for u in updates]}")
    in_updates = {k: sum(u["launches"][k] for u in updates) for k in names}
    log(f"phase {phase}: kernel launches {launches} (setup "
        f"{setup_launches}); per step of the run "
        + str({k: round((launches[k] - setup_launches[k]) / steps, 2)
               for k in names})
        + ", of which inside photoionization updates "
        + str({k: round(in_updates[k] / steps, 2) for k in names}))
    if min(cells0, n_leaf) < min_cells:
        raise RuntimeError(f"fewer leaf cells than the uniform level: "
                           f"{cells0}, {n_leaf} < {min_cells}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    if lsf is not None and not bnd_lvls[t.highest_lvl] > 0:
        raise RuntimeError("the electrode is not resolved to the finest "
                           "level")
    if sim.surfaces is not None and not (
            len(sim.surfaces.active()) and any(e["rm"] for e in epochs)):
        raise RuntimeError("no surface, or no epoch removed boxes")
    n = t.highest_id
    if not bool(torch.isfinite(sim.cc[:, :n]).all()) or \
            not bool(torch.isfinite(sim.fc[:, :, :n]).all()):
        raise RuntimeError("non-finite state after the run")
    fld = leaf_interiors(torch, sim, sim.i_electric_fld)
    if lsf is not None:
        # the field at the tip: the largest norm over the leaf cells
        # outside the electrode
        outside = leaf_interiors(torch, sim, sim.i_lsf) > 0
        emax = float(fld[outside].max())
        ne_in = float(leaf_interiors(torch, sim,
                                     sim.i_electron)[~outside].max())
        log(f"phase {phase}: max(E) outside the electrode = {emax:.4e} V/m "
            f"= {emax / BACKGROUND_FIELD:.2f} times the background "
            f"{BACKGROUND_FIELD:.2e}; voltage "
            f"{sim.field.current_voltage:.4e} V; max electron density inside "
            f"the electrode (its boundary cells carry the species boundary "
            f"condition) {ne_in:.4e} 1/m3")
        if not emax > 3 * BACKGROUND_FIELD:
            raise RuntimeError("the field is not enhanced at the electrode")
    else:
        emax = float(fld.max())
        log(f"phase {phase}: max(E) = {emax:.4e} V/m = "
            f"{emax / BACKGROUND_FIELD:.2f} times the background "
            f"{BACKGROUND_FIELD:.2e}")
        if not emax > BACKGROUND_FIELD:
            raise RuntimeError("max(E) did not rise above the background")
    if sim.photoi.enabled and not float(
            sim.cc[sim.photoi.i_photo, :n].max()) > 0.0:
        raise RuntimeError("the photoionization source is empty")

    params = sim.field.solve_params()
    P, R = mgb.gather_levels(sim.field.mg, sim.cc)
    vc_ms = time_ms(torch, lambda: mgb.fas_vcycle_blocks(sim.field.mg, P, R,
                                                         params), reps=10)
    log(f"phase {phase}: {vc_ms:.3f} ms per V-cycle of the field solve "
        f"({t.highest_lvl} levels, float64)")
    if sim.surfaces is None:
        lvl = t.highest_lvl
        for name in [k for k in names if "sweep" in k] + (
                ["fill_3d"] if ndim == 3 else []):
            time_on_level(torch, ks, mgb, sim, name, lvl, "2b", smi,
                          what=f"the field solve of phase {phase} "
                          f"({bnd_lvls[lvl]} boxes hold the electrode's "
                          f"boundary)")
    return launches


def leaf_volumes(torch, sim):
    """The volume of every interior leaf cell, in leaf_interiors' order."""
    return torch.cat([
        sim.mesh.tb(l).d.vol.reshape(-1).to(sim.cc.dtype)
        for l in range(1, sim.tree.highest_lvl + 1)
        if len(sim.mesh.tb(l).leaves)])


def phase_gas_full(torch, ks, Simulation, mgb, out_dir, smi):
    """Phase 15: the main path with gas dynamics at the card's size
    (gas_heating_cyl_slice.cfg with phase 7's refinement flags); returns
    the launch counts of the run's kernels. Then phase 2b: K1, K2 and K3
    on the finest level of the field solve."""
    phase, ndim, steps = "15", 2, GAS_FULL_STEPS
    extra, _steps, min_cells = AMR_FULL[ndim]
    names = PATH_KERNELS[ndim]
    free_earlier_runs(torch)
    torch.cuda.reset_peak_memory_stats()
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(argv=amr_argv(out_dir / f"p{phase}_full", ndim, "cuda",
                                   extra, GAS_CFG, TABLE_REACTIONS))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    setup_launches = {k: ks.KERNELS[k].launches for k in names}
    t = sim.tree
    cells0 = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    boxes0 = [len(x) for x in t.lvl_ids]
    mesh0 = [list(map(int, x)) for x in t.lvl_ids]
    epochs, updates, solves, dts, gas_lims = [], [], [], [], []
    record_epochs(sim, epochs, torch)
    record_photoi(sim, ks, updates, torch)
    record_field_cycles(mgb, sim, solves)
    record_dts(sim, dts)
    advance_gas, gas_step, gas_s = sim._advance_gas, sim._gas_step, []

    def recorded(*args):
        gas_lims.append(advance_gas(*args))
        return gas_lims[-1]

    def timed(*args):
        # synchronised on both sides: the gas's own time, not the queue of
        # the field solve before it
        torch.cuda.synchronize()
        t = time.perf_counter()
        gas_step(*args)
        torch.cuda.synchronize()
        gas_s.append(time.perf_counter() - t)
    sim._advance_gas, sim._gas_step = recorded, timed
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: ks.KERNELS[k].launches for k in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaf = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    per_lvl = [len(x) for x in t.lvl_ids]
    changed = [k for k, e in enumerate(epochs) if e["add"] or e["rm"]]
    ms_step = 1e3 * (t2 - t1) / steps
    gas_ms = 1e3 * sum(gas_s) / steps
    log(f"phase {phase}: {GAS_CFG.name} {' '.join(extra)}: {cells0} leaf "
        f"cells and boxes per level {boxes0} after setup, {n_leaf} and "
        f"{per_lvl} ({sum(per_lvl)} boxes) after {steps} steps; setup "
        f"{t1 - t0:.2f} s; {steps} steps {t2 - t1:.2f} s = {ms_step:.2f} "
        f"ms/step, of which the gas advance and the coupling {gas_ms:.2f} "
        f"ms/step ({gas_ms / ms_step:.3f} of the step; synchronised before "
        f"and after), the epochs "
        f"{sum(e['s'] for e in epochs):.2f} s and the photoionization "
        f"updates {sum(u['s'] for u in updates):.2f} s; t = "
        f"{sim.global_time:.4e} s; peak memory {peak_gb:.3f} GB")
    log(f"phase {phase}: plasma dt per attempted step "
        f"{[float(f'{v:.4e}') for v in dts]} s; gas dt limit per step "
        f"{[float(f'{v:.4e}') for v in gas_lims]} s, "
        f"{min(gas_lims) / max(dts):.1f} times the largest plasma dt or "
        f"more; {len(changed)} of {len(epochs)} epochs changed the mesh, "
        f"seconds per epoch {[round(e['s'], 3) for e in epochs]}")
    n_v = sum(v for _f, v in solves)
    in_updates = {k: sum(u["launches"][k] for u in updates) for k in names}
    log(f"phase {phase}: {len(solves)} field solves, {n_v} V-cycles = "
        f"{n_v / len(solves):.2f} per solve; {len(updates)} "
        f"photoionization updates, FMG cycles per mode "
        f"{[u['cycles'] for u in updates]}; kernel launches {launches} "
        f"(setup {setup_launches}); per step of the run "
        + str({k: round((launches[k] - setup_launches[k]) / steps, 2)
               for k in names})
        + ", of which inside photoionization updates "
        + str({k: round(in_updates[k] / steps, 2) for k in names}))
    # the energy the plasma gave the gas, and its temperature
    gd, gas = sim.gasdyn, sim.gas
    vol = leaf_volumes(torch, sim)
    U = [leaf_interiors(torch, sim, iv) for iv in gd.gas_vars]
    e0 = gas.pressure * 1e5 / (gas.euler_gamma - 1.0)
    gained = float(((U[gd.i_e] - e0) * vol).sum())
    ke = 0.5 * sum(U[m] ** 2 for m in gd.i_mom) / U[gd.i_rho]
    p = (gas.euler_gamma - 1.0) * (U[gd.i_e] - ke)
    N = leaf_interiors(torch, sim, gd.i_gas_dens)
    T = p / (N * 1.3806503e-23)
    dT = float(T.max()) - gas.temperature
    log(f"phase {phase}: Joule energy of the plasma (sum of J.E dt) "
        f"{sim.global_JdotE:.6e} J, energy gained by the gas "
        f"(sum of (gas_e - E0) dV) {gained:.6e} J; largest temperature rise "
        f"{dT:.6e} K (T = p / (N k_B), T0 = {gas.temperature} K); rho in "
        f"[{float(U[gd.i_rho].min()):.10g}, {float(U[gd.i_rho].max()):.10g}] "
        f"kg/m3")
    if min(cells0, n_leaf) < min_cells:
        raise RuntimeError(f"fewer leaf cells than the frozen slice: "
                           f"{cells0}, {n_leaf} < {min_cells}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    if not changed or len(updates) < 2:
        raise RuntimeError("needs a changing epoch and two photoionization "
                           "updates")
    n = t.highest_id
    if not bool(torch.isfinite(sim.cc[:, :n]).all()) or \
            not bool(torch.isfinite(sim.fc[:, :, :n]).all()):
        raise RuntimeError("non-finite state after the run")
    if not (sim.global_JdotE > 0 and gained > 0 and dT > 0):
        raise RuntimeError("the plasma did not heat the gas")
    if not min(gas_lims) > max(dts):
        raise RuntimeError("the gas dt limit is below the plasma's dt")
    emax = float(sim.cc[sim.i_electric_fld, :n].max())
    log(f"phase {phase}: max(E) = {emax:.4e} V/m (background "
        f"{BACKGROUND_FIELD:.2e})")
    if not emax > BACKGROUND_FIELD:
        raise RuntimeError("max(E) did not rise above the background field")
    for name in names:
        time_on_level(torch, ks, mgb, sim, name, t.highest_lvl, "2b", smi,
                      what=f"the field solve of phase {phase}")
    return launches


#: the programs' cuda-vs-cpu runs (phase 3t): label, config, ndim, table,
#: flags, steps, the kernels that must be launched, and whether both
#: simulations start past 1 ns (the controller of velocity_control_2d acts
#: from then on)
PROGRAMS_SMALL = [
    ("a", AMR_CFG[2], 2, TABLE,
     ["-photoi%per_steps=2", "-field_amplitude=-1.8e6", "-output%log=t",
      "-silo_write=t", "-output%dt=5e-14",
      f"-user%module={PROGRAMS / 'velocity_control_2d.py'}"], 4,
     ("fill_sweep_2d", "sweep_2d", "fill_2d"), True),
    ("b", DATA / "comparison_air_2d.cfg", 2, TABLE, [], 8,
     ("fill_sweep_2d", "sweep_2d", "fill_2d"), False),
    ("c", DATA / "stability_3d.cfg", 3, TABLE, ["-output%dt=5e-14"], 4,
     ("sweep_3d", "fill_3d"), False)]
#: the stock writers on the main path at the card's size (phase 16), under
#: velocity_control_2d: flags beside phase 7's and steps
WRITERS_FULL = (["-field_amplitude=-1.8e6", "-output%log=t", "-silo_write=t",
                 "-output%dt=1.5e-13",
                 f"-user%module={PROGRAMS / 'velocity_control_2d.py'}"], 6)
PAST_ONE_NS = 1.1e-9


def record_hooks(sim, calls, torch=None, seconds=None):
    """Record every call of the generic and field_amplitude hooks of
    ``sim`` (name, time, amplitude); with ``seconds``, add each call's host
    seconds there (synchronised before, so that the queue is not the
    hook's)."""
    for name in ("generic", "field_amplitude"):
        hook = getattr(sim.user, name)
        if hook is None:
            continue

        def wrapped(s, t_, hook=hook, name=name):
            if seconds is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = hook(s, t_)
            if seconds is not None:
                seconds.append(time.perf_counter() - t0)
            calls.append((name, t_, 0.0 if out is None else float(out)))
            return out
        setattr(sim.user, name, wrapped)


def phase_programs_cpu_vs_cuda(torch, ks, Simulation, mgb, out_dir):
    """Phase 3t: the programs with the stock writers on the card and on
    the CPU at the committed sizes: (a) the main path's slice under
    velocity_control_2d (both simulations past 1 ns, photoionization every
    2 steps), (b) comparison_air_2d (the tabulated electrode potentials in
    the ghost constants A), (c) stability_3d. The same mesh at every epoch,
    dt at every attempted step, (FMG, V-cycle) counts of every field solve,
    every recorded hook call, every variable within 1e-9 of its scale and
    every written file (io/compare.py: log, grid files, chemistry files)
    within 1e-8, the last of the 9 digits the text files print; the path's
    kernels launched."""
    from afivo_streamer_tpu_torch.io.compare import compare_outputs
    for label, cfg, ndim, table, extra, steps, must, past in PROGRAMS_SMALL:
        phase = f"3t{label}"
        if cfg != AMR_CFG[2]:
            extra = extra + [f"-user%module={PROGRAMS / (cfg.stem + '.py')}"]
        sims, rec = {}, {}
        for dev in ("cpu", "cuda"):
            sim = Simulation(argv=amr_argv(out_dir / f"p{phase}_{dev}", ndim,
                                           dev, extra, cfg, table))
            if past:
                sim.global_time = PAST_ONE_NS
            r = rec[dev] = {"epochs": [], "dts": [], "solves": [],
                            "calls": []}
            record_epochs(sim, r["epochs"], torch)
            record_dts(sim, r["dts"])
            record_field_cycles(mgb, sim, r["solves"])
            record_hooks(sim, r["calls"])
            before = {k: fn.launches for k, fn in ks.KERNELS.items()}
            sim.run(max_steps=steps)
            r["launched"] = {k: fn.launches - before[k]
                             for k, fn in ks.KERNELS.items()}
            sims[dev] = sim
        a, b = sims["cpu"], sims["cuda"]
        ra, rb = rec["cpu"], rec["cuda"]
        if [e["ids"] for e in ra["epochs"]] != \
                [e["ids"] for e in rb["epochs"]]:
            raise RuntimeError(f"phase {phase}: the meshes differ")
        if ra["solves"] != rb["solves"]:
            raise RuntimeError(f"phase {phase}: the cycle counts differ: "
                               f"{ra['solves']} {rb['solves']}")
        if len(ra["dts"]) != len(rb["dts"]) or any(
                abs(x / y - 1) > 1e-9 for x, y in zip(ra["dts"], rb["dts"])):
            raise RuntimeError(f"phase {phase}: dt differs")
        ca, cb = ra["calls"], rb["calls"]
        if [c[0] for c in ca] != [c[0] for c in cb] or any(
                abs(x - y) > 1e-9 * max(abs(x), 1e-300)
                for p, q in zip(ca, cb) for x, y in zip(p[1:], q[1:])):
            raise RuntimeError(f"phase {phase}: the hook calls differ")
        if any(rb["launched"][k] <= 0 for k in must):
            raise RuntimeError(f"phase {phase}: not launched on the card: "
                               f"{rb['launched']}")
        n = a.tree.highest_id
        use = torch.as_tensor(a.tree.in_use[:n])
        worst, worst_name = 0.0, ""
        for iv, name in enumerate(a.registry.cc_names):
            if iv == a.i_tmp:
                continue
            ref = a.cc[iv, :n][use]
            err = float((b.cc[iv, :n].cpu()[use] - ref).abs().max())
            scale = float(ref.abs().max())
            rel = err / scale if scale > 0 else err
            if rel > worst:
                worst, worst_name = rel, name
        if worst > 1e-9:
            raise RuntimeError(f"phase {phase}: cuda vs cpu {worst} "
                               f"{worst_name}")
        # the text files print 9 significant digits: a deviation of 1e-13
        # can turn the last one, 1e-8 of the value
        files = compare_outputs(*(out_dir / f"p{phase}_{dev}"
                                  for dev in sims), 1e-8)
        grids = sum(k.startswith("grid_") for k in files)
        if "log.txt" not in files or grids < 3 or b.out_cnt < 2:
            raise RuntimeError(f"phase {phase}: too few outputs: {files}")
        amps = [c[2] for c in cb if c[0] == "field_amplitude"]
        extra_text = ""
        if label == "b":
            coords = b.mesh.gc(1).dirs[3].bc_coords
            _kind, val = b.field.phi_bc(b.i_phi, 3, coords,
                                        {"voltage": b.field.current_voltage})
            if val.device.type != "cuda" or not float(val.max()) > float(
                    val.min()):
                raise RuntimeError(f"phase {phase}: no tabulated profile "
                                   f"on the card")
            extra_text = (f"; the top plane's potential on level 1 from "
                          f"{float(val.min()):.6g} to {float(val.max()):.6g}"
                          f" V at {b.field.current_voltage:.6g} V")
        hooks = [k for k, v in vars(b.user).items() if v is not None]
        log(f"phase {phase}: {cfg.name} (hooks {hooks}) "
            f"cuda vs cpu, {steps} steps: the same mesh at "
            f"{len(ra['epochs'])} epochs "
            f"({sum(1 for e in ra['epochs'] if e['add'] or e['rm'])} changed "
            f"it), dt at {len(ra['dts'])} attempted steps, (FMG, V-cycle) "
            f"counts at {len(ra['solves'])} field solves "
            f"{sorted(set(ra['solves']))}, {len(cb)} hook calls (field "
            f"amplitude from {min(amps, default=0.0):.8g} to "
            f"{max(amps, default=0.0):.8g} V/m); worst scaled deviation "
            f"{worst:.3e} ({worst_name}); {len(files)} files within 1e-8, "
            f"the worst {max(files.values()):.3e} "
            f"({max(files, key=files.get)}), {grids} grid files; launches "
            f"on the card {rb['launched']}{extra_text}")


def writers_against_main_path(w, p7):
    """Phase 16 against phase 7 of the same call: ms per step, and the K1-K3
    launches per step, which must be equal where the two runs made the
    same field solves and photoionization updates on the same meshes (the
    writers and hooks launch nothing; phase 16 checks that itself). The
    outputs of phase 16 shorten the steps that end at an output time, so
    its solves may differ from phase 7's."""
    same = (w["solves"] == p7["solves"] and w["updates"] == p7["updates"]
            and w["epochs"] == p7["epochs"])
    log(f"phase 16: {w['ms_step']:.2f} ms/step against phase 7's "
        f"{p7['ms_step']:.2f} ({w['ms_step'] / p7['ms_step']:.3f}); K1-K3 "
        f"launches per step {w['per_step']} against {p7['per_step']}; the "
        f"same field solves, photoionization updates and meshes as phase "
        f"7: {same} (V-cycles {sum(v for _f, v in w['solves'])} against "
        f"{sum(v for _f, v in p7['solves'])}; dt per step "
        f"{[float(f'{v:.4e}') for v in w['dts']]} against "
        f"{[float(f'{v:.4e}') for v in p7['dts']]})")
    if same and w["per_step"] != p7["per_step"]:
        raise RuntimeError("phase 16: the same solves as phase 7 with other "
                           "launch counts")


def file_bytes(prefix, pattern):
    return sum(p.stat().st_size for p in prefix.parent.glob(
        f"{prefix.name}_{pattern}"))


def phase_writers_full(torch, ks, Simulation, mgb, out_dir, smi):
    """Phase 16: the main path at phase 7's size under velocity_control_2d
    with the stock writers on (the text log and the grid files, the
    chemistry files), output%dt set for outputs within the run: ms per
    step, seconds per output of each writer (synchronised), the grid
    file's bytes, the hooks' host ms per step, V-cycles per field solve,
    K1-K3 launches per step and inside the writers and hooks (none), peak
    memory. Returns what main() holds against phase 7."""
    phase, ndim = "16", 2
    extra7, _steps7, min_cells = AMR_FULL[ndim]
    extra, steps = WRITERS_FULL
    names = PATH_KERNELS[ndim]
    free_earlier_runs(torch)
    torch.cuda.reset_peak_memory_stats()
    ks.reset_launch_counts()
    prefix = out_dir / f"p{phase}_full"
    t0 = time.perf_counter()
    sim = Simulation(argv=amr_argv(prefix, ndim, "cuda", extra7 + extra))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    setup_launches = {k: ks.KERNELS[k].launches for k in names}
    t = sim.tree
    cells0 = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    epochs, updates, solves, dts, calls, hook_s = [], [], [], [], [], []
    record_epochs(sim, epochs, torch)
    record_photoi(sim, ks, updates, torch)
    record_field_cycles(mgb, sim, solves)
    record_dts(sim, dts)
    record_hooks(sim, calls, torch, hook_s)
    out = sim.output
    writer_s = {"log": [], "grid": [], "chemistry": []}
    inside = {k: 0 for k in names}

    def timed(fn, key):
        def wrapped(*args):
            torch.cuda.synchronize()
            before = {k: ks.KERNELS[k].launches for k in names}
            t_ = time.perf_counter()
            r = fn(*args)
            torch.cuda.synchronize()
            writer_s[key].append(time.perf_counter() - t_)
            for k in names:
                inside[k] += ks.KERNELS[k].launches - before[k]
            return r
        return wrapped
    out.log = timed(out.log, "log")
    out.write_grid = timed(out.write_grid, "grid")
    out.chemical_rates = timed(out.chemical_rates, "chemistry")
    out.chemical_amounts = timed(out.chemical_amounts, "chemistry")
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: ks.KERNELS[k].launches for k in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaf = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    ms_step = 1e3 * (t2 - t1) / steps
    n_out = sim.out_cnt
    per_out = {k: sum(v) / max(len(v), 1) for k, v in writer_s.items()}
    per_out["chemistry"] *= 2  # rates and amounts: one call each
    grid_bytes = file_bytes(prefix, "grid_*.npz")
    n_grid = len(list(prefix.parent.glob(f"{prefix.name}_grid_*.npz")))
    hook_ms = 1e3 * sum(hook_s) / steps
    n_v = sum(v for _f, v in solves)
    per_step = {k: round((launches[k] - setup_launches[k]) / steps, 2)
                for k in names}
    log(f"phase {phase}: {AMR_CFG[ndim].name} {' '.join(extra7 + extra)}: "
        f"{cells0} leaf cells after setup, {n_leaf} after {steps} steps; "
        f"setup {t1 - t0:.2f} s; {steps} steps {t2 - t1:.2f} s = "
        f"{ms_step:.2f} ms/step with {n_out} outputs in the run (t = "
        f"{sim.global_time:.4e} s); peak memory {peak_gb:.3f} GB")
    log(f"phase {phase}: seconds per output (synchronised, the run's "
        f"outputs and the setup's): the log {per_out['log']:.4f} "
        f"({len(writer_s['log'])} calls), the grid file "
        f"{per_out['grid']:.4f} ({len(writer_s['grid'])} calls), the "
        f"chemistry files {per_out['chemistry']:.4f}; {n_grid} grid files "
        f"of {grid_bytes / max(n_grid, 1) / 1e6:.3f} MB each on average; "
        f"hooks {hook_ms:.3f} host ms per step ({len(hook_s)} calls, "
        f"{sum(1 for c in calls if c[0] == 'generic')} of generic); "
        f"K1-K3 launches inside the writers and hooks {inside}")
    log(f"phase {phase}: {len(solves)} field solves, {n_v} V-cycles = "
        f"{n_v / len(solves):.2f} per solve; FMG cycles per photoionization "
        f"update {[u['cycles'] for u in updates]}; dt per attempted step "
        f"{[float(f'{v:.4e}') for v in dts]}; kernel launches {launches} "
        f"(setup {setup_launches}), per step of the run {per_step}")
    if min(cells0, n_leaf) < min_cells:
        raise RuntimeError(f"fewer leaf cells than the frozen slice: "
                           f"{cells0}, {n_leaf} < {min_cells}")
    if not all(v > 0 for v in launches.values()) or any(inside.values()):
        raise RuntimeError(f"launches {launches}, inside the writers and "
                           f"hooks {inside}")
    if n_out < 2 or n_grid != n_out + 1 or len(writer_s["log"]) != n_out:
        raise RuntimeError(f"a writer wrote nothing: {n_out} outputs, "
                           f"{n_grid} grid files, {writer_s}")
    for name in ("log", "species", "reactions", "stoich_matrix", "summary",
                 "rates", "amounts"):
        if file_bytes(prefix, f"{name}.txt") == 0:
            raise RuntimeError(f"phase {phase}: empty _{name}.txt")
    n = t.highest_id
    if not bool(torch.isfinite(sim.cc[:, :n]).all()):
        raise RuntimeError("non-finite state after the run")
    return {"launches": launches, "ms_step": ms_step, "per_step": per_step,
            "solves": solves,
            "updates": [u["cycles"] for u in updates],
            "epochs": [e["ids"] for e in epochs], "dts": dts}


def time_on_eps_level(torch, ks, mgb, sim, phase, smi):
    """Phase 2b of a dielectric run: its sweep and its fill (K4 and K5 in
    3D, K2 and K3-swap in 2D) on the finest level with extrapolating
    ghosts of eps, one that also holds an electrode's boundary where the
    mesh has one."""
    mg, t, ndim = sim.field.mg, sim.tree, sim.ndim
    lsf = sim.field.lsf_data
    bnd = {l: (int(lsf.level_data(l)["has_bnd"].sum()) if lsf else 0)
           for l in range(1, t.highest_lvl + 1)}
    lvls = [l for l in range(1, t.highest_lvl + 1)
            if mg.rb_extrap(l) and (ndim == 3 or mg.smoother(l).has_swap)]
    if not lvls:
        raise RuntimeError("no level with extrapolating ghosts of eps")
    lvl = max([l for l in lvls if bnd[l] > 0] or lvls)
    what = (f"the field solve of phase {phase} after setup "
            f"({int(mg.op(lvl).veps.sum())} boxes with variable eps, "
            f"{bnd[lvl]} hold the electrode's boundary)")
    for name in (("sweep_3d", "fill_3d") if ndim == 3
                 else ("sweep_2d", "fill_2d_swap")):
        time_on_level(torch, ks, mgb, sim, name, lvl, "2b", smi, what=what)


def phase_imex(torch, ks):
    """Phase 3q: the IMEX integrators on the stiff reaction-diffusion
    problem of tests/test_imex.py (programs/reaction_diffusion.py: the
    implicit step is a Helmholtz solve through the multigrid, K1-K3 on the
    card) at 32^2 and 512^2 cells: the runs of that test held to its bounds
    against the solution (imex_euler below 0.05 and first order,
    imex_trapezoidal below 5e-4 and 0.15 of imex_euler's error), the FMG
    cycles per implicit solve and the kernel launches; then the card
    against the CPU: the whole trapezoidal run at 32^2, one step of each
    scheme at 512^2, every time state within rtol 1e-9 of its scale and
    the same FMG cycles."""
    from afivo_streamer_tpu_torch.programs import reaction_diffusion as rd
    for coarse, level in IMEX_MESHES:
        cells = f"{coarse * 2 ** (level - 1)}^2"
        errs, fmg = {}, {}
        ks.reset_launch_counts()
        t0 = time.perf_counter()
        for integrator, dt, steps in IMEX_RUNS:
            prob = rd.ReactionDiffusion(coarse, level, "cuda")
            errs[integrator, dt] = prob.run(integrator, dt, steps)
            fmg[integrator, dt] = prob.fmg_cycles
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: ks.KERNELS[k].launches for k in PATH_KERNELS[2]}
        e1, e2 = errs["imex_euler", 2e-3], errs["imex_euler", 1e-3]
        et = errs["imex_trapezoidal", 2e-3]
        n_solves = sum(len(v) for v in fmg.values())
        log(f"phase 3q: IMEX at {cells} cells ({level} levels): relative "
            f"error imex_euler dt 2e-3 {e1:.6e}, dt 1e-3 {e2:.6e} (ratio "
            f"{e2 / e1:.4f}, limit 0.65), imex_trapezoidal dt 2e-3 {et:.6e} "
            f"({et / e1:.4f} of imex_euler's, limits 0.15 and 5e-4); FMG "
            f"cycles per implicit solve "
            f"{ {f'{k[0]} {k[1]:g}': sorted(set(v)) for k, v in fmg.items()} } "
            f"({n_solves} solves); kernel launches {launches} = "
            f"{ {k: round(v / n_solves, 1) for k, v in launches.items()} } "
            f"per implicit solve (the explicit substeps launch none); "
            f"{wall:.2f} s")
        if not (e1 < 0.05 and e2 < 0.65 * e1 and et < 0.15 * e1
                and et < 5e-4):
            raise RuntimeError(f"phase 3q: IMEX outside the bounds: {errs}")
        if not all(v > 0 for v in launches.values()):
            raise RuntimeError(f"phase 3q: a kernel was not launched: "
                               f"{launches}")
        runs = ([IMEX_RUNS[2]] if level == 2 else
                [(integrator, dt, 1) for integrator, dt, _ in IMEX_RUNS[::2]])
        for integrator, dt, steps in runs:
            probs = {dev: rd.ReactionDiffusion(coarse, level, dev)
                     for dev in ("cpu", "cuda")}
            for prob in probs.values():
                prob.run(integrator, dt, steps)
            a, b = probs["cpu"], probs["cuda"]
            worst = 0.0
            for s in range(3):
                ref = a.cc[rd.I_U + s, a.ids]
                got = b.cc[rd.I_U + s, b.ids].cpu()
                worst = max(worst, float((got - ref).abs().max())
                            / max(float(ref.abs().max()), 1e-300))
            log(f"phase 3q: {integrator} at {cells} cells, {steps} steps: "
                f"cuda vs cpu worst scaled deviation {worst:.3e} (limit "
                f"1e-9), FMG cycles {b.fmg_cycles} on both: "
                f"{a.fmg_cycles == b.fmg_cycles}")
            if worst > 1e-9 or a.fmg_cycles != b.fmg_cycles:
                raise RuntimeError(f"phase 3q: cuda vs cpu {worst}, "
                                   f"{a.fmg_cycles} {b.fmg_cycles}")
        free_earlier_runs(torch)


def phase_energy_physics(torch, Simulation, out_dir):
    """Phase 3i: the 1D slice without a seed (a uniform background of 1e13
    electrons per m3 in the uniform field) under ee53 on the card to
    0.3 ns: the mean energy in mid-domain within 5 % of the table's value
    at the local reduced field, the energy density >= 0, the energy-loss
    limit active."""
    from afivo_streamer_tpu_torch import constants as uc
    from afivo_streamer_tpu_torch.physics.transport_data import TD_ENERGY_EV
    sim = Simulation(argv=amr_argv(
        out_dir / "p3i", 1, "cuda",
        EE_FLAGS + ["-seed_density=0", "-background_density=1e13"], ONED_CFG,
        TABLE_NEW))
    limits = []
    record_dt_limits(sim, limits)
    sim.run(end_time=3.0e-10)
    t = sim.tree
    ids = t.lvl_leaves[t.highest_lvl - 1]
    b, mid = int(ids[len(ids) // 2]), t.nc // 2
    ne, en, fld = (float(sim.cc[iv, b, mid]) for iv in (
        sim.i_electron, sim.i_electron_energy, sim.i_electric_fld))
    mean_eV = en / max(ne, 1.0)
    td = fld * uc.SI_to_Townsend * sim.gas.inverse_number_density
    want = float(sim.td.tbl.get_col(TD_ENERGY_EV, torch.tensor(
        [td], dtype=torch.float64))[0])
    log(f"phase 3i: uniform field, {sim.it - 1} steps to t = "
        f"{sim.global_time:.4e} s: mean energy in mid-domain {mean_eV:.6f} "
        f"eV, the table's value at {td:.4f} Td {want:.6f} eV (limit 5 %)")
    if not ne > 0 or abs(mean_eV - want) > 0.05 * want:
        raise RuntimeError("phase 3i: the mean energy did not relax to the "
                           "table's value")
    check_energy_model(torch, sim, limits, "3i", nonnegative=True)


def phase_1d_full(torch, ks, Simulation, out_dir):
    """Phase 10: the planar 1D slice under ee53 on uniform 1 um cells for 10
    steps. One dimension has no kernel: the launch counts must stay 0."""
    extra, steps = ONED_FULL
    free_earlier_runs(torch)
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(argv=amr_argv(out_dir / "p10_1d", 1, "cuda",
                                   extra + EE_FLAGS, ONED_CFG, TABLE_NEW))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    limits, epochs = [], []
    record_dt_limits(sim, limits)
    record_epochs(sim, epochs, torch)
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    t = sim.tree
    n_leaf = sum(len(l) for l in t.lvl_leaves) * t.nc
    launches = {k: fn.launches for k, fn in ks.KERNELS.items()}
    log(f"phase 10: {ONED_CFG.name} {' '.join(extra + EE_FLAGS)}: {n_leaf} "
        f"leaf cells, {sum(len(x) for x in t.lvl_ids)} boxes on "
        f"{t.highest_lvl} levels; setup {t1 - t0:.2f} s; {steps} steps "
        f"{t2 - t1:.2f} s = {1e3 * (t2 - t1) / steps:.2f} ms/step, of which "
        f"{len(epochs)} refinement epochs {sum(e['s'] for e in epochs):.2f} "
        f"s; t = {sim.global_time:.4e} s; kernel launches "
        f"{sum(launches.values())} (none by design: one dimension has no "
        f"kernel in either package, its smoother is tensor operations)")
    if n_leaf < 16000:
        raise RuntimeError(f"phase 10: only {n_leaf} leaf cells")
    if any(launches.values()):
        raise RuntimeError(f"phase 10: a kernel was launched: {launches}")
    n = t.highest_id
    if not bool(torch.isfinite(sim.cc[:, :n]).all()):
        raise RuntimeError("phase 10: non-finite state")
    check_energy_model(torch, sim, limits, "10")



# ------------------------------------------------ Monte-Carlo photons (3u)
def check_mc_photons(sim, phase):
    """The Monte-Carlo update of the card's run made photons, and with
    dielectrics some reached a surface; a line on the last update."""
    mc = sim.photoi.mc
    note = (f"phase {phase}: last Monte-Carlo update: {mc.n_photons} photons"
            f" made, {mc.n_deposited} deposited")
    if mc.n_photons <= 0:
        raise RuntimeError(f"phase {phase}: no Monte-Carlo photons")
    if sim.surfaces is not None:
        rows = [s.id_out for s in sim.surfaces.active()]
        flux = float(sim.cc[sim.surfaces.i_photon, rows,
                            :sim.surfaces.face_cells].abs().max())
        n_lit = int((sim.cc[sim.surfaces.i_photon, rows,
                            :sim.surfaces.face_cells] != 0).any(1).sum())
        note += (f"; {n_lit} of {len(rows)} surfaces hold a photon flux, "
                 f"max {flux:.4e} 1/(m2 s)")
        if n_lit == 0:
            raise RuntimeError(f"phase {phase}: no photon reached a surface")
    log(note)


# ------------------------------------------- checkpoint and restart (3v)
def restart_point(prefix, per_steps):
    """The first checkpoint of a run written at an iteration that is no
    refinement epoch (one written at an epoch's iteration holds the state
    before that epoch, which a restart skips, in both packages)."""
    import numpy as np
    for path in sorted(prefix.parent.glob(f"{prefix.name}_*.dat.npz")):
        it = int(np.load(path)["payload_it"])
        if it > 0 and it % per_steps != 0:
            return path
    raise RuntimeError(f"no checkpoint of {prefix.name} between epochs")


def state_deviation(torch, a, b):
    """The same mesh and the worst deviation of ``b``'s variables (but the
    scratch one) from ``a``'s, scaled by each variable's largest magnitude
    over the boxes in use."""
    if [list(x) for x in a.tree.lvl_ids] != [list(x) for x in b.tree.lvl_ids]:
        return None
    n = a.tree.highest_id
    use = torch.as_tensor(a.tree.in_use[:n])
    worst = 0.0
    for iv, name in enumerate(a.registry.cc_names):
        if iv == a.i_tmp:
            continue
        ref = a.cc[iv, :n].cpu()[use]
        got = b.cc[iv, :n].cpu()[use]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


def phase_restart(torch, Simulation, out_dir):
    """Phase 3v: checkpoints and restart on the card. The cylindrical slice
    with live refinement and photoionization every 2 steps (air_cyl_amr_
    slice.cfg) runs 8 steps on the card and on the CPU, writing a
    checkpoint at every output; a run restarted from the first checkpoint
    between two epochs continues to the same step: on the card from the
    card's checkpoint, on the card from the CPU's and on the CPU from the
    card's. Each must give the uninterrupted run's mesh, time, dt and
    state (within 1e-9 of each variable's scale)."""
    phase, steps = "3v", 8
    flags = ["-photoi%per_steps=2", "-output%dt=1e-13", "-datfile%write=t"]
    full, ckpt = {}, {}
    for dev in ("cuda", "cpu"):
        prefix = out_dir / f"p{phase}_{dev}"
        full[dev] = Simulation(argv=amr_argv(prefix, 2, dev, flags))
        full[dev].run(max_steps=steps)
        ckpt[dev] = restart_point(prefix, full[dev].refine_cfg.per_steps)
    lines = []
    for dev, src in (("cuda", "cuda"), ("cuda", "cpu"), ("cpu", "cuda")):
        t0 = time.perf_counter()
        sim = Simulation(argv=amr_argv(
            out_dir / f"p{phase}_{dev}_from_{src}", 2, dev,
            flags[:2] + [f"-restart_from_file={ckpt[src]}"]))
        it0 = sim.it
        sim.run(max_steps=steps)
        ref = full[src]
        worst = state_deviation(torch, ref, sim)
        ok = (worst is not None and worst <= 1e-9
              and abs(sim.global_time / ref.global_time - 1) <= 1e-9
              and abs(sim.global_dt / ref.global_dt - 1) <= 1e-9)
        lines.append(f"{dev} from the {src}'s checkpoint at step {it0} "
                     f"({time.perf_counter() - t0:.2f} s): same mesh "
                     f"{worst is not None}, worst scaled deviation from the "
                     f"uninterrupted {src} run {worst}")
        if not ok:
            raise RuntimeError(f"phase {phase}: {lines[-1]}")
    log(f"phase {phase}: air_cyl_amr_slice.cfg, {steps} steps with a "
        f"checkpoint at every output; restarted runs: " + "; ".join(lines))


# ------------------------------------------------ the opt-in writers (3w)
#: the writers' runs of phase 3w: config, ndim, table, flags, steps
WRITER_FLAGS = ["-output%dt=1e-13", "-output%npz=t", "-output%vtk=t",
                "-lineout%write=t", "-lineout%npoints=100", "-plane%write=t",
                "-plane%npixels=32 32", "-cross%write=t", "-cross%npoints=50",
                "-field_maxima%write=t", "-field_maxima%threshold=1.9e6",
                "-compute_power_density=t", "-output%conductivity=t",
                "-output%electron_current=t", "-output%write_source=e",
                "-datfile%write=t", "-silo_write=t"]
WRITERS_SMALL = [
    (AMR_CFG[2], 2, TABLE, ["-photoi%per_steps=2"] + WRITER_FLAGS, 4),
    (DATA / "air_cyl_slice.cfg", 2, TABLE_NEW,
     ["-input_data%old_style=f", "-output%dt=2e-14", "-output%npz=t",
      "-output%electron_energy=t"], 4),
    (DATA / "dielectric_cyl_slice.cfg", 2, TABLE,
     ["-photoi%per_steps=2", f"-user%module={USER_MODULE}",
      "-output%dt=1e-13", "-silo_write=t", "-dielectric%write=t",
      "-output%vtk=t"] + MC_FLAGS[:2] + ["-photoi_mc%num_photons=20000"], 4),
    (CFG[3], 3, TABLE,
     ["-refine_max_dx=5e-4", "-output%dt=1e-13", "-output%npz=t",
      "-output%vtk=t", "-plane%write=t", "-plane%rmin=0 0 0.45",
      "-plane%rmax=1 1 0.45", "-lineout%write=t", "-datfile%write=t"], 2)]


def phase_writers_cpu_vs_cuda(torch, Simulation, out_dir):
    """Phase 3w: the opt-in writers on the card and on the CPU, every file
    the CPU's run wrote held against the card's by io/compare.py within
    1e-8 (the uniform-grid npz with the extra variables, the VTK grid, the
    checkpoints, the line, the plane, the cross sections, the field maxima
    above 1.9 MV/m, the power density, and the surfaces' data in the grid
    files)."""
    from afivo_streamer_tpu_torch.io.compare import compare_outputs
    phase = "3w"
    for k, (cfg, ndim, table, extra, steps) in enumerate(WRITERS_SMALL):
        t0 = time.perf_counter()
        for dev in ("cpu", "cuda"):
            sim = Simulation(argv=amr_argv(out_dir / f"p{phase}{k}_{dev}",
                                           ndim, dev, extra, cfg, table))
            sim.run(max_steps=steps)
        worst = compare_outputs(out_dir / f"p{phase}{k}_cpu",
                                out_dir / f"p{phase}{k}_cuda", 1e-8)
        kinds = sorted({re.sub(r"\d{6}", "N", name) for name in worst})
        log(f"phase {phase}: {cfg.name} ({steps} steps, "
            f"{time.perf_counter() - t0:.2f} s): {len(worst)} files the "
            f"same within 1e-8 (kinds {kinds}), worst "
            f"{max(worst.values()):.3e}")
        if ("vtk" in " ".join(extra)) != any(n.endswith(".vtk")
                                             for n in worst):
            raise RuntimeError(f"phase {phase}: a writer wrote nothing")


# -------------------------- the Monte-Carlo main path at full size (17)
MC_FULL_STEPS = 6


def host_rss_gb():
    """The process's peak host memory so far (ru_maxrss) in GB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def phase_mc_full(torch, ks, Simulation, out_dir):
    """Phase 17: the main path at phase 7's size with Monte-Carlo
    photoionization at the default 5,000,000 photons per update (physical
    photons off), 6 steps: ms per step and the busy share, photons per
    update, ms per update split into the host's generation and flight, the
    locate, the copy to the card, the deposit and the prolongation (each
    stage synchronised), peak device and host memory, K1-K3 launches per
    step; then one checkpoint of the final state written and read back
    onto the card (seconds and bytes, the state restored exactly).
    Returns the launch counts and the per-update ms."""
    from afivo_streamer_tpu_torch.io.checkpoint import write_checkpoint
    from afivo_streamer_tpu_torch.physics.photoi_mc import STAGES
    phase, ndim, steps = "17", 2, MC_FULL_STEPS
    extra7, _steps7, min_cells = AMR_FULL[ndim]
    names = PATH_KERNELS[ndim]
    free_earlier_runs(torch)
    torch.cuda.reset_peak_memory_stats()
    ks.reset_launch_counts()
    rss0 = host_rss_gb()
    prefix = out_dir / f"p{phase}_full"
    t0 = time.perf_counter()
    sim = Simulation(argv=amr_argv(prefix, ndim, "cuda", extra7 + MC_FLAGS))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mc = sim.photoi.mc
    mc.sync_stages = True
    setup_launches = {k: ks.KERNELS[k].launches for k in names}
    t = sim.tree
    cells0 = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    epochs, updates, stages = [], [], []
    record_epochs(sim, epochs, torch)
    record_photoi(sim, ks, updates, torch)
    orig = sim.photoi.set_src

    def with_stages(cc, dt=None, params=None):
        cc = orig(cc, dt, params)
        stages.append((mc.n_photons, mc.n_deposited, dict(mc.timings)))
        return cc
    sim.photoi.set_src = with_stages
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: ks.KERNELS[k].launches for k in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step = 1e3 * (t2 - t1) / steps
    n_leaf = sum(len(l) for l in t.lvl_leaves) * t.nc ** ndim
    changed = [k for k, e in enumerate(epochs) if e["add"] or e["rm"]]
    log(f"phase {phase}: {AMR_CFG[2].name} {' '.join(extra7 + MC_FLAGS)} "
        f"(num_photons {mc.num_photons}): {cells0} leaf cells after setup, "
        f"{n_leaf} after {steps} steps on {t.highest_lvl} levels; setup "
        f"{t1 - t0:.2f} s; {steps} steps {t2 - t1:.2f} s = {ms_step:.2f} "
        f"ms/step, of which the epochs {sum(e['s'] for e in epochs):.2f} s "
        f"and the Monte-Carlo updates {sum(u['s'] for u in updates):.2f} s; "
        f"{len(changed)} epochs changed the mesh; peak device memory "
        f"{peak_gb:.3f} GB, peak host memory of the process {rss0:.3f} GB "
        f"before the phase and {host_rss_gb():.3f} GB after")
    for u, (made, kept, tm) in zip(updates, stages):
        log(f"phase {phase}: update at step {u['it']}: {made} photons made, "
            f"{kept} deposited; {1e3 * u['s']:.1f} ms = "
            + ", ".join(f"{s} {1e3 * tm.get(s, 0.0):.1f}" for s in STAGES)
            + f" ms (host plan building {1e3 * u['build_s']:.1f} ms); "
            f"kernel launches {u['launches']}")
    per_step = {k: round((launches[k] - setup_launches[k]) / steps, 2)
                for k in names}
    log(f"phase {phase}: kernel launches {launches}, per step {per_step}")
    if min(cells0, n_leaf) < min_cells:
        raise RuntimeError(f"phase {phase}: fewer leaf cells than the frozen "
                           f"slice: {cells0}, {n_leaf} < {min_cells}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"phase {phase}: a kernel was not launched")
    if not changed or len(updates) < 2:
        raise RuntimeError(f"phase {phase}: needs a changing epoch and two "
                           f"photoionization updates")
    if any(abs(made / mc.num_photons - 1) > 0.01 for made, _k, _t in stages):
        raise RuntimeError(f"phase {phase}: photons per update "
                           f"{[s[0] for s in stages]}, not ~{mc.num_photons}")
    n = t.highest_id
    if not bool(torch.isfinite(sim.cc[:, :n]).all()):
        raise RuntimeError(f"phase {phase}: non-finite state")
    photo_max = float(sim.cc[sim.photoi.i_photo, :n].max())
    emax = float(sim.cc[sim.i_electric_fld, :n].max())
    log(f"phase {phase}: max(E) = {emax:.4e} V/m, max(photo) = "
        f"{photo_max:.4e} 1/(m3 s)")
    if not emax > BACKGROUND_FIELD or not photo_max > 0.0:
        raise RuntimeError(f"phase {phase}: no streamer or no photons")

    # one checkpoint of the final state, written and read back on the card
    path = Path(f"{prefix}_final.dat.npz")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    write_checkpoint(str(path), sim)
    t4 = time.perf_counter()
    back = Simulation(argv=amr_argv(prefix.parent / f"p{phase}_back", ndim,
                                    "cuda", extra7 + MC_FLAGS
                                    + [f"-restart_from_file={path}"]))
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    same = (back.tree.highest_id == n and back.it == sim.it
            and bool(torch.equal(back.cc[:, :n], sim.cc[:, :n]))
            and bool(torch.equal(back.fc[:, :, :n], sim.fc[:, :, :n])))
    log(f"phase {phase}: checkpoint of the final state: {path.stat().st_size} "
        f"bytes ({n} boxes), written in {t4 - t3:.2f} s, read back onto the "
        f"card (a new simulation) in {t5 - t4:.2f} s; state restored "
        f"exactly: {same}")
    if not same:
        raise RuntimeError(f"phase {phase}: the checkpoint does not restore "
                           "the state")
    del back
    log(f"phase {phase}: device busy share: "
        f"{busy_share(torch, sim, ms_step)}")
    return launches, [1e3 * u["s"] for u in updates]


def busy_share(torch, sim, ms_per_step):
    """Device-kernel time per step of two more steps under torch.profiler
    over the unprofiled ms per step (the profiler slows the host), or 'not
    measured' if the trace has no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(max_steps=sim.it + 2)  # run() counts its closing check
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(us for _key, (_n, us) in device_events(torch, prof))
    if dev_us <= 0:
        return "not measured"
    dev_ms = dev_us * 1e-3 / 2
    return (f"{dev_ms / ms_per_step:.3f} ({dev_ms:.2f} ms of device kernels "
            f"per step against {ms_per_step:.2f} ms per unprofiled step; "
            f"{dev_ms * 2e-3 / wall:.3f} of the profiled wall time)")


#: phase 3x: the main path sharded over ranks that share the card
#: (gloo), against the unsharded run on the card: (config, ndim, flags,
#: steps, rank counts); the field rises over 0.3 ps so that an epoch of
#: the 2D run adds boxes
SHARDED_SMALL = [
    (AMR_CFG[2], 2, ["-photoi%per_steps=2", "-field_rise_time=3e-13",
                     "-output%dt=1e-13"], 8, (2, 4)),
    (AMR_CFG[3], 3, ["-photoi%per_steps=2", "-output%dt=1e-13"], 2, (2,))]
#: phase 3x, the branches that ran unsharded only before, over 2 ranks:
#: name, config, ndim, flags, steps (each but the program's holds an epoch
#: that changes the mesh)
SHARDED_BRANCHES = [
    ("electrode", ELECTRODE_CFG["cyl"], 2, [], 4),
    ("dielectric", DATA / "dielectric_cyl_slice.cfg", 2,
     ["-coarse_grid_size=8 16", f"-user%module={USER_MODULE}"], 4),
    ("user-module", DATA / "velocity_control_2d.cfg", 2,
     [f"-user%module={PROGRAMS / 'velocity_control_2d.py'}"], 4),
    ("montecarlo", DATA / "air_cyl_amr_slice.cfg", 2,
     MC_FLAGS + ["-photoi_mc%num_photons=20000", "-photoi%per_steps=2"], 4)]
#: phase 18: phase 7's configuration and flags over 2 ranks on the card
SHARDED_FULL = (2, 6)


def shard_flags(n):
    return ["-compiled%enabled=T", f"-compiled%shards={n}"] if n > 1 else []


def _probe_gloo_cuda():
    """On every rank of a gloo group whose ranks share the card: which
    collectives take CUDA tensors ("ok" or the error's first line)."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    x = torch.ones(4, device=dev) * (dist.get_rank() + 1)
    n = dist.get_world_size()
    out = {}
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(n)], x)),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                torch.empty(4 * n // n, device=dev), x[:4 * n // n])),
            ("gather", lambda: dist.gather(
                x, [torch.empty_like(x) for _ in range(n)]
                if dist.get_rank() == 0 else None, dst=0)),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # the answer is the probe's result
            out[name] = str(e).splitlines()[0][:120] if str(e) else repr(e)
        dist.barrier()
    return out


def _busy_of_rank(sim, seconds):
    """The device busy share of two more steps on this rank against the
    ms per step of the run (every rank runs them: they hold
    collectives)."""
    import torch
    return busy_share(torch, sim, 1e3 * seconds / SHARDED_FULL[1])


def compare_sharded(torch, phase, u, s, steps, ndim, prefixes):
    """Hold a sharded run's record (``record_run``) against
    the unsharded one's: the same mesh at every epoch, dts, (FMG, V-cycle)
    counts and FMG cycles per Helmholtz mode; every variable within 1e-12
    of its scale; the regression logs at rtol 1e-8, atol 1e-10; the path's
    kernels launched on every rank. Returns (worst scaled deviation,
    bitwise equal)."""
    import numpy as np
    if len(u["epochs"]) != len(s["epochs"]) or any(
            len(a) != len(b) or any(not np.array_equal(x, y)
                                    for x, y in zip(a, b))
            for a, b in zip(u["epochs"], s["epochs"])):
        raise RuntimeError(f"phase {phase}: the meshes differ")
    if u["changes"] != s["changes"] or u["solves"] != s["solves"] \
            or u["photoi"] != s["photoi"]:
        raise RuntimeError(f"phase {phase}: epochs or cycle counts differ")
    if len(u["dts"]) != len(s["dts"]) or any(
            abs(a / b - 1) > 1e-12 for a, b in zip(u["dts"], s["dts"])):
        raise RuntimeError(f"phase {phase}: dt differs")
    if not np.array_equal(u["ids"], s["ids"]) or u["it"] != s["it"]:
        raise RuntimeError(f"phase {phase}: boxes or steps differ")
    worst, bitwise = 0.0, True
    for key in ("cc", "fc"):
        for iv in range(len(u[key])):
            a, b = u[key][iv], s[key][iv]
            scale = float(np.abs(a).max())
            err = float(np.abs(a - b).max())
            worst = max(worst, err / scale if scale > 0 else err)
            bitwise &= bool(np.array_equal(a, b))
    if worst > 1e-12:
        raise RuntimeError(f"phase {phase}: state deviates by {worst}")
    ru, rs = (np.loadtxt(f"{p}_rtest.log", skiprows=1, ndmin=2)
              for p in prefixes)
    if ru.shape != rs.shape or not np.allclose(rs, ru, rtol=1e-8,
                                               atol=1e-10):
        raise RuntimeError(f"phase {phase}: the regression logs differ")
    for r, rank in enumerate(s["ranks"]):
        if not all(rank["launches"][k] > 0 for k in PATH_KERNELS[ndim]):
            raise RuntimeError(f"phase {phase}: rank {r} launched "
                               f"{rank['launches']}")
    if not steps or not np.isfinite(s["cc"]).all():
        raise RuntimeError(f"phase {phase}: non-finite state")
    return worst, bitwise


def _probe_after(_sim, _seconds):
    return _probe_gloo_cuda()


def start_sharded(out_dir):
    """Phase 3x, first half: start the main path sharded over 2 and 4
    ranks that share the card (gloo), the 3D one over 2, and each
    unsharded (one rank: a process of its own, whose BLAS runs one thread
    as the ranks' do, so that its dense level-1 inverses round as theirs),
    all together, in threads that spawn their ranks; the 2-rank run's
    ranks then probe which gloo collectives take CUDA tensors. Returns
    what ``phase_sharded`` joins."""
    import threading
    from afivo_streamer_tpu_torch.parallel import compiled
    runs, errors = {}, []

    def sharded(key, argv, n, steps, after):
        t0 = time.perf_counter()
        try:
            runs[key] = (compiled.run_ranks(record_run, n,
                                            (argv, steps, after)),
                         time.perf_counter() - t0)
        except Exception as e:  # re-raised below, after every run ended
            errors.append((key, e))
    threads = []
    for cfg, ndim, extra, steps, rank_counts in SHARDED_SMALL:
        for n in (1,) + rank_counts:
            after = _probe_after if (ndim, n) == (2, 2) else None
            argv = (amr_argv(out_dir / f"p3x_{ndim}d_{n}", ndim, "cuda",
                             extra, cfg) + shard_flags(n))
            threads.append(threading.Thread(
                target=sharded, args=((ndim, n), argv, n, steps, after)))
    for name, cfg, ndim, extra, steps in SHARDED_BRANCHES:
        for n in (1, 2):
            argv = (amr_argv(out_dir / f"p3x_{name}_{n}", ndim, "cuda",
                             extra, cfg) + shard_flags(n))
            threads.append(threading.Thread(
                target=sharded, args=((name, n), argv, n, steps, None)))
    for th in threads:
        th.start()
    return threads, runs, errors


def phase_sharded(torch, out_dir, started):
    """Phase 3x, second half: the runs ``start_sharded`` started, joined,
    the sharded ones held against the unsharded ones. Returns the launches
    of every kernel summed over the sharded runs and ranks."""
    threads, runs, errors = started
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError(f"phase 3x: sharded runs failed: {errors}")
    ref = {ndim: runs[(ndim, 1)][0] for _c, ndim, *_r in SHARDED_SMALL}
    probe = runs[(2, 2)][0]["ranks"][0]["after"]
    log(f"phase 3x: gloo with CUDA tensors, 2 ranks on one card: {probe}")
    if any(v != "ok" for v in probe.values()):
        raise RuntimeError("phase 3x: a gloo collective refuses CUDA "
                           "tensors, which parallel/compiled.Shards passes")
    total = {}
    for cfg, ndim, extra, steps, rank_counts in SHARDED_SMALL:
        u = ref[ndim]
        for n in rank_counts:
            s, wall = runs[(ndim, n)]
            worst, bitwise = compare_sharded(
                torch, "3x", u, s, steps, ndim,
                (out_dir / f"p3x_{ndim}d_1", out_dir / f"p3x_{ndim}d_{n}"))
            adds = [c for c in s["changes"] if c[0] or c[1]]
            if ndim == 2 and not any(a for a, _r in adds):
                raise RuntimeError("phase 3x: no epoch added boxes")
            for rank in s["ranks"]:
                for k, v in rank["launches"].items():
                    total[k] = total.get(k, 0) + v
            log(f"phase 3x: {cfg.name} {' '.join(extra)} over {n} ranks "
                f"sharing the card (gloo) against the unsharded card run, "
                f"{steps} steps, {s['n_leaf_cells']} leaf cells at the end: "
                f"the same mesh at {len(s['epochs'])} meshes (epochs that "
                f"changed it, boxes added/removed: {adds}), the same dt at "
                f"{len(s['dts'])} attempted steps, (FMG, V-cycle) counts at "
                f"{len(s['solves'])} field solves and FMG cycles per mode at "
                f"{len(s['photoi'])} updates; state worst scaled deviation "
                f"{worst:.3e} (limit 1e-12), bitwise equal: {bitwise}; "
                f"regression logs within rtol 1e-8; per rank: leaf cells "
                f"{s['leaf_cells']}, rows (own + halo) "
                f"{[(r['own'], r['halo']) for r in s['ranks']]} against "
                f"{u['ranks'][0]['rows']} unsharded, launches "
                f"{[{k: v for k, v in r['launches'].items() if v} for r in s['ranks']]}, "
                f"halo exchanges (calls, bytes) "
                f"{[(r['exchange']['calls'], r['exchange']['bytes']) for r in s['ranks']]}; "
                f"{wall:.1f} s with the ranks' start (the runs started "
                f"together, beside the workers of phases 3-3z)")
    for name, cfg, ndim, extra, steps in SHARDED_BRANCHES:
        u, s = runs[(name, 1)][0], runs[(name, 2)][0]
        worst, bitwise = compare_sharded(
            torch, "3x", u, s, steps, ndim,
            (out_dir / f"p3x_{name}_1", out_dir / f"p3x_{name}_2"))
        adds = [c for c in s["changes"] if c[0] or c[1]]
        if name != "user-module" and not adds:
            raise RuntimeError(f"phase 3x: {name}: no epoch changed the mesh")
        for rank in s["ranks"]:
            for k, v in rank["launches"].items():
                total[k] = total.get(k, 0) + v
        per_rank = [
            {"own": r["own"], "halo": r["halo"],
             "calls": round(r["exchange"]["calls"] / steps, 1),
             "bytes": round(r["exchange"]["bytes"] / steps),
             "host_ms": round(1e3 * r["exchange"]["seconds"] / steps, 2),
             **{k: r[k] for k in ("lsf_bnd", "surf_own", "surf_cross")
                if k in r}} for r in s["ranks"]]
        extra_text = ""
        if s["surf_integral"] is not None:
            if s["surf_integral"] != u["surf_integral"]:
                raise RuntimeError(f"phase 3x: {name}: the surface charge's "
                                   f"integral {s['surf_integral']} differs "
                                   f"from {u['surf_integral']}")
            extra_text = (f"; surface charge integral "
                          f"{s['surf_integral']:.6e} as unsharded")
        log(f"phase 3x: {name}: {cfg.name} {' '.join(extra)} over 2 ranks "
            f"sharing the card (gloo) against the unsharded card run, "
            f"{steps} steps, {s['n_leaf_cells']} leaf cells at the end: the "
            f"same mesh at {len(s['epochs'])} meshes (epochs that changed "
            f"it: {adds}), the same dt at {len(s['dts'])} attempted steps, "
            f"(FMG, V-cycle) counts at {len(s['solves'])} field solves; "
            f"state worst scaled deviation {worst:.3e} (limit 1e-12), "
            f"bitwise equal: {bitwise}{extra_text}; per rank and step: "
            f"halo exchanges {per_rank}; launches "
            f"{[{k: v for k, v in r['launches'].items() if v} for r in s['ranks']]}; "
            f"{runs[(name, 2)][1]:.1f} s with the ranks' start")
    return total


def phase_sharded_full(torch, out_dir, main_path):
    """Phase 18: phase 7's configuration and flags over 2 ranks sharing the
    card (gloo), 6 steps: ms per step against phase 7's, each rank's leaf
    cells, K1-K3 launches per step, halo exchanges and level gathers per
    step (bytes, host ms), peak device memory and the device busy share of
    two more steps; returns the launches summed over the ranks."""
    from afivo_streamer_tpu_torch.parallel import compiled
    n, steps = SHARDED_FULL
    extra = AMR_FULL[2][0]
    free_earlier_runs(torch)
    t0 = time.perf_counter()
    s = compiled.run_ranks(record_run, n, (
        amr_argv(out_dir / "p18", 2, "cuda", extra) + shard_flags(n), steps,
        _busy_of_rank))
    wall = time.perf_counter() - t0
    ranks = s["ranks"]
    names = PATH_KERNELS[2]
    ms_step = 1e3 * ranks[0]["seconds"] / steps
    for r, rank in enumerate(ranks):
        st = rank["exchange"]
        log(f"phase 18: rank {r}: {rank['leaf_cells_own']} leaf cells at the "
            f"end, rows own + halo {rank['own']} + {rank['halo']}; K1-K3 "
            f"launches per step "
            f"{ {k: round(rank['launches'][k] / steps, 2) for k in names} }; "
            f"halo exchanges per step {st['calls'] / steps:.1f} calls, "
            f"{st['bytes'] / steps:.0f} bytes, "
            f"{1e3 * st['seconds'] / steps:.2f} host ms; level and root "
            f"gathers per step {st['gather_calls'] / steps:.1f} calls, "
            f"{st['gather_bytes'] / steps:.0f} bytes, "
            f"{1e3 * st['gather_seconds'] / steps:.2f} host ms; peak device "
            f"memory {rank['peak_bytes'] / 1e9:.3f} GB; device busy share "
            f"of two more steps {rank.get('after', 'not measured')}")
        if not all(rank["launches"][k] > 0 for k in names):
            raise RuntimeError(f"phase 18: rank {r} launched "
                               f"{rank['launches']}")
    log(f"phase 18: {s['n_leaf_cells']} leaf cells at the end over {n} ranks "
        f"({s['leaf_cells']}), {steps} steps {ms_step:.2f} ms/step on rank 0 "
        f"against phase 7's {main_path['ms_step']:.2f} ms/step unsharded "
        f"({ms_step / main_path['ms_step']:.3f} times); "
        f"{wall:.1f} s with the ranks' start and setup")
    # phase 7's run of the same configuration: the same meshes, dts,
    # (FMG, V-cycle) counts and FMG cycles per mode
    if s["epochs"] != main_path["meshes"]:
        raise RuntimeError(
            f"phase 18: the meshes differ from phase 7's: boxes per level "
            f"{[[len(x) for x in m] for m in s['epochs']]} against "
            f"{[[len(x) for x in m] for m in main_path['meshes']]}")
    if s["solves"] != main_path["solves"] or \
            [c for _it, c in s["photoi"]] != main_path["updates"]:
        raise RuntimeError(
            f"phase 18: cycle counts differ from phase 7's: solves "
            f"{s['solves']} against {main_path['solves']}, updates "
            f"{s['photoi']} against {main_path['updates']}")
    if len(s["dts"]) != len(main_path["dts"]) or any(
            abs(a / b - 1) > 1e-12 for a, b in zip(s["dts"],
                                                    main_path["dts"])):
        raise RuntimeError(f"phase 18: dts {s['dts']} differ from phase "
                           f"7's {main_path['dts']}")
    log(f"phase 18: the same meshes as phase 7 at {len(s['epochs'])} meshes, "
        f"the same dts at {len(s['dts'])} attempted steps (bitwise equal: "
        f"{s['dts'] == main_path['dts']}), (FMG, V-cycle) counts at "
        f"{len(s['solves'])} field solves and FMG cycles per mode at "
        f"{len(s['photoi'])} updates")
    import numpy as np
    if not np.isfinite(s["cc"]).all() or not np.isfinite(s["fc"]).all():
        raise RuntimeError("phase 18: non-finite state")
    total = {}
    for rank in ranks:
        for k, v in rank["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_full_slice(torch, ks, Simulation, mgb, out_dir, ndim, smi):
    """Phase 4 (2D) and 5 (3D): a full-size slice on the card; returns the
    launch counts of that run's kernels."""
    phase = "4" if ndim == 2 else "5"
    refine_max_dx, want_cells, want_boxes, steps = FULL[ndim]
    free_earlier_runs(torch)
    torch.cuda.reset_peak_memory_stats()
    ks.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(argv=slice_argv(out_dir / f"full{ndim}d", ndim,
                                     refine_max_dx, "cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    epochs = []
    record_epochs(sim, epochs, torch)
    sim.run(max_steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: ks.KERNELS[name].launches
                for name in PATH_KERNELS[ndim]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_leaf = sum(len(l) for l in sim.tree.lvl_leaves) * sim.tree.nc ** ndim
    n_boxes = sim.tree.highest_id
    log(f"phase {phase}: {n_leaf} leaf cells, {n_boxes} boxes, "
        f"{sim.tree.highest_lvl} levels; setup {t1 - t0:.2f} s, "
        f"{steps} steps {t2 - t1:.2f} s = "
        f"{1e3 * (t2 - t1) / steps:.2f} ms/step, of which "
        f"{len(epochs)} refinement epochs (mesh unchanged in "
        f"{sum(not (e['add'] or e['rm']) for e in epochs)}) "
        f"{sum(e['s'] for e in epochs):.2f} s; t = "
        f"{sim.global_time:.4e} s, dt = {sim.global_dt:.4e} s; peak memory "
        f"{peak_gb:.3f} GB")
    log(f"phase {phase}: kernel launches {launches}")
    if n_leaf != want_cells or n_boxes != want_boxes:
        raise RuntimeError(f"unexpected mesh: {n_leaf} cells, {n_boxes} boxes")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    if not bool(torch.isfinite(sim.cc[:, :n_boxes]).all()) or \
            not bool(torch.isfinite(sim.fc[:, :, :n_boxes]).all()):
        raise RuntimeError("non-finite state after the full slice")
    emax = float(sim.cc[sim.i_electric_fld, :n_boxes].max())
    log(f"phase {phase}: max(E) = {emax:.4e} V/m (background "
        f"{BACKGROUND_FIELD:.2e})")
    if not emax > BACKGROUND_FIELD:
        raise RuntimeError("max(E) did not rise above the background field")

    # V-cycle time on the final state (gather once, then cycles); these
    # launches are not counted as the run's
    mg = sim.field.mg
    params = {"voltage": sim.field.current_voltage}
    P, R = mgb.gather_levels(mg, sim.cc)
    vc_ms = time_ms(torch, lambda: mgb.fas_vcycle_blocks(mg, P, R, params),
                    reps=10)
    log(f"phase {phase}: {vc_ms:.3f} ms per V-cycle ({sim.tree.highest_lvl} "
        f"levels, float64)")
    for name in LEVEL_KERNELS[ndim]:
        time_on_level(torch, ks, mgb, sim, name, sim.tree.highest_lvl,
                      phase, smi)
    return launches


def small_phases():
    """The cuda-vs-cpu phases (3 to 3z but 3x) by name, each a callable of
    (torch, ks, Simulation, mgb, out_dir); a name with several runs runs
    them in turn."""
    def runs(table, must=None):
        def run(torch, ks, Simulation, mgb, out_dir):
            for phase, cfg, ndim, tab, extra, steps, *rest in table:
                phase_amr_cpu_vs_cuda(torch, ks, Simulation, out_dir, ndim,
                                      phase, cfg, tab, extra, steps,
                                      must or (rest[0] if rest else ()))
        return run

    def select(table, phase):
        return [row for row in table if row[0] == phase]
    tasks = {
        "3": lambda torch, ks, S, mgb, out: phase_cpu_vs_cuda(
            torch, S, out, 2),
        "3b": lambda torch, ks, S, mgb, out: phase_cpu_vs_cuda(
            torch, S, out, 3),
        "3c": lambda torch, ks, S, mgb, out: phase_dielectric_cpu_vs_cuda(
            torch, ks, S, out),
        "3d": lambda torch, ks, S, mgb, out: phase_amr_cpu_vs_cuda(
            torch, ks, S, out, 2),
        "3e": lambda torch, ks, S, mgb, out: phase_amr_cpu_vs_cuda(
            torch, ks, S, out, 3),
        "3i": lambda torch, ks, S, mgb, out: phase_energy_physics(
            torch, S, out),
        "3q": lambda torch, ks, S, mgb, out: phase_imex(torch, ks),
        "3t": phase_programs_cpu_vs_cuda,
        "3v": lambda torch, ks, S, mgb, out: phase_restart(torch, S, out),
        "3w": lambda torch, ks, S, mgb, out: phase_writers_cpu_vs_cuda(
            torch, S, out),
        "3y": lambda torch, ks, S, mgb, out: phase_float32_small(
            torch, ks, S, out)}
    for table, must in ((VARIANTS_SMALL, None), (ELECTRODES_SMALL, None),
                        (BRANCHES_SMALL, None), (GAS_SMALL, PATH_KERNELS[2]),
                        (MC_SMALL, None), (BOX32_SMALL, None)):
        for phase in dict.fromkeys(row[0] for row in table):
            tasks[phase] = runs(select(table, phase), must)
    return tasks


#: the cuda-vs-cpu phases in WORKER groups, each group one process that
#: runs its phases in turn; the groups run together, beside phase 3x's
#: ranks, each with WORKER_THREADS threads in PyTorch and in the BLAS
WORKER_GROUPS = (("3e", "3", "3b", "3c", "3d", "3f", "3g", "3h", "3i",
                  "3v"),
                 ("3l", "3n", "3j", "3k", "3m", "3o", "3p"),
                 ("3r", "3s", "3t", "3u", "3q"),
                 ("3y", "3w"),
                 ("3z",))
WORKER_THREADS = 2


def worker_main(group):
    """A child process: the cuda-vs-cpu phases of WORKER_GROUPS[group];
    any failure raises (the process exits non-zero)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.set_num_threads(WORKER_THREADS)
    sys.path.insert(0, str(ROOT))
    from afivo_streamer_tpu_torch.ops import smoother as ks
    from afivo_streamer_tpu_torch.driver import Simulation
    from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
    tasks = small_phases()
    out_dir = ROOT / "out" / "chip_smoke"
    for phase in WORKER_GROUPS[group]:
        tasks[phase](torch, ks, Simulation, mgb, out_dir)
        free_earlier_runs(torch)
    return 0


def start_workers(out_dir):
    """Start one process per group of WORKER_GROUPS, each writing its log
    to a file of ``out_dir``; returns what join_workers joins."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CHIP_SMOKE_T0=repr(T_START))
    env.update({k: str(WORKER_THREADS) for k in (
        "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
    procs = []
    for k in range(len(WORKER_GROUPS)):
        path = out_dir / f"worker_{k}.log"
        with open(path, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 str(k)], stdout=f, stderr=subprocess.STDOUT, env=env,
                cwd=ROOT)
        procs.append((proc, path))
    return procs


def stop_workers(procs):
    for proc, _path in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def join_workers(procs):
    """Wait for every worker and print its log; raise if one failed."""
    failed = []
    for k, (proc, path) in enumerate(procs):
        rc = proc.wait()
        print(path.read_text(), end="", flush=True)
        if rc:
            failed.append((WORKER_GROUPS[k], rc))
    if failed:
        raise RuntimeError(f"cuda-vs-cpu phases failed (phases, exit code): "
                           f"{failed}")
    log(f"phases 3-3z: {len(procs)} workers ended")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "afivo_streamer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from afivo_streamer_tpu_torch.ops import smoother as ks
    from afivo_streamer_tpu_torch.driver import Simulation
    from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = ks.build_libraries()
    for entry in built:
        ks._library(entry)
    log(f"phase 1: built {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for _path, build_log in built.values():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 1: ptxas {line.strip()}")

    results = phase_kernels(torch, ks, smi)
    phase_kernels_level_set(torch, ks, smi)
    phase_kernels_eps(torch, ks, smi)
    box32 = phase_kernels_box_sizes(torch, ks, smi)
    out_dir = ROOT / "out" / "chip_smoke"
    # the cuda-vs-cpu phases in worker processes beside phase 3x's ranks;
    # the measurements below run alone
    started = start_sharded(out_dir)
    workers = start_workers(out_dir)
    try:
        join_workers(workers)
    finally:
        stop_workers(workers)
    sharded = phase_sharded(torch, out_dir, started)
    # phases 9 to 15 run before the long profiler traces of phases 6 to 8,
    # after which the host has been seen to run slower for the rest of the
    # process
    by_phase = {"9": phase_amr_full(torch, ks, Simulation, mgb, out_dir, 2,
                                    smi, "9", EE_CFG, TABLE_NEW,
                                    EE_FULL_STEPS)}
    phase_1d_full(torch, ks, Simulation, out_dir)
    for phase in ELECTRODES_FULL:
        by_phase[phase] = phase_electrode_full(torch, ks, Simulation, mgb,
                                               out_dir, phase, smi)
    by_phase["15"] = phase_gas_full(torch, ks, Simulation, mgb, out_dir, smi)
    by_phase["17"], mc_update_ms = phase_mc_full(torch, ks, Simulation,
                                                 out_dir)
    for ndim in (2, 3):
        by_phase[str(2 + ndim)] = phase_full_slice(
            torch, ks, Simulation, mgb, out_dir, ndim, smi)
    by_phase["6"] = phase_dielectric_full(torch, ks, Simulation, mgb,
                                          out_dir, smi)
    # phase 16 just before phase 7, whose host state it shares
    writers = phase_writers_full(torch, ks, Simulation, mgb, out_dir, smi)
    main_path = {}
    for ndim in (2, 3):
        by_phase[str(5 + ndim)] = phase_amr_full(
            torch, ks, Simulation, mgb, out_dir, ndim, smi,
            record=main_path if ndim == 2 else None)
    writers_against_main_path(writers, main_path)
    by_phase["19"] = phase_amr_full(torch, ks, Simulation, mgb, out_dir, 2,
                                    smi, "19", record={}, against=main_path)
    by_phase["3x"] = sharded
    by_phase["18"] = phase_sharded_full(torch, out_dir, main_path)
    log(f"phase 17: ms per Monte-Carlo update "
        f"{[round(v, 1) for v in mc_update_ms]} against phase 7's ms per "
        f"Helmholtz update {[round(v, 1) for v in main_path['update_ms']]}")
    by_phase["16"] = writers["launches"]
    # each kernel's count is that of its main path: the cylindrical run
    # with photoionization for K1-K3, the 3D one for K4 and K5, the
    # dielectric run for K3-swap
    launches = {**by_phase["7"], **by_phase["8"],
                "fill_2d_swap": by_phase["6"]["fill_2d_swap"]}

    kernels = [{"name": name, "route": "cuda",
                "source": SOURCE[ndim_of(name)],
                "replaces": REPLACES[name], "launches": launches[name],
                "launches_by_phase": {ph: c[name] for ph, c in
                                      by_phase.items() if name in c},
                "max_abs_err": results[name]["max_abs_err"],
                "ms": 1e-3 * results[name]["cold_us"],
                "plain_ms": 1e-3 * results[name]["plain_cold_us"],
                "bound_ms": 1e-3 * results[name]["bound_us"],
                "bound_by": results[name]["bound_by"], "library_ms": None,
                "warm_ms": 1e-3 * results[name]["warm_us"],
                "wall_ms": results[name]["wall_ms"],
                "enqueue_us": results[name]["enqueue_us"],
                # phase 2c: nc = 32, n = 4096, cold, by dtype
                "nc32": {d: {"ms": 1e-3 * r["cold_us"],
                             "plain_ms": 1e-3 * r["plain_cold_us"],
                             "bound_ms": 1e-3 * r["bound_us"],
                             "max_abs_err": r["max_abs_err"]}
                         for d, r in box32[name].items()}}
               for name in ks.KERNELS]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(int(sys.argv[2])))
    sys.exit(main())
