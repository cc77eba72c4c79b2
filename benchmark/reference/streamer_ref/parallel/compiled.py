"""The compiled engine's options and the sharded run over torch.distributed.

Port of ``afivo_streamer_tpu/parallel/compiled.py`` and of the options the
JAX driver reads for it (``driver.py:306-343``). The JAX package routes
the inner loop of ``-compiled%enabled=T`` through jitted device units; this
package runs every step on the device already, so ``compiled%enabled``
runs the ordinary path. ``compiled%fused``, ``compiled%prepad`` and
``compiled%warm_next_level`` steer XLA compilation and are read without
effect. ``compiled%dtype=float32`` holds the state and every device array
of the step in float32 (JAX driver.py:1188-1207): the setup (or a
restart's reading) runs in float64, the first step of ``run`` casts the
state, and from then on the simulation's ``dtype`` is float32, constants
are built in float64 and cast to the operand's dtype, and the host
machinery (writers, checkpoints) sees float64.

``-compiled%shards=N`` (N > 1; rounded down to a power of two, as the JAX
package rounds its mesh) runs the simulation over N ranks of a
torch.distributed process group, the box axis of the state split over them
as the JAX package splits it over a device mesh (parallel/halo.py). Rank r
runs on ``cuda:(r % device_count)``, or on the CPU with ``-device=cpu``;
ranks share a card when there are fewer cards than ranks. The backend is
NCCL when every rank has a card of its own and gloo otherwise (NCCL
refuses two ranks on one card). ``launch`` starts the N ranks of the
command line: from torchrun's environment when it is set, else with
``torch.multiprocessing`` and the ``spawn`` start method, after building
the kernels once.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import threading
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..physics import advance as adv

HOW_TO_LAUNCH = (
    "compiled%shards={n} needs a torch.distributed process group of {n} "
    "ranks: run `python -m afivo_streamer_tpu_torch CONFIG ... "
    "-compiled%enabled=T -compiled%shards={n}` (it starts the ranks), "
    "`torchrun --nproc-per-node={n} -m afivo_streamer_tpu_torch CONFIG "
    "... -compiled%enabled=T -compiled%shards={n}`, or construct the "
    "Simulation on every rank of an initialized group of size {n}")


class CompiledSettings:
    """The ``compiled%`` options (JAX driver.py:306-343)."""

    def __init__(self, cfg):
        self.enabled = cfg.add_get(
            "compiled%enabled", False,
            "Run the inner time step through the compiled engine (every "
            "step runs on the device in this package)")
        self.dtype = cfg.add_get(
            "compiled%dtype", "float64",
            "Device dtype of the compiled step (float64 or float32)")
        self.fused = cfg.add_get(
            "compiled%fused", True,
            "Fuse each time step into one XLA dispatch (no effect here)")
        self.shards = cfg.add_get(
            "compiled%shards", 0,
            "Run over this many ranks (power of two; 0 = one): the box "
            "axis of the state is split over them, the tree and the plans "
            "are replicated, halo rows are exchanged and reductions are "
            "collectives")
        self.prepad = cfg.add_get(
            "compiled%prepad", 1.0,
            "Bucket headroom of the XLA-compiled tables (no effect here)")
        self.warm_next_level = cfg.add_get(
            "compiled%warm_next_level", "auto",
            "Pre-compile the next level's XLA executable (no effect here)")

    @property
    def state_dtype(self) -> torch.dtype:
        """dtype of the simulation state: float32 under
        ``-compiled%enabled=T -compiled%dtype=float32``, else float64
        (compiled%dtype has no effect without the compiled engine, and any
        other value is float64, JAX driver.py:306-314, 1192)."""
        if self.enabled and self.dtype == "float32":
            return torch.float32
        return torch.float64

    @property
    def n_shards(self) -> int:
        """Ranks of the run: compiled%shards rounded down to a power of
        two, 1 unless the compiled engine is on."""
        n = int(self.shards) if self.enabled else 0
        if n <= 1:
            return 1
        if n & (n - 1):
            n2 = 1 << (n.bit_length() - 1)
            print(f"compiled%shards: {n} is not a power of two; using {n2}")
            n = n2
        return n


def pad_capacity_to(cap: int, multiple: int) -> int:
    """The box capacity padded so that the box axis divides over
    ``multiple`` ranks."""
    return ((int(cap) + multiple - 1) // multiple) * multiple


def choose_backend(n: int, device_type: str) -> str:
    """NCCL when each of the n ranks has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


class Shards:
    """One rank of a sharded run: rank, world size, device and backend of
    the process group, the owner table of the box axis, and the
    collectives of parallel/halo.py on the state's tensors (gloo takes
    CUDA tensors in every collective used here, chip_smoke.py phase 3x;
    NCCL takes no host tensor, which ``_out`` moves to the card)."""

    def __init__(self, n: int, device_type: str):
        if not dist.is_available() or not dist.is_initialized() \
                or dist.get_world_size() != n:
            raise ValueError(HOW_TO_LAUNCH.format(n=n))
        self.world = n
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        if device_type == "cuda":
            self.device = torch.device(
                "cuda", self.rank % torch.cuda.device_count())
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device("cpu")

    def owner(self, ids, cap: int) -> np.ndarray:
        """The rank of every box id: ``b // (cap / N)``."""
        return np.asarray(ids, np.int64) // (int(cap) // self.world)

    # ------------------------------------------------------------ wire
    def _out(self, t):
        if self.backend == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t

    def _back(self, t, like):
        return t.to(like.device, non_blocking=False)

    def all_to_all(self, x, n_rcv, n_snd):
        """Rows of x (split by peer, ``n_snd``) to every peer; the rows
        from every peer (``n_rcv``), concatenated by peer."""
        w = self._out(x)
        out = w.new_empty((sum(n_rcv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, w, list(n_rcv), list(n_snd))
        return self._back(out, x)

    def all_reduce(self, t, op: str):
        ops = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
               "sum": dist.ReduceOp.SUM}
        w = self._out(t.clone())
        dist.all_reduce(w, op=ops[op])
        return self._back(w, t)

    def all_gather(self, t):
        """[N] + t.shape: every rank's t."""
        w = self._out(t.contiguous())
        parts = [torch.empty_like(w) for _ in range(self.world)]
        dist.all_gather(parts, w)
        return self._back(torch.stack(parts), t)

    def gather_root(self, t):
        """Every rank's t as a list on rank 0 (on t's device), None
        elsewhere."""
        w = self._out(t.contiguous())
        if self.backend == "nccl":
            parts = [torch.empty_like(w) for _ in range(self.world)]
            dist.all_gather(parts, w)
            return ([self._back(p, t) for p in parts] if self.rank == 0
                    else None)
        parts = ([torch.empty_like(w) for _ in range(self.world)]
                 if self.rank == 0 else None)
        dist.gather(w, parts, dst=0)
        return None if parts is None else [self._back(p, t) for p in parts]


# --------------------------------------------------------------------------
# the step with a fixed count of V-cycles (JAX parallel/compiled.py:29-75)
# --------------------------------------------------------------------------
def make_field_fixed_vcycles(sim, n_vcycles: int = 2):
    """Field solve with a fixed number of V-cycles (no data-dependent
    exit): field_fn(cc, fc, s_in, time, have_guess, params)."""
    field = sim.field

    def field_fn(cc, fc, s_in, time, have_guess, params):
        cc = field.set_rhs(cc, s_in)
        params = dict(params or {})
        if field.lsf_data is not None:
            params["lsf_phi_b"] = field.lsf_phi_b()
        for _ in range(n_vcycles):
            cc, _res = field.mg.vcycle(cc, params)
        return field.from_potential(cc, fc, params)

    return field_fn


def make_step_fn(sim, n_vcycles: int = 2):
    """One full time step: the configured integrator's substeps with a
    field solve between stages, then the final field solve, each with
    ``n_vcycles`` V-cycles. ``step(cc, fc, dt, voltage) -> (cc, fc,
    dt_lim)``; sharded or not as ``sim`` is."""
    field_fn = make_field_fixed_vcycles(sim, n_vcycles)
    integrator = sim.dt_cfg.integrator

    def substep(cc, fc, dt, dt_lim, time, s_deriv, s_prev, w_prev, s_out,
                i_step, n_steps, params):
        return sim.fluid.forward_euler(cc, fc, dt, dt_lim, time, s_deriv,
                                       s_prev, w_prev, s_out, i_step,
                                       n_steps, params)

    def step(cc, fc, dt, voltage):
        params = {"voltage": voltage}
        saved = sim.fluid.field_compute
        sim.fluid.field_compute = field_fn
        try:
            cc, fc, dt_lim, _t, _diag = adv.advance(cc, fc, dt, 0.0,
                                                    integrator, substep,
                                                    params)
        finally:
            sim.fluid.field_compute = saved
        cc, fc = field_fn(cc, fc, 0, 0.0, True, params)
        return cc, fc, dt_lim

    return step


def shard_over_boxes(layout, cc, fc):
    """The rows of one rank (own boxes, then halo) of a whole state
    ``cc [n_var, cap, S]``, ``fc [n_fc, ndim, cap, Sf]``."""
    rows = torch.as_tensor(layout.glob, device=cc.device)
    return cc[:, rows].contiguous(), fc[:, :, rows].contiguous()


# --------------------------------------------------------------------------
# starting the ranks
# --------------------------------------------------------------------------
def _rank_main(rank: int, n: int, store: str, backend: str, threads: int,
               quiet: bool, result: str, fn: Callable, args):
    torch.set_num_threads(threads)
    if quiet and rank > 0:
        sys.stdout = open(os.devnull, "w")
    dist.init_process_group(backend, store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        out = fn(*args)
        if rank == 0:
            with open(result, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, args=(), backend: str = "gloo",
              threads: int = 1, quiet: bool = False):
    """Run ``fn(*args)`` on n spawned ranks of a process group that meets
    through a FileStore in a temporary directory; returns rank 0's result.
    A rank that raises makes this raise (and the other ranks stop). Each
    rank runs ``threads`` threads in PyTorch and in NumPy's BLAS: ranks
    whose BLAS took every core each would spin against one another (the
    dense level-1 inverses of solvers/coarse.py then take seconds)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        result = os.path.join(tmp, "result.pkl")
        with _SPAWN_LOCK:
            # the spawned interpreters read these when NumPy loads
            saved = {k: os.environ.get(k) for k in _BLAS_THREADS}
            os.environ.update({k: str(threads) for k in _BLAS_THREADS})
            try:
                ctx = mp.spawn(_rank_main, args=(n, store, backend, threads,
                                                 quiet, result, fn, args),
                               nprocs=n, join=False, start_method="spawn")
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        while not ctx.join():
            pass
        with open(result, "rb") as f:
            return pickle.load(f)


#: the variables that set the BLAS threads of a spawned rank, and the lock
#: that keeps them to one spawn at a time (chip_smoke.py spawns from
#: threads)
_BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
_SPAWN_LOCK = threading.Lock()


def _run_cli(argv):
    from ..__main__ import run_simulation
    run_simulation(argv)


def launch(argv, n: int, device_type: str) -> None:
    """Run the command line ``argv`` over n ranks: in torchrun's ranks
    when its environment is set, else in n spawned ones."""
    backend = choose_backend(n, device_type)
    print(f"compiled%shards={n}: {n} ranks, backend {backend}", flush=True)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise ValueError(HOW_TO_LAUNCH.format(n=n))
        dist.init_process_group(backend, init_method="env://")
        try:
            _run_cli(argv)
        finally:
            dist.destroy_process_group()
        return
    threads = max(1, (os.cpu_count() or 1) // n)
    run_ranks(_run_cli, n, (list(argv),), backend=backend, threads=threads,
              quiet=True)


# --------------------------------------------------------------------------
# the dry run (the counterpart of __graft_entry__.dryrun_multichip)
# --------------------------------------------------------------------------
_DATA = Path(__file__).resolve().parent.parent / "data"
DRYRUN_ARGV = [str(_DATA / "air_cyl_slice.cfg"), "-ndim=2", "-device=cpu",
               f"-input_data%file={_DATA / 'td_air_synthetic.txt'}",
               "-refine_max_dx=2.6e-4", "-output%regression_test=f"]


def _dryrun_rank(n: int, workdir: str):
    from ..driver import Simulation
    from . import halo
    name = os.path.join(workdir, "dryrun")
    argv = DRYRUN_ARGV + [f"-output%name={name}"]
    un = Simulation(argv=argv + [f"-output%name={name}_{dist.get_rank()}"])
    sh = Simulation(argv=argv + ["-compiled%enabled=T",
                                 f"-compiled%shards={n}"])
    # the sharded setup's own boxes hold the unsharded one's rows
    cc0, fc0 = shard_over_boxes(sh.layout, un.cc, un.fc)
    k = sh.layout.n_own
    setup_equal = bool(torch.equal(cc0[:, :k], sh.cc[:, :k])
                       and torch.equal(fc0[:, :, :k], sh.fc[:, :, :k]))
    dt = 1.0e-13
    cc, fc, dt_lim = make_step_fn(sh, 2)(sh.cc, sh.fc, dt,
                                         sh.field.current_voltage)
    cc_full = halo.gather_to_root(cc, sh.layout, 1, sh.layout.cap)
    if sh.shards.rank != 0:
        return None
    cc1, _fc1, dt_lim1 = make_step_fn(un, 2)(un.cc, un.fc, dt,
                                             un.field.current_voltage)
    ids = np.nonzero(un.tree.in_use[:un.tree.highest_id])[0]
    a = cc1[:, ids].cpu().numpy()
    b = cc_full[:, ids].cpu().numpy()
    scale = np.maximum(np.abs(a).max(axis=(1, 2)), 1.0)[:, None, None]
    err = float(np.max(np.abs(a - b) / scale))
    return {"dt_lim": float(dt_lim), "dt_lim_unsharded": float(dt_lim1),
            "max_scaled_err": err, "setup_equal": setup_equal,
            "leaf_cells": sh.layout.leaf_cells(sh.tree)}


def dryrun(n: int) -> dict:
    """One sharded step of a small mesh (4 + 16 + 64 boxes) on n gloo
    ranks on the CPU, against the unsharded step: the sharded setup's own
    boxes must hold the unsharded one's rows (``shard_over_boxes``); prints
    and returns the dt limits and the largest deviation of the state from
    the unsharded one, relative to each variable's scale."""
    with tempfile.TemporaryDirectory() as tmp:
        out = run_ranks(_dryrun_rank, n, (n, tmp))
    if not np.isfinite(out["dt_lim"]) or out["max_scaled_err"] > 1e-12 \
            or not out["setup_equal"]:
        raise RuntimeError(f"dryrun({n}) failed: {out}")
    print(f"dryrun({n}): ok, dt_lim={out['dt_lim']:.3E}, state within "
          f"{out['max_scaled_err']:.1E} of the unsharded step")
    return out
