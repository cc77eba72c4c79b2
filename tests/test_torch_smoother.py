"""The port's smoother kernels K1-K5 and K3-swap
(afivo_streamer_tpu_torch/ops/smoother.py).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's Pallas kernels run in interpret mode, on random
non-symmetric inputs (n = 6 boxes, nc = 8, and for K1 and K5 also n = 5
at nc = 4 and 16, and K1 with a random mask; in 3D random face weights and
constants per face, so an axis swap fails; all 8 ghost-weight columns
nonzero, so K3 must ignore the parity-swap columns 3-4 and K3-swap must
use them), float64, rtol 1e-13. The wrappers check their inputs' dtypes
and shapes on the CPU as on the card. The CUDA kernels are held against
the plain versions in tests/test_torch_cuda.py.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from afivo_streamer_tpu.ops import pallas_smoother as ps
from afivo_streamer_tpu_torch.ops import smoother as ks

torch.set_num_threads(1)

N, NC = 6, 8
C = NC + 2


def random_inputs(seed=0, n=N, nc=NC, ndim=2):
    """Blocks, rhs, a red-black mask, ghost constants, a neighbor table
    (own rows permuted, about a quarter of the neighbors the box itself),
    ghost weights and a stencil with |c0| >= 1."""
    rng = np.random.default_rng(seed)
    c = nc + 2
    nd = 2 * ndim
    cube = (nc,) * ndim
    g = np.empty((n, 1 + nd), np.int32)
    g[:, 0] = rng.permutation(n)
    g[:, 1:] = rng.integers(0, n, size=(n, nd))
    selfrow = rng.random((n, nd)) < 0.25
    g[:, 1:][selfrow] = np.repeat(g[:, :1], nd, axis=1)[selfrow]
    parity = sum(np.meshgrid(*[np.arange(1, nc + 1)] * ndim, indexing="ij"))
    cs = rng.standard_normal((n, 2 + nd) + cube)
    cs[:, 0] = -(1.0 + rng.random((n,) + cube))
    return dict(
        phi3=rng.standard_normal((n,) + (c,) * ndim),
        R=rng.standard_normal((n,) + cube),
        mask=(parity % 2 == 1).astype(np.float32),
        A=rng.standard_normal((n, nd) + (nc,) * (ndim - 1)),
        g=g,
        W=rng.standard_normal((n, nd, 8)),
        cs=cs)


class _Ref:
    """A block of an array as a kernel ref (read by index, written by
    index into a new array)."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, k):
        return self.a[k]

    def __setitem__(self, k, v):
        self.a = self.a.at[k].set(v)


def _grid_pallas_call(kernel, grid_spec, out_shape, interpret=False):
    """pallas_call run as a plain loop over the grid: the blocks named by
    each BlockSpec's index map are handed to the kernel body as refs. The
    parity-swap branch of _fill_2d captures a constant array, which this
    JAX version's pallas_call refuses even in interpret mode; this loop
    runs the same kernel body."""
    def run(*args):
        k = grid_spec.num_scalar_prefetch
        scal, ins = args[:k], args[k:]
        out = jnp.zeros(out_shape.shape, out_shape.dtype)

        def block(spec, arr, i):
            idx = spec.index_map(i, *scal)
            return tuple(slice(int(b) * s, int(b) * s + s)
                         for b, s in zip(idx, spec.block_shape))
        for i in range(grid_spec.grid[0]):
            refs = [_Ref(a[block(sp_, a, i)])
                    for sp_, a in zip(grid_spec.in_specs, ins)]
            sl = block(grid_spec.out_specs, out, i)
            o = _Ref(out[sl])
            kernel(*scal, *refs, o)
            out = out.at[sl].set(o.a)
        return out
    return run


def jax_call(name, x):
    """The Pallas kernel ``name`` in interpret mode on the inputs ``x``
    (n boxes and nc from the shape of phi3)."""
    a = {k: jnp.asarray(v) for k, v in x.items()}
    n, nc = x["phi3"].shape[0], x["phi3"].shape[-1] - 2
    if name == "sweep_3d":
        out = ps._sweep_3d(a["phi3"], a["R"], a["mask"], a["g"], a["cs"],
                           nc, n, interpret=True)
    elif name == "fill_3d":
        out = ps._fill_3d(a["phi3"], a["A"], a["g"], a["W"], nc, n,
                          interpret=True)
    elif name == "sweep_2d":
        out = ps._sweep_2d(a["phi3"], a["R"], a["mask"], a["g"], a["cs"],
                           nc, n, interpret=True)
    elif name in ("fill_2d", "fill_2d_swap"):
        out = ps._fill_2d(a["phi3"], a["A"], a["g"], a["W"], nc, n,
                          name == "fill_2d_swap", interpret=True)
    else:
        out = ps._fill_sweep_2d(a["phi3"], a["R"], a["mask"], a["A"],
                                a["g"], a["W"], a["cs"], nc, n,
                                interpret=True)
    return np.asarray(out)


def torch_call(fn, x):
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    if fn in (ks.sweep_2d, ks.sweep_2d_plain, ks.sweep_3d, ks.sweep_3d_plain):
        return fn(t["phi3"], t["R"], t["mask"], t["g"], t["cs"])
    if fn in (ks.fill_2d, ks.fill_2d_plain, ks.fill_2d_swap,
              ks.fill_2d_swap_plain, ks.fill_3d, ks.fill_3d_plain):
        return fn(t["phi3"], t["A"], t["g"], t["W"])
    return fn(t["phi3"], t["R"], t["mask"], t["A"], t["g"], t["W"], t["cs"])


SEEDS = {"fill_sweep_2d": 1, "sweep_2d": 2, "fill_2d": 3, "sweep_3d": 4,
         "fill_3d": 6, "fill_2d_swap": 7}


def ndim_of(name):
    return int(re.search(r"_(\d)d", name).group(1))


@pytest.mark.parametrize("name", list(SEEDS))
def test_plain_kernel_matches_pallas_interpret(name, monkeypatch):
    x = random_inputs(seed=SEEDS[name], ndim=ndim_of(name))
    if name == "fill_2d_swap":
        monkeypatch.setattr(ps.pl, "pallas_call", _grid_pallas_call)
    want = jax_call(name, x)
    got = torch_call(ks.KERNELS[name], x)  # CPU tensors -> plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("nc", [4, 16])
@pytest.mark.parametrize("name", ["fill_sweep_2d", "fill_3d"])
def test_plain_kernel_matches_pallas_interpret_other_sizes(name, nc):
    """K1 and K5 at n = 5 boxes and nc = 4, 16: their CUDA kernels compile
    nc = 8 in and take any other even nc at run time, and the card tests
    hold both against these plain versions."""
    x = random_inputs(seed=SEEDS[name] + nc, n=5, nc=nc, ndim=ndim_of(name))
    want = jax_call(name, x)
    got = torch_call(ks.KERNELS[name], x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n, nc", [(6, 8), (5, 4)])
def test_fill_sweep_2d_random_mask_matches_pallas_interpret(n, nc):
    """K1 with a random mask that is no checkerboard: an updated cell may
    have updated neighbors, which must still enter with their filled
    values."""
    x = random_inputs(seed=9 + nc, n=n, nc=nc)
    rng = np.random.default_rng(nc)
    x["mask"] = (rng.random((nc, nc)) < 0.5).astype(np.float32)
    parity = np.add.outer(np.arange(nc), np.arange(nc)) % 2
    assert not any(np.array_equal(x["mask"], (parity == p)) for p in (0, 1))
    want = jax_call("fill_sweep_2d", x)
    got = torch_call(ks.fill_sweep_2d, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_wrapper_counts_only_kernel_launches():
    """A CPU call takes the plain version and launches nothing."""
    ks.reset_launch_counts()
    x = {nd: random_inputs(seed=5, ndim=nd) for nd in (2, 3)}
    for name, fn in ks.KERNELS.items():
        torch_call(fn, x[ndim_of(name)])
    assert all(fn.launches == 0 for fn in ks.KERNELS.values())


def float32_inputs(name):
    """Float32 inputs of kernel ``name`` (g int32, mask float32 as the
    card takes them)."""
    x = random_inputs(seed=SEEDS[name], ndim=ndim_of(name))
    return {k: v if k in ("g", "mask") else v.astype(np.float32)
            for k, v in x.items()}


@pytest.mark.parametrize("name", list(SEEDS))
def test_plain_path_refuses_a_mixed_dtype(name):
    """The wrappers check their inputs on the CPU as on the card: a
    float64 stencil cs (a sweep) or ghost weights W (a fill) beside float32
    blocks raises, where the plain version would promote to float64; the
    float32 inputs alone run and stay float32."""
    x = float32_inputs(name)
    assert torch_call(ks.KERNELS[name], x).dtype == torch.float32
    key = "cs" if name in ("sweep_2d", "sweep_3d", "fill_sweep_2d") else "W"
    x[key] = x[key].astype(np.float64)
    with pytest.raises(ValueError, match=f"{key} must be torch.float32"):
        torch_call(ks.KERNELS[name], x)


def test_plain_path_refuses_a_wrong_shape():
    """A shape check of the card's, on the CPU: A with a face too few."""
    x = random_inputs(seed=3)
    x["A"] = x["A"][:, :3]
    with pytest.raises(ValueError, match="A must be"):
        torch_call(ks.fill_2d, x)


def test_fill_2d_swap_is_the_host_extrapolating_ghost():
    """On a block whose four sides all carry the extrapolating weights,
    K3-swap gives the host form of JAX ghostcell._rb_extrap_ghost
    (0.5 pcopy + 1.125 f1 - 0.375 (f2 + swap(f1)) + 0.125 swap(f2)), with
    A the half parent copy."""
    x = random_inputs(seed=8)
    x["W"][:] = 0.0
    x["W"][:, :, 1:5] = (1.125, -0.375, -0.375, 0.125)
    got = torch_call(ks.fill_2d_swap, x).numpy()
    own = x["phi3"][x["g"][:, 0]]
    n, nc = N, NC

    def pswap(a):
        return a.reshape(a.shape[:-1] + (nc // 2, 2))[..., ::-1].reshape(
            a.shape)
    sides = [(own[:, 1, 1:-1], own[:, 2, 1:-1], got[:, 0, 1:-1]),
             (own[:, nc, 1:-1], own[:, nc - 1, 1:-1], got[:, nc + 1, 1:-1]),
             (own[:, 1:-1, 1], own[:, 1:-1, 2], got[:, 1:-1, 0]),
             (own[:, 1:-1, nc], own[:, 1:-1, nc - 1], got[:, 1:-1, nc + 1])]
    for d, (f1, f2, ghost) in enumerate(sides):
        pcopy = 2.0 * x["A"][:, d]
        want = (0.5 * pcopy + 1.125 * f1 - 0.375 * (f2 + pswap(f1))
                + 0.125 * pswap(f2))
        np.testing.assert_allclose(ghost, want, rtol=1e-13, atol=1e-13)


#: hand counts at n = 4096, nc = 8, float64 (each input value read once,
#: the output written once; the fills read 68 of a 2D block's 100 input
#: values and 616 of a 3D block's 1000, not the ghosts they overwrite; W
#: and g only where read): bytes, and of them the int32 g and float32
#: mask bytes, which float32 leaves as they are
MIN_BYTES = {"fill_sweep_2d": (21_709_056, 81_920 + 256),
             "sweep_2d": (21_250_304, 16_384 + 256),
             "fill_2d": (7_028_736, 81_920),
             "fill_2d_swap": (7_290_880, 81_920),
             "sweep_3d": (216_549_376, 16_384 + 2_048),
             "fill_3d": (66_240_512, 114_688)}


@pytest.mark.parametrize("name", list(MIN_BYTES))
def test_min_bytes_matches_hand_count(name):
    f64, fixed = MIN_BYTES[name]
    assert ks.min_bytes(name, 4096, 8, torch.float64) == f64
    assert ks.min_bytes(name, 4096, 8) == f64
    # float32 halves the float bytes only
    assert ks.min_bytes(name, 4096, 8, torch.float32) == (f64 - fixed) // 2 \
        + fixed
