"""Tests of afivo_streamer_tpu_torch that need an NVIDIA card (marker
``gpu``; they skip where torch.cuda.is_available() is false). They import
no JAX, so they run on a machine that has only PyTorch with CUDA:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

* each CUDA smoother kernel (K1-K3 and K3-swap in 2D, K4-K5 in 3D)
  against its plain PyTorch version on the same inputs, float64 and
  float32; the 2D fill (K3, K3-swap) besides at n in {1, 3, 33, 4096}
  and nc in {2, 4, 8, 16}, with neighbor rows that are the box's own,
  and its refusal of a misaligned block array;
* the 2D and 3D slices, and the dielectric slice with live refinement, on
  the card against the same slices on the CPU (plain kernels).
"""

import re
from pathlib import Path

import pytest
import torch

from afivo_streamer_tpu_torch.ops import smoother as ks

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(n, nc, dtype, device, seed=7, ndim=2):
    gen = torch.Generator().manual_seed(seed)
    C = nc + 2
    nd = 2 * ndim
    cube = (nc,) * ndim
    g = torch.empty((n, 1 + nd), dtype=torch.int32)
    g[:, 0] = torch.randperm(n, generator=gen).to(torch.int32)
    g[:, 1:] = torch.randint(0, n, (n, nd), generator=gen, dtype=torch.int32)
    cs = torch.randn((n, 2 + nd) + cube, generator=gen, dtype=torch.float64)
    cs[:, 0] = -1.0 - torch.rand((n,) + cube, generator=gen,
                                 dtype=torch.float64)
    idx = torch.arange(1, nc + 1)
    parity = sum(torch.meshgrid(*[idx] * ndim, indexing="ij"))
    x = {"phi3": torch.randn((n,) + (C,) * ndim, generator=gen,
                             dtype=torch.float64),
         "R": torch.randn((n,) + cube, generator=gen, dtype=torch.float64),
         "A": torch.randn((n, nd) + (nc,) * (ndim - 1), generator=gen,
                          dtype=torch.float64),
         "W": torch.randn(n, nd, 8, generator=gen, dtype=torch.float64),
         "cs": cs}
    x = {k: v.to(dtype) for k, v in x.items()}
    x["g"] = g
    x["mask"] = ((parity % 2) == 0).to(torch.float32)
    return {k: v.to(device).contiguous() for k, v in x.items()}


def call(fn, x, name):
    if name.startswith("sweep"):
        return fn(x["phi3"], x["R"], x["mask"], x["g"], x["cs"])
    if name.startswith("fill_") and "sweep" not in name:
        return fn(x["phi3"], x["A"], x["g"], x["W"])
    return fn(x["phi3"], x["R"], x["mask"], x["A"], x["g"], x["W"], x["cs"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["fill_sweep_2d", "sweep_2d", "fill_2d",
                                  "fill_2d_swap", "sweep_3d", "fill_3d"])
def test_cuda_kernel_matches_plain(name, dtype, cuda):
    """Tolerance: float64 1e-12, float32 2e-5 (the kernel may fuse a
    multiply-add where the plain version rounds twice)."""
    x = inputs(512, 8, dtype, cuda,
               ndim=int(re.search(r"_(\d)d", name).group(1)))
    want = call(ks.PLAIN[name], x, name)
    before = ks.KERNELS[name].launches
    got = call(ks.KERNELS[name], x, name)
    torch.cuda.synchronize()
    assert ks.KERNELS[name].launches == before + 1
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def fill_inputs(n, nc, dtype, device, self_rows=0.25, seed=11,
                own="permuted"):
    """Blocks, ghost constants and weights (all 8 columns nonzero) and a
    neighbor table with permuted own rows (or with ``own="identity"`` the
    box's index, as on every level the V-cycle builds) and a share
    ``self_rows`` of neighbor rows that point at the box's own row."""
    x = inputs(n, nc, dtype, "cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    g = x["g"]
    if own == "identity":
        g[:, 0] = torch.arange(n, dtype=torch.int32)
    selfs = torch.rand((n, 4), generator=gen) < self_rows
    g[:, 1:][selfs] = g[:, :1].expand(n, 4)[selfs]
    return {k: x[k].to(device) for k in ("phi3", "A", "g", "W")}


@pytest.mark.gpu
@pytest.mark.parametrize("own", ["permuted", "identity"])
@pytest.mark.parametrize("nc", [2, 4, 8, 16])
@pytest.mark.parametrize("n", [1, 3, 33, 4096])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["fill_2d", "fill_2d_swap"])
def test_cuda_fill_matches_plain(name, dtype, n, nc, own, cuda):
    """The warp-per-box fill (nc = 8 compiled in, other nc at run time; n
    leaves the last block of four boxes part empty; own rows permuted, so
    the copy started before g is redone, or the box's index) against its
    plain version: a new output, the input unchanged. Tolerance: float64
    1e-12, float32 1e-5 (a fused multiply-add rounds once)."""
    x = fill_inputs(n, nc, dtype, cuda, own=own)
    before = x["phi3"].clone()
    want = call(ks.PLAIN[name], x, name)
    count = ks.KERNELS[name].launches
    got = call(ks.KERNELS[name], x, name)
    torch.cuda.synchronize()
    assert ks.KERNELS[name].launches == count + 1
    assert got.data_ptr() != x["phi3"].data_ptr()
    assert torch.equal(x["phi3"], before)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fill_2d", "fill_2d_swap"])
def test_cuda_fill_with_only_self_rows(name, cuda):
    """Every neighbor row is the box's own row (a level of one box, or
    boxes with physical boundaries on all sides)."""
    x = fill_inputs(64, 8, torch.float64, cuda, self_rows=1.0)
    want = call(ks.PLAIN[name], x, name)
    got = call(ks.KERNELS[name], x, name)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_fill_refuses_misaligned_blocks(dtype, cuda):
    """The fill reads phi3 in 16-byte vectors: a view that starts one
    element into its storage is refused before any launch."""
    x = fill_inputs(8, 8, dtype, cuda)
    flat = torch.empty(x["phi3"].numel() + 1, dtype=dtype, device=cuda)
    view = flat[1:].view_as(x["phi3"])
    view.copy_(x["phi3"])
    counts = (ks.fill_2d.launches, ks.fill_2d_swap.launches)
    for fn in (ks.fill_2d, ks.fill_2d_swap):
        with pytest.raises(ValueError, match="16-byte"):
            fn(view, x["A"], x["g"], x["W"])
    assert (ks.fill_2d.launches, ks.fill_2d_swap.launches) == counts


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_arguments(cuda):
    x = inputs(16, 8, torch.float64, cuda)
    with pytest.raises(ValueError):
        ks.fill_2d(x["phi3"], x["A"], x["g"].long(), x["W"])
    with pytest.raises(ValueError):
        ks.sweep_2d(x["phi3"], x["R"], x["mask"], x["g"], x["cs"].cpu())
    x3 = inputs(16, 8, torch.float64, cuda, ndim=3)
    with pytest.raises(ValueError):  # a 2D block array to the 3D kernel
        ks.fill_3d(x["phi3"], x3["A"], x3["g"], x3["W"])
    with pytest.raises(ValueError):  # 2D neighbor table
        ks.sweep_3d(x3["phi3"], x3["R"], x3["mask"], x["g"], x3["cs"])
    with pytest.raises(ValueError):  # float32 ghost weights
        ks.fill_3d(x3["phi3"], x3["A"], x3["g"], x3["W"].float())


@pytest.mark.gpu
def test_slice_cuda_matches_cpu(cuda, tmp_path):
    """The committed 2D slice at 32 x 32 cells, 2 steps: the state on the
    card against the state on the CPU, rtol 1e-9 per variable."""
    slice_cuda_vs_cpu(tmp_path, "air_cyl_slice.cfg", 2)


@pytest.mark.gpu
def test_slice_3d_cuda_matches_cpu(cuda, tmp_path):
    """The committed 3D slice at 32^3 cells, 2 steps, through K4 and K5:
    the state on the card against the state on the CPU, rtol 1e-9 per
    variable."""
    before = (ks.sweep_3d.launches, ks.fill_3d.launches)
    slice_cuda_vs_cpu(tmp_path, "air_3d_slice.cfg", 3)
    assert ks.sweep_3d.launches > before[0]
    assert ks.fill_3d.launches > before[1]


@pytest.mark.gpu
def test_dielectric_slice_cuda_matches_cpu(cuda, tmp_path):
    """The dielectric slice (live refinement, extrapolating ghosts) for 2
    steps, through K3-swap: the same mesh and state on the card as on the
    CPU, rtol 1e-9 per variable."""
    before = ks.fill_2d_swap.launches
    sims = slice_cuda_vs_cpu(
        tmp_path, "dielectric_2d_slice.cfg", 2, [
            "-refine_max_dx=2.5e-4",
            f"-user%module={ROOT / 'afivo_streamer_tpu_torch' / 'programs'}"
            "/dielectric_2d.py"])
    assert ks.fill_2d_swap.launches > before
    for a, b in zip(sims[0].tree.lvl_ids, sims[1].tree.lvl_ids):
        assert (a == b).all()


def slice_cuda_vs_cpu(tmp_path, cfg, ndim, extra=("-refine_max_dx=5e-4",)):
    from afivo_streamer_tpu_torch.driver import Simulation
    sims = []
    for dev in ("cpu", "cuda"):
        sim = Simulation(argv=[
            str(DATA / cfg), f"-ndim={ndim}", *extra,
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            f"-output%name={tmp_path}/{dev}", f"-device={dev}"])
        sim.run(max_steps=2)
        sims.append(sim)
    n = sims[0].tree.highest_id
    for iv in range(sims[0].cc.shape[0]):
        ref = sims[0].cc[iv, :n]
        scale = float(ref.abs().max())
        torch.testing.assert_close(sims[1].cc[iv, :n].cpu(), ref, rtol=1e-9,
                                   atol=1e-9 * scale)
    return sims
