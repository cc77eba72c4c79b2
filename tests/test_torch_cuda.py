"""Tests of afivo_streamer_tpu_torch that need an NVIDIA card (marker
``gpu``; they skip where torch.cuda.is_available() is false). They import
no JAX, so they run on a machine that has only PyTorch with CUDA:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

* each CUDA smoother kernel against its plain PyTorch version on the same
  inputs, float64 and float32;
* the slice on the card against the slice on the CPU (plain kernels).
"""

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


def inputs(n, nc, dtype, device, seed=7):
    gen = torch.Generator().manual_seed(seed)
    C = nc + 2
    g = torch.empty((n, 5), dtype=torch.int32)
    g[:, 0] = torch.randperm(n, generator=gen).to(torch.int32)
    g[:, 1:] = torch.randint(0, n, (n, 4), generator=gen, dtype=torch.int32)
    cs = torch.randn(n, 6, nc, nc, generator=gen, dtype=torch.float64)
    cs[:, 0] = -1.0 - torch.rand(n, nc, nc, generator=gen,
                                 dtype=torch.float64)
    idx = torch.arange(1, nc + 1)
    x = {"phi3": torch.randn(n, C, C, generator=gen, dtype=torch.float64),
         "R": torch.randn(n, nc, nc, generator=gen, dtype=torch.float64),
         "A": torch.randn(n, 4, nc, generator=gen, dtype=torch.float64),
         "W": torch.randn(n, 4, 8, generator=gen, dtype=torch.float64),
         "cs": cs}
    x = {k: v.to(dtype) for k, v in x.items()}
    x["g"] = g
    x["mask"] = (((idx[:, None] + idx[None, :]) % 2) == 0).to(torch.float32)
    return {k: v.to(device).contiguous() for k, v in x.items()}


def call(fn, x, name):
    if name == "sweep_2d":
        return fn(x["phi3"], x["R"], x["mask"], x["g"], x["cs"])
    if name == "fill_2d":
        return fn(x["phi3"], x["A"], x["g"], x["W"])
    return fn(x["phi3"], x["R"], x["mask"], x["A"], x["g"], x["W"], x["cs"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["fill_sweep_2d", "sweep_2d", "fill_2d"])
def test_cuda_kernel_matches_plain(name, dtype, cuda):
    """Tolerance: float64 1e-12, float32 2e-5 (the kernel may fuse a
    multiply-add where the plain version rounds twice)."""
    x = inputs(512, 8, dtype, cuda)
    want = call(ks.PLAIN[name], x, name)
    before = ks.KERNELS[name].launches
    got = call(ks.KERNELS[name], x, name)
    torch.cuda.synchronize()
    assert ks.KERNELS[name].launches == before + 1
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_arguments(cuda):
    x = inputs(16, 8, torch.float64, cuda)
    with pytest.raises(ValueError):
        ks.fill_2d(x["phi3"], x["A"], x["g"].long(), x["W"])
    with pytest.raises(ValueError):
        ks.sweep_2d(x["phi3"], x["R"], x["mask"], x["g"], x["cs"].cpu())


@pytest.mark.gpu
def test_slice_cuda_matches_cpu(cuda, tmp_path):
    """The committed slice at 32 x 32 cells, 2 steps: the state on the card
    against the state on the CPU, rtol 1e-9 per variable."""
    from afivo_streamer_tpu_torch.driver import Simulation
    sims = []
    for dev in ("cpu", "cuda"):
        sim = Simulation(argv=[
            str(DATA / "air_cyl_slice.cfg"), "-ndim=2",
            "-refine_max_dx=5e-4",
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
