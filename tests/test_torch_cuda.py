"""Tests of afivo_streamer_tpu_torch that need an NVIDIA card (marker
``gpu``; they skip where torch.cuda.is_available() is false). They import
no JAX, so they run on a machine that has only PyTorch with CUDA:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

* each CUDA smoother kernel (K1-K3 and K3-swap in 2D, K4-K5 in 3D)
  against its plain PyTorch version on the same inputs, float64 and
  float32; the kernels that stage boxes in shared memory (K1, K2, K3,
  K3-swap, K5) besides at n in {1, 3, 33, 4096} and nc in {2, 4, 8, 16,
  32, 64} (past 48 KB of shared memory K1 and K3 opt in, K2 and K5 take
  kernels that stage less), with
  neighbor rows that are the box's own, K1 and K2 with a mask that is no
  checkerboard, and their refusal of a misaligned input; each staged
  kernel at the largest nc it runs on the H100, and its refusal of the
  next even nc (no fall back to the plain version);
* K1-K5 on every level of a Helmholtz multigrid (the photoionization
  boundary set, the smallest and the largest Bourdon-3 lambda) with that
  level's own stencil, ghost weights, ghost constants and blocks, and on
  every level of a multigrid with a rod electrode (level-set stencil,
  the boundary potential in the rhs);
* the 2D and 3D slices, and the dielectric slice with live refinement, on
  the card against the same slices on the CPU (plain kernels); the
  cylindrical and the 3D slice with live refinement and photoionization
  the same way, with the FMG cycle counts;
* the fluid-model variants the same way: the planar 1D slice under the
  local field approximation and under the electron energy equation (no
  kernel launch: one dimension smooths with tensor operations, held here
  on the card against the CPU), the cylindrical slice under ee53 with
  photoionization, with the source factor and with a plasma region;
* the electrode slices the same way: the Cartesian rod as cathode, the
  cylindrical needle with photoionization, a user electrode and the 3D
  rod;
* the field solver's last branches the same way: the cylindrical
  dielectric, the 3D slab, the needle above the plate (K3-swap launched)
  and the 256 x 256-cell level-1 grid (the uniform coarse multigrid, the
  same V-cycles), and the IMEX problem of programs/reaction_diffusion.py
  (the same FMG cycles);
* one gas step: the slice with gas dynamics, slow heating and a
  pre-heated channel for 2 steps (each ends with the coupling, a Heun step
  of the Euler equations and the new gas density), the state and the gas
  dt limit on the card as on the CPU;
* the comparison_air_2d program (a potential_bc hook whose tabulated
  profile stays on the card) with the text log and the grid files: the
  state and every written file on the card as on the CPU;
* Monte-Carlo photoionization on the cylindrical slice and on the
  cylindrical dielectric (the surfaces' photon fluxes), the particle
  deposits and gather, and a restart on the card from a checkpoint the CPU
  wrote, each against the CPU;
* the compiled engine's float32 state on the cylindrical and the 3D slice
  against the CPU's float32 run, every launch float32;
* the stochastic background density (init_cond.stochastic_density) on the
  cylindrical slice with live refinement: right after the call and after
  4 steps, on the card as on the CPU.
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


def inputs(n, nc, dtype, device, seed=7, ndim=2, sweep=True):
    """Random inputs of every kernel (without R and cs unless ``sweep``)."""
    gen = torch.Generator().manual_seed(seed)
    C = nc + 2
    nd = 2 * ndim
    cube = (nc,) * ndim
    g = torch.empty((n, 1 + nd), dtype=torch.int32)
    g[:, 0] = torch.randperm(n, generator=gen).to(torch.int32)
    g[:, 1:] = torch.randint(0, n, (n, nd), generator=gen, dtype=torch.int32)
    idx = torch.arange(1, nc + 1)
    parity = sum(torch.meshgrid(*[idx] * ndim, indexing="ij"))
    x = {"phi3": torch.randn((n,) + (C,) * ndim, generator=gen,
                             dtype=torch.float64),
         "A": torch.randn((n, nd) + (nc,) * (ndim - 1), generator=gen,
                          dtype=torch.float64),
         "W": torch.randn(n, nd, 8, generator=gen, dtype=torch.float64)}
    if sweep:
        x["R"] = torch.randn((n,) + cube, generator=gen, dtype=torch.float64)
        x["cs"] = torch.randn((n, 2 + nd) + cube, generator=gen,
                              dtype=torch.float64)
        x["cs"][:, 0] = -1.0 - torch.rand((n,) + cube, generator=gen,
                                          dtype=torch.float64)
    x = {k: v.to(dtype) for k, v in x.items()}
    x["g"] = g
    x["mask"] = ((parity % 2) == 0).to(torch.float32)
    return {k: v.to(device).contiguous() for k, v in x.items()}


def ndim_of(name):
    return int(re.search(r"_(\d)d", name).group(1))


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
    x = inputs(512, 8, dtype, cuda, ndim=ndim_of(name))
    want = call(ks.PLAIN[name], x, name)
    before = ks.KERNELS[name].launches
    got = call(ks.KERNELS[name], x, name)
    torch.cuda.synchronize()
    assert ks.KERNELS[name].launches == before + 1
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def fill_inputs(name, n, nc, dtype, device, self_rows=0.25, seed=11,
                own="permuted"):
    """The inputs of kernel ``name``: blocks, ghost constants and weights
    (all 8 columns nonzero), a neighbor table with permuted own rows (or
    with ``own="identity"`` the box's index, as on every level the V-cycle
    builds) and a share ``self_rows`` of neighbor rows that point at the
    box's own row, and for K1 and K2 the sweep's R, cs and checkerboard
    mask."""
    ndim = ndim_of(name)
    x = inputs(n, nc, dtype, "cpu", seed=seed, ndim=ndim,
               sweep="sweep" in name)
    gen = torch.Generator().manual_seed(seed + 1)
    g = x["g"]
    nd = 2 * ndim
    if own == "identity":
        g[:, 0] = torch.arange(n, dtype=torch.int32)
    selfs = torch.rand((n, nd), generator=gen) < self_rows
    g[:, 1:][selfs] = g[:, :1].expand(n, nd)[selfs]
    return {k: v.to(device) for k, v in x.items()}


#: the kernels that stage boxes in shared memory, and their float32
#: tolerance (a fused multiply-add rounds once where the plain version
#: rounds twice; the sweeps divide as well)
STAGED = {"fill_2d": 1e-5, "fill_2d_swap": 1e-5, "fill_3d": 1e-5,
          "fill_sweep_2d": 2e-5, "sweep_2d": 2e-5}
#: the staged kernels that read R, cs and the mask besides phi3
SWEEPS = ("fill_sweep_2d", "sweep_2d")


#: the staged kernels' cases: every name, dtype, n, nc and kind of own
#: row, but K5 at n = 4096 only up to nc = 32 (at nc = 64 one copy of its
#: blocks is 9.4 GB in float64)
STAGED_CASES = [
    (name, dtype, n, nc, own)
    for name in STAGED for dtype in (torch.float64, torch.float32)
    for n in (1, 3, 33, 4096) for nc in (2, 4, 8, 16, 32, 64)
    for own in ("permuted", "identity")
    if not (name == "fill_3d" and n == 4096 and nc == 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,n,nc,own", STAGED_CASES)
def test_cuda_fill_matches_plain(name, dtype, n, nc, own, cuda):
    """The kernels that stage boxes in shared memory (nc = 8 compiled in,
    other nc at run time; in 2D n leaves the last block of a few boxes
    part empty; own rows permuted, so the copy started before g is
    redone, or the box's index) against their plain versions: a new
    output, the input unchanged, one launch. Tolerance: float64 1e-12,
    float32 STAGED."""
    x = fill_inputs(name, n, nc, dtype, cuda, own=own)
    before = x["phi3"].clone()
    want = call(ks.PLAIN[name], x, name)
    count = ks.KERNELS[name].launches
    got = call(ks.KERNELS[name], x, name)
    torch.cuda.synchronize()
    assert ks.KERNELS[name].launches == count + 1
    assert got.data_ptr() != x["phi3"].data_ptr()
    assert torch.equal(x["phi3"], before)
    tol = 1e-12 if dtype == torch.float64 else STAGED[name]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("nc", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", SWEEPS)
def test_cuda_fill_sweep_with_random_mask(name, dtype, nc, cuda):
    """K1 and K2 with a mask that is no checkerboard (neighbors of an
    updated cell updated too): every new value comes from the staged block
    before any is written back, as in the plain version."""
    x = fill_inputs(name, 257, nc, dtype, cuda)
    gen = torch.Generator().manual_seed(nc)
    mask = (torch.rand((nc, nc), generator=gen) < 0.5).to(torch.float32)
    idx = torch.arange(nc)
    parity = (idx[:, None] + idx[None, :]) % 2
    assert not any(torch.equal(mask, (parity == p).float()) for p in (0, 1))
    x["mask"] = mask.to(cuda)
    want = call(ks.PLAIN[name], x, name)
    got = call(ks.KERNELS[name], x, name)
    tol = 1e-12 if dtype == torch.float64 else STAGED[name]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(STAGED))
def test_cuda_fill_with_only_self_rows(name, cuda):
    """Every neighbor row is the box's own row (a level of one box, or
    boxes with physical boundaries on all sides)."""
    x = fill_inputs(name, 64, 8, torch.float64, cuda, self_rows=1.0)
    want = call(ks.PLAIN[name], x, name)
    got = call(ks.KERNELS[name], x, name)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_fill_refuses_misaligned_blocks(dtype, cuda):
    """The staged kernels read phi3 (K1 and K2 also R, cs and the mask)
    in vectors or bulk copies: a view that starts one element into its
    storage is refused before any launch."""
    def misaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view_as(t)
        view.copy_(t)
        return view
    counts = {name: ks.KERNELS[name].launches for name in STAGED}
    for name in STAGED:
        x = fill_inputs(name, 8, 8, dtype, cuda)
        for key in (("phi3", "R", "cs", "mask") if name in SWEEPS
                    else ("phi3",)):
            y = dict(x, **{key: misaligned(x[key])})
            with pytest.raises(ValueError, match="16-byte"):
                call(ks.KERNELS[name], y, name)
    assert {name: ks.KERNELS[name].launches for name in STAGED} == counts


#: the largest nc each 2D staged kernel runs on the H100 (232,448 bytes of
#: shared memory a block once opted in), by dtype: K1 stages a box's block
#: and its interior, K2 (past nc = 32) and K3 a box's block. K4 and K5 stage
#: no box past the limit and have none.
LARGEST_NC = {"fill_sweep_2d": {torch.float64: 118, torch.float32: 168},
              "sweep_2d": {torch.float64: 168, torch.float32: 238},
              "fill_2d": {torch.float64: 168, torch.float32: 238},
              "fill_2d_swap": {torch.float64: 168, torch.float32: 238}}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(LARGEST_NC))
def test_cuda_largest_nc_runs_and_the_next_raises(name, dtype, cuda):
    """At its largest nc a kernel matches its plain version; at the next
    even nc its launch is refused (cudaErrorInvalidValue), the wrapper
    raises and counts no launch, and nothing falls back to the plain
    version."""
    nc = LARGEST_NC[name][dtype]
    x = fill_inputs(name, 3, nc, dtype, cuda)
    want = call(ks.PLAIN[name], x, name)
    got = call(ks.KERNELS[name], x, name)
    tol = 1e-12 if dtype == torch.float64 else STAGED[name]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    x = fill_inputs(name, 3, nc + 2, dtype, cuda)
    count = ks.KERNELS[name].launches
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        call(ks.KERNELS[name], x, name)
    assert ks.KERNELS[name].launches == count


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


def helmholtz_level_inputs(ndim, lam, device, electrode=False):
    """Per level of a Helmholtz multigrid (16 mm domain, 1 mm level-1
    cells, refined twice over one corner; Dirichlet zero in the last
    dimension, Neumann zero elsewhere; cylindrical in 2D) the inputs a
    V-cycle hands the kernels: blocks of a random guess after one cycle,
    a positive source, the level's A, g, W and cs. With ``electrode`` a
    rod of 0.4 mm radius stands 2.4 mm up from that corner at 28.8 kV: the
    stencil is the level set's and R carries the boundary term."""
    import numpy as np
    from afivo_streamer_tpu_torch.core.levels import MeshPlans
    from afivo_streamer_tpu_torch.core.tree import Tree, DO_REF, KEEP_REF
    from afivo_streamer_tpu_torch.physics.photoi import helmh_bc
    from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
    from afivo_streamer_tpu_torch.solvers.lsf import LsfData
    from afivo_streamer_tpu_torch.solvers.multigrid import Multigrid
    from afivo_streamer_tpu_torch.utils import geometry
    nc = 8
    t = Tree(ndim, nc, [16e-3] * ndim, [16] * ndim,
             coord="cyl" if ndim == 2 else "xyz")

    def flags(ids):
        out = np.full([len(ids)] + [nc] * ndim, KEEP_REF, np.int64)
        for k, b in enumerate(ids):
            r0 = t.box_r_min(np.asarray([int(b)]))[0]
            if np.all(r0 < 3.2e-3) and t.lvl[int(b)] == t.highest_lvl:
                out[k] = DO_REF
        return out
    for _ in range(2):
        t.adjust_refinement(flags, ref_buffer=1)
    mg = Multigrid(MeshPlans(t, device), 0, 1,
                   lambda iv, d, c, p: helmh_bc(iv, d, c, p, ndim),
                   helmholtz_lambda=lam ** 2)
    params = {}
    if electrode:
        r0 = np.array([0.7e-3] * (ndim - 1) + [0.0])
        r1 = np.array([0.9e-3] * (ndim - 1) + [2.4e-3])
        mg.lsf_data = LsfData(
            mg.mesh, lambda r: geometry.dist_line(r, r0, r1) - 4e-4,
            length_scale=4e-4)
        params = {"lsf_phi_b": 2.88e4}
    gen = torch.Generator().manual_seed(ndim)
    cc = torch.rand((2, t.highest_id, (nc + 2) ** ndim), generator=gen,
                    dtype=torch.float64)
    cc[0] *= 1e10
    cc[1] *= 1e24
    cc = mg.fill_ghosts_phi(cc.to(device), params)
    cc, _res = mg.vcycle(cc, params)
    P, R = mgb.gather_levels(mg, cc)
    out = []
    for lvl in range(1, t.highest_lvl + 1):
        sm = mg.smoother(lvl)
        A = mgb.build_A_blocks(mg, lvl, P[lvl - 2] if lvl > 1 else None,
                               params, P[0].dtype)
        R_l = mgb.rhs_with_boundary(mg, lvl, R[lvl - 1], params).contiguous()
        assert not electrode or mg.corr(lvl, P[0].dtype) is not None
        out.append({"phi3": P[lvl - 1], "R": R_l, "A": A, "g": sm.g,
                    "W": sm.W(P[0].dtype), "cs": mg.cs(lvl, P[0].dtype),
                    "mask": mg.parity_masks(2)[1]})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("lam", [4147.85 * 0.2, 66755.67 * 0.2],
                         ids=["lambda-min", "lambda-max"])
@pytest.mark.parametrize("name", ["fill_sweep_2d", "sweep_2d", "fill_2d",
                                  "sweep_3d", "fill_3d"])
def test_cuda_kernel_on_helmholtz_levels(name, lam, cuda):
    """Each kernel against its plain version on every level of a Helmholtz
    multigrid (lambda^2 dx^2 from 0.043 to 178), float64, to 1e-12 of the
    blocks' scale."""
    for x in helmholtz_level_inputs(ndim_of(name), lam, cuda):
        want = call(ks.PLAIN[name], x, name)
        count = ks.KERNELS[name].launches
        got = call(ks.KERNELS[name], x, name)
        torch.cuda.synchronize()
        assert ks.KERNELS[name].launches == count + 1
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fill_sweep_2d", "sweep_2d", "fill_2d",
                                  "sweep_3d", "fill_3d"])
def test_cuda_kernel_on_level_set_levels(name, cuda):
    """Each kernel against its plain version on every level of a Poisson
    multigrid with a rod electrode (the neighbor coefficients 0 toward the
    electrode, the centre coefficient up to 1e4 times the plain one beside
    it, the boundary potential in R), float64, to 1e-12 of the blocks'
    scale."""
    for x in helmholtz_level_inputs(ndim_of(name), 0.0, cuda, electrode=True):
        want = call(ks.PLAIN[name], x, name)
        got = call(ks.KERNELS[name], x, name)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * scale)


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


@pytest.mark.gpu
@pytest.mark.parametrize("cfg, ndim", [("air_cyl_amr_slice.cfg", 2),
                                       ("air_3d_amr_slice.cfg", 3)])
def test_photoi_slice_cuda_matches_cpu(cfg, ndim, cuda, tmp_path):
    """The slices with live refinement and Helmholtz photoionization every
    2 steps, 4 steps (the epoch after step 4 removes boxes): the same
    mesh, the same FMG cycles per mode at every update, and the state on
    the card as on the CPU, rtol 1e-9 per variable."""
    cycles = ([], [])
    sims = slice_cuda_vs_cpu(tmp_path, cfg, ndim, ["-photoi%per_steps=2"],
                             steps=4, cycles=cycles)
    assert len(cycles[0]) >= 3 and cycles[0] == cycles[1]
    for a, b in zip(sims[0].tree.lvl_ids, sims[1].tree.lvl_ids):
        assert (a == b).all()


EE = ["-model%type=ee53", "-input_data%old_style=f",
      f"-input_data%file={DATA / 'td_air_synthetic_new.txt'}"]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg, ndim, extra, steps", [
    ("air_1d_slice.cfg", 1, [], 6),
    ("air_1d_slice.cfg", 1, EE, 6),
    ("air_cyl_ee_slice.cfg", 2, EE + ["-photoi%per_steps=2"], 4),
    ("air_cyl_amr_slice.cfg", 2, ["-fixes%source_factor=flux",
                                  "-fixes%write_source_factor=t"], 4),
    ("air_cyl_amr_slice.cfg", 2, ["-plasma_region_enabled=t",
                                  "-plasma_region_rmin=0 0.0135",
                                  "-plasma_region_rmax=0.002 0.0155"], 4),
    ("electrode_2d_slice.cfg", 2, ["-field_given_by=field 1.8e6"], 4),
    ("electrode_cyl_slice.cfg", 2, ["-photoi%per_steps=2"], 4),
    ("electrode_2d_slice.cfg", 2, [
        "-field_electrode_type=user", "-user%module="
        f"{ROOT / 'afivo_streamer_tpu_torch' / 'programs'}/electrode_user.py"],
     4),
    ("electrode_3d_slice.cfg", 3, [], 4),
], ids=["1d-lfa", "1d-ee53", "cyl-ee53-photoi", "cyl-source-factor",
        "cyl-plasma-region", "cathode-rod", "cyl-needle-photoi",
        "user-electrode", "3d-rod"])
def test_variant_slice_cuda_matches_cpu(cfg, ndim, extra, steps, cuda,
                                        tmp_path):
    """The fluid-model variants with live refinement (an early epoch
    removes boxes): the same mesh and the state on the card as on the
    CPU, rtol 1e-9 per variable; a 1D run launches no kernel, a 2D one
    K1-K3, a 3D one K4 and K5; under ee53 the energy-loss limit is active
    on both. The electrode slices the same way."""
    ks.reset_launch_counts()
    sims = slice_cuda_vs_cpu(tmp_path, cfg, ndim, extra, steps=steps)
    launched = {k: fn.launches for k, fn in ks.KERNELS.items()}
    if ndim == 1:
        assert not any(launched.values())
    else:
        assert all(launched[k] > 0 for k in (
            ("fill_sweep_2d", "sweep_2d", "fill_2d") if ndim == 2
            else ("sweep_3d", "fill_3d")))
    for a, b in zip(sims[0].tree.lvl_ids, sims[1].tree.lvl_ids):
        assert (a == b).all()
    if "-model%type=ee53" in extra:
        for sim in sims:
            assert sim.dt_limits[3] < 1e99


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_1d_smoother_on_card_matches_cpu(dtype, cuda):
    """sweep_1d and fill_1d (tensor operations, no kernel) give on the card
    what they give on the CPU, to rounding."""
    x = inputs(33, 8, dtype, "cpu", ndim=1)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for fn, names in ((ks.sweep_1d, ("phi3", "R", "mask", "g", "cs")),
                      (ks.fill_1d, ("phi3", "A", "g", "W"))):
        want = fn(*[x[k] for k in names])
        got = fn(*[x[k].to(cuda) for k in names]).cpu()
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def slice_cuda_vs_cpu(tmp_path, cfg, ndim, extra=("-refine_max_dx=5e-4",),
                      steps=2, cycles=None, prepare=None):
    """Run ``cfg`` on the CPU and on the card and compare every variable;
    ``cycles``, a pair of lists, takes the FMG cycle counts of every
    photoionization update of the two runs; ``prepare(sim)`` runs right
    after each setup."""
    from afivo_streamer_tpu_torch.driver import Simulation
    sims = []
    for k, dev in enumerate(("cpu", "cuda")):
        sim = Simulation(argv=[
            str(DATA / cfg), f"-ndim={ndim}",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}", *extra,
            f"-output%name={tmp_path}/{dev}", f"-device={dev}"])
        if prepare is not None:
            prepare(sim)
        if cycles is not None:
            def set_src(*args, _sim=sim, _set=sim.photoi.set_src, _k=k):
                cc = _set(*args)
                cycles[_k].append(list(_sim.photoi.fmg_cycles))
                return cc
            sim.photoi.set_src = set_src
        sim.run(max_steps=steps)
        sims.append(sim)
    n = sims[0].tree.highest_id
    for iv in range(sims[0].cc.shape[0]):
        ref = sims[0].cc[iv, :n]
        scale = float(ref.abs().max())
        torch.testing.assert_close(sims[1].cc[iv, :n].cpu(), ref, rtol=1e-9,
                                   atol=1e-9 * scale)
    return sims


DIEL_USER = ("-user%module="
             f"{ROOT / 'afivo_streamer_tpu_torch' / 'programs'}/dielectric_2d.py")


@pytest.mark.gpu
@pytest.mark.parametrize("cfg, ndim, extra, launched_names", [
    ("dielectric_cyl_slice.cfg", 2, ["-photoi%per_steps=2", DIEL_USER],
     ("fill_2d_swap",)),
    ("dielectric_3d_slice.cfg", 3, [DIEL_USER], ("sweep_3d", "fill_3d")),
    ("electrode_dielectric_cyl_slice.cfg", 2,
     ["-photoi%per_steps=2", DIEL_USER], ("sweep_2d", "fill_2d_swap")),
    ("air_cyl_slice.cfg", 2, ["-cylindrical=f", "-coarse_grid_size=256 256"],
     ("fill_2d",)),
], ids=["cyl-dielectric", "3d-slab", "needle-above-plate", "coarse-256"])
def test_field_branch_slice_cuda_matches_cpu(cfg, ndim, extra,
                                             launched_names, cuda, tmp_path):
    """Dielectrics beyond Cartesian 2D, the pair and the uniform coarse
    multigrid: the same mesh, state and surface data on the card as on
    the CPU, rtol 1e-9 of each variable's scale, the kernels of the path
    launched and, on the coarse grid, the same V-cycles of every level-1
    solve."""
    from afivo_streamer_tpu_torch import interop
    ks.reset_launch_counts()
    sims = slice_cuda_vs_cpu(tmp_path, cfg, ndim, extra, steps=4)
    assert all(ks.KERNELS[k].launches > 0 for k in launched_names)
    for a, b in zip(sims[0].tree.lvl_ids, sims[1].tree.lvl_ids):
        assert (a == b).all()
    if sims[0].surfaces is not None:
        want, got = (interop.surface_data(s) for s in sims)
        assert want.keys() == got.keys() and want
        for k in want:
            torch.testing.assert_close(torch.as_tensor(got[k]),
                                       torch.as_tensor(want[k]), rtol=1e-9,
                                       atol=1e-9 * abs(want[k]).max())
    else:
        solvers = [s.field.mg.coarse_solver() for s in sims]
        assert solvers[0].last_vcycles == solvers[1].last_vcycles >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("integrator", ["imex_euler", "imex_trapezoidal"])
def test_reaction_diffusion_cuda_matches_cpu(integrator, cuda):
    """Two IMEX steps of the stiff reaction-diffusion problem at 64^2 cells:
    the implicit Helmholtz solve launches K1-K3; every time state equal to
    the CPU's within rtol 1e-9 of its scale, the same FMG cycles."""
    from afivo_streamer_tpu_torch.programs import reaction_diffusion as rd
    probs = []
    for dev in ("cpu", "cuda"):
        ks.reset_launch_counts()
        prob = rd.ReactionDiffusion(16, 3, device=dev)
        prob.run(integrator, 2e-3, 2)
        probs.append(prob)
    assert all(ks.KERNELS[k].launches > 0
               for k in ("fill_sweep_2d", "sweep_2d", "fill_2d"))
    assert probs[0].fmg_cycles == probs[1].fmg_cycles
    for s in range(3):
        ref = probs[0].cc[rd.I_U + s, probs[0].ids]
        torch.testing.assert_close(
            probs[1].cc[rd.I_U + s, probs[1].ids].cpu(), ref, rtol=1e-9,
            atol=1e-9 * max(float(ref.abs().max()), 1e-300))


@pytest.mark.gpu
def test_gas_step_cuda_matches_cpu(cuda, tmp_path):
    """One gas step (the coupling, a Heun step of the Euler equations, the
    new gas density) on the card and on the CPU from one state: the slice
    with slow heating and a pre-heated channel after 2 steps on the CPU,
    carried to the card by interop, then a step of 0.4 of the gas dt
    limit, where the gas moves by O(1) of its variation. Every variable
    and the gas's face fluxes within 1e-11 of their scale, the gas's
    increments within 1e-11 of their own, the same gas dt limit."""
    from afivo_streamer_tpu_torch import interop
    from afivo_streamer_tpu_torch.driver import Simulation
    programs = ROOT / "afivo_streamer_tpu_torch" / "programs"
    sims = [Simulation(argv=[
        str(DATA / "gas_heating_cyl_slice.cfg"), "-input_data%old_style=f",
        f"-input_data%file={DATA / 'td_air_synthetic_reactions.txt'}",
        "-gas%fraction_slow_heating=0.3",
        f"-user%module={programs / 'heated_channel.py'}",
        f"-output%name={tmp_path}/{dev}", f"-device={dev}"])
        for dev in ("cpu", "cuda")]
    a, b = sims
    a.run(max_steps=2)
    interop.state_from_numpy(b, a.cc.numpy(), a.fc.numpy(),
                             interop.tree_arrays(a.tree), it=a.it,
                             global_time=a.global_time, global_dt=a.global_dt)
    start = a.cc.clone()
    dt = 0.4 * a.dt_gas_lim
    for sim in sims:
        sim._gas_step(dt, {"voltage": sim.field.current_voltage})
    n = a.tree.highest_id
    for iv, name in enumerate(a.registry.cc_names):
        ref = a.cc[iv, :n]
        torch.testing.assert_close(b.cc[iv, :n].cpu(), ref, rtol=1e-11,
                                   atol=1e-11 * float(ref.abs().max()))
        if name.startswith("gas_") or name == "vibrational_energy":
            inc_a = ref - start[iv, :n]
            inc_b = b.cc[iv, :n].cpu() - start[iv, :n]
            scale = float(inc_a.abs().max())
            assert scale > 0, name
            torch.testing.assert_close(inc_b, inc_a, rtol=1e-11,
                                       atol=1e-11 * scale)
    for f_iv in a.gasdyn.gas_fluxes:
        ref = a.fc[f_iv, :, :n]
        torch.testing.assert_close(b.fc[f_iv, :, :n].cpu(), ref, rtol=1e-11,
                                   atol=1e-11 * float(ref.abs().max()))
    assert b.dt_gas_lim == pytest.approx(a.dt_gas_lim, rel=1e-12)


@pytest.mark.gpu
def test_potential_bc_and_writers_cuda_match_cpu(cuda, tmp_path):
    """The comparison_air_2d program (potential_bc: the tabulated electrode
    potentials, kept on the card and scaled there by the voltage) for 8
    steps on the card and on the CPU, with the text log and the grid files
    on: every variable within 1e-9 of its scale, K1-K3 launched, and every
    file both runs wrote (io/compare.py) within 1e-8, the last of the 9
    digits the text files print."""
    from afivo_streamer_tpu_torch.io.compare import compare_outputs
    programs = ROOT / "afivo_streamer_tpu_torch" / "programs"
    ks.reset_launch_counts()
    sims = slice_cuda_vs_cpu(
        tmp_path, "comparison_air_2d.cfg", 2,
        extra=(f"-user%module={programs / 'comparison_air_2d.py'}",),
        steps=8)
    assert all(ks.KERNELS[k].launches > 0
               for k in ("fill_sweep_2d", "sweep_2d", "fill_2d"))
    b = sims[1]
    coords = b.mesh.gc(1).dirs[3].bc_coords
    _kind, val = b.field.phi_bc(b.i_phi, 3, coords, {"voltage": 1.0})
    assert val.device.type == "cuda" and float(val.max() - val.min()) > 0
    worst = compare_outputs(tmp_path / "cpu", tmp_path / "cuda", 1e-8)
    assert "log.txt" in worst and any(k.startswith("grid_") for k in worst)


MC = ("-photoi%method=montecarlo", "-photoi_mc%physical_photons=f",
      "-photoi_mc%num_photons=20000", "-photoi%per_steps=2")


@pytest.mark.gpu
@pytest.mark.parametrize("cfg, ndim, extra", [
    ("air_cyl_amr_slice.cfg", 2, MC),
    ("dielectric_cyl_slice.cfg", 2,
     MC + (DIEL_USER, "-dielectric%gamma_se_ph_highenergy=0.1",
           "-dielectric%gamma_se_ph_lowenergy=0.1")),
], ids=["cyl", "cyl-dielectric"])
def test_monte_carlo_cuda_matches_cpu(cfg, ndim, extra, cuda, tmp_path):
    """Monte-Carlo photoionization (20,000 photons every 2 steps) for 4
    steps on the card and on the CPU: the same photons (one NumPy stream),
    every variable within 1e-9 and with dielectrics the surfaces' photon
    fluxes, which are among the variables."""
    sims = slice_cuda_vs_cpu(tmp_path, cfg, ndim, extra=extra, steps=4)
    a, b = sims
    assert b.photoi.mc.n_photons == a.photoi.mc.n_photons > 0
    assert float(b.cc[b.photoi.i_photo].abs().max()) > 0.0


@pytest.mark.gpu
def test_particles_cuda_match_cpu(cuda):
    """core/particles.py with the state on the card: deposits of order 0
    and 1 and the gather back, against the same on the CPU."""
    import numpy as np
    from afivo_streamer_tpu_torch.core import particles as part
    from afivo_streamer_tpu_torch.core.tree import Tree
    t = Tree(2, 8, [1.0, 1.0], [16, 16])
    rng = np.random.default_rng(3)
    r = rng.uniform(0.05, 0.95, size=(500, 2))
    w = rng.uniform(0.5, 2.0, size=500)
    for order in (0, 1):
        out = []
        for dev in ("cpu", cuda):
            cc = torch.zeros((1, t.highest_id, 100), dtype=torch.float64,
                             device=dev)
            cc = part.particles_to_grid(cc, t, 0, r, w, order=order)
            out.append((cc.cpu(), part.grid_to_particles(cc, t, 0, r).cpu()))
        torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-12,
                                   atol=0.0)
        torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-12,
                                   atol=0.0)


@pytest.mark.gpu
def test_restart_on_the_card_from_a_cpu_checkpoint(cuda, tmp_path):
    """A checkpoint written on the CPU after 5 steps, read onto the card,
    and 3 more steps there: the CPU's uninterrupted run, within 1e-9."""
    from afivo_streamer_tpu_torch.driver import Simulation
    base = [str(DATA / "air_cyl_amr_slice.cfg"), "-ndim=2",
            "-photoi%per_steps=2", "-output%dt=1e-13"]
    a = Simulation(argv=base + [f"-output%name={tmp_path}/a", "-device=cpu",
                                "-datfile%write=t"])
    a.run(max_steps=8)
    b = Simulation(argv=base + [
        f"-output%name={tmp_path}/b", "-device=cuda",
        f"-restart_from_file={tmp_path}/a_000002.dat.npz"])
    assert b.it == 5 and b.cc.device.type == "cuda"
    b.run(max_steps=8)
    assert [list(x) for x in b.tree.lvl_ids] == \
        [list(x) for x in a.tree.lvl_ids]
    n = a.tree.highest_id
    for iv, name in enumerate(a.registry.cc_names):
        if name == "tmp":
            continue
        ref = a.cc[iv, :n]
        torch.testing.assert_close(b.cc[iv, :n].cpu(), ref, rtol=1e-9,
                                   atol=1e-9 * float(ref.abs().max()))


@pytest.mark.gpu
def test_two_ranks_on_the_card_match_the_unsharded_run(cuda, tmp_path):
    """The cylindrical slice with live refinement and photoionization over
    two gloo ranks that share the card (-compiled%shards=2), 8 steps: the
    unsharded card run's meshes, dts and cycle counts, every variable
    within 1e-12 of its scale, and K1-K3 launched on each rank."""
    import numpy as np
    from afivo_streamer_tpu_torch.parallel import compiled
    from chip_smoke import record_run
    base = [str(DATA / "air_cyl_amr_slice.cfg"), "-ndim=2",
            "-photoi%per_steps=2", "-field_rise_time=3e-13",
            "-output%dt=1e-13", "-device=cuda"]
    u = record_run(base + [f"-output%name={tmp_path}/u"], 8)
    s = compiled.run_ranks(record_run, 2, (
        base + [f"-output%name={tmp_path}/s", "-compiled%enabled=T",
                "-compiled%shards=2"], 8))
    assert len(s["epochs"]) == len(u["epochs"])
    for a, b in zip(u["epochs"], s["epochs"]):
        assert [list(x) for x in a] == [list(x) for x in b]
    assert s["changes"] == u["changes"] and any(c[0] for c in u["changes"])
    assert s["dts"] == pytest.approx(u["dts"], rel=1e-12)
    assert s["solves"] == u["solves"] and s["photoi"] == u["photoi"]
    for key in ("cc", "fc"):
        for a, b in zip(u[key], s[key]):
            scale = max(float(np.abs(a).max()), 1e-300)
            np.testing.assert_allclose(b, a, rtol=0.0, atol=1e-12 * scale)
    for rank in s["ranks"]:
        for k in ("fill_sweep_2d", "sweep_2d", "fill_2d"):
            assert rank["launches"][k] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cfg, ndim", [("air_cyl_amr_slice.cfg", 2),
                                       ("air_3d_amr_slice.cfg", 3)],
                         ids=["cyl", "3d"])
def test_float32_state_on_the_card_matches_cpu(cfg, ndim, cuda, tmp_path):
    """-compiled%enabled=T -compiled%dtype=float32, refinement frozen, 2
    steps with a photoionization update: the card's float32 run against
    the CPU's, every variable but the scratch one within 1e-4 of its
    scale (rhs on the leaves: its other rows hold the FAS coarse-grid
    right-hand sides, whose float32 rounding follows phi / dx^2), the
    state float32, and every smoother launch float32 (K1-K3 in 2D, K4-K5
    in 3D)."""
    from afivo_streamer_tpu_torch.driver import Simulation
    base = [str(DATA / cfg), f"-ndim={ndim}", "-photoi%per_steps=2",
            "-refine_per_steps=1000000", "-compiled%enabled=T",
            "-compiled%dtype=float32"]
    sims = []
    for dev in ("cpu", "cuda"):
        sim = Simulation(argv=base + [f"-output%name={tmp_path}/{dev}",
                                      f"-device={dev}"])
        ks.reset_launch_counts()  # the setup runs in float64
        sim.run(max_steps=2)
        sims.append(sim)
    a, b = sims
    assert b.cc.dtype == b.fc.dtype == torch.float32
    names = (("fill_sweep_2d", "sweep_2d", "fill_2d") if ndim == 2
             else ("sweep_3d", "fill_3d"))
    for name, fn in ks.KERNELS.items():
        assert fn.launches_by_dtype[torch.float64] == 0, name
        assert (fn.launches_by_dtype[torch.float32] > 0) == (name in names)
    n = a.tree.highest_id
    leaves = torch.as_tensor(
        [int(i) for ids in a.tree.lvl_leaves for i in ids])
    for iv, name in enumerate(a.registry.cc_names):
        if name == "tmp":
            continue
        rows = leaves if name == "rhs" else slice(0, n)
        ref = a.cc[iv, rows].double()
        torch.testing.assert_close(b.cc[iv, rows].cpu().double(), ref,
                                   rtol=0.0,
                                   atol=1e-4 * float(ref.abs().max()))


@pytest.mark.gpu
def test_stochastic_density_cuda_matches_cpu(cuda, tmp_path):
    """The stochastic background (rng seed 3, 1e15 per m3) on the
    cylindrical slice with live refinement and photoionization every 2
    steps: the electron, ion and rhs rows right after the call within
    1e-12 of their scale on the card as on the CPU, no kernel launched by
    it; then 4 steps as test_photoi_slice_cuda_matches_cpu, K1-K3
    launched."""
    from afivo_streamer_tpu_torch.physics.init_cond import \
        stochastic_density
    after = []

    def prepare(sim):
        before = ks.KERNELS["fill_2d"].launches
        stochastic_density(sim, 3)
        assert ks.KERNELS["fill_2d"].launches == before
        after.append(sim.cc[[sim.i_electron, sim.i_1pos_ion, sim.i_rhs],
                            :sim.tree.highest_id].cpu())
    before = {k: fn.launches for k, fn in ks.KERNELS.items()}
    cycles = ([], [])
    slice_cuda_vs_cpu(tmp_path, "air_cyl_amr_slice.cfg", 2,
                      ["-photoi%per_steps=2", "-stochastic_density=1e15"],
                      steps=4, cycles=cycles, prepare=prepare)
    for ref, got in zip(after[0], after[1]):
        torch.testing.assert_close(got, ref, rtol=1e-12,
                                   atol=1e-12 * float(ref.abs().max()))
    assert 0.9e15 < float(after[1][2].max()) < 1e15
    assert len(cycles[0]) >= 3 and cycles[0] == cycles[1]
    for k in ("fill_sweep_2d", "sweep_2d", "fill_2d"):
        assert ks.KERNELS[k].launches > before[k], k
