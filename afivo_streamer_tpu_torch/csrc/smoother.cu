// Multigrid smoother kernels for Hopper (sm_90a): K1 fill + sweep, K2
// sweep, K3 fill (with or without its parity-swap terms), on the
// level-local block arrays of the 2D block V-cycle.
//
// Replaces the TPU Pallas kernels of afivo_streamer_tpu/ops/pallas_smoother.py:
//   K1 _fill_sweep_2d (pallas_call at :397)  -> mode 2, smoother_2d_kernel
//   K2 _sweep_2d      (pallas_call at :229)  -> mode 0, smoother_2d_kernel
//   K3 _fill_2d       (pallas_call at :302)  -> mode 1 (has_swap=False),
//                                               mode 3 (has_swap=True),
//                                               fill_2d_kernel
//
// Contract (shared with the plain PyTorch versions in ops/smoother.py):
//   phi3 [n, C, C] with C = nc + 2, one block per box of the level;
//   g    [n, 5] int32: own row, then the rows of the x-low, x-high, y-low,
//        y-high neighbors (a box's own row where it has none);
//   W    [n, 4, 8]: ghost weights (nb slab, f1, f2, f1 swapped, f2
//        swapped, unused...) per side; modes 1 and 2 read columns 0-2;
//   A    [n, 4, nc]: ghost constants (boundary values, coarse strips);
//   R    [n, nc, nc] rhs; cs [n, 6, nc, nc] stencil (c0, 4 neighbors, c_sum);
//   mask [nc, nc] float32, > 0 where the half sweep updates a cell.
// A side ghost is W0*nb_slab + W1*f1 + W2*f2 + A (corners kept); mode 3
// then adds W3*f1s + W4*f2s, where f1s, f2s are f1, f2 at the transverse
// pair partner t^1 (the extrapolating refinement-boundary ghost of a box
// with variable permittivity; nc is even). The red-black update is
// new = B0 + (R - L)/c0 with the difference-form
// L = c5*B0 + sum_d c_d*(B_d - B0). Output box b is the own block
// phi3[g[b, 0]] with its ghosts rebuilt and/or its half sweep done. The
// output is a new array: neighbor slabs are read from the input, and the
// V-cycle keeps a level's restricted blocks to subtract them from the
// corrected ones (mg_blocks.fas_vcycle_blocks), so no kernel works in
// place.
//
// What bounds these kernels on the H100: memory traffic. Per box the
// kernels move one C^2 block in and out and, for the sweeps, 6 nc^2
// stencil values in: cs, a broadcast of per-level coefficients, is the
// largest input (6*64 values against 100 of phi at nc = 8), then R and
// phi. The arithmetic is a dozen flops per cell.
//
// The sweeps (modes 0 and 2) are one thread per output cell of [n, C, C]:
// consecutive threads touch consecutive addresses of phi3, cs, R and out,
// so every load and store is coalesced, and the 5 rows of g, the
// neighbor slabs and the own block are re-read by the threads of one box
// from L1/L2 rather than from device memory. A thread next to a side
// recomputes the ghost value it needs (K1) instead of sharing it.
//
// The fill (modes 1 and 3) must move only 7 MB at n = 4096, nc = 8 in
// float64 (a 2.1 us bound; the function needs none of the input's side
// ghosts, which it overwrites, though the 16-byte copy below reads them
// with their rows), so whatever a design spends besides the bytes shows.
// A thread per cell spent a 64-bit division per thread, warps that mixed
// copy lanes with ghost lanes, a chain of dependent loads (g, then the
// neighbor) in each ghost lane, and 8-byte accesses. fill_2d_kernel is one
// warp per box and four boxes per block, so n = 4096 is one wave on 132
// SMs; the 4 nc = 32 ghosts at nc = 8 are one per lane. Each lane loads
// its ghost's W row and A value, and its share of the own block in
// 16-byte vectors into shared memory (50 per box in float64), while five
// lanes load the box's g row, which a shuffle hands to the warp. The own
// row is the box's index on every level the V-cycle builds, so the copy
// does not wait for g (it is redone where the row differs); only the
// neighbor's slab value does. After a warp barrier each lane reads f1 and
// f2 from shared memory and writes its ghost there, and the warp stores
// the block out in 16-byte vectors, contiguous and coalesced. No integer
// division but by compile-time constants: nc is a template parameter,
// instantiated at 8 (every config's box size); a second instance takes
// any even nc at run time (lanes loop over the 4 nc ghosts, the copy
// strides over the block). C is even, so each block is a whole number of
// 16-byte vectors and starts on a 16-byte boundary when phi3 does (the
// wrapper checks it). What is left between it and its bound is a fixed
// cost of a short launch (the first loads' latency, one wave's start and
// drain) more than the bytes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kModeSweep = 0;
constexpr int kModeFill = 1;
constexpr int kModeFillSweep = 2;
constexpr int kModeFillSwap = 3;
constexpr unsigned kFullWarp = 0xffffffffu;

// Side ghost d (0 x-low, 1 x-high, 2 y-low, 3 y-high) at transverse cell
// t (0-based) of box b, from the own block B and the neighbor block (K1).
template <typename T>
__device__ __forceinline__ T ghost_value(const T* __restrict__ phi3,
                                         const T* __restrict__ B,
                                         const int* __restrict__ g,
                                         const T* __restrict__ W,
                                         const T* __restrict__ A, long long b,
                                         int d, int t, int nc) {
  const int C = nc + 2;
  const T* nb = phi3 + (long long)g[b * 5 + 1 + d] * C * C;
  const T* w = W + (b * 4 + d) * 8;
  const int j = t + 1;
  // the own-block layers next to side d: f1 at row/column r1, f2 at r2
  const int r1 = (d == 0 || d == 2) ? 1 : nc;
  const int r2 = (d == 0 || d == 2) ? 2 : nc - 1;
  const int nbr = (d == 0 || d == 2) ? nc : 1;
  const bool along_x = d < 2;  // sides 0, 1 are rows of the block
  auto at = [&](const T* X, int layer, int jj) {
    return along_x ? X[layer * C + jj] : X[jj * C + layer];
  };
  return w[0] * at(nb, nbr, j) + w[1] * at(B, r1, j) + w[2] * at(B, r2, j) +
         A[(b * 4 + d) * nc + t];
}

// Value of cell (r, c) of box b's block, after the side-ghost fill when
// FILL is set (corners and interior are the own block's).
template <typename T, bool FILL>
__device__ __forceinline__ T cell_value(const T* __restrict__ phi3,
                                        const T* __restrict__ B,
                                        const int* __restrict__ g,
                                        const T* __restrict__ W,
                                        const T* __restrict__ A, long long b,
                                        int r, int c, int nc) {
  if (FILL) {
    const bool r_in = r >= 1 && r <= nc;
    const bool c_in = c >= 1 && c <= nc;
    if (c_in && r == 0)
      return ghost_value<T>(phi3, B, g, W, A, b, 0, c - 1, nc);
    if (c_in && r == nc + 1)
      return ghost_value<T>(phi3, B, g, W, A, b, 1, c - 1, nc);
    if (r_in && c == 0)
      return ghost_value<T>(phi3, B, g, W, A, b, 2, r - 1, nc);
    if (r_in && c == nc + 1)
      return ghost_value<T>(phi3, B, g, W, A, b, 3, r - 1, nc);
  }
  return B[r * (nc + 2) + c];
}

// K2 (MODE 0) and K1 (MODE 2): one thread per output cell.
template <typename T, int MODE>
__global__ void smoother_2d_kernel(const T* __restrict__ phi3,
                                   const T* __restrict__ R,
                                   const float* __restrict__ mask,
                                   const T* __restrict__ A,
                                   const int* __restrict__ g,
                                   const T* __restrict__ W,
                                   const T* __restrict__ cs,
                                   T* __restrict__ out, int n, int nc) {
  constexpr bool FILL = MODE == kModeFillSweep;
  const int C = nc + 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * C * C) return;
  const long long b = idx / (C * C);
  const int rem = (int)(idx - b * C * C);
  const int r = rem / C;
  const int c = rem - r * C;
  const T* B = phi3 + (long long)g[b * 5] * C * C;

  const bool interior = r >= 1 && r <= nc && c >= 1 && c <= nc;
  if (!interior) {
    out[idx] = cell_value<T, FILL>(phi3, B, g, W, A, b, r, c, nc);
    return;
  }
  const T B0 = B[r * C + c];
  const int k = (r - 1) * nc + (c - 1);
  if (!(mask[k] > 0.0f)) {
    out[idx] = B0;
    return;
  }
  const int s = nc * nc;
  const T* cb = cs + b * 6 * s;
  const T up = cell_value<T, FILL>(phi3, B, g, W, A, b, r - 1, c, nc);
  const T dn = cell_value<T, FILL>(phi3, B, g, W, A, b, r + 1, c, nc);
  const T lf = cell_value<T, FILL>(phi3, B, g, W, A, b, r, c - 1, nc);
  const T rt = cell_value<T, FILL>(phi3, B, g, W, A, b, r, c + 1, nc);
  const T lphi = cb[5 * s + k] * B0 + cb[1 * s + k] * (up - B0) +
                 cb[2 * s + k] * (dn - B0) + cb[3 * s + k] * (lf - B0) +
                 cb[4 * s + k] * (rt - B0);
  out[idx] = B0 + (R[b * s + k] - lphi) / cb[k];
}

// 16 bytes of T: the unit of the fill's block copy.
template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
};
template <>
struct Vec16<float> {
  using type = float4;
};

// What one side ghost reads besides the own block.
template <typename T>
struct GhostIn {
  T slab, w0, w1, w2, w3, w4, a;
};

// Ghost k of a box: side d = k / nc (0 x-low, 1 x-high, 2 y-low, 3
// y-high), transverse cell t = k % nc; no run-time division.
template <int NC>
__device__ __forceinline__ void side_of(int k, int nc, int& d, int& t) {
  if constexpr (NC > 0) {
    d = k / NC;
    t = k - d * NC;
  } else {
    d = 0;
    t = k;
    while (t >= nc) {
      t -= nc;
      ++d;
    }
  }
}

// The side's weights and the ghost constant of ghost (d, t) of box b;
// they do not depend on g, so they load while g does.
template <typename T, bool SWAP>
__device__ __forceinline__ void load_side(GhostIn<T>& in,
                                          const T* __restrict__ A,
                                          const T* __restrict__ W,
                                          long long b, int d, int t, int nc) {
  const T* w = W + (b * 4 + d) * 8;
  in.w0 = w[0];
  in.w1 = w[1];
  in.w2 = w[2];
  if (SWAP) {
    in.w3 = w[3];
    in.w4 = w[4];
  }
  in.a = A[(b * 4 + d) * nc + t];
}

// The slab value next to side d of ghost (d, t) in the neighbor block
// nrow of phi3.
template <typename T>
__device__ __forceinline__ T load_slab(const T* __restrict__ phi3,
                                       long long nrow, int d, int t, int nc) {
  const int C = nc + 2;
  const T* nb = phi3 + nrow * C * C;
  const int j = t + 1;
  const int layer = (d == 0 || d == 2) ? nc : 1;
  return d < 2 ? nb[layer * C + j] : nb[j * C + layer];
}

// Ghost (d, t) into the staged block s: the sum of K3 from the own-block
// layers f1, f2 next to side d, then with SWAP the parity-swap terms of
// the pair partner t^1, in the operation order of the TPU kernel. Ghosts
// have a coordinate 0 or nc + 1 and the layers none, so the lanes of a
// warp never write what another lane reads.
template <typename T, bool SWAP>
__device__ __forceinline__ void put_ghost(T* s, const GhostIn<T>& in, int d,
                                          int t, int nc) {
  const int C = nc + 2;
  const int j = t + 1;
  const int r1 = (d == 0 || d == 2) ? 1 : nc;
  const int r2 = (d == 0 || d == 2) ? 2 : nc - 1;
  const int gr = (d == 0 || d == 2) ? 0 : nc + 1;
  const bool along_x = d < 2;  // sides 0, 1 are rows of the block
  auto at = [&](int layer, int jj) -> T& {
    return along_x ? s[layer * C + jj] : s[jj * C + layer];
  };
  T ghost = in.w0 * in.slab + in.w1 * at(r1, j) + in.w2 * at(r2, j) + in.a;
  if (SWAP) {
    const int js = (t ^ 1) + 1;
    ghost = ghost + in.w3 * at(r1, js) + in.w4 * at(r2, js);
  }
  at(gr, j) = ghost;
}

// The lane's share of a block of nv 16-byte vectors, from src to dst.
template <typename V>
__device__ __forceinline__ void copy_block(V* dst, const V* __restrict__ src,
                                           int lane, int nv) {
#pragma unroll 4
  for (int i = lane; i < nv; i += 32) dst[i] = src[i];
}

constexpr int kFillWarps = 4;
constexpr size_t kMaxFillSmem = 48 * 1024;

// K3 (SWAP false) and K3-swap (SWAP true): one warp per box, a few boxes
// per block; NC > 0 is a compile-time nc, NC == 0 takes nc_rt.
template <typename T, int NC, bool SWAP>
__global__ void __launch_bounds__(kFillWarps * 32)
    fill_2d_kernel(const T* __restrict__ phi3, const T* __restrict__ A,
                   const int* __restrict__ g, const T* __restrict__ W,
                   T* __restrict__ out, int n, int nc_rt) {
  using V = typename Vec16<T>::type;
  constexpr int kPerVec = (int)(sizeof(V) / sizeof(T));
  const int nc = NC > 0 ? NC : nc_rt;
  const int CC = (nc + 2) * (nc + 2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n) return;  // b is the same for the whole warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem) + warp * CC;

  // this lane's first ghost: its weights and constant load with g
  int d, t;
  side_of<NC>(lane, nc, d, t);
  const bool has_ghost = lane < 4 * nc;
  GhostIn<T> in{};
  if (has_ghost) load_side<T, SWAP>(in, A, W, b, d, t, nc);

  // the box's g row (own, x-low, x-high, y-low, y-high), shared by shuffles
  const int gv = lane < 5 ? g[b * 5 + lane] : 0;
  // the own block into shared memory, 16 bytes per access. Every level the
  // V-cycle builds has own row b (ops/smoother.SmootherTables), so the
  // copy of block b goes out with the load of g and is redone only for a
  // box whose own row is another
  V* sv = reinterpret_cast<V*>(s);
  const int nv = CC / kPerVec;
  copy_block(sv, reinterpret_cast<const V*>(phi3 + b * CC), lane, nv);
  const long long own = __shfl_sync(kFullWarp, gv, 0);
  const int g1 = __shfl_sync(kFullWarp, gv, 1);
  const int g2 = __shfl_sync(kFullWarp, gv, 2);
  const int g3 = __shfl_sync(kFullWarp, gv, 3);
  const int g4 = __shfl_sync(kFullWarp, gv, 4);
  auto nb_row = [&](int d) -> long long {
    return d == 0 ? g1 : d == 1 ? g2 : d == 2 ? g3 : g4;
  };

  if (own != b)  // the same for the whole warp
    copy_block(sv, reinterpret_cast<const V*>(phi3 + own * CC), lane, nv);
  if (has_ghost) in.slab = load_slab(phi3, nb_row(d), d, t, nc);
  __syncwarp();

  if (has_ghost) put_ghost<T, SWAP>(s, in, d, t, nc);
  // ghosts beyond the warp's 32 lanes (nc > 8, the run-time instance)
  for (int k = lane + 32; k < 4 * nc; k += 32) {
    side_of<NC>(k, nc, d, t);
    GhostIn<T> more{};
    load_side<T, SWAP>(more, A, W, b, d, t, nc);
    more.slab = load_slab(phi3, nb_row(d), d, t, nc);
    put_ghost<T, SWAP>(s, more, d, t, nc);
  }
  __syncwarp();

  V* dst = reinterpret_cast<V*>(out + b * CC);
#pragma unroll 4
  for (int i = lane; i < nv; i += 32) dst[i] = sv[i];
}

// Launch K3 or K3-swap: nc even (a block is then a whole number of 16-byte
// vectors), phi3 and out on 16-byte boundaries, one block of a box within
// 48 KB of shared memory (nc <= 76 in float64).
template <typename T, bool SWAP>
int launch_fill(const T* phi3, const T* A, const int* g, const T* W, T* out,
                int n, int nc, cudaStream_t stream) {
  const size_t box_bytes = (size_t)(nc + 2) * (nc + 2) * sizeof(T);
  if (nc < 2 || nc % 2 != 0 || box_bytes > kMaxFillSmem)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(phi3) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int warps = kMaxFillSmem / box_bytes < (size_t)kFillWarps
                        ? (int)(kMaxFillSmem / box_bytes)
                        : kFillWarps;
  const unsigned blocks = (unsigned)((n + warps - 1) / warps);
  const size_t smem = warps * box_bytes;
  if (nc == 8) {
    fill_2d_kernel<T, 8, SWAP>
        <<<blocks, warps * 32, smem, stream>>>(phi3, A, g, W, out, n, nc);
  } else {
    fill_2d_kernel<T, 0, SWAP>
        <<<blocks, warps * 32, smem, stream>>>(phi3, A, g, W, out, n, nc);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int mode, const void* phi3, const void* R, const void* mask,
           const void* A, const void* g, const void* W, const void* cs,
           void* out, int n, int nc, cudaStream_t stream) {
  const long long total = (long long)n * (nc + 2) * (nc + 2);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const T* p = static_cast<const T*>(phi3);
  const T* r = static_cast<const T*>(R);
  const float* m = static_cast<const float*>(mask);
  const T* a = static_cast<const T*>(A);
  const int* gi = static_cast<const int*>(g);
  const T* w = static_cast<const T*>(W);
  const T* c = static_cast<const T*>(cs);
  T* o = static_cast<T*>(out);
  if (mode == kModeSweep) {
    smoother_2d_kernel<T, kModeSweep>
        <<<blocks, threads, 0, stream>>>(p, r, m, a, gi, w, c, o, n, nc);
  } else if (mode == kModeFillSweep) {
    smoother_2d_kernel<T, kModeFillSweep>
        <<<blocks, threads, 0, stream>>>(p, r, m, a, gi, w, c, o, n, nc);
  } else if (mode == kModeFill) {
    return launch_fill<T, false>(p, a, gi, w, o, n, nc, stream);
  } else if (mode == kModeFillSwap) {
    return launch_fill<T, true>(p, a, gi, w, o, n, nc, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 sweep (K2), 1 fill (K3), 2 fill + sweep (K1), 3 fill with the
// parity-swap terms (K3-swap); dbl: 1 for double,
// 0 for float. Pointers a mode does not read may be null. Returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int afs_smoother_2d(int mode, int dbl, const void* phi3,
                               const void* R, const void* mask, const void* A,
                               const void* g, const void* W, const void* cs,
                               void* out, int n, int nc, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dbl) return launch<double>(mode, phi3, R, mask, A, g, W, cs, out, n, nc, s);
  return launch<float>(mode, phi3, R, mask, A, g, W, cs, out, n, nc, s);
}
