// Multigrid smoother kernels for Hopper (sm_90a): K1 fill + sweep, K2
// sweep, K3 fill (with or without its parity-swap terms), on the
// level-local block arrays of the 2D block V-cycle.
//
// Replaces the TPU Pallas kernels of afivo_streamer_tpu/ops/pallas_smoother.py:
//   K1 _fill_sweep_2d (pallas_call at :397)  -> mode 2
//   K2 _sweep_2d      (pallas_call at :229)  -> mode 0
//   K3 _fill_2d       (pallas_call at :302)  -> mode 1 (has_swap=False)
//                                                 mode 3 (has_swap=True)
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
// L = c5*B0 + sum_d c_d*(B_d - B0). The output is a new array: neighbor
// slabs are read from the input, so the kernels never update in place.
//
// What bounds these kernels on the H100: memory traffic. Per box the
// kernels move one C^2 block out and, for the sweeps, 6 nc^2 stencil
// values in: cs, a broadcast of per-level coefficients, is the largest
// input (6*64 values against 100 of phi at nc = 8), then R and phi. The
// arithmetic is a dozen flops per cell. This first design is one thread per
// output cell of [n, C, C]: consecutive threads touch consecutive addresses
// of phi3, cs, R and out, so every load and store is coalesced, and the
// 5 rows of g, the neighbor slabs and the own block are re-read by the
// threads of one box from L1/L2 rather than from device memory. A thread
// next to a side recomputes the ghost value it needs (K1) instead of
// sharing it through shared memory. Cutting the cs traffic (recomputing
// the stencil from c0 and the four neighbor coefficients), shared-memory
// tiles and graph capture of the smoothing loop are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kModeSweep = 0;
constexpr int kModeFill = 1;
constexpr int kModeFillSweep = 2;
constexpr int kModeFillSwap = 3;

// Side ghost d (0 x-low, 1 x-high, 2 y-low, 3 y-high) at transverse cell
// t (0-based) of box b, from the own block B and the neighbor block; with
// SWAP the parity-swap terms of the pair partner t^1 are added last, in
// the operation order of the TPU kernel.
template <typename T, bool SWAP>
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
  T ghost = w[0] * at(nb, nbr, j) + w[1] * at(B, r1, j) + w[2] * at(B, r2, j) +
            A[(b * 4 + d) * nc + t];
  if (SWAP) {
    const int js = (t ^ 1) + 1;
    ghost = ghost + w[3] * at(B, r1, js) + w[4] * at(B, r2, js);
  }
  return ghost;
}

// Value of cell (r, c) of box b's block, after the side-ghost fill when
// FILL is set (corners and interior are the own block's).
template <typename T, bool FILL, bool SWAP>
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
      return ghost_value<T, SWAP>(phi3, B, g, W, A, b, 0, c - 1, nc);
    if (c_in && r == nc + 1)
      return ghost_value<T, SWAP>(phi3, B, g, W, A, b, 1, c - 1, nc);
    if (r_in && c == 0)
      return ghost_value<T, SWAP>(phi3, B, g, W, A, b, 2, r - 1, nc);
    if (r_in && c == nc + 1)
      return ghost_value<T, SWAP>(phi3, B, g, W, A, b, 3, r - 1, nc);
  }
  return B[r * (nc + 2) + c];
}

template <typename T, int MODE>
__global__ void smoother_2d_kernel(const T* __restrict__ phi3,
                                   const T* __restrict__ R,
                                   const float* __restrict__ mask,
                                   const T* __restrict__ A,
                                   const int* __restrict__ g,
                                   const T* __restrict__ W,
                                   const T* __restrict__ cs,
                                   T* __restrict__ out, int n, int nc) {
  constexpr bool FILL = MODE != kModeSweep;
  constexpr bool SWAP = MODE == kModeFillSwap;
  const int C = nc + 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * C * C) return;
  const long long b = idx / (C * C);
  const int rem = (int)(idx - b * C * C);
  const int r = rem / C;
  const int c = rem - r * C;
  const T* B = phi3 + (long long)g[b * 5] * C * C;

  const bool interior = r >= 1 && r <= nc && c >= 1 && c <= nc;
  if (MODE == kModeFill || MODE == kModeFillSwap || !interior) {
    out[idx] = cell_value<T, FILL, SWAP>(phi3, B, g, W, A, b, r, c, nc);
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
  const T up = cell_value<T, FILL, false>(phi3, B, g, W, A, b, r - 1, c, nc);
  const T dn = cell_value<T, FILL, false>(phi3, B, g, W, A, b, r + 1, c, nc);
  const T lf = cell_value<T, FILL, false>(phi3, B, g, W, A, b, r, c - 1, nc);
  const T rt = cell_value<T, FILL, false>(phi3, B, g, W, A, b, r, c + 1, nc);
  const T lphi = cb[5 * s + k] * B0 + cb[1 * s + k] * (up - B0) +
                 cb[2 * s + k] * (dn - B0) + cb[3 * s + k] * (lf - B0) +
                 cb[4 * s + k] * (rt - B0);
  out[idx] = B0 + (R[b * s + k] - lphi) / cb[k];
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
  } else if (mode == kModeFill) {
    smoother_2d_kernel<T, kModeFill>
        <<<blocks, threads, 0, stream>>>(p, r, m, a, gi, w, c, o, n, nc);
  } else if (mode == kModeFillSweep) {
    smoother_2d_kernel<T, kModeFillSweep>
        <<<blocks, threads, 0, stream>>>(p, r, m, a, gi, w, c, o, n, nc);
  } else if (mode == kModeFillSwap) {
    if (nc % 2 != 0) return (int)cudaErrorInvalidValue;
    smoother_2d_kernel<T, kModeFillSwap>
        <<<blocks, threads, 0, stream>>>(p, r, m, a, gi, w, c, o, n, nc);
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
