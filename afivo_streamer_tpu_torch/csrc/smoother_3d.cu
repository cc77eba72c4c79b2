// Multigrid smoother kernels for Hopper (sm_90a): K4 sweep and K5 fill, on
// the level-local block arrays of the 3D block V-cycle.
//
// Replaces the TPU Pallas kernels of afivo_streamer_tpu/ops/pallas_smoother.py:
//   K4 _sweep_3d (def :549, pallas_call :574) -> mode 0
//   K5 _fill_3d  (def :597, pallas_call :637) -> mode 1
// There is no fused fill + sweep in 3D (the TPU package has none either):
// a 3D half sweep is K4 then K5.
//
// Contract (shared with the plain PyTorch versions in ops/smoother.py):
//   phi3 [n, C, C, C] with C = nc + 2, one block per box of the level;
//   g    [n, 7] int32: own row, then the rows of the x-low, x-high, y-low,
//        y-high, z-low, z-high neighbors (a box's own row where it has
//        none); K4 reads only the own row;
//   W    [n, 6, 8]: ghost weights (nb slab, f1, f2, unused...) per face;
//   A    [n, 6, nc, nc]: ghost constants (boundary values, coarse strips),
//        each face over its two other axes in their natural order;
//   R    [n, nc, nc, nc] rhs; cs [n, 8, nc, nc, nc] stencil (c0, the six
//        neighbors in face order, c_sum);
//   mask [nc, nc, nc] float32, > 0 where the half sweep updates a cell.
// Face d = 2 * axis + high. A face ghost is W0*nb_slab + W1*f1 + W2*f2 + A,
// with the neighbor's slab at row nc (low face) or 1 (high face) along the
// axis; edges, corners and the interior are the own block's. The
// red-black update is new = B0 + (R - L)/c0 with the difference-form
// L = c7*B0 + sum_d c_d*(B_d - B0). The output is a new array: neighbor
// slabs are read from the input, so the kernels never update in place.
//
// What bounds these kernels on the H100: memory traffic. K4 reads
// 8 nc^3 = 4096 stencil values per box against C^3 = 1000 of phi, so at
// n = 4096 boxes in float64 it moves ~134 MB of cs, 33 MB of phi in,
// 17 MB of R and 33 MB out (~0.22 GB, more than the 50 MB L2). K5 reads
// the own block and six neighbor faces and writes one block per box
// (~70 MB). The arithmetic is a dozen flops per cell. This first design is
// one thread per output cell of [n, C, C, C]: consecutive threads touch
// consecutive addresses of phi3, cs, R and out, so those loads and stores
// are coalesced; the rows of g, the neighbor faces and the own block are
// re-read by the threads of one box from L1/L2. Offsets are 64-bit: n*C^3
// and n*8*nc^3 pass 2^31 at 256^3 cells. Cutting the cs traffic
// (recomputing the stencil from the per-level coefficients) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kModeSweep = 0;
constexpr int kModeFill = 1;

template <typename T>
__global__ void sweep_3d_kernel(const T* __restrict__ phi3,
                                const T* __restrict__ R,
                                const float* __restrict__ mask,
                                const int* __restrict__ g,
                                const T* __restrict__ cs,
                                T* __restrict__ out, int n, int nc) {
  const int C = nc + 2;
  const long long C3 = (long long)C * C * C;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * C3) return;
  const long long b = idx / C3;
  const int rem = (int)(idx - b * C3);
  const int x = rem / (C * C);
  const int y = (rem / C) % C;
  const int z = rem % C;
  const T* B = phi3 + (long long)g[b * 7] * C3;
  const T B0 = B[rem];
  const bool interior = x >= 1 && x <= nc && y >= 1 && y <= nc && z >= 1 &&
                        z <= nc;
  if (!interior) {
    out[idx] = B0;
    return;
  }
  const int k = ((x - 1) * nc + (y - 1)) * nc + (z - 1);
  if (!(mask[k] > 0.0f)) {
    out[idx] = B0;
    return;
  }
  const long long s = (long long)nc * nc * nc;
  const T* cb = cs + b * 8 * s + k;
  const int sx = C * C;
  const int sy = C;
  const T lphi = cb[7 * s] * B0 + cb[1 * s] * (B[rem - sx] - B0) +
                 cb[2 * s] * (B[rem + sx] - B0) +
                 cb[3 * s] * (B[rem - sy] - B0) +
                 cb[4 * s] * (B[rem + sy] - B0) +
                 cb[5 * s] * (B[rem - 1] - B0) + cb[6 * s] * (B[rem + 1] - B0);
  out[idx] = B0 + (R[b * s + k] - lphi) / cb[0];
}

template <typename T>
__global__ void fill_3d_kernel(const T* __restrict__ phi3,
                               const T* __restrict__ A,
                               const int* __restrict__ g,
                               const T* __restrict__ W,
                               T* __restrict__ out, int n, int nc) {
  const int C = nc + 2;
  const long long C3 = (long long)C * C * C;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * C3) return;
  const long long b = idx / C3;
  const int rem = (int)(idx - b * C3);
  const int x = rem / (C * C);
  const int y = (rem / C) % C;
  const int z = rem % C;
  const T* B = phi3 + (long long)g[b * 7] * C3;
  const bool xg = x == 0 || x == nc + 1;
  const bool yg = y == 0 || y == nc + 1;
  const bool zg = z == 0 || z == nc + 1;
  if ((int)xg + (int)yg + (int)zg != 1) {  // interior, edge or corner
    out[idx] = B[rem];
    return;
  }
  // the face's axis, the cell's coordinate along it, the stride of that
  // axis and the two transverse coordinates in their natural order
  int axis, normal, stride, t0, t1;
  if (xg) {
    axis = 0, normal = x, stride = C * C, t0 = y, t1 = z;
  } else if (yg) {
    axis = 1, normal = y, stride = C, t0 = x, t1 = z;
  } else {
    axis = 2, normal = z, stride = 1, t0 = x, t1 = y;
  }
  const bool low = normal == 0;
  const int d = 2 * axis + (low ? 0 : 1);
  const int base = rem - normal * stride;  // the same cell at row 0
  const int nb_row = low ? nc : 1;
  const int f1_row = low ? 1 : nc;
  const int f2_row = low ? 2 : nc - 1;
  const T* nb = phi3 + (long long)g[b * 7 + 1 + d] * C3;
  const T* w = W + (b * 6 + d) * 8;
  out[idx] = w[0] * nb[base + nb_row * stride] +
             w[1] * B[base + f1_row * stride] +
             w[2] * B[base + f2_row * stride] +
             A[(b * 6 + d) * nc * nc + (t0 - 1) * nc + (t1 - 1)];
}

template <typename T>
int launch(int mode, const void* phi3, const void* R, const void* mask,
           const void* A, const void* g, const void* W, const void* cs,
           void* out, int n, int nc, cudaStream_t stream) {
  const long long total = (long long)n * (nc + 2) * (nc + 2) * (nc + 2);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const T* p = static_cast<const T*>(phi3);
  const int* gi = static_cast<const int*>(g);
  T* o = static_cast<T*>(out);
  if (mode == kModeSweep) {
    sweep_3d_kernel<T><<<blocks, threads, 0, stream>>>(
        p, static_cast<const T*>(R), static_cast<const float*>(mask), gi,
        static_cast<const T*>(cs), o, n, nc);
  } else if (mode == kModeFill) {
    fill_3d_kernel<T><<<blocks, threads, 0, stream>>>(
        p, static_cast<const T*>(A), gi, static_cast<const T*>(W), o, n, nc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 sweep (K4), 1 fill (K5); dbl: 1 for double, 0 for float.
// Pointers a mode does not read may be null. Returns the cudaGetLastError()
// of the launch (0 on success).
extern "C" int afs_smoother_3d(int mode, int dbl, const void* phi3,
                               const void* R, const void* mask, const void* A,
                               const void* g, const void* W, const void* cs,
                               void* out, int n, int nc, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dbl) return launch<double>(mode, phi3, R, mask, A, g, W, cs, out, n, nc, s);
  return launch<float>(mode, phi3, R, mask, A, g, W, cs, out, n, nc, s);
}
