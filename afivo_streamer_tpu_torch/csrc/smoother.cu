// Multigrid smoother kernels for Hopper (sm_90a): K1 fill + sweep, K2
// sweep, K3 fill (with or without its parity-swap terms), on the
// level-local block arrays of the 2D block V-cycle.
//
// Replaces the TPU Pallas kernels of afivo_streamer_tpu/ops/pallas_smoother.py:
//   K1 _fill_sweep_2d (pallas_call at :397)  -> mode 2, fill_sweep_2d_kernel
//   K2 _sweep_2d      (pallas_call at :229)  -> mode 0, sweep_2d_kernel
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
// K2 moves 21.3 MB at n = 4096, nc = 8 in float64 (a 6.3 us bound), 3/4
// of it R and cs, and half of that in float32. One thread per output cell
// paid a 64-bit division by a run-time C^2 and a dependent chain (g, then
// the block value) in every thread, kept 36 of 100 threads copying a ghost
// and half the interior ones copying too, and read cs and R in scalars; in
// float32 it issued as much per cell for half the bytes (0.69 of the bound
// in float64, 0.47-0.49 in float32). sweep_2d_kernel stages a run of k
// consecutive boxes per block: the run's blocks (own row b on every level
// the V-cycle builds), R and cs are three contiguous ranges, so one thread
// starts three bulk copies (TMA) on one mbarrier that expects their sum,
// before any g is read; a box whose own row is another is copied again by
// its threads after the wait. Each thread takes two adjacent interior
// cells of a row (nc^2 / 2 threads per box, one warp at nc = 8), reads
// its mask pair and the box's own row while the copies fly, computes both
// new values from the staged blocks into registers before a block barrier
// and writes them back; the run's blocks, contiguous in out, go out in
// 16-byte vectors. k = ceil(n / 528), so n = 4096 is one wave of four
// blocks per SM (k = 8; 712 boxes: k = 2). Measured against one variant
// at a time (chip_smoke.measure, cold L2, on one H100): one bulk copy
// out instead of the vector stores ran 5 % slower at n = 4096 in float64
// and 3 % in float32; four cells per thread in float32 ran as fast at n =
// 4096 and 4 % slower at 712 boxes; a fixed k of 1, 2, 4 or 16 ran within
// 5 % of k = 8 at n = 4096 (k = 16 10-16 % slower at 712 boxes). A
// persistent block that fetches its next run while it computes is not
// built: at n = 4096 every run is in flight at once already. What is left
// between K2 and its bound is the ~1.8 us that any short launch here
// costs besides its bytes (K3 pays the same).
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
// the block out in 16-byte vectors, contiguous and coalesced. What is
// left between it and its bound is a fixed cost of a short launch (the
// first loads' latency, one wave's start and drain) more than the bytes.
//
// K1 moves 21.7 MB at n = 4096, nc = 8 in float64 (a 6.5 us bound), 3/4
// of it R and cs. One thread per cell made every interior thread next to
// a side rebuild the ghosts it read, each with its own g -> neighbor chain
// and its own W and A loads, read cs in 8-byte scalars, and paid a 64-bit
// division per thread: 0.45 of the bound. fill_sweep_2d_kernel is the
// fill above (one warp per box, the block staged in shared memory, one
// ghost per lane) followed by the sweep on the staged block: each lane
// owns two adjacent interior cells of a row (nc is even), so R and each
// of the six cs planes come in one 8-byte-per-cell vector per lane, a
// whole plane per warp in one coalesced access (512 bytes at nc = 8 in
// float64), and the mask, the same for every box, from L1. The sweep's
// inputs do not depend on g, so with nc compiled in they load with the
// fill's, before the neighbor slabs. Every lane computes its updated
// cells from the filled block into a scratch row of shared memory before
// any lane writes one back (the mask is an input, not assumed a
// checkerboard), and the block goes out in 16-byte vectors. Both
// warp-per-box kernels divide by compile-time constants only: nc is a
// template parameter, instantiated at 8 (every config's box size); a
// second instance takes any even nc at run time (lanes loop over the
// ghosts, the cell pairs and the block). C is even, so each block is a
// whole number of 16-byte vectors and starts on a 16-byte boundary when
// phi3 does; the wrapper checks phi3 (and for K1 and K2 R, cs and mask)
// for it.
// What is left between K1 and its bound is the fill's fixed cost per
// launch and the sectors it touches but does not need (the side ghosts
// copied with the block, and a 32-byte sector per value of a y-side
// slab, which is a column of the neighbor block).
//
// Box sizes. A block may take 48 KB of dynamic shared memory as it is, and
// up to the device's opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin,
// 232,448 bytes on the H100) once its kernel instance is opted in
// (allow_smem: one cudaFuncSetAttribute per instance and device, the first
// time a launch needs more than 48 KB). Where a box's staging fits 48 KB
// (in float64 K2 to nc = 26, K1 to 54, K3 to 76; nc = 8 among them) the
// launches are those above, unchanged. Above that: K1 and K3 stage one box
// per block (one warp) past 48 KB; K2 takes sweep_2d_big_kernel, which
// stages the box's block alone (at n = 4096 in float64 it reads 0.88-0.89
// of its bound at nc = 34 and 64, where sweep_2d_kernel opted in to stage
// a box of nc = 28-32 read 0.79-0.80; kernel_ab.py, one H100). The largest nc
// on the H100: K1 118 (float64) and 168 (float32), K2, K3 and K3-swap 168
// and 238; a larger nc returns cudaErrorInvalidValue, which the wrapper
// raises.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kModeSweep = 0;
constexpr int kModeFill = 1;
constexpr int kModeFillSweep = 2;
constexpr int kModeFillSwap = 3;
constexpr unsigned kFullWarp = 0xffffffffu;

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

// Quotient and remainder of k by nc (NC > 0 a compile-time nc); no
// run-time division. Ghost k of a box is on side q (0 x-low, 1 x-high, 2
// y-low, 3 y-high) at transverse cell r; interior cell k of a block at row
// q, column r.
template <int NC>
__device__ __forceinline__ void div_nc(int k, int nc, int& q, int& r) {
  if constexpr (NC > 0) {
    q = k / NC;
    r = k - q * NC;
  } else {
    q = 0;
    r = k;
    while (r >= nc) {
      r -= nc;
      ++q;
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

// The own block of box b staged in s with its side ghosts rebuilt (K3, or
// K3-swap with SWAP) by one warp, one ghost per lane at nc = 8; NC > 0 is
// a compile-time nc. Ends with a warp barrier.
template <typename T, int NC, bool SWAP>
__device__ __forceinline__ void stage_filled_block(
    T* s, const T* __restrict__ phi3, const T* __restrict__ A,
    const int* __restrict__ g, const T* __restrict__ W, long long b,
    int lane, int nc) {
  using V = typename Vec16<T>::type;
  constexpr int kPerVec = (int)(sizeof(V) / sizeof(T));
  const int CC = (nc + 2) * (nc + 2);

  // this lane's first ghost: its weights and constant load with g
  int d, t;
  div_nc<NC>(lane, nc, d, t);
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
    div_nc<NC>(k, nc, d, t);
    GhostIn<T> more{};
    load_side<T, SWAP>(more, A, W, b, d, t, nc);
    more.slab = load_slab(phi3, nb_row(d), d, t, nc);
    put_ghost<T, SWAP>(s, more, d, t, nc);
  }
  __syncwarp();
}

// The warp's block s to out, 16 bytes per access.
template <typename T>
__device__ __forceinline__ void store_block(T* __restrict__ out, const T* s,
                                            int lane, int CC) {
  using V = typename Vec16<T>::type;
  const V* sv = reinterpret_cast<const V*>(s);
  V* dst = reinterpret_cast<V*>(out);
  const int nv = CC / (int)(sizeof(V) / sizeof(T));
#pragma unroll 4
  for (int i = lane; i < nv; i += 32) dst[i] = sv[i];
}

constexpr int kFillWarps = 4;
// the dynamic shared memory a block takes without opting in
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

// The dynamic shared memory a block of the current device may take once
// its kernel is opted in (232,448 bytes on the H100), read once per device.
inline size_t smem_optin() {
  static std::atomic<int> limit[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return kDefaultSmem;
  int v = limit[dev].load();
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        v <= 0)
      v = (int)kDefaultSmem;
    limit[dev].store(v);
  }
  return (size_t)v;
}

// Let `kernel` take `bytes` of dynamic shared memory beside its static
// shared memory (at most `static_bytes`): nothing to do within 48 KB;
// above, one cudaFuncSetAttribute per kernel instance and device, to the
// whole opt-in limit less the kernel's static shared memory as the
// compiler laid it out, so that no later launch pays for it.
// cudaErrorInvalidValue where the limit is too small.
inline int allow_smem(const void* kernel, size_t bytes, size_t static_bytes) {
  if (bytes + static_bytes <= kDefaultSmem) return 0;
  const size_t limit = smem_optin();
  int dev = 0;
  cudaGetDevice(&dev);
  struct OptedIn {
    const void* kernel;
    int dev;
    size_t static_bytes;
  };
  static std::mutex mu;
  static std::vector<OptedIn> done;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& e : done)
    if (e.kernel == kernel && e.dev == dev)
      return bytes + e.static_bytes > limit ? (int)cudaErrorInvalidValue : 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(limit - attr.sharedSizeBytes));
  if (err != cudaSuccess) return (int)err;
  done.push_back({kernel, dev, attr.sharedSizeBytes});
  if (bytes + attr.sharedSizeBytes > limit) return (int)cudaErrorInvalidValue;
  return 0;
}

// K3 (SWAP false) and K3-swap (SWAP true): one warp per box, a few boxes
// per block; NC > 0 is a compile-time nc, NC == 0 takes nc_rt.
template <typename T, int NC, bool SWAP>
__global__ void __launch_bounds__(kFillWarps * 32)
    fill_2d_kernel(const T* __restrict__ phi3, const T* __restrict__ A,
                   const int* __restrict__ g, const T* __restrict__ W,
                   T* __restrict__ out, int n, int nc_rt) {
  const int nc = NC > 0 ? NC : nc_rt;
  const int CC = (nc + 2) * (nc + 2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n) return;  // b is the same for the whole warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem) + warp * CC;
  stage_filled_block<T, NC, SWAP>(s, phi3, A, g, W, b, lane, nc);
  store_block(out + b * CC, s, lane, CC);
}

// Two adjacent values of T: a thread's cell pair in the sweeps of K1 and K2.
template <typename T>
struct Vec2;
template <>
struct Vec2<double> {
  using type = double2;
};
template <>
struct Vec2<float> {
  using type = float2;
};

// What the update of one cell pair reads besides the block: R, the six cs
// planes (c0, the 4 neighbors, c_sum) and the mask at the pair.
template <typename T>
struct PairIn {
  typename Vec2<T>::type r, c[6];
  float2 m;
};

// Pair p of box b: interior cells 2p and 2p + 1 in row-major order (nc is
// even, so a pair never straddles two rows), one vector per array.
template <typename T>
__device__ __forceinline__ void load_pair(PairIn<T>& in,
                                          const T* __restrict__ R,
                                          const float* __restrict__ mask,
                                          const T* __restrict__ cs,
                                          long long b, int p, int S) {
  using P = typename Vec2<T>::type;
  in.r = reinterpret_cast<const P*>(R + b * S)[p];
#pragma unroll
  for (int q = 0; q < 6; ++q)
    in.c[q] = reinterpret_cast<const P*>(cs + (b * 6 + q) * S)[p];
  in.m = __ldg(reinterpret_cast<const float2*>(mask) + p);
}

// One cell of the red-black update at x in the filled block (row stride
// C), in the operation order of the TPU kernel; the mask selects the new
// value or the old.
template <typename T>
__device__ __forceinline__ T update_cell(const T* x, int C, T rv, float mv,
                                         T c0, T c1, T c2, T c3, T c4, T c5) {
  const T B0 = x[0];
  const T lphi = c5 * B0 + c1 * (x[-C] - B0) + c2 * (x[C] - B0) +
                 c3 * (x[-1] - B0) + c4 * (x[1] - B0);
  const T nw = B0 + (rv - lphi) / c0;
  return mv > 0.0f ? nw : B0;
}

// The updated values of pair p, from the filled block s, into the
// scratch u ([nc, nc], row major).
template <typename T, int NC>
__device__ __forceinline__ void update_pair(T* u, const T* s,
                                            const PairIn<T>& in, int p,
                                            int nc) {
  using P = typename Vec2<T>::type;
  int r, c;
  div_nc<NC>(2 * p, nc, r, c);
  const int C = nc + 2;
  const T* x = s + (r + 1) * C + c + 1;
  P v;
  v.x = update_cell(x, C, in.r.x, in.m.x, in.c[0].x, in.c[1].x, in.c[2].x,
                    in.c[3].x, in.c[4].x, in.c[5].x);
  v.y = update_cell(x + 1, C, in.r.y, in.m.y, in.c[0].y, in.c[1].y,
                    in.c[2].y, in.c[3].y, in.c[4].y, in.c[5].y);
  reinterpret_cast<P*>(u)[p] = v;
}

// K1: the fill of K3 on a staged block, then the red-black update of the
// filled block, one warp per box and two adjacent interior cells per
// lane; NC > 0 is a compile-time nc, NC == 0 takes nc_rt.
template <typename T, int NC>
__global__ void __launch_bounds__(kFillWarps * 32)
    fill_sweep_2d_kernel(const T* __restrict__ phi3, const T* __restrict__ R,
                         const float* __restrict__ mask,
                         const T* __restrict__ A, const int* __restrict__ g,
                         const T* __restrict__ W, const T* __restrict__ cs,
                         T* __restrict__ out, int n, int nc_rt) {
  using P = typename Vec2<T>::type;
  // cell pairs per lane with a compile-time nc (one at nc = 8)
  constexpr int kPairs = NC > 0 ? (NC * NC / 2 + 31) / 32 : 1;
  const int nc = NC > 0 ? NC : nc_rt;
  const int C = nc + 2;
  const int CC = C * C;
  const int S = nc * nc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n) return;  // b is the same for the whole warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem) + warp * (CC + S);  // the block
  T* u = s + CC;  // its updated interior cells

  // with nc compiled in, the sweep's inputs load first: they do not
  // depend on g, and are in flight while the fill waits for it
  PairIn<T> in[kPairs];
  if constexpr (NC > 0) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < S / 2) load_pair<T>(in[i], R, mask, cs, b, p, S);
    }
  }
  stage_filled_block<T, NC, false>(s, phi3, A, g, W, b, lane, nc);

  // every updated value from the filled block before any goes back into
  // it: the mask is an input, so no cell is assumed left alone
  if constexpr (NC > 0) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < S / 2) update_pair<T, NC>(u, s, in[i], p, nc);
    }
  } else {
    for (int p = lane; p < S / 2; p += 32) {
      PairIn<T> one;
      load_pair<T>(one, R, mask, cs, b, p, S);
      update_pair<T, NC>(u, s, one, p, nc);
    }
  }
  __syncwarp();
  for (int p = lane; p < S / 2; p += 32) {  // each lane its own pairs
    int r, c;
    div_nc<NC>(2 * p, nc, r, c);
    const P v = reinterpret_cast<const P*>(u)[p];
    T* x = s + (r + 1) * C + c + 1;
    x[0] = v.x;
    x[1] = v.y;
  }
  __syncwarp();
  store_block(out + b * CC, s, lane, CC);
}

// K2's staging: the mbarrier and bulk-copy (TMA) instructions, as
// smoother_3d.cu's K5 uses them (each library is keyed by the hash of its
// own source, so they are repeated here, not shared through a header).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A barrier of one arrival.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival on bar, which then expects `bytes`: the sum of the bulk
// copies that complete its phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// The bulk copy of `bytes` (a multiple of 16, both ends on 16 bytes) from
// src to dst in shared memory, completing that many of bar's bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// K2's largest block: the run of boxes times the nc^2 / 2 threads of a box.
constexpr int kSweepThreads = 512;
// K2's target number of blocks: four on each of the H100's 132 SMs, all
// resident at once (one wave) at n = 4096.
constexpr int kSweepBlocks = 4 * 132;

// K2: a run of `run` consecutive boxes per block, staged whole in shared
// memory by three bulk copies (the run's blocks, R and cs, each a
// contiguous range) on one mbarrier; nc^2 / 2 threads per box, each with
// a pair of adjacent interior cells of a row (nc is even); the run's new
// blocks go out in 16-byte vectors. NC > 0 is a compile-time nc, NC == 0
// takes nc_rt.
template <typename T, int NC>
__global__ void __launch_bounds__(kSweepThreads)
    sweep_2d_kernel(const T* __restrict__ phi3, const T* __restrict__ R,
                    const float* __restrict__ mask, const int* __restrict__ g,
                    const T* __restrict__ cs, T* __restrict__ out, int n,
                    int nc_rt, int run) {
  using P = typename Vec2<T>::type;
  using V = typename Vec16<T>::type;
  constexpr int kPerVec = (int)(sizeof(V) / sizeof(T));
  const int nc = NC > 0 ? NC : nc_rt;
  const int C = nc + 2;
  const int CC = C * C;
  const int S = nc * nc;
  const int tid = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * run;
  const int kk = (int)min((long long)run, n - b0);  // the run's boxes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  T* blk = reinterpret_cast<T*>(smem);  // [run, C, C]
  T* rs = blk + run * CC;               // [run, nc, nc]
  T* css = rs + run * S;                // [run, 6, nc, nc]

  // Every level the V-cycle builds has own row b (ops/smoother
  // SmootherTables), so the run's blocks are rows [b0, b0 + kk) of phi3
  // and their copy starts before g is read; it is redone below for a box
  // whose own row is another. A tail run expects only what it copies.
  if (tid == 0) {
    mbar_init(&bar);
    const unsigned block_bytes = (unsigned)(kk * CC * sizeof(T));
    const unsigned r_bytes = (unsigned)(kk * S * sizeof(T));
    mbar_expect(&bar, block_bytes + 7 * r_bytes);
    bulk_load(blk, phi3 + b0 * CC, block_bytes, &bar);
    bulk_load(rs, R + b0 * S, r_bytes, &bar);
    bulk_load(css, cs + b0 * 6 * S, 6 * r_bytes, &bar);
  }
  // this thread's box j and pair p (interior cells 2p and 2p + 1, row
  // major); g's own row and the mask load while the copies are in flight
  const int per = NC > 0 ? NC * NC / 2 : S / 2;  // threads per box
  const int j = tid / per;
  const int p = tid - j * per;
  const bool active = j < kk;
  const long long b = b0 + j;
  const long long own = active ? (long long)g[b * 5] : b;
  const float2 m = __ldg(reinterpret_cast<const float2*>(mask) + p);
  int r, c;
  div_nc<NC>(2 * p, nc, r, c);
  // a block barrier, after which every thread sees the mbarrier initialised
  const bool moved = __syncthreads_or(own != b);
  mbar_wait(&bar, 0);
  if (moved) {  // the same for the whole block
    if (own != b) {
      V* dst = reinterpret_cast<V*>(blk + j * CC);
      const V* src = reinterpret_cast<const V*>(phi3 + own * CC);
      for (int i = p; i < CC / kPerVec; i += per) dst[i] = src[i];
    }
    __syncthreads();
  }

  // every updated value from the staged blocks before any goes back into
  // them: the mask is an input, so no cell is assumed left alone
  T* x = blk + j * CC + (r + 1) * C + c + 1;
  P nw;
  if (active) {
    const P rv = reinterpret_cast<const P*>(rs + j * S)[p];
    P cv[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      cv[k] = reinterpret_cast<const P*>(css + (j * 6 + k) * S)[p];
    nw.x = update_cell(x, C, rv.x, m.x, cv[0].x, cv[1].x, cv[2].x, cv[3].x,
                       cv[4].x, cv[5].x);
    nw.y = update_cell(x + 1, C, rv.y, m.y, cv[0].y, cv[1].y, cv[2].y,
                       cv[3].y, cv[4].y, cv[5].y);
  }
  __syncthreads();
  if (active) {
    x[0] = nw.x;
    x[1] = nw.y;
  }
  __syncthreads();
  const V* sv = reinterpret_cast<const V*>(blk);
  V* dst = reinterpret_cast<V*>(out + b0 * CC);
  const int nv = kk * CC / kPerVec;
#pragma unroll 4
  for (int i = tid; i < nv; i += blockDim.x) dst[i] = sv[i];
}

// K2's threads per block where one box's threads or staging do not fit
// sweep_2d_kernel.
constexpr int kBigThreads = 256;

// K2 for a large nc: one block per box stages the box's block alone (in
// 16-byte vectors from its own row) and its threads loop over the cell
// pairs, each reading R, the six cs planes and the mask at its pair from
// global memory (one vector each, coalesced across the threads) and
// writing its two new values straight to out; the ghost frame goes out
// from the staged block. Nothing is written back into shared memory, so
// every update reads the staged values, as the plain version does.
template <typename T>
__global__ void __launch_bounds__(kBigThreads)
    sweep_2d_big_kernel(const T* __restrict__ phi3, const T* __restrict__ R,
                        const float* __restrict__ mask,
                        const int* __restrict__ g, const T* __restrict__ cs,
                        T* __restrict__ out, int nc) {
  using V = typename Vec16<T>::type;
  constexpr int kPerVec = (int)(sizeof(V) / sizeof(T));
  const int C = nc + 2;
  const int CC = C * C;
  const int S = nc * nc;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const long long own = g[b * 5];
  const V* src = reinterpret_cast<const V*>(phi3 + own * CC);
  V* sv = reinterpret_cast<V*>(s);
  for (int i = tid; i < CC / kPerVec; i += blockDim.x) sv[i] = src[i];
  __syncthreads();
  T* o = out + b * CC;
  PairIn<T> in;
  for (int p = tid; p < S / 2; p += blockDim.x) {
    load_pair<T>(in, R, mask, cs, b, p, S);
    const int r = (2 * p) / nc;
    const int c = 2 * p - r * nc;
    const int k = (r + 1) * C + c + 1;
    o[k] = update_cell(s + k, C, in.r.x, in.m.x, in.c[0].x, in.c[1].x,
                       in.c[2].x, in.c[3].x, in.c[4].x, in.c[5].x);
    o[k + 1] = update_cell(s + k + 1, C, in.r.y, in.m.y, in.c[0].y,
                           in.c[1].y, in.c[2].y, in.c[3].y, in.c[4].y,
                           in.c[5].y);
  }
  // the frame: rows 0 and C - 1 whole, then columns 0 and C - 1 between
  for (int i = tid; i < 4 * C - 4; i += blockDim.x) {
    const int k = i < 2 * C ? (i < C ? i : (C - 1) * C + i - C)
                            : (1 + ((i - 2 * C) >> 1)) * C +
                                  ((i & 1) ? C - 1 : 0);
    o[k] = s[k];
  }
}

// Boxes (warps) per block of a warp-per-box kernel whose box takes
// box_bytes of shared memory: as many as fit 48 KB, up to kFillWarps, and
// one where a box needs more.
inline int warps_for(size_t box_bytes) {
  return (int)std::max<size_t>(
      1, std::min<size_t>(kDefaultSmem / box_bytes, kFillWarps));
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch K1: as K3, and R, cs and mask on 16-byte boundaries too; a box
// takes its block and its interior in shared memory.
template <typename T>
int launch_fill_sweep(const T* phi3, const T* R, const float* mask,
                      const T* A, const int* g, const T* W, const T* cs,
                      T* out, int n, int nc, cudaStream_t stream) {
  const size_t box_bytes =
      ((size_t)(nc + 2) * (nc + 2) + (size_t)nc * nc) * sizeof(T);
  if (nc < 2 || nc % 2 != 0) return (int)cudaErrorInvalidValue;
  if (!(aligned16(phi3) && aligned16(out) && aligned16(R) && aligned16(cs) &&
        aligned16(mask)))
    return (int)cudaErrorMisalignedAddress;
  const int warps = warps_for(box_bytes);
  const unsigned blocks = (unsigned)((n + warps - 1) / warps);
  const size_t smem = warps * box_bytes;
  auto kernel = nc == 8 ? fill_sweep_2d_kernel<T, 8>
                        : fill_sweep_2d_kernel<T, 0>;
  if (int err = allow_smem((const void*)kernel, smem, 0)) return err;
  kernel<<<blocks, warps * 32, smem, stream>>>(phi3, R, mask, A, g, W, cs,
                                               out, n, nc);
  return (int)cudaGetLastError();
}

// Launch K3 or K3-swap: nc even (a block is then a whole number of 16-byte
// vectors), phi3 and out on 16-byte boundaries, one block of a box within
// the opt-in limit of shared memory (nc <= 168 in float64).
template <typename T, bool SWAP>
int launch_fill(const T* phi3, const T* A, const int* g, const T* W, T* out,
                int n, int nc, cudaStream_t stream) {
  const size_t box_bytes = (size_t)(nc + 2) * (nc + 2) * sizeof(T);
  if (nc < 2 || nc % 2 != 0) return (int)cudaErrorInvalidValue;
  if (!(aligned16(phi3) && aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  const int warps = warps_for(box_bytes);
  const unsigned blocks = (unsigned)((n + warps - 1) / warps);
  const size_t smem = warps * box_bytes;
  auto kernel = nc == 8 ? fill_2d_kernel<T, 8, SWAP>
                        : fill_2d_kernel<T, 0, SWAP>;
  if (int err = allow_smem((const void*)kernel, smem, 0)) return err;
  kernel<<<blocks, warps * 32, smem, stream>>>(phi3, A, g, W, out, n, nc);
  return (int)cudaGetLastError();
}

// Launch K2: nc even, phi3, R, cs, mask and out on 16-byte boundaries (C
// and nc are even, so every range a block copies is a multiple of 16 bytes
// and starts on 16 bytes). Where a box's threads fit kSweepThreads and its
// block, R, cs and the mbarrier fit 48 KB of shared memory (nc <= 26 in
// float64, 32 in float32), sweep_2d_kernel, with the run of boxes per
// block sized from n, so that n = 4096 is one wave of kSweepBlocks blocks;
// else sweep_2d_big_kernel, whose box's block fits the opt-in limit (nc <=
// 168 in float64, 238 in float32).
template <typename T>
int launch_sweep(const T* phi3, const T* R, const float* mask, const int* g,
                 const T* cs, T* out, int n, int nc, cudaStream_t stream) {
  if (nc < 2 || nc % 2 != 0) return (int)cudaErrorInvalidValue;
  if (!(aligned16(phi3) && aligned16(out) && aligned16(R) && aligned16(cs) &&
        aligned16(mask)))
    return (int)cudaErrorMisalignedAddress;
  const int per = nc * nc / 2;  // threads per box
  const size_t block_bytes = (size_t)(nc + 2) * (nc + 2) * sizeof(T);
  const size_t box_bytes = block_bytes + 7 * (size_t)nc * nc * sizeof(T);
  // the mbarrier, with the 16-byte alignment of what follows it
  const size_t bar_bytes = 16;
  if (per > kSweepThreads || box_bytes + bar_bytes > kDefaultSmem) {
    auto kernel = sweep_2d_big_kernel<T>;
    if (int err = allow_smem((const void*)kernel, block_bytes, 0)) return err;
    kernel<<<n, kBigThreads, block_bytes, stream>>>(phi3, R, mask, g, cs,
                                                   out, nc);
    return (int)cudaGetLastError();
  }
  const size_t smem_max = kDefaultSmem - bar_bytes;
  const int run = std::max(
      1, std::min({(n + kSweepBlocks - 1) / kSweepBlocks,
                   (int)(smem_max / box_bytes), kSweepThreads / per}));
  const unsigned blocks = (unsigned)((n + run - 1) / run);
  const size_t smem = run * box_bytes;
  if (nc == 8) {
    sweep_2d_kernel<T, 8><<<blocks, run * per, smem, stream>>>(
        phi3, R, mask, g, cs, out, n, nc, run);
  } else {
    sweep_2d_kernel<T, 0><<<blocks, run * per, smem, stream>>>(
        phi3, R, mask, g, cs, out, n, nc, run);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int mode, const void* phi3, const void* R, const void* mask,
           const void* A, const void* g, const void* W, const void* cs,
           void* out, int n, int nc, cudaStream_t stream) {
  const T* p = static_cast<const T*>(phi3);
  const T* r = static_cast<const T*>(R);
  const float* m = static_cast<const float*>(mask);
  const T* a = static_cast<const T*>(A);
  const int* gi = static_cast<const int*>(g);
  const T* w = static_cast<const T*>(W);
  const T* c = static_cast<const T*>(cs);
  T* o = static_cast<T*>(out);
  if (mode == kModeSweep) {
    return launch_sweep<T>(p, r, m, gi, c, o, n, nc, stream);
  } else if (mode == kModeFillSweep) {
    return launch_fill_sweep<T>(p, r, m, a, gi, w, c, o, n, nc, stream);
  } else if (mode == kModeFill) {
    return launch_fill<T, false>(p, a, gi, w, o, n, nc, stream);
  } else if (mode == kModeFillSwap) {
    return launch_fill<T, true>(p, a, gi, w, o, n, nc, stream);
  }
  return (int)cudaErrorInvalidValue;
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
