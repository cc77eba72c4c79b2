// Multigrid smoother kernels for Hopper (sm_90a): K4 sweep and K5 fill, on
// the level-local block arrays of the 3D block V-cycle.
//
// Replaces the TPU Pallas kernels of afivo_streamer_tpu/ops/pallas_smoother.py:
//   K4 _sweep_3d (def :549, pallas_call :574) -> mode 0, sweep_3d_kernel
//   K5 _fill_3d  (def :597, pallas_call :637) -> mode 1, fill_3d_kernel
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
// Offsets are 64-bit: n*C^3 and n*8*nc^3 pass 2^31 at 256^3 cells.
//
// What bounds these kernels on the H100: memory traffic, at a dozen flops
// per cell. K4 reads 8 nc^3 = 4096 stencil values per box against C^3 =
// 1000 of phi, so at n = 4096 boxes in float64 it moves ~134 MB of cs,
// 33 MB of phi in, 17 MB of R and 33 MB out (~0.22 GB, more than the
// 50 MB L2). It is one thread per output cell of [n, C, C, C]: consecutive
// threads touch consecutive addresses of phi3, cs, R and out, so those
// loads and stores are coalesced, and it runs at ~0.8 of its bound.
// Cutting the cs traffic (recomputing the stencil from the per-level
// coefficients) is later work.
//
// K5 must move 66 MB at n = 4096, nc = 8 in float64 (a 19.8 us bound): 616
// of the 1000 values of each own block (it needs none of the 384 face
// ghosts it overwrites), the 384 neighbor-slab values and 384 ghost
// constants, and one block out. Besides the bytes it pays a dependent
// chain per box (g, then the neighbor slabs) and, on the z faces, one
// 32-byte sector per 8-byte slab value (the values lie C apart). One
// thread per cell spent a 64-bit division per thread, warps that mixed
// 616 copying threads with 384 ghost threads, and 8-byte accesses, and
// read 0.45 of the bound. fill_3d_kernel is one block of 128 threads (a
// warp group) per box. Thread 0 starts one bulk copy (TMA,
// cp.async.bulk) of the own block into shared memory, completing on an
// mbarrier, so the copy costs the threads neither registers nor
// instructions; meanwhile each thread loads its three ghosts' weights and
// constants (contiguous: the ghosts are numbered as A is laid out) and
// each warp the box's g row, which shuffles hand round, and then the
// three neighbor-slab values. The own row is the box's index on every
// level the V-cycle builds (ops/smoother.SmootherTables), so the copy
// does not wait for g; it is redone where the row differs. After the
// copy lands each thread reads f1 and f2 from shared memory and writes
// its ghosts there (a ghost cell is never an f1 or f2 cell), and after a
// block barrier the block goes out in 16-byte stores, contiguous and
// coalesced. No integer division but by compile-time constants: nc is a
// template parameter, instantiated at 8 (every config's box size); a
// second instance takes any even nc at run time (threads loop over the 6
// nc^2 ghosts). C is even, so a block is a whole number of 16-byte units
// and starts on a 16-byte boundary when phi3 does (the wrapper checks
// it); one block must fit 48 KB of shared memory (nc <= 16 in float64).
// What is left between it and its bound is traffic the function does not
// need: the copy reads the face ghosts with their rows, and a z-face slab
// value costs a 32-byte sector, ~26 KB of sectors per box in float64
// against the 16.2 KB counted. One warp per box (12 ghosts per thread) or
// 64 threads per box ran 2-5 % slower than 128.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kModeSweep = 0;
constexpr int kModeFill = 1;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kFillThreads = 128;
constexpr size_t kMaxSmem = 48 * 1024;

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

// 16 bytes of T: the unit of the fill's block store.
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

// The mbarrier and bulk-copy (TMA) instructions the fill uses.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on bar that expects `bytes` more, and the bulk copy of those
// bytes (a multiple of 16, both ends on 16 bytes) from src to dst that
// completes them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
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

// Quotient and remainder of k by nc (NC > 0 a compile-time nc); no
// run-time division.
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

// Face ghost k of a box, numbered as A lays the ghosts out (k = d nc^2 +
// t0 nc + t1: face d, transverse cells t0, t1 over the face's two other
// axes in their natural order): d, the offset in a block of the ghost's
// cell at row 0 along the face's axis, and the stride of that axis.
struct Face {
  int d, base, stride;
};

template <int NC>
__device__ __forceinline__ Face face_of(int k, int nc) {
  int j, t0, t1;
  Face f;
  div_nc<NC>(k, nc, j, t1);  // j = d nc + t0
  div_nc<NC>(j, nc, f.d, t0);
  const int C = nc + 2;
  const int axis = f.d >> 1;
  f.base = axis == 0   ? (t0 + 1) * C + t1 + 1
           : axis == 1 ? (t0 + 1) * C * C + t1 + 1
                       : ((t0 + 1) * C + t1 + 1) * C;
  f.stride = axis == 0 ? C * C : axis == 1 ? C : 1;
  return f;
}

// What one face ghost reads besides the own block.
template <typename T>
struct FaceIn {
  T slab, w0, w1, w2, a;
};

// The face's weights and the ghost constant of ghost k (on face f) of box
// b; they do not depend on g, so they load while g does.
template <typename T>
__device__ __forceinline__ void load_face(FaceIn<T>& in,
                                          const T* __restrict__ A,
                                          const T* __restrict__ W,
                                          long long b, Face f, int k,
                                          int nc) {
  const T* w = W + (b * 6 + f.d) * 8;
  in.w0 = w[0];
  in.w1 = w[1];
  in.w2 = w[2];
  in.a = A[b * 6 * nc * nc + k];
}

// The slab value next to a ghost on face f in the neighbor block nrow.
template <typename T>
__device__ __forceinline__ T load_face_slab(const T* __restrict__ phi3,
                                            long long nrow, Face f, int nc) {
  const long long C = nc + 2;
  const int layer = (f.d & 1) ? 1 : nc;
  return phi3[nrow * C * C * C + f.base + layer * f.stride];
}

// A ghost on face f into the staged block s, from the own-block layers f1,
// f2 next to the face, in the operation order of the TPU kernel.
template <typename T>
__device__ __forceinline__ void put_face(T* s, const FaceIn<T>& in, Face f,
                                         int nc) {
  const bool low = (f.d & 1) == 0;
  const int f1 = low ? 1 : nc;
  const int f2 = low ? 2 : nc - 1;
  const int gr = low ? 0 : nc + 1;
  s[f.base + gr * f.stride] = in.w0 * in.slab +
                              in.w1 * s[f.base + f1 * f.stride] +
                              in.w2 * s[f.base + f2 * f.stride] + in.a;
}

// K5: one block of kFillThreads threads per box; NC > 0 is a compile-time
// nc, NC == 0 takes nc_rt.
template <typename T, int NC>
__global__ void __launch_bounds__(kFillThreads)
    fill_3d_kernel(const T* __restrict__ phi3, const T* __restrict__ A,
                   const int* __restrict__ g, const T* __restrict__ W,
                   T* __restrict__ out, int nc_rt) {
  using V = typename Vec16<T>::type;
  constexpr int kPerVec = (int)(sizeof(V) / sizeof(T));
  // ghosts per thread with a compile-time nc (3 at nc = 8)
  constexpr int kGhosts =
      NC > 0 ? (6 * NC * NC + kFillThreads - 1) / kFillThreads : 1;
  const int nc = NC > 0 ? NC : nc_rt;
  const int C = nc + 2;
  const long long C3 = (long long)C * C * C;
  const int n_ghosts = 6 * nc * nc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long b = blockIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  T* s = reinterpret_cast<T*>(smem);
  const unsigned bytes = (unsigned)(C3 * sizeof(T));

  // the own block into shared memory, one bulk copy. Every level the
  // V-cycle builds has own row b (ops/smoother.SmootherTables), so the
  // copy of block b starts before g arrives; it is redone for a box whose
  // own row is another
  if (tid == 0) {
    mbar_init(&bar);
    bulk_load(s, phi3 + b * C3, bytes, &bar);
  }
  // the box's g row (own, then the six faces' neighbors), shared by
  // shuffles in each warp; this thread's ghosts' weights and constants
  const int gv = lane < 7 ? g[b * 7 + lane] : 0;
  FaceIn<T> in[kGhosts];
  if constexpr (NC > 0) {
#pragma unroll
    for (int i = 0; i < kGhosts; ++i) {
      const int k = tid + i * kFillThreads;
      if (k < n_ghosts)
        load_face<T>(in[i], A, W, b, face_of<NC>(k, nc), k, nc);
    }
  }
  const long long own = __shfl_sync(kFullWarp, gv, 0);
  int nb[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) nb[d] = __shfl_sync(kFullWarp, gv, 1 + d);
  // a select, not nb[d]: a run-time index would put nb in local memory
  auto nb_row = [&](int d) -> long long {
    return d == 0   ? nb[0]
           : d == 1 ? nb[1]
           : d == 2 ? nb[2]
           : d == 3 ? nb[3]
           : d == 4 ? nb[4]
                    : nb[5];
  };
  if constexpr (NC > 0) {
#pragma unroll
    for (int i = 0; i < kGhosts; ++i) {
      const int k = tid + i * kFillThreads;
      if (k < n_ghosts) {
        const Face f = face_of<NC>(k, nc);
        in[i].slab = load_face_slab<T>(phi3, nb_row(f.d), f, nc);
      }
    }
  }
  __syncthreads();  // the barrier's initialisation is seen by all threads
  mbar_wait(&bar, 0);
  if (own != b) {     // the same for the whole block
    __syncthreads();  // every thread is past phase 0 before phase 1 starts
    if (tid == 0) bulk_load(s, phi3 + own * C3, bytes, &bar);
    mbar_wait(&bar, 1);
  }

  if constexpr (NC > 0) {
#pragma unroll
    for (int i = 0; i < kGhosts; ++i) {
      const int k = tid + i * kFillThreads;
      if (k < n_ghosts) put_face<T>(s, in[i], face_of<NC>(k, nc), nc);
    }
  } else {
    for (int k = tid; k < n_ghosts; k += kFillThreads) {
      const Face f = face_of<NC>(k, nc);
      FaceIn<T> one;
      load_face<T>(one, A, W, b, f, k, nc);
      one.slab = load_face_slab<T>(phi3, nb_row(f.d), f, nc);
      put_face<T>(s, one, f, nc);
    }
  }
  __syncthreads();

  const V* sv = reinterpret_cast<const V*>(s);
  V* dst = reinterpret_cast<V*>(out + b * C3);
  const int nv = (int)(C3 / kPerVec);
#pragma unroll 4
  for (int i = tid; i < nv; i += kFillThreads) dst[i] = sv[i];
}

// Launch K5: nc even (a block is then a whole number of 16-byte units),
// phi3 and out on 16-byte boundaries, one block of a box and the barrier
// within 48 KB of shared memory.
template <typename T>
int launch_fill(const T* phi3, const T* A, const int* g, const T* W, T* out,
                int n, int nc, cudaStream_t stream) {
  const size_t box_bytes = (size_t)(nc + 2) * (nc + 2) * (nc + 2) * sizeof(T);
  if (nc < 2 || nc % 2 != 0 || box_bytes + sizeof(uint64_t) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(phi3) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (nc == 8) {
    fill_3d_kernel<T, 8>
        <<<n, kFillThreads, box_bytes, stream>>>(phi3, A, g, W, out, nc);
  } else {
    fill_3d_kernel<T, 0>
        <<<n, kFillThreads, box_bytes, stream>>>(phi3, A, g, W, out, nc);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int mode, const void* phi3, const void* R, const void* mask,
           const void* A, const void* g, const void* W, const void* cs,
           void* out, int n, int nc, cudaStream_t stream) {
  const T* p = static_cast<const T*>(phi3);
  const int* gi = static_cast<const int*>(g);
  T* o = static_cast<T*>(out);
  if (mode == kModeSweep) {
    const long long total = (long long)n * (nc + 2) * (nc + 2) * (nc + 2);
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    sweep_3d_kernel<T><<<blocks, threads, 0, stream>>>(
        p, static_cast<const T*>(R), static_cast<const float*>(mask), gi,
        static_cast<const T*>(cs), o, n, nc);
  } else if (mode == kModeFill) {
    return launch_fill<T>(p, static_cast<const T*>(A), gi,
                          static_cast<const T*>(W), o, n, nc, stream);
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
