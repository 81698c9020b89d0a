// K-Means distance phase on Hopper (sm_90a): two hand-written CUDA kernels.
//
// K1 kd_pairwise_sq_dists replaces the TPU kernel
//    src/repro/kernels/kmeans_distance/kernel.py::pairwise_sq_dists_pallas
//    (body _dists_kernel / _dist_tile): x (n, d), c (k, d) in f32 or bf16
//    -> (n, k) f32 squared distances ||x||^2 + ||c||^2 - 2 x.c, clamped at 0.
// K2 kd_assign replaces
//    src/repro/kernels/kmeans_distance/kernel.py::assign_pallas
//    (body _assign_kernel): the same distances reduced to a running argmin,
//    -> labels (n,) int32 and best (n,) f32, never writing the (n, k) matrix.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores,
// a multiply-add counted as 2), counting 2*n*k*d operations for the dot
// products, 2*(n+k)*d for the norms and 4 per (point, centroid) pair (add the
// norms, scale, subtract, clamp; K2 adds a compare, 5):
//  * K1 is bound by its output: n*k*4 bytes written (65.5 MB at n = 16,000,
//    k = 1,024, about 19.6 us) against 5.4 us of arithmetic at d = 9.  The
//    design writes each output element once, coalesced along k (16 threads
//    on 16 neighbouring columns), and keeps everything else on chip: the
//    point and centroid tiles sit in shared memory and each thread holds a
//    4x4 register tile of dot products.
//  * K2 moves well under a megabyte, so it is bound by arithmetic (5.6 us
//    at n = 16,000, k = 1,024, d = 9; 45 us at k = 8,192).  One
//    block owns 32 point rows and loops over every 64-centroid panel itself
//    (the loop replaces the TPU's sequential trailing grid axis, which
//    Hopper does not have); best value and label stay in registers and are
//    combined across the 16 threads of a row with warp shuffles.
//
// Both kernels use plain f32 arithmetic, not TF32 or tensor cores: the f32
// parity tolerance (rtol 1e-5) is beyond TF32, and at d = 9 an MMA's depth
// would be mostly padding.  Products and sums are rounded separately (no FMA
// contraction) and summed over d in order, the arithmetic of the plain
// version in ref.py, so the two agree bit for bit in f32: a near-tie between
// two centroids then breaks the same way in both, and a MiniBatch run through
// the kernels keeps the same counts as one through the plain version.  This
// costs up to 2x the FMA issue rate in K2.  bf16 inputs are widened to f32 as
// they are staged.  d is walked in chunks of 32, so any d works; ragged n, k
// and d are masked in the kernels (zero-filled loads, masked stores, +inf for
// missing centroids) with no padding or sentinel rows.  Ties follow the TPU kernel: the smaller
// distance wins, and on an equal distance the smaller centroid index.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream of the given device, leaves the caller's current device as it found
// it, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int BK = 32;         // depth chunk over d staged per step
constexpr int TM = 4;          // rows per thread
constexpr int TN = 4;          // centroids per thread
constexpr int TX = 16;         // threads along the centroid axis
constexpr int BN = TX * TN;    // centroids per tile (64)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// a * b + c rounded twice, never contracted to an FMA, so the sums match the
// plain version's (ref.py) sequential order bit for bit
__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return __fadd_rn(__fmul_rn(a, b), c);
}

// max((xn + cn) - 2 * dot, 0), rounded as ref.py rounds it
__device__ __forceinline__ float sq_dist(float xn, float cn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(xn, cn), 2.f * dot), 0.f);
}

// Stage rows [row0, row0 + ROWS) and dims [k0, k0 + BK) of a row-major
// (nrows, d) matrix into tile[BK][ROWS + 1], transposed and widened to f32,
// with zeros outside the matrix.  Consecutive threads read consecutive dims
// of a row; the +1 pad keeps the transposed stores free of bank conflicts.
template <typename T, int ROWS, int NT>
__device__ __forceinline__ void stage(float (*tile)[ROWS + 1],
                                      const T* __restrict__ src, int nrows,
                                      int d, int row0, int k0) {
  for (int e = threadIdx.x; e < ROWS * BK; e += NT) {
    const int r = e / BK, kk = e % BK;
    const int gr = row0 + r, gk = k0 + kk;
    float v = 0.f;
    if (gr < nrows && gk < d) v = to_f32(src[(size_t)gr * d + gk]);
    tile[kk][r] = v;
  }
}

// Shared-memory workspace of one (BM x BN) distance tile.
template <int BM>
struct Smem {
  float xs[BK][BM + 1];
  float cs[BK][BN + 1];
  float xnorm[BM];
  float cnorm[BN];
};

// Dot products of this thread's TM x TN micro-tile over all of d, plus the
// tile's squared row and column norms, each computed once (one thread per
// row, one per column).  On return the norms are in smem and visible to all.
template <typename T, int BM>
__device__ __forceinline__ void dot_tile(Smem<BM>& sm, const T* __restrict__ x,
                                         const T* __restrict__ c, int n, int k,
                                         int d, int row0, int col0,
                                         float acc[TM][TN]) {
  constexpr int TY = BM / TM;
  constexpr int NT = TY * TX;
  static_assert(BM + BN <= NT, "one thread per tile row and column for the norms");
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  float norm = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += BK) {
    stage<T, BM, NT>(sm.xs, x, n, d, row0, k0);
    stage<T, BN, NT>(sm.cs, c, k, d, col0, k0);
    __syncthreads();
    const int kmax = min(BK, d - k0);
    if (tid < BM) {
      for (int kk = 0; kk < kmax; ++kk) norm = mul_add(sm.xs[kk][tid], sm.xs[kk][tid], norm);
    } else if (tid < BM + BN) {
      const int cc = tid - BM;
      for (int kk = 0; kk < kmax; ++kk) norm = mul_add(sm.cs[kk][cc], sm.cs[kk][cc], norm);
    }
    for (int kk = 0; kk < kmax; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.xs[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.cs[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mul_add(a[i], b[j], acc[i][j]);
    }
    __syncthreads();   // the next chunk overwrites xs / cs
  }
  if (tid < BM) sm.xnorm[tid] = norm;
  else if (tid < BM + BN) sm.cnorm[tid - BM] = norm;
  __syncthreads();
}

// ---------------------------------------------------------------- K1
constexpr int K1_BM = 64;
constexpr int K1_THREADS = (K1_BM / TM) * TX;   // 256

template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
pairwise_sq_dists_kernel(const T* __restrict__ x, const T* __restrict__ c,
                         float* __restrict__ out, int n, int k, int d) {
  constexpr int TY = K1_BM / TM;
  __shared__ Smem<K1_BM> sm;
  const int row0 = blockIdx.y * K1_BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
  dot_tile<T, K1_BM>(sm, x, c, n, k, d, row0, col0, acc);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + TY * i;
    if (row0 + r >= n) continue;
    float* orow = out + (size_t)(row0 + r) * k;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = tx + TX * j;
      if (col0 + cc < k)
        orow[col0 + cc] = sq_dist(sm.xnorm[r], sm.cnorm[cc], acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- K2
constexpr int K2_BM = 32;
constexpr int K2_THREADS = (K2_BM / TM) * TX;   // 128

template <typename T>
__global__ void __launch_bounds__(K2_THREADS)
assign_kernel(const T* __restrict__ x, const T* __restrict__ c,
              int* __restrict__ labels, float* __restrict__ best, int n, int k,
              int d) {
  constexpr int TY = K2_BM / TM;
  __shared__ Smem<K2_BM> sm;
  const int row0 = blockIdx.x * K2_BM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float bv[TM];
  int bi[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) { bv[i] = CUDART_INF_F; bi[i] = 0; }
  for (int col0 = 0; col0 < k; col0 += BN) {
    float acc[TM][TN];
    dot_tile<T, K2_BM>(sm, x, c, n, k, d, row0, col0, acc);
    // each thread visits its centroids in increasing index order, so the
    // strict < keeps the smallest index among equal distances
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int cc = tx + TX * j;
        const float v = col0 + cc < k
            ? sq_dist(sm.xnorm[r], sm.cnorm[cc], acc[i][j])
            : CUDART_INF_F;
        if (v < bv[i]) { bv[i] = v; bi[i] = col0 + cc; }
      }
    }
    __syncthreads();   // the next panel overwrites the norms
  }
  // the TX threads of a row group are 16 aligned lanes of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (ov < bv[i] || (ov == bv[i] && oi < bi[i])) { bv[i] = ov; bi[i] = oi; }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + ty + TY * i;
      if (gr < n) { labels[gr] = bi[i]; best[gr] = bv[i]; }
    }
  }
}

// Makes `device` current for one launch and gives the caller's device back.
struct DeviceGuard {
  int prev = 0;
  bool switched = false;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
int kd_pairwise_sq_dists(const void* x, const void* c, float* out, int n,
                         int k, int d, int dtype, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const dim3 grid((k + BN - 1) / BN, (n + K1_BM - 1) / K1_BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    pairwise_sq_dists_kernel<float><<<grid, K1_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(c), out, n, k, d);
  else if (dtype == 1)
    pairwise_sq_dists_kernel<__nv_bfloat16><<<grid, K1_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(c),
        out, n, k, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int kd_assign(const void* x, const void* c, int* labels, float* best, int n,
              int k, int d, int dtype, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const dim3 grid((n + K2_BM - 1) / K2_BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    assign_kernel<float><<<grid, K2_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(c), labels, best,
        n, k, d);
  else if (dtype == 1)
    assign_kernel<__nv_bfloat16><<<grid, K2_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(c),
        labels, best, n, k, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
