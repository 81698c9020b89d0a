// K-Means distance phase on Hopper (sm_90a): hand-written CUDA kernels.
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
//  * K1 is bound by its output: n*k*4 bytes written (524 MB at n = 16,000,
//    k = 8,192, 0.157 ms), against 0.086 ms of arithmetic at d = 9.
//  * K2 moves well under a megabyte, so it is bound by arithmetic: 0.045 ms
//    at n = 16,000, k = 8,192, d = 9.
//
// Arithmetic, shared by both kernels and by the plain version in ref.py, so
// that all three agree bit for bit in f32: norms and dot products summed over
// d in index order, each product and each sum rounded on its own (mul_add: no
// FMA contraction), then (xn + cn) - 2 dot clamped at 0 (sq_dist).  A
// near-tie between two centroids then breaks the same way in the kernels and
// in the plain version, and a MiniBatch run through the kernels keeps the
// same counts as one through the plain version.  bf16 inputs are widened to
// f32 as they are loaded.  Plain f32 on the CUDA cores, not TF32 or tensor
// cores: rtol 1e-5 is beyond TF32, and at d = 9 an MMA's depth would be
// mostly padding.  The unfused product and sum issue 2 instructions per
// multiply-add where the bound counts one FMA, so the issue floor of this
// arithmetic is 2x the operation bound (about 0.09 ms for K2 at k = 8,192).
// Ties follow the TPU kernel: the smaller distance wins, and on an equal
// distance the smaller centroid index.
//
// Two designs for each kernel:
//  * d <= MAX_REG_DIM (the Mini-App's d is 9): templates on d, with the
//    rows or centroids a thread owns held in registers and the rest staged
//    in shared memory at d's own width (each row padded to a float4, its
//    squared norm in the pad), every norm computed once per block.
//    - K2 (assign_kernel): a grid of (512-row tiles) x (k-slices).  Each
//      block stages its slice of centroids and their norms once, each
//      thread keeps 4 point rows and their norms in registers, and walks
//      the slice in index order with no barrier inside the loop (one
//      broadcast float4 read of a centroid feeds 4 rows' dot products).
//      The slice width (ops.py::slice_width) splits k so that the grid
//      fills the card's resident blocks about once, in place of the TPU's
//      sequential trailing grid axis, which Hopper does not have.  With
//      more than one slice each block writes its slice's (best, index)
//      pair per row to scratch, and assign_combine_kernel reduces a row's
//      pairs to the smallest distance and, among equal ones, the smallest
//      index.  Each slice keeps the first index of its minimum (increasing
//      index, strict <), so the result is the first index of the row's
//      minimum, as in one pass over k.  The combine has no atomics and no
//      order that depends on which block ran first, so the result is the
//      same on every run.  (A 64-bit atomicMin on (distance bits, index)
//      would need its keys set before the kernel and unpacked after it.)
//    - K1 (pairwise_sq_dists_kernel): each block owns 128 centroids (4
//      consecutive ones a lane, in registers with their norms) and walks
//      64-row tiles of x with a grid stride, so the grid is about one wave
//      of resident blocks and each block pays its prologue once.  A tile
//      is staged once (the next tile's rows are fetched into registers
//      while the block computes this one; two buffers, one barrier a
//      tile).  A warp writes a row's 128 columns as 32 16-byte streaming
//      stores (st.global.cs: the output is 10x the size of L2 and is not
//      read again here); a ragged k edge, k not a multiple of 4 or an
//      output not 16-byte aligned takes scalar streaming stores.
//  * any d (the general path): a (64 x 64) distance tile per step, the
//    point and centroid panels staged in shared memory in depth chunks of
//    32, a 4x4 register micro-tile of dot products per thread.  K1 writes
//    each tile once; K2 (assign_tile_kernel) takes the same (row tiles) x
//    (k-slices) grid and the same combine as the register design.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream of the given device, leaves the caller's current device as it found
// it, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

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

// ------------------------------------------------- register design (d <= 16)
constexpr int MAX_REG_DIM = 16;

// floats per staged row: d values, then the row's squared norm, padded to a float4
template <int D>
constexpr int kPaddedRow = (D + 4) / 4 * 4;

// sum over t < D of a[t] * b[t], in index order (a row's norm when a == b)
template <int D>
__device__ __forceinline__ float dot_d(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < D; ++t) s = mul_add(a[t], b[t], s);
  return s;
}

// one staged row (16-byte aligned) into registers, as float4 reads
template <int CS>
__device__ __forceinline__ void load_row(float (&v)[CS], const float* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < CS / 4; ++q) {
    const float4 f = p[q];
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
  }
}

// K2: one block per (512-row tile, k-slice)
constexpr int AS_THREADS = 128;
constexpr int AS_ROWS = 4;                           // point rows per thread
constexpr int AS_BLOCK_ROWS = AS_THREADS * AS_ROWS;  // 512
constexpr int KS_MAX = 512;                          // centroids a slice stages

template <typename T, int D>
__global__ void __launch_bounds__(AS_THREADS)
assign_kernel(const T* __restrict__ x, const T* __restrict__ c,
              int* __restrict__ labels, float* __restrict__ best, int n, int k,
              int ks) {
  constexpr int CS = kPaddedRow<D>;
  __shared__ __align__(16) float cs[KS_MAX * CS];
  const int k0 = blockIdx.y * ks;
  const int kn = min(ks, k - k0);
  const T* cslice = c + (size_t)k0 * D;
  for (int e = threadIdx.x; e < kn * D; e += AS_THREADS) {
    const int j = e / D;
    cs[j * CS + (e - j * D)] = to_f32(cslice[e]);
  }
  float xr[AS_ROWS][D], xn[AS_ROWS], bv[AS_ROWS];
  int bi[AS_ROWS];
  const int row0 = blockIdx.x * AS_BLOCK_ROWS + threadIdx.x;
#pragma unroll
  for (int i = 0; i < AS_ROWS; ++i) {
    const int r = row0 + i * AS_THREADS;
#pragma unroll
    for (int t = 0; t < D; ++t) xr[i][t] = r < n ? to_f32(x[(size_t)r * D + t]) : 0.f;
    xn[i] = dot_d<D>(xr[i], xr[i]);
    bv[i] = CUDART_INF_F;
    bi[i] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kn; j += AS_THREADS)
    cs[j * CS + D] = dot_d<D>(cs + j * CS, cs + j * CS);
  __syncthreads();
  // increasing index with a strict <: the first index of the slice's minimum
#pragma unroll 2
  for (int j = 0; j < kn; ++j) {
    float cv[CS];
    load_row<CS>(cv, cs + j * CS);
#pragma unroll
    for (int i = 0; i < AS_ROWS; ++i) {
      const float v = sq_dist(xn[i], cv[D], dot_d<D>(xr[i], cv));
      if (v < bv[i]) { bv[i] = v; bi[i] = k0 + j; }
    }
  }
  labels += (size_t)blockIdx.y * n;
  best += (size_t)blockIdx.y * n;
#pragma unroll
  for (int i = 0; i < AS_ROWS; ++i) {
    const int r = row0 + i * AS_THREADS;
    if (r < n) { labels[r] = bi[i]; best[r] = bv[i]; }
  }
}

// K1: one block per 128 centroids, walking 64-row tiles with a grid stride
constexpr int P_THREADS = 256;
constexpr int P_WARPS = P_THREADS / 32;
constexpr int P_COLS = 128;                          // 4 consecutive a lane
constexpr int P_ROWS = 64;                           // rows a staged tile

template <typename T, int D>
__global__ void __launch_bounds__(P_THREADS)
pairwise_sq_dists_kernel(const T* __restrict__ x, const T* __restrict__ c,
                         float* __restrict__ out, int n, int k, int vec) {
  constexpr int CS = kPaddedRow<D>;
  __shared__ __align__(16) float xs[2][P_ROWS * CS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * P_COLS + 4 * lane;
  float cr[4][D], cn[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = col + q;
#pragma unroll
    for (int t = 0; t < D; ++t) cr[q][t] = j < k ? to_f32(c[(size_t)j * D + t]) : 0.f;
    cn[q] = dot_d<D>(cr[q], cr[q]);
  }
  const int row_tiles = (n + P_ROWS - 1) / P_ROWS;
  // the first P_ROWS threads stage: each fetches its row of the next tile
  // into registers while the block computes the current one
  float pre[D];
  auto fetch = [&](int rt) {
    const int r = rt * P_ROWS + threadIdx.x;
#pragma unroll
    for (int t = 0; t < D; ++t)
      pre[t] = rt < row_tiles && r < n ? to_f32(x[(size_t)r * D + t]) : 0.f;
  };
  if (threadIdx.x < P_ROWS) fetch(blockIdx.y);
  int buf = 0;
  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y, buf ^= 1) {
    // two buffers: the tile written here was last read two tiles ago,
    // before the barrier of the previous tile
    float* xt = xs[buf];
    if (threadIdx.x < P_ROWS) {
      float* dst = xt + threadIdx.x * CS;
#pragma unroll
      for (int t = 0; t < D; ++t) dst[t] = pre[t];
      dst[D] = dot_d<D>(pre, pre);
      fetch(rt + gridDim.y);
    }
    __syncthreads();
    const int row0 = rt * P_ROWS;
    for (int rr = warp; rr < P_ROWS && row0 + rr < n; rr += P_WARPS) {
      float xv[CS];
      load_row<CS>(xv, xt + rr * CS);
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = sq_dist(xv[D], cn[q], dot_d<D>(xv, cr[q]));
      float* dst = out + (size_t)(row0 + rr) * k + col;
      if (vec && col + 4 <= k) {
        __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < k) __stcs(dst + q, o[q]);
      }
    }
  }
}

// ------------------------------------------------------ general design (any d)
constexpr int BK = 32;         // depth chunk over d staged per step
constexpr int TM = 4;          // rows per thread
constexpr int TN = 4;          // centroids per thread
constexpr int TX = 16;         // threads along the centroid axis
constexpr int BN = TX * TN;    // centroids per tile (64)

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
// row, one per column); centroid rows at or past k are zero.  On return the
// norms are in smem and visible to all.
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

constexpr int K1_BM = 64;
constexpr int K1_THREADS = (K1_BM / TM) * TX;   // 256

template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
pairwise_sq_dists_tile_kernel(const T* __restrict__ x, const T* __restrict__ c,
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

constexpr int K2_BM = 32;
constexpr int K2_THREADS = (K2_BM / TM) * TX;   // 128

// K2's general design: one block per (32-row tile, k-slice), walking the
// slice's 64-centroid panels in order
template <typename T>
__global__ void __launch_bounds__(K2_THREADS)
assign_tile_kernel(const T* __restrict__ x, const T* __restrict__ c,
                   int* __restrict__ labels, float* __restrict__ best, int n,
                   int k, int d, int ks) {
  constexpr int TY = K2_BM / TM;
  __shared__ Smem<K2_BM> sm;
  const int row0 = blockIdx.x * K2_BM;
  const int k0 = blockIdx.y * ks, k1 = min(k, k0 + ks);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float bv[TM];
  int bi[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) { bv[i] = CUDART_INF_F; bi[i] = 0; }
  for (int col0 = k0; col0 < k1; col0 += BN) {
    float acc[TM][TN];
    dot_tile<T, K2_BM>(sm, x, c, n, k1, d, row0, col0, acc);
    // each thread visits its centroids in increasing index order, so the
    // strict < keeps the smallest index among equal distances
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int cc = tx + TX * j;
        const float v = col0 + cc < k1
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
  labels += (size_t)blockIdx.y * n;
  best += (size_t)blockIdx.y * n;
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + ty + TY * i;
      if (gr < n) { labels[gr] = bi[i]; best[gr] = bv[i]; }
    }
  }
}

// ------------------------------------------------------------- K2's combine
constexpr int COMBINE_THREADS = 128;
constexpr int COMBINE_LANES = 4;      // threads per row
constexpr int COMBINE_ROWS = COMBINE_THREADS / COMBINE_LANES;

// Per row, the slices' (best, index) pairs (scratch laid out (slices, n))
// reduced to the row's minimum and the first index that reaches it.  Each
// of a row's COMBINE_LANES neighbouring threads takes a contiguous run of
// slices in order (strict <), then the runs are combined with shuffles,
// the smaller index winning an equal distance: slices are in index order,
// so this is the slice-order reduction.  An all-+inf row keeps slice 0's
// pair, index 0, as torch.min and the one-slice kernel do.
__global__ void __launch_bounds__(COMBINE_THREADS)
assign_combine_kernel(const int* __restrict__ part_labels,
                      const float* __restrict__ part_best, int slices, int n,
                      int* __restrict__ labels, float* __restrict__ best) {
  const int r = blockIdx.x * COMBINE_ROWS + threadIdx.x / COMBINE_LANES;
  const int lane = threadIdx.x % COMBINE_LANES;
  const int run = (slices + COMBINE_LANES - 1) / COMBINE_LANES;
  const int s0 = lane * run, s1 = min(slices, s0 + run);
  float bv = CUDART_INF_F;
  int bi = INT_MAX;                    // no pair yet: loses every tie
  if (r < n) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const size_t at = (size_t)s * n + r;
      const float v = part_best[at];
      const int i = part_labels[at];
      if (v < bv || bi == INT_MAX) { bv = v; bi = i; }
    }
  }
#pragma unroll
  for (int off = 1; off < COMBINE_LANES; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  if (r < n && lane == 0) {
    labels[r] = bi;
    best[r] = bv;
  }
}

// ---------------------------------------------------------------- launches
// Each picks the register design's instantiation for d <= MAX_REG_DIM, by
// recursion over D, and the general design above that.

template <typename T, int D = 1>
cudaError_t launch_pairwise(const T* x, const T* c, float* out, int n, int k,
                            int d, int sms, cudaStream_t s) {
  if constexpr (D > MAX_REG_DIM) {
    const dim3 grid((k + BN - 1) / BN, (n + K1_BM - 1) / K1_BM);
    pairwise_sq_dists_tile_kernel<T><<<grid, K1_THREADS, 0, s>>>(x, c, out, n, k, d);
    return cudaSuccess;
  } else {
    if (d != D) return launch_pairwise<T, D + 1>(x, c, out, n, k, d, sms, s);
    static int per_sm = -1;   // same for every call: the kernel's own limits
    if (per_sm < 0) {
      int v = 0;
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &v, pairwise_sq_dists_kernel<T, D>, P_THREADS, 0);
      if (err != cudaSuccess) return err;
      per_sm = v;
    }
    const int col_tiles = (k + P_COLS - 1) / P_COLS;
    const int row_tiles = (n + P_ROWS - 1) / P_ROWS;
    // about one wave of resident blocks, each walking its column's row tiles
    const int g = max(1, min(row_tiles, max(1, per_sm * sms) / col_tiles));
    const int vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    pairwise_sq_dists_kernel<T, D><<<dim3(col_tiles, g), P_THREADS, 0, s>>>(
        x, c, out, n, k, vec);
    return cudaSuccess;
  }
}

template <typename T, int D = 1>
void launch_assign(const T* x, const T* c, int* labels, float* best, int n, int k,
                   int d, int ks, cudaStream_t s) {
  const int slices = (k + ks - 1) / ks;
  if constexpr (D > MAX_REG_DIM) {
    const dim3 grid((n + K2_BM - 1) / K2_BM, slices);
    assign_tile_kernel<T><<<grid, K2_THREADS, 0, s>>>(x, c, labels, best, n, k, d, ks);
  } else {
    if (d != D) return launch_assign<T, D + 1>(x, c, labels, best, n, k, d, ks, s);
    const dim3 grid((n + AS_BLOCK_ROWS - 1) / AS_BLOCK_ROWS, slices);
    assign_kernel<T, D><<<grid, AS_THREADS, 0, s>>>(x, c, labels, best, n, k, ks);
  }
}

template <typename T, int D = 1>
cudaError_t assign_blocks_per_sm(int d, int* per_sm) {
  if constexpr (D > MAX_REG_DIM) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, assign_tile_kernel<T>, K2_THREADS, 0);
  } else {
    if (d != D) return assign_blocks_per_sm<T, D + 1>(d, per_sm);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, assign_kernel<T, D>, AS_THREADS, 0);
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
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_pairwise(static_cast<const float*>(x), static_cast<const float*>(c),
                          out, n, k, d, sms, s);
  else if (dtype == 1)
    err = launch_pairwise(static_cast<const __nv_bfloat16*>(x),
                          static_cast<const __nv_bfloat16*>(c), out, n, k, d, sms, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Blocks of kd_assign's slice kernel (for this d and dtype) resident at once
// on the whole card, into *slots; ops.py sizes the k-slices from it.
int kd_assign_slots(int d, int dtype, int device, int* slots) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (dtype == 0) err = assign_blocks_per_sm<float>(d, &per_sm);
  else if (dtype == 1) err = assign_blocks_per_sm<__nv_bfloat16>(d, &per_sm);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  *slots = sms * per_sm;
  return cudaSuccess;
}

// k is cut into slices of ks centroids.  With one slice the kernel writes
// labels and best itself; with more, each slice's pairs go to the scratch
// part_labels / part_best, (slices, n) each, and the combine kernel writes
// labels and best.
int kd_assign(const void* x, const void* c, int* labels, float* best,
              int* part_labels, float* part_best, int n, int k, int d, int ks,
              int dtype, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (ks < 1 || (d <= MAX_REG_DIM && ks > KS_MAX)) return cudaErrorInvalidValue;
  const int slices = (k + ks - 1) / ks;
  if (slices > 1 && (part_labels == nullptr || part_best == nullptr))
    return cudaErrorInvalidValue;
  int* out_labels = slices > 1 ? part_labels : labels;
  float* out_best = slices > 1 ? part_best : best;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_assign(static_cast<const float*>(x), static_cast<const float*>(c),
                  out_labels, out_best, n, k, d, ks, s);
  else if (dtype == 1)
    launch_assign(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(c), out_labels, out_best, n, k,
                  d, ks, s);
  else
    return cudaErrorInvalidValue;
  if (slices > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    assign_combine_kernel<<<(n + COMBINE_ROWS - 1) / COMBINE_ROWS, COMBINE_THREADS, 0, s>>>(part_labels, part_best, slices,
                                                     n, labels, best);
  }
  return cudaGetLastError();
}

}  // extern "C"
