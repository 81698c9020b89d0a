// Mamba-2 SSD chunked scan on Hopper (sm_90a): the backward of kernel K4.
//
// Replaces no TPU kernel: the reference trains through XLA's derivative of
// its chunked SSD (src/repro/models/ssm.py::ssd_chunked).  This is the
// gradient of ssd_scan.cu's function: for one (batch row, head), with
// a_t = dt_t A_h <= 0, h_t = exp(a_t) h_{t-1} + dt_t x_t ⊗ B_t and y_t = h_t C_t.
// Given dy and the final state's cotangent dh (zero when absent), the
// state's adjoint g_t = dy_t ⊗ C_t + exp(a_{t+1}) g_{t+1}, from g_S = dh +
// dy_S ⊗ C_S, gives
//    dx_t = dt_t g_t B_t,   dB_t = Σ_{h,p} dt_t x_t[p] g_t[p],
//    dC_t = Σ_{h,p} dy_t[p] h_t[p],   da_t = <g_t, exp(a_t) h_{t-1}>,
//    ddt_t = <x_t, g_t B_t> + A_h da_t,   dA_h = Σ_{b,t} dt_t da_t,
//    dh0 = exp(a_1) g_1.
// B and C (ngroups = 1) are shared by the heads, so dB and dC sum over them.
// f32 in, f32 out.  The plain version is ref.py::ssd_bwd_ref, written in
// these kernels' phases.
//
// Layout.  The model's own, as the forward's: x and dy (batch, S, H, P), dt
// (batch, S, H), A (H,), B and C (batch, S, N), dh and dh0 (batch, H, P,
// N); and the forward's span states (batch·H, n_spans, P, N), the state
// entering each span of SPAN = 4 chunks of Q = 64 positions, which the
// forward keeps when a gradient is needed.
//
// Design: chunks of Q positions (the last zero-filled past S: dt = 0 there
// decays nothing and adds nothing), five kernels in order on one stream.
//  1. ssd_bwd_adj_kernel, grid (batch·H, P/64 x N/64 tiles, chunks): each
//     chunk's local adjoint sum_t exp(cum_t) dy_t ⊗ C_t (cum the running sum
//     of a from the chunk's start), one (64 x 64) tile a block, and the
//     chunk's summed a.
//  2. ssd_bwd_pass_kernel, one thread per state element: walks the chunks
//     backwards from dh, R_{c-1} = exp(sum a over c) R_c + local_c, writes
//     R_c (the adjoint entering chunk c from its right) in place over the
//     local adjoints and dh0 at the start.  Mirrors the forward's pass.
//  3. ssd_bwd_hin_kernel, grid (batch·H, tiles, spans): from the span's
//     saved state, the state entering each chunk of the span, by the
//     forward's update h <- exp(sum a) h + sum_t exp(sum_{s>t} a_s) dt_t x_t
//     ⊗ B_t.
//  4. ssd_bwd_chunk_kernel, grid (batch·H, chunks), 256 threads: the dual
//     quadratic form of the chunk, with L[j][k] = exp(sum_{k<s<=j} a_s) for
//     j >= k, M = L ⊙ C B^T, LD = L ⊙ dy (dt x)^T, K = M ⊙ dy (dt x)^T,
//     w_k = exp(sum_{s>k} a_s), D = exp(sum a) and R, h_in from 2 and 3:
//        g B = M^T dy + w ⊙ B R^T  ->  dx = dt ⊙ g B, <x, g B>;
//        dC_h = exp(cum) ⊙ dy h_in + LD B;   dB_h = LD^T C + w ⊙ (dt x) R;
//        da_i = sum_{j>=i>k} K[j][k] + sum_{j>=i} u_j + sum_{k<i} v_k
//               + D <R, h_in>,
//     u_j = exp(cum_j) (dy h_in)_j · C_j, v_k = w_k ((dt x) R)_k · B_k.  dx
//     and ddt are written; this head's dB and dC rows and its sum of dt·da
//     go to scratch.
//  5. ssd_bwd_sum_kernel: dB and dC as the sum of the heads' rows, head 0
//     first, and dA_h as the sum of its (batch row, chunk) partials, in
//     order.  No atomics anywhere: two calls give the same bits.
//  * Why chunks and not spans for the adjoint: every chunk then has its R
//    and h_in in device memory, so the chunk kernel's blocks are
//    independent (batch·H·chunks of them, 1,536 at the training shape) and
//    hold nothing across chunks.  The cost is the two (batch·H, chunks, P,
//    N) buffers, 50 MB each at the training shape, written once and read
//    once or twice.
//  * da is formed as the inner product itself, split by where the state's
//    and the adjoint's terms come from; the textbook route (a reverse
//    cumsum of the rows and columns of dL ⊙ L) subtracts large terms where
//    heads decay fast.  Every decay is a segment sum of a (warp scans, or a
//    running sum down a column of L), never exp(cum_i - cum_j), whose
//    difference of two running sums loses digits (ssd_scan.cu's note).
//  * Products.  f32 on the CUDA cores, each thread a 4 x 4 block of a 64 x
//    64 output (rows ty + 16 i, columns tx + 16 j) from shared-memory tiles
//    with rows 65 floats apart, so the column reads are free of bank
//    conflicts and the row reads broadcast.  The triangles are computed as
//    full squares (the masked entries are zeros).  A simple first kernel:
//    no tensor cores, plain loads.
//
// Bound on an H100 SXM at the training microbatch of Mamba2-130M (batch 4,
// S 1,024, H 24, P 64, N 128), chunk 64.  Bytes: x, dy and dx 25.2 MB
// each, dt and ddt 0.4 each, B, C, dB and dC 2.1 each, the span states
// 12.6: ~98 MB, 29 us at 3.35 TB/s.  Operations in chunked form, a
// multiply-add counted as 2: per batch row and chunk C B^T on the 2,080
// lower pairs (2 N each); per head and chunk on those pairs dy (dt x)^T
// and M^T dy (2 P each), LD B and LD^T C (2 N each), and the four full
// products dy h_in, (dt x) R, B R^T and the local adjoint (2 Q P N each):
// 8.9 GFLOP, 133 us on the CUDA cores at 67 TFLOP/s, 54 us as 3xTF32 on
// the tensor cores (ssd_scan.cu's route), which bounds it.  These kernels
// issue more: the squares in full and the chunk states recomputed, ~14
// GFLOP of f32 FMA, and ~300 MB of traffic with the chunk buffers and the
// heads' dB and dC rows (50 MB each).  The measured time is in PERF.md.
//
// C interface (loaded with ctypes): ssd_backward launches the five kernels
// on the given stream of the given device, leaves the caller's current
// device as it found it, does not synchronise, allocates nothing (the
// caller passes the scratch), checks every launch, and returns a
// cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "ssd_common.cuh"

namespace {

constexpr int Q = 64;                  // positions per chunk (ssd_scan.cu's)
constexpr int SPAN = 4;                // chunks per span of the saved states
constexpr int T = 64;                  // P and N tile
constexpr int THREADS = 256;           // every kernel
constexpr int LDT = T + 1;             // row stride of a (64 x 64) tile
constexpr int LDQ = Q + 1;             // row stride of a (Q x Q) matrix
constexpr int MAX_N = 256;
static_assert(THREADS == 16 * 16 && T == 64 && Q == 64, "4 x 4 blocks of a 64 x 64 tile");

// The chunk kernel's dynamic shared memory, in floats (152,584 B): L/K, M,
// LD; dy, x, B, C, h_in and R tiles; ds, ec, w, uu, vv, t1, da; the
// block's partials.  The other kernels use static shared memory only.
constexpr int CHUNK_FLOATS = 3 * Q * LDQ + 6 * T * LDT + 7 * Q + THREADS + 4;

// -- device helpers -----------------------------------------------------------

// Sum over the 16 lanes of a half-warp (the threads of one ty), the same
// order in every call.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off, 16);
  return v;
}

// acc[i][j] += sum_{k0 <= k < k1} fa(r_i, k) fb(k, c_j) with r_i = ty + 16 i,
// c_j = tx + 16 j (ty = thread / 16, tx = thread % 16): one 64 x 64 output.
template <class FA, class FB>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], int k0, int k1, FA fa, FB fb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = fa(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = fb(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// dst[r][c] (64 x 64, row stride LDT) = src[r * rs + c] for r < rows and
// c < cols, else 0.  Plain loads: any alignment.
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          size_t rs, int rows, int cols) {
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    const int r = e / T, c = e - r * T;
    dst[r * LDT + c] = r < rows && c < cols ? src[r * rs + c] : 0.f;
  }
}

// Stores the block's 64 x 64 output acc to dst[r * rs + c] for r < rows,
// c < cols.
__device__ __forceinline__ void store_tile(float* __restrict__ dst, size_t rs,
                                           const float (&acc)[4][4], int rows, int cols) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < rows && c < cols) dst[r * rs + c] = acc[i][j];
    }
}

// dt of the chunk's positions (zero past `len`) into ds[Q].
__device__ __forceinline__ void load_dt(float* ds, const float* __restrict__ dt, size_t first,
                                        int H, int len) {
  if (threadIdx.x < Q) ds[threadIdx.x] = threadIdx.x < len ? dt[first + (size_t)threadIdx.x * H] : 0.f;
}

// -- kernels ------------------------------------------------------------------

// Chunk-local adjoints: adj[bh][c] tile = sum_t exp(cum_t) dy_t ⊗ C_t; asum[bh][c]
// = the chunk's sum of a.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_adj_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Cm,
                   float* __restrict__ adj, float* __restrict__ asum, int S, int H, int P,
                   int N, int tiles_n) {
  __shared__ float ys[Q * LDT], cs[Q * LDT];
  __shared__ float ds[Q], ec[Q], w[Q], sums[2];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = (blockIdx.y / tiles_n) * T, n0 = (blockIdx.y % tiles_n) * T;
  const int c = blockIdx.z, nc = (S + Q - 1) / Q, s0 = c * Q, len = min(Q, S - s0);
  const int pw = min(T, P - p0), nw = min(T, N - n0);
  const size_t row0 = (size_t)b * S + s0;
  load_dt(ds, dt, row0 * H + h, H, len);
  load_tile(ys, dy + (row0 * H + h) * P + p0, (size_t)H * P, len, pw);
  load_tile(cs, Cm + row0 * N + n0, N, len, nw);
  __syncthreads();
  chunk_decays(ds, A[h], ec, w, &sums[1], &sums[0]);
  __syncthreads();
  float acc[4][4];
  zero(acc);
  gemm_tile(acc, 0, len, [&](int r, int k) { return ys[k * LDT + r] * ec[k]; },
            [&](int k, int col) { return cs[k * LDT + col]; });
  store_tile(adj + (((size_t)bh * nc + c) * P + p0) * N + n0, N, acc, pw, nw);
  if (blockIdx.y == 0 && threadIdx.x == 0) asum[(size_t)bh * nc + c] = sums[0];
}

// The adjoint across chunks, one thread per state element, backwards from
// dh (or 0): R_{nc-1} = dh, R_{c-1} = exp(asum_c) R_c + local_c, each R_c
// written in place over local_c; dh0 = exp(asum_0) R_0 + local_0.  Eight
// chunks' loads are in flight at a time.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_kernel(const float* __restrict__ dh, float* __restrict__ adj,
                    const float* __restrict__ asum, float* __restrict__ dh0, int PN, int nc) {
  const int bh = blockIdx.x;
  const int e = blockIdx.y * THREADS + threadIdx.x;
  if (e >= PN) return;
  float g = dh != nullptr ? dh[(size_t)bh * PN + e] : 0.f;
  float* st = adj + (size_t)bh * nc * PN + e;
  const float* ld = asum + (size_t)bh * nc;
  for (int top = nc - 1; top >= 0; top -= 8) {
    float local[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (top - k >= 0) local[k] = st[(size_t)(top - k) * PN];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = top - k;
      if (c < 0) break;
      st[(size_t)c * PN] = g;
      g = fmaf(expf(ld[c]), g, local[k]);
    }
  }
  dh0[(size_t)bh * PN + e] = g;
}

// The state entering each chunk of a span, from the span's saved state:
// hin[bh][c] for c in the span, one (64 x 64) tile a block.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_hin_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ states, float* __restrict__ hin, int S, int H,
                   int P, int N, int tiles_n) {
  __shared__ float xs[Q * LDT], bs[Q * LDT];
  __shared__ float ds[Q], ec[Q], w[Q], sums[2];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = (blockIdx.y / tiles_n) * T, n0 = (blockIdx.y % tiles_n) * T;
  const int pw = min(T, P - p0), nw = min(T, N - n0);
  const int nc = (S + Q - 1) / Q, n_spans = (nc + SPAN - 1) / SPAN;
  const int c0 = blockIdx.z * SPAN, c1 = min(nc, c0 + SPAN);
  const float a_h = A[h];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* src = states + (((size_t)bh * n_spans + blockIdx.z) * P + p0) * N + n0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, col = tx + 16 * j;
      acc[i][j] = r < pw && col < nw ? src[(size_t)r * N + col] : 0.f;
    }
  for (int c = c0; c < c1; ++c) {
    store_tile(hin + (((size_t)bh * nc + c) * P + p0) * N + n0, N, acc, pw, nw);
    if (c + 1 == c1) break;
    const int s0 = c * Q, len = min(Q, S - s0);
    const size_t row0 = (size_t)b * S + s0;
    __syncthreads();                  // the previous chunk's tiles read
    load_dt(ds, dt, row0 * H + h, H, len);
    load_tile(xs, x + (row0 * H + h) * P + p0, (size_t)H * P, len, pw);
    load_tile(bs, Bm + row0 * N + n0, N, len, nw);
    __syncthreads();
    chunk_decays(ds, a_h, ec, w, &sums[1], &sums[0]);
    __syncthreads();
    const float decay = sums[1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
    gemm_tile(acc, 0, len, [&](int r, int k) { return xs[k * LDT + r] * (w[k] * ds[k]); },
              [&](int k, int col) { return bs[k * LDT + col]; });
  }
}

// One chunk of one (batch row, head): dx, ddt, this head's dB and dC rows,
// and its sum of dt·da (see the note above).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ dy,
                     const float* __restrict__ R, const float* __restrict__ hin,
                     float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBh,
                     float* __restrict__ dCh, float* __restrict__ dApart, int S, int H, int P,
                     int N) {
  extern __shared__ __align__(16) float smem[];
  float* Lm = smem;                   // [Q][LDQ] L, then K, then K's exclusive row sums
  float* Mm = Lm + Q * LDQ;           // [Q][LDQ] C B^T, then M
  float* Dm = Mm + Q * LDQ;           // [Q][LDQ] dy (dt x)^T, then LD
  float* ys = Dm + Q * LDQ;           // [Q][LDT] dy, a P tile
  float* xs = ys + T * LDT;           // [Q][LDT] x, a P tile
  float* bs = xs + T * LDT;           // [Q][LDT] B, an N tile
  float* cs = bs + T * LDT;           // [Q][LDT] C, an N tile
  float* hs = cs + T * LDT;           // [T][LDT] h_in, a (P, N) tile
  float* rs = hs + T * LDT;           // [T][LDT] R, a (P, N) tile
  float* ds = rs + T * LDT;           // [Q] dt
  float* ec = ds + Q;                 // [Q] exp(cum_i)
  float* w = ec + Q;                  // [Q] exp(sum_{s>i} a_s)
  float* uu = w + Q;                  // [Q] (dy h_in)_j · C_j
  float* vv = uu + Q;                 // [Q] ((dt x) R)_k · B_k
  float* t1 = vv + Q;                 // [Q] <x_i, (g B)_i>
  float* da = t1 + Q;                 // [Q] da_i
  float* red = da + Q;                // [THREADS] partials of <R, h_in>
  float* sums = red + THREADS;        // [4] sum a, exp(sum a), D <R, h_in>

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int c = blockIdx.y, nc = (S + Q - 1) / Q, s0 = c * Q, len = min(Q, S - s0);
  const size_t row0 = (size_t)b * S + s0;
  const size_t state0 = ((size_t)bh * nc + c) * P * N;
  const float a_h = A[h];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_dt(ds, dt, row0 * H + h, H, len);
  if (tid < Q) uu[tid] = vv[tid] = t1[tid] = 0.f;
  __syncthreads();
  chunk_decays(ds, a_h, ec, w, &sums[1], &sums[0]);   // warps 0 and 1
  if (tid >= 64 && tid < 64 + Q) {              // warps 2 and 3: column k of L
    const int k = tid - 64;
    float run = 0.f;
    for (int j = 0; j < Q; ++j) {
      if (j > k) run += ds[j] * a_h;
      Lm[j * LDQ + k] = j >= k ? expf(run) : 0.f;
    }
  }

  // C B^T and dy (dt x)^T
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < N; n0 += T) {
    const int nw = min(T, N - n0);
    __syncthreads();
    load_tile(cs, Cm + row0 * N + n0, N, len, nw);
    load_tile(bs, Bm + row0 * N + n0, N, len, nw);
    __syncthreads();
    gemm_tile(acc, 0, nw, [&](int r, int k) { return cs[r * LDT + k]; },
              [&](int k, int col) { return bs[col * LDT + k]; });
  }
  store_tile(Mm, LDQ, acc, Q, Q);
  zero(acc);
  for (int p0 = 0; p0 < P; p0 += T) {
    const int pw = min(T, P - p0);
    __syncthreads();
    load_tile(ys, dy + (row0 * H + h) * P + p0, (size_t)H * P, len, pw);
    load_tile(xs, x + (row0 * H + h) * P + p0, (size_t)H * P, len, pw);
    __syncthreads();
    gemm_tile(acc, 0, pw, [&](int r, int k) { return ys[r * LDT + k]; },
              [&](int k, int col) { return xs[col * LDT + k] * ds[col]; });
  }
  store_tile(Dm, LDQ, acc, Q, Q);
  __syncthreads();

  // M = L ⊙ C B^T, LD = L ⊙ dy (dt x)^T, K = M ⊙ dy (dt x)^T; then the
  // first term of da, sum_{j>=i} sum_{k<i} K[j][k]: each row's exclusive
  // prefix sums, then each column's sum from the diagonal down
  for (int e = tid; e < Q * Q; e += THREADS) {
    const int j = e / Q, k = e - j * Q;
    const float l = Lm[j * LDQ + k], m = l * Mm[j * LDQ + k], d = Dm[j * LDQ + k];
    Mm[j * LDQ + k] = m;
    Dm[j * LDQ + k] = l * d;
    Lm[j * LDQ + k] = m * d;
  }
  __syncthreads();
  if (tid < Q) {
    float run = 0.f;
    for (int k = 0; k < Q; ++k) {
      const float v = Lm[tid * LDQ + k];
      Lm[tid * LDQ + k] = run;
      run += v;
    }
  }
  __syncthreads();
  if (tid < Q) {
    float s = 0.f;
    for (int j = tid; j < Q; ++j) s += Lm[j * LDQ + tid];
    da[tid] = s;
  }

  // N tiles: dC_h = exp(cum) ⊙ dy h_in + LD B, dB_h = LD^T C + w ⊙ (dt x) R,
  // with uu, vv and the partials of <R, h_in> beside them
  float part = 0.f;
  for (int n0 = 0; n0 < N; n0 += T) {
    const int nw = min(T, N - n0);
    float yh[4][4], xr[4][4];
    zero(yh);
    zero(xr);
    __syncthreads();
    load_tile(cs, Cm + row0 * N + n0, N, len, nw);
    load_tile(bs, Bm + row0 * N + n0, N, len, nw);
    for (int p0 = 0; p0 < P; p0 += T) {
      const int pw = min(T, P - p0);
      __syncthreads();
      load_tile(ys, dy + (row0 * H + h) * P + p0, (size_t)H * P, len, pw);
      load_tile(xs, x + (row0 * H + h) * P + p0, (size_t)H * P, len, pw);
      load_tile(hs, hin + state0 + (size_t)p0 * N + n0, N, pw, nw);
      load_tile(rs, R + state0 + (size_t)p0 * N + n0, N, pw, nw);
      __syncthreads();
      gemm_tile(yh, 0, pw, [&](int r, int k) { return ys[r * LDT + k]; },
                [&](int k, int col) { return hs[k * LDT + col]; });
      gemm_tile(xr, 0, pw, [&](int r, int k) { return xs[r * LDT + k] * ds[r]; },
                [&](int k, int col) { return rs[k * LDT + col]; });
      for (int e = tid; e < T * T; e += THREADS) {
        const int r = e / T, col = e - r * T;
        part = fmaf(hs[r * LDT + col], rs[r * LDT + col], part);
      }
    }
    float dc[4][4], db[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float pu = 0.f, pv = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        pu = fmaf(yh[i][j], cs[r * LDT + col], pu);
        pv = fmaf(xr[i][j], bs[r * LDT + col], pv);
        dc[i][j] = ec[r] * yh[i][j];
        db[i][j] = w[r] * xr[i][j];
      }
      pu = half_warp_sum(pu);
      pv = half_warp_sum(pv);
      if (tx == 0) {
        uu[r] += pu;
        vv[r] += pv;
      }
    }
    gemm_tile(dc, 0, len, [&](int r, int k) { return Dm[r * LDQ + k]; },
              [&](int k, int col) { return bs[k * LDT + col]; });
    gemm_tile(db, 0, len, [&](int r, int k) { return Dm[k * LDQ + r]; },
              [&](int k, int col) { return cs[k * LDT + col]; });
    store_tile(dCh + (row0 * H + h) * N + n0, (size_t)H * N, dc, len, nw);
    store_tile(dBh + (row0 * H + h) * N + n0, (size_t)H * N, db, len, nw);
  }

  // P tiles: g B = M^T dy + w ⊙ B R^T, dx = dt ⊙ g B, t1 = <x, g B>
  for (int p0 = 0; p0 < P; p0 += T) {
    const int pw = min(T, P - p0);
    __syncthreads();
    load_tile(ys, dy + (row0 * H + h) * P + p0, (size_t)H * P, len, pw);
    load_tile(xs, x + (row0 * H + h) * P + p0, (size_t)H * P, len, pw);
    __syncthreads();
    float gb[4][4], br[4][4];
    zero(gb);
    zero(br);
    gemm_tile(gb, 0, len, [&](int r, int k) { return Mm[k * LDQ + r]; },
              [&](int k, int col) { return ys[k * LDT + col]; });
    for (int n0 = 0; n0 < N; n0 += T) {
      const int nw = min(T, N - n0);
      __syncthreads();
      load_tile(bs, Bm + row0 * N + n0, N, len, nw);
      load_tile(rs, R + state0 + (size_t)p0 * N + n0, N, pw, nw);
      __syncthreads();
      gemm_tile(br, 0, nw, [&](int r, int k) { return bs[r * LDT + k]; },
                [&](int k, int col) { return rs[col * LDT + k]; });
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float pt = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        gb[i][j] = fmaf(w[r], br[i][j], gb[i][j]);
        pt = fmaf(xs[r * LDT + col], gb[i][j], pt);
        gb[i][j] *= ds[r];
      }
      pt = half_warp_sum(pt);
      if (tx == 0) t1[r] += pt;
    }
    store_tile(dx + (row0 * H + h) * P + p0, (size_t)H * P, gb, len, pw);
  }

  // da, ddt and this (batch row, chunk)'s sum of dt·da
  red[tid] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int t = 0; t < THREADS; ++t) s += red[t];
    sums[2] = sums[1] * s;
  }
  __syncthreads();
  if (tid < Q) {
    float su = 0.f, sv = 0.f;
    for (int j = tid; j < Q; ++j) su = fmaf(ec[j], uu[j], su);
    for (int k = 0; k < tid; ++k) sv = fmaf(w[k], vv[k], sv);
    const float d = da[tid] + su + sv + sums[2];
    da[tid] = d;
    if (tid < len) ddt[(row0 + tid) * H + h] = fmaf(a_h, d, t1[tid]);
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < Q; ++i) s = fmaf(ds[i], da[i], s);
    dApart[(size_t)bh * nc + c] = s;
  }
}

// dB and dC: the heads' rows summed, head 0 first; the last block: dA_h,
// the sum of its (batch row, chunk) partials in order.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                   const float* __restrict__ dApart, float* __restrict__ dB,
                   float* __restrict__ dC, float* __restrict__ dA, int batch, int S, int H,
                   int N) {
  const int nc = (S + Q - 1) / Q;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += THREADS) {
      float s = 0.f;
      for (int b = 0; b < batch; ++b)
        for (int c = 0; c < nc; ++c) s += dApart[((size_t)b * H + h) * nc + c];
      dA[h] = s;
    }
    return;
  }
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (size_t)batch * S * N) return;
  const size_t row = e / N, n = e - row * N;
  const float* pb = dBh + row * H * N + n;
  const float* pc = dCh + row * H * N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[(size_t)h * N];
    sc += pc[(size_t)h * N];
  }
  dB[e] = sb;
  dC[e] = sc;
}

}  // namespace

extern "C" {

// x (batch, S, H, P), dt (batch, S, H), A (H,), Bm and Cm (batch, S, N), dy
// (batch, S, H, P), dh (batch, H, P, N) or null, states (batch·H, n_spans,
// P, N) the forward's span states.  Scratch: adj and hin (batch·H, nc, P, N),
// asum and dApart (batch·H, nc), dBh and dCh (batch, S, H, N), with nc =
// ceil(S / 64) and n_spans = ceil(nc / 4).  Out: dx (batch, S, H, P), ddt
// (batch, S, H), dA (H,), dB and dC (batch, S, N), dh0 (batch, H, P, N).
// All float32 and contiguous; 0 < N <= 256.
int ssd_backward(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* dy, const void* dh, const void* states,
                 void* adj, void* asum, void* hin, void* dBh, void* dCh, void* dApart,
                 void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0, int batch,
                 int S, int H, int P, int N, int device, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      (long long)batch * H > INT_MAX || (long long)P * N > INT_MAX)
    return cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q, n_spans = (nc + SPAN - 1) / SPAN;
  const int tiles_p = (P + T - 1) / T, tiles_n = (N + T - 1) / T, PN = P * N;
  const long long sum_blocks = ((long long)batch * S * N + THREADS - 1) / THREADS + 1;
  if ((long long)tiles_p * tiles_n > 65535 || nc > 65535 || (PN + THREADS - 1) / THREADS > 65535 ||
      sum_blocks > INT_MAX)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *dtf = static_cast<const float*>(dt),
              *Af = static_cast<const float*>(A), *Bf = static_cast<const float*>(Bm),
              *Cf = static_cast<const float*>(Cm), *dyf = static_cast<const float*>(dy);
  float *adjf = static_cast<float*>(adj), *asumf = static_cast<float*>(asum),
        *hinf = static_cast<float*>(hin), *dApf = static_cast<float*>(dApart),
        *dBhf = static_cast<float*>(dBh), *dChf = static_cast<float*>(dCh);
  cudaError_t err;

  ssd_bwd_adj_kernel<<<dim3(batch * H, tiles_p * tiles_n, nc), THREADS, 0, s>>>(
      dyf, dtf, Af, Cf, adjf, asumf, S, H, P, N, tiles_n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_pass_kernel<<<dim3(batch * H, (PN + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(dh), adjf, asumf, static_cast<float*>(dh0), PN, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_hin_kernel<<<dim3(batch * H, tiles_p * tiles_n, n_spans), THREADS, 0, s>>>(
      xf, dtf, Af, Bf, static_cast<const float*>(states), hinf, S, H, P, N, tiles_n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem = CHUNK_FLOATS * (int)sizeof(float);
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<<<dim3(batch * H, nc), THREADS, smem, s>>>(
      xf, dtf, Af, Bf, Cf, dyf, adjf, hinf, static_cast<float*>(dx), static_cast<float*>(ddt),
      dBhf, dChf, dApf, S, H, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_sum_kernel<<<(unsigned)sum_blocks, THREADS, 0, s>>>(
      dBhf, dChf, dApf, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), batch, S, H, N);
  return cudaGetLastError();
}

}  // extern "C"
