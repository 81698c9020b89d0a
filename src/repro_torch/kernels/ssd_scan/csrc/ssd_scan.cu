// Mamba-2 SSD chunked scan on Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel
//    src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas (body _ssd_kernel):
//    per chunk of Q positions,
//        y = (C B^T ⊙ L)(dt·x) + exp(cum) · C h^T,   L[i,j] = exp(cum_i - cum_j), j <= i
//        h <- exp(cum_Q) h + sum_s exp(cum_Q - cum_s) (dt·x)_s ⊗ B_s
//    with cum the running sum of a = dt·A inside the chunk, and the final
//    (P, N) state emitted.  B and C (ngroups = 1) are shared across heads.
//    All math in f32 (no TF32), f32 outputs.
//
// Layout.  The model's own: x (batch, S, H, P), dt (batch, S, H), A (H,),
// B and C (batch, S, N), optional h0 (batch, H, P, N); y (batch, S, H, P)
// and h (batch, H, P, N).  All contiguous.  The TPU wrapper's two moveaxis
// copies to a head-major layout are not needed: the kernel computes its own
// offsets into the model layout.
//
// Bound on an H100 SXM: operations.  At the serving micro-batch of
// Mamba2-130M (batch 4, S 1,024, H 24, P 64, N 128) the function moves
// ~58 MB (x and y 25.2 MB each, B and C 4.2, h 3.1), 17 us at 3.35 TB/s.
// In chunked form at Q = 64 it needs ~3.7 GFLOP (C B^T once per batch and
// chunk, the lower triangles only; 2 Q^2 P / 2 for the intra-chunk product
// and 4 Q P N for the carry-in and the state update per head and chunk),
// 55 us at the 67 TFLOP/s f32 CUDA-core rate.  This first kernel does more
// than that (~10 GFLOP: C B^T and full Q x Q squares recomputed by every
// block) on the CUDA cores, from shared memory.
//
// Design.  The TPU grid (B·H, S/Q) carries the state in VMEM across its
// sequential chunk axis; Hopper's blocks run in no order, so the chunk loop
// runs inside the block:
//  * grid (batch·H, ceil(P / 16)): the state's rows are independent
//    (y[:, p] needs only h[p, :] and x[:, p]), so each block of 256 threads
//    owns 16 of them and walks the chunks in order, its (16, N) slice of the
//    state in shared memory.  384 blocks at the serving shape;
//  * Q = 64, the kernel's own chunk length, chosen for shared memory (a
//    256 x 256 f32 score tile would not fit); the result is the same
//    function up to f32 rounding.  A ragged last chunk is zero-filled
//    (dt = 0 there, so it adds nothing and decays nothing) and its rows
//    past S are not stored;
//  * per chunk: stage B, C, dt·x and dt; the segment sums
//    seg[i][j] = sum_{j<s<=i} a_s as running sums down each column, one
//    thread per column, and cum_i by a warp-shuffle scan; C B^T in 4 x 4
//    register micro-tiles, each score times exp(seg[i][j]) only where
//    j <= i (the exponential is never taken above the diagonal, where it
//    would overflow); y = intra + carry-in, stored in the model layout;
//    then the state update, weighted by exp(seg[Q-1][j]);
//  * numerics: the TPU kernel (and the chunked reference) forms the decay
//    as exp(cum_i - cum_j), a difference of two running sums; where a
//    head decays fast these reach -100 or less within a chunk and the
//    difference keeps only ~1e-5 of relative accuracy (errors of 1.1e-3
//    against the float64 recurrence at the serving shape, |y| up to ~300,
//    where 2e-4 is asked).  The column sums add only the terms of each
//    segment;
//  * the +1 row pads of the (Q, N) and (16, N) tiles keep column-wise reads
//    free of bank conflicts.
// Shared memory: 2 Q (N + 1) + Q (Q + 1) + 2 Q 16 + 16 (N + 1) + 3 Q + 1
// floats: 99,908 B at N = 128, 2 blocks per SM.
//
// C interface (loaded with ctypes): ssd_forward launches on the given stream
// of the given device, leaves the caller's current device as it found it,
// does not synchronise, and returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int Q = 64;                 // positions per chunk
constexpr int PT = 16;                // state rows (head-dim columns) per block
constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;       // score micro-tiling
constexpr int TM = Q / TY;            // score rows per thread (4)
constexpr int TN = Q / TX;            // score columns per thread (4)
constexpr int YROWS = Q * PT / THREADS;   // y rows per thread (4)
constexpr int MLD = Q + 1;            // row stride of the score tile
constexpr int HALF = THREADS / 2;     // state update: threads per 8-row half
constexpr int MAX_N = 256;

size_t smem_floats(int N) {
  const size_t ld = (size_t)N + 1;
  return 2 * Q * ld + (size_t)Q * MLD + 2 * (size_t)Q * PT + PT * ld + 3 * Q + 1;
}

__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hout, int S, int H,
                int P, int N) {
  extern __shared__ float smem[];
  const int ld = N + 1;
  float* bs = smem;                   // [Q][ld]  B rows of the chunk
  float* cs = bs + Q * ld;            // [Q][ld]  C rows
  float* ms = cs + Q * ld;            // [Q][MLD] (C B^T ⊙ L), zero above the diagonal
  float* xs = ms + Q * MLD;           // [Q][PT]  dt·x
  float* wx = xs + Q * PT;            // [Q][PT]  exp(seg[Q-1][j]) dt·x
  float* hs = wx + Q * PT;            // [PT][ld] the block's slice of the state
  float* dts = hs + PT * ld;          // [Q]
  float* sfx = dts + Q;               // [Q] seg[Q-1][j] = sum_{j<s<Q} dt·A
  float* ecum = sfx + Q;              // [Q] exp(cum_i), cum_i = sum_{s<=i} dt·A
  float* cdecay = ecum + Q;           // [1] exp(cum_{Q-1})

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PT;
  const int pw = min(PT, P - p0);     // state rows of this block that exist
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const size_t hbase = ((size_t)bh * P + p0) * N;   // h[b, h, p0, 0]

  for (int e = tid; e < PT * N; e += THREADS) {
    const int r = e / N, n = e - r * N;
    hs[r * ld + n] = (h0 != nullptr && r < pw) ? h0[hbase + (size_t)r * N + n] : 0.f;
  }

  const int tx = tid % TX, ty = tid / TX;     // scores
  const int yc = tid % PT, yr = tid / PT;     // y: column yc, rows yr + 16 k
  const int half = tid / HALF, col = tid % HALF;   // state: rows 8 half .. +7

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int len = min(Q, S - s0);
    // 1. stage the chunk; rows past len are zero
    const float* bsrc = Bm + ((size_t)b * S + s0) * N;
    const float* csrc = Cm + ((size_t)b * S + s0) * N;
    for (int e = tid; e < Q * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      const bool in = r < len;
      bs[r * ld + n] = in ? bsrc[e] : 0.f;
      cs[r * ld + n] = in ? csrc[e] : 0.f;
    }
    for (int e = tid; e < Q * PT; e += THREADS) {
      const int r = e / PT, c = e - r * PT;
      float v = 0.f;
      if (r < len && c < pw) {
        const size_t row = ((size_t)b * S + s0 + r) * H + h;
        v = x[row * P + p0 + c] * dt[row];
      }
      xs[e] = v;
    }
    if (tid < Q) dts[tid] = tid < len ? dt[((size_t)b * S + s0 + tid) * H + h] : 0.f;
    __syncthreads();

    // 2. decays of a = dt·A.  Threads j < Q: seg[i][j] (i > j) into ms by a
    //    running sum down column j, and sfx[j].  The next warp: cum by an
    //    inclusive shuffle scan, two positions per lane.
    if (tid < Q) {
      float acc = 0.f;
      for (int i = tid + 1; i < Q; ++i) {
        acc += dts[i] * a_h;
        ms[i * MLD + tid] = acc;
      }
      ms[tid * MLD + tid] = 0.f;
      sfx[tid] = acc;
    } else if (tid < Q + 32) {
      const int lane = tid - Q;
      const float a0 = dts[2 * lane] * a_h, a1 = dts[2 * lane + 1] * a_h;
      float v = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      float before = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane == 0) before = 0.f;
      ecum[2 * lane] = expf(before + a0);
      ecum[2 * lane + 1] = expf(v);
      if (lane == 31) cdecay[0] = expf(v);
    }
    __syncthreads();

    // 3. scores C B^T (4 x 4 per thread) times exp(seg) where j <= i; wx
    {
      float sc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) cv[i] = cs[(ty + TY * i) * ld + n];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = bs[(tx + TX * j) * ld + n];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = ty + TY * i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = tx + TX * j;
          ms[row * MLD + c] = c <= row ? sc[i][j] * expf(ms[row * MLD + c]) : 0.f;
        }
      }
      for (int e = tid; e < Q * PT; e += THREADS) wx[e] = expf(sfx[e / PT]) * xs[e];
    }
    __syncthreads();

    // 4. y = intra-chunk + carry-in, rows yr + 16 k of column yc
    {
      float acc[YROWS], carry[YROWS];
#pragma unroll
      for (int k = 0; k < YROWS; ++k) acc[k] = carry[k] = 0.f;
      for (int j = 0; j < len; ++j) {
        const float xv = xs[j * PT + yc];
#pragma unroll
        for (int k = 0; k < YROWS; ++k)
          acc[k] = fmaf(ms[(yr + 16 * k) * MLD + j], xv, acc[k]);
      }
      for (int n = 0; n < N; ++n) {
        const float hv = hs[yc * ld + n];
#pragma unroll
        for (int k = 0; k < YROWS; ++k)
          carry[k] = fmaf(cs[(yr + 16 * k) * ld + n], hv, carry[k]);
      }
      if (yc < pw) {
#pragma unroll
        for (int k = 0; k < YROWS; ++k) {
          const int i = yr + 16 * k;
          if (i < len)
            y[(((size_t)b * S + s0 + i) * H + h) * P + p0 + yc] =
                fmaf(ecum[i], carry[k], acc[k]);
        }
      }
    }
    __syncthreads();

    // 5. state update: column n of rows 8 half .. 8 half + 7
    const float decay = cdecay[0];
    for (int n = col; n < N; n += HALF) {
      float hv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) hv[k] = decay * hs[(8 * half + k) * ld + n];
      for (int j = 0; j < len; ++j) {
        const float bv = bs[j * ld + n];
        const float* w = wx + j * PT + 8 * half;
#pragma unroll
        for (int k = 0; k < 8; ++k) hv[k] = fmaf(w[k], bv, hv[k]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) hs[(8 * half + k) * ld + n] = hv[k];
    }
    __syncthreads();   // the next chunk overwrites the staged tiles
  }

  for (int n = col; n < N; n += HALF)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = 8 * half + k;
      if (r < pw) hout[hbase + (size_t)r * N + n] = hs[r * ld + n];
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

// Dynamic shared memory of one block at state size N, in bytes.
int ssd_smem_bytes(int N) { return (int)(smem_floats(N) * sizeof(float)); }

// x (batch, S, H, P), dt (batch, S, H), A (H,), Bm and Cm (batch, S, N),
// h0 (batch, H, P, N) or null; y (batch, S, H, P), hout (batch, H, P, N).
// All float32 and contiguous; 0 < N <= 256.
int ssd_forward(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* h0, void* y, void* hout, int batch,
                int S, int H, int P, int N, int device, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      (long long)batch * H > INT_MAX || (P + PT - 1) / PT > 65535)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int smem = ssd_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * H, (P + PT - 1) / PT);
  ssd_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), S, H, P, N);
  return cudaGetLastError();
}

}  // extern "C"
