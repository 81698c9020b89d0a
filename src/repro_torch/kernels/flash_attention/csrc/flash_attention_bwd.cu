// Causal GQA flash-attention backward on Hopper (sm_90a): K3's gradient.
//
// No TPU kernel to replace: the reference trains through its model's
// attention (src/repro/models/attention.py attend_full / attend_chunked),
// which XLA differentiates, and its Pallas forward
// (src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas) has
// no custom VJP.  Here training runs K3's forward (flash_attention.cu, which
// then also writes each row's log-sum-exp), so its gradient is a kernel too.
//
// Math (the FlashAttention-2 backward), per q row b (kv row b / G): with
// s = scale q k^T, P = exp(s - lse) from the forward's lse, and
// D = rowsum(dO o O):
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//     dQ = scale dS K,  dK = scale dS^T Q.
// A pair that the forward masks (key > query, key or query >= S, or
// key <= query - window) gets P = 0 explicitly: no exponent of -1e30 is
// ever taken, so a window tile that is fully masked for a row contributes
// exact zeros (the forward's NaN of PERF.md cannot arise here), and a ragged
// S is masked like the forward's.  Dh up to 128; the wrapper raises for more.
//
// Three kernels a call, on the caller's stream:
//  (a) fa_bwd_delta_kernel: D = rowsum(dO o O) in f32, one warp a row.
//  (b) dK, dV: one block per (kv row, 64-key tile).  It loops over the G
//      query heads of its group and, for each, over the 64-query tiles that
//      can see its keys (from the diagonal tile to the last one the window
//      reaches), recomputes P and dS, and accumulates dK and dV in f32
//      registers; it writes them once.  GQA's sum over the group is thus a
//      loop in one block in a fixed order, with no atomics: two runs give the
//      same bits.
//  (c) dQ: one block per (q row, 64-query tile), over the key tiles the tile
//      sees (the forward's loop), accumulating dQ in f32 registers.
// (b) and (c) both recompute s and dP: 7 tile products where 5 would do.
// FlashAttention-2 computes dQ inside (b) with atomics, whose order of
// addition changes from run to run.
//
// bf16 (the training dtype): mma.sync m16n8k16 with f32 accumulation, 4
// warps of 16 rows, tiles staged as bf16 in shared memory with a 16-byte row
// pad (the forward's staging, cp.async where rows are 16-byte aligned).
// Products of bf16 inputs are exact in f32.  The f32 P and dS enter the
// products dV, dK and dQ as hi/lo bf16 pairs (the forward's split of P), so
// each keeps ~16 bits; the kernel then computes in f32 up to summation
// order and rounds dq, dk and dv to bf16 once, as mha_bwd_ref does.  In (b)
// each warp owns 16 keys: S^T = K Q^T and dP^T = V dO^T come out with keys
// as rows, so P^T and dS^T are already A fragments for P^T dO and dS^T Q
// (ldmatrix.trans on the dO and Q tiles), and a 64-query tile is taken in
// two passes of 32 queries, which holds the scores to 32 floats a thread
// beside the 2 x 64 of dK and dV at Dh 128.  Up to Dh 64 the warp's K and V
// fragments ((b)) or q and dO fragments ((c)) live in registers; above, they
// are read from shared memory each tile.  No double buffering: each tile is
// staged, waited for, then computed.
//
// f32: CUDA cores, 256 threads as a 16 x 16 grid (the forward's f32
// layout): each thread owns 4 rows and 4 columns of a tile's scores and 4
// rows by DN columns of the accumulators; P, dS (and P^T, dS^T) pass to the
// second products through shared tiles with a +1 row pad.
//
// Bound on an H100 SXM: operations.  The gradient needs five products over
// the visible (query, key) pairs, 2 Dh operations each (QK^T, dO V^T, P^T dO,
// dS K, dS^T Q; 2.5x the forward's two); at Qwen2-0.5B's training shape
// (BH 56, BKV 8, S 1,024, Dh 64) that is ~18.8 GFLOP, 19 us at the 989
// TFLOP/s bf16 peak, against ~2.3 us to move q, k, v, o, dO, lse in and
// dq, dk, dv out at 3.35 TB/s.  This simple design issues 7 products (10
// with the hi/lo halves), stages every tile synchronously, and runs (b) on
// BKV x S/64 blocks (128 at that shape): later work (wgmma, TMA, dQ by a
// deterministic second pass or split over more blocks) is in ROADMAP.
//
// C interface (loaded with ctypes): fa_backward launches (a), (b) and (c)
// on the given stream of the given device, leaves the caller's current
// device as it found it, does not synchronise, and returns a cudaError_t
// (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fa_common.cuh"

namespace {

constexpr int MAX_BWD_DH = 128;
constexpr int DELTA_ROWS = THREADS / 32;    // rows of D a block, one warp each

// Whether query `qry` sees key `key` (absolute positions) in the forward.
__device__ __forceinline__ bool visible(int qry, int key, int S, int window) {
  return key <= qry && qry < S && (window == 0 || key + window > qry);
}

// The last query tile that sees a key of the tile starting at k0.
__device__ __forceinline__ int last_q_tile(int k0, int S, int window) {
  const int last = (S - 1) / BQ;
  return window > 0 ? min(last, (k0 + TK - 1 + window - 1) / BQ) : last;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// -- (a) D = rowsum(dO o O) ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int rows, int dh) {
  const int row = blockIdx.x * DELTA_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                  // the whole warp: one row a warp
  const T* orow = o + (size_t)row * dh;
  const T* drow = dout + (size_t)row * dh;
  float acc = 0.f;
  for (int c = lane; c < dh; c += 32) acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// -- f32: CUDA cores -----------------------------------------------------------

template <int DN>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int S, int dh, int group, float scale,
                     int window) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;                   // [BQ][ld], q * scale (the forward's s)
  float* dos = qs + BQ * ld;          // [BQ][ld]
  float* ks = dos + BQ * ld;          // [TK][ld]
  float* vs = ks + TK * ld;           // [TK][ld]
  float* dss = vs + TK * ld;          // [BQ][PLD], dS of one tile
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int q0 = qt * BQ;
  const float* kb = k + (size_t)(bh / group) * S * dh;
  const float* vb = v + (size_t)(bh / group) * S * dh;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  stage(qs, q + ((size_t)bh * S + q0) * dh, S - q0, dh, ld, scale);
  stage(dos, dout + ((size_t)bh * S + q0) * dh, S - q0, dh, ld, 1.f);
  float rl[TM], rd[TM], acc[TM][DN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + TY * i;
    rl[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    rd[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  for (int t = first_tile(q0, window); t <= qt; ++t) {
    const int k0 = t * TK;
    stage(ks, kb + (size_t)k0 * dh, S - k0, dh, ld, 1.f);
    stage(vs, vb + (size_t)k0 * dh, S - k0, dh, ld, 1.f);
    __syncthreads();

    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[TM], e[TM], b[TN], c[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = qs[(ty + TY * i) * ld + d];
        e[i] = dos[(ty + TY * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b[j] = ks[(tx + TX * j) * ld + d];
        c[j] = vs[(tx + TX * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(e[i], c[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = q0 + ty + TY * i, key = k0 + tx + TX * j;
        const float p = visible(row, key, S, window) ? expf(s[i][j] - rl[i]) : 0.f;
        dss[(ty + TY * i) * PLD + tx + TX * j] = p * (dp[i][j] - rd[i]);
      }
    __syncthreads();   // dss complete

    const int keys = min(TK, S - k0);
    for (int c = 0; c < keys; ++c) {
      float ds[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) ds[i] = dss[(ty + TY * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int col = tx + TX * j;
        const float kv = col < dh ? ks[c * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
    __syncthreads();   // the next tile overwrites ks, vs and dss
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    float* out = dq + ((size_t)bh * S + row) * dh;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = tx + TX * j;
      if (col < dh) out[col] = acc[i][j] * scale;
    }
  }
}

template <int DN>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int S, int dh,
                       int group, float scale, int window) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* ks = smem;                   // [TK][ld]
  float* vs = ks + TK * ld;           // [TK][ld]
  float* qs = vs + TK * ld;           // [BQ][ld], q * scale: dK needs no rescale
  float* dos = qs + BQ * ld;          // [BQ][ld]
  float* ps = dos + BQ * ld;          // [TK][PLD], P^T of one tile
  float* dss = ps + TK * PLD;         // [TK][PLD], dS^T of one tile
  float* lses = dss + TK * PLD;       // [BQ]
  float* dels = lses + BQ;            // [BQ]
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * TK;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  stage(ks, k + ((size_t)bkv * S + k0) * dh, S - k0, dh, ld, 1.f);
  stage(vs, v + ((size_t)bkv * S + k0) * dh, S - k0, dh, ld, 1.f);
  float adk[TM][DN], adv[TM][DN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int qt_last = last_q_tile(k0, S, window);
  for (int h = 0; h < group; ++h) {
    const int bh = bkv * group + h;
    for (int qt = blockIdx.y; qt <= qt_last; ++qt) {
      const int q0 = qt * BQ;
      stage(qs, q + ((size_t)bh * S + q0) * dh, S - q0, dh, ld, scale);
      stage(dos, dout + ((size_t)bh * S + q0) * dh, S - q0, dh, ld, 1.f);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        lses[r] = q0 + r < S ? lse[(size_t)bh * S + q0 + r] : 0.f;
        dels[r] = q0 + r < S ? delta[(size_t)bh * S + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[TM][TN], dp[TM][TN];    // keys ty + 16 i, queries tx + 16 j
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < dh; ++d) {
        float a[TM], e[TM], b[TN], c[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          a[i] = ks[(ty + TY * i) * ld + d];
          e[i] = vs[(ty + TY * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          b[j] = qs[(tx + TX * j) * ld + d];
          c[j] = dos[(tx + TX * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(e[i], c[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int key = k0 + ty + TY * i, ql = tx + TX * j;
          const float p = visible(q0 + ql, key, S, window) ? expf(s[i][j] - lses[ql]) : 0.f;
          ps[(ty + TY * i) * PLD + ql] = p;
          dss[(ty + TY * i) * PLD + ql] = p * (dp[i][j] - dels[ql]);
        }
      __syncthreads();   // ps, dss complete

      const int rows = min(BQ, S - q0);
      for (int c = 0; c < rows; ++c) {
        float pc[TM], dc[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          pc[i] = ps[(ty + TY * i) * PLD + c];
          dc[i] = dss[(ty + TY * i) * PLD + c];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          const int col = tx + TX * j;
          const float ov = col < dh ? dos[c * ld + col] : 0.f;
          const float qv = col < dh ? qs[c * ld + col] : 0.f;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            adv[i][j] = fmaf(pc[i], ov, adv[i][j]);
            adk[i][j] = fmaf(dc[i], qv, adk[i][j]);
          }
        }
      }
      __syncthreads();   // the next tile overwrites qs, dos, ps, dss, lses, dels
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int key = k0 + ty + TY * i;
    if (key >= S) continue;
    float* krow = dk + ((size_t)bkv * S + key) * dh;
    float* vrow = dv + ((size_t)bkv * S + key) * dh;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = tx + TX * j;
      if (col < dh) {
        krow[col] = adk[i][j];
        vrow[col] = adv[i][j];
      }
    }
  }
}

// -- bf16: tensor cores --------------------------------------------------------

// A fragments (hi and lo halves) of a 16 x 16 block from two accumulator
// tiles of 16 x 8 (columns 0-7 in c0, 8-15 in c1), as the forward's P.
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        unsigned (&hi)[4], unsigned (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// acc (16 x 16 DK, as 2 DK accumulator tiles) += A (hi + lo, 16 x 16) B,
// where B's 16 rows start at `rows` in a [..][LD] tile and span its columns.
template <int DK, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * DK][4], const unsigned (&hi)[4],
                                         const unsigned (&lo)[4], const bf16* rows, int lane) {
#pragma unroll
  for (int dp = 0; dp < DK; ++dp) {
    unsigned b[4];                    // columns 16 dp + [0, 8) and [8, 16)
    ldmatrix_x4_trans(b, rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                             (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], hi, b[0], b[1]);
    mma_bf16(acc[2 * dp], lo, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
  }
}

// Stage this warp's 16 rows of `acc` times `mul` as bf16 into `tile` (its
// rows of a [..][LD] tile, which no other warp reads), then store the rows
// below S to `dst` (row0's row of a contiguous (S, dh) slab).
template <int DK, int LD>
__device__ __forceinline__ void store_rows(const float (&acc)[2 * DK][4], float mul,
                                           bf16* tile, bf16* dst, int rows, int dh,
                                           bool vec, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n) {
    const int col = n * 8 + tq * 2;
    *reinterpret_cast<__nv_bfloat162*>(tile + g * LD + col) =
        __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(tile + (g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  if (vec) {
    const int ch = dh / 8;
    for (int e = lane; e < rows * ch; e += 32) {
      const int r = e / ch, c = e - r * ch;
      *reinterpret_cast<uint4*>(dst + (size_t)r * dh + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * LD + c * 8);
    }
  } else {
    for (int e = lane; e < rows * dh; e += 32) {
      const int r = e / dh, c = e - r * dh;
      dst[(size_t)r * dh + c] = tile[r * LD + c];
    }
  }
}

template <int DK>   // DP = 16 DK: Dh zero-filled up to a multiple of 16
__global__ void __launch_bounds__(TC_THREADS)
fa_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, int S, int dh, int group, float scale,
                      int window, bool vec) {
  constexpr int DP = 16 * DK, LD = DP + 8, TILE = BQ * LD;
  constexpr bool FREG = DK <= 4;      // q and dO fragments in registers, else per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]; dQ staged here last
  bf16* dos = qs + TILE;                         // [BQ][LD]
  bf16* ks = dos + TILE;                         // [TK][LD]
  bf16* vs = ks + TILE;                          // [TK][LD]
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;     // heaviest tiles first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;        // accumulator row and column pair
  const bf16* kb = k + (size_t)(bh / group) * S * dh;
  const bf16* vb = v + (size_t)(bh / group) * S * dh;
  const int arow = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  stage_bf16<DP>(qs, q + ((size_t)bh * S + q0) * dh, S - q0, dh, vec);
  stage_bf16<DP>(dos, dout + ((size_t)bh * S + q0) * dh, S - q0, dh, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  unsigned qf[FREG ? DK : 1][4], of[FREG ? DK : 1][4];
  if constexpr (FREG) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      ldmatrix_x4(qf[kk], qs + arow + kk * 16);
      ldmatrix_x4(of[kk], dos + arow + kk * 16);
    }
  }
  float rl[2], rd[2];                 // lse log2e and D of rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    rl[r] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
    rd[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float acc[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = first_tile(q0, window); t <= qt; ++t) {
    const int k0 = t * TK;
    stage_bf16<DP>(ks, kb + (size_t)k0 * dh, S - k0, dh, vec);
    stage_bf16<DP>(vs, vb + (size_t)k0 * dh, S - k0, dh, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[TK / 8][4], dp[TK / 8][4];   // keys 8 n + 2 tq + {0, 1}
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      unsigned a[4], o[4];
      if constexpr (FREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = qf[kk][e];
          o[e] = of[kk][e];
        }
      } else {
        ldmatrix_x4(a, qs + arow + kk * 16);
        ldmatrix_x4(o, dos + arow + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        unsigned b[4];                // keys 16 np + [0, 8) and [8, 16)
        ldmatrix_x4(b, ks + off);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        ldmatrix_x4(b, vs + off);
        mma_bf16(dp[2 * np], o, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], o, b[2], b[3]);
      }
    }

    // dS = P o (dP - D), P = exp(scale s - lse); 0 where the forward masks
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + warp * 16 + g + (e >> 1) * 8;
        const int key = k0 + n * 8 + tq * 2 + (e & 1);
        const float p = visible(row, key, S, window)
                            ? exp2f(fmaf(s[n][e] * scale, LOG2E, -rl[e >> 1])) : 0.f;
        s[n][e] = p * (dp[n][e] - rd[e >> 1]);
      }

#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {   // dQ += dS K over keys 16 kk + [0, 16)
      unsigned hi[4], lo[4];
      split_a(s[2 * kk], s[2 * kk + 1], hi, lo);
      mma_rows<DK, LD>(acc, hi, lo, ks + kk * 16 * LD, lane);
    }
    __syncthreads();   // the next tile overwrites ks and vs
  }

  const int row0 = q0 + warp * 16;
  store_rows<DK, LD>(acc, scale, qs + warp * 16 * LD, dq + ((size_t)bh * S + row0) * dh,
                     min(16, S - row0), dh, vec, lane);
}

template <int DK>
__global__ void __launch_bounds__(TC_THREADS)
fa_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int dh,
                        int group, float scale, int window, bool vec) {
  constexpr int DP = 16 * DK, LD = DP + 8, TILE = BQ * LD;
  constexpr bool FREG = DK <= 4;      // k and v fragments in registers, else per tile
  constexpr int QH = 32;              // queries a pass: half a query tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [TK][LD]; dK staged here last
  bf16* vs = ks + TILE;                          // [TK][LD]; dV staged here last
  bf16* qs = vs + TILE;                          // [BQ][LD]
  bf16* dos = qs + TILE;                         // [BQ][LD]
  float* lses = reinterpret_cast<float*>(dos + TILE);   // [BQ], lse log2e
  float* dels = lses + BQ;                               // [BQ], D
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * TK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int arow = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  stage_bf16<DP>(ks, k + ((size_t)bkv * S + k0) * dh, S - k0, dh, vec);
  stage_bf16<DP>(vs, v + ((size_t)bkv * S + k0) * dh, S - k0, dh, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  unsigned kf[FREG ? DK : 1][4], vf[FREG ? DK : 1][4];   // this warp's 16 keys
  if constexpr (FREG) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      ldmatrix_x4(kf[kk], ks + arow + kk * 16);
      ldmatrix_x4(vf[kk], vs + arow + kk * 16);
    }
  }
  float adk[2 * DK][4], adv[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  const int qt_last = last_q_tile(k0, S, window);
  for (int h = 0; h < group; ++h) {
    const int bh = bkv * group + h;
    for (int qt = blockIdx.y; qt <= qt_last; ++qt) {
      const int q0 = qt * BQ;
      stage_bf16<DP>(qs, q + ((size_t)bh * S + q0) * dh, S - q0, dh, vec);
      stage_bf16<DP>(dos, dout + ((size_t)bh * S + q0) * dh, S - q0, dh, vec);
      for (int r = threadIdx.x; r < BQ; r += TC_THREADS) {
        lses[r] = q0 + r < S ? lse[(size_t)bh * S + q0 + r] * LOG2E : 0.f;
        dels[r] = q0 + r < S ? delta[(size_t)bh * S + q0 + r] : 0.f;
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();

      for (int qh0 = 0; qh0 < BQ; qh0 += QH) {
        // S^T = K Q^T and dP^T = V dO^T: this warp's keys by the pass's queries
        float s[QH / 8][4], dp[QH / 8][4];   // queries qh0 + 8 n + 2 tq + {0, 1}
#pragma unroll
        for (int n = 0; n < QH / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          unsigned a[4], w[4];
          if constexpr (FREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a[e] = kf[kk][e];
              w[e] = vf[kk][e];
            }
          } else {
            ldmatrix_x4(a, ks + arow + kk * 16);
            ldmatrix_x4(w, vs + arow + kk * 16);
          }
#pragma unroll
          for (int np = 0; np < QH / 16; ++np) {
            const int off = (qh0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8;
            unsigned b[4];
            ldmatrix_x4(b, qs + off);
            mma_bf16(s[2 * np], a, b[0], b[1]);
            mma_bf16(s[2 * np + 1], a, b[2], b[3]);
            ldmatrix_x4(b, dos + off);
            mma_bf16(dp[2 * np], w, b[0], b[1]);
            mma_bf16(dp[2 * np + 1], w, b[2], b[3]);
          }
        }

        // P^T, dS^T; 0 where the forward masks
#pragma unroll
        for (int n = 0; n < QH / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + warp * 16 + g + (e >> 1) * 8;
            const int ql = qh0 + n * 8 + tq * 2 + (e & 1);
            const float p = visible(q0 + ql, key, S, window)
                                ? exp2f(fmaf(s[n][e] * scale, LOG2E, -lses[ql])) : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - dels[ql]);
          }

#pragma unroll
        for (int kk = 0; kk < QH / 16; ++kk) {   // over queries qh0 + 16 kk + [0, 16)
          unsigned hi[4], lo[4];
          split_a(s[2 * kk], s[2 * kk + 1], hi, lo);
          mma_rows<DK, LD>(adv, hi, lo, dos + (qh0 + kk * 16) * LD, lane);   // dV += P^T dO
          split_a(dp[2 * kk], dp[2 * kk + 1], hi, lo);
          mma_rows<DK, LD>(adk, hi, lo, qs + (qh0 + kk * 16) * LD, lane);    // dK += dS^T Q
        }
      }
      __syncthreads();   // the next tile overwrites qs, dos, lses and dels
    }
  }

  const int row0 = k0 + warp * 16;
  const int rows = min(16, S - row0);
  store_rows<DK, LD>(adk, scale, ks + warp * 16 * LD, dk + ((size_t)bkv * S + row0) * dh,
                     rows, dh, vec, lane);
  store_rows<DK, LD>(adv, 1.f, vs + warp * 16 * LD, dv + ((size_t)bkv * S + row0) * dh,
                     rows, dh, vec, lane);
}

// -- launch --------------------------------------------------------------------

// Dynamic shared memory of one block of (b) (`dkdv`) or (c), in bytes.
size_t bwd_smem_bytes(int dh, int dtype, bool dkdv) {
  if (dtype == 0) {
    const size_t tiles = (size_t)(2 * BQ + 2 * TK) * (dh + 1);
    return (tiles + (dkdv ? 2 * (size_t)TK * PLD + 2 * BQ : (size_t)BQ * PLD)) * sizeof(float);
  }
  const size_t ld = 16 * (size_t)((dh + 15) / 16) + 8;
  return (size_t)(2 * BQ + 2 * TK) * ld * sizeof(bf16) + (dkdv ? 2 * BQ * sizeof(float) : 0);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, bkv, S, dh, window;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const void* o, const Args& a, float* delta) {
  const int rows = a.bh * a.S;
  fa_bwd_delta_kernel<T><<<(rows + DELTA_ROWS - 1) / DELTA_ROWS, THREADS, 0, a.stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(a.dout), delta, rows, a.dh);
  return cudaGetLastError();
}

template <int DN>
cudaError_t launch_f32(const Args& a) {
  const int tiles = (a.S + BQ - 1) / BQ, group = a.bh / a.bkv;
  const float scale = 1.0f / sqrtf((float)a.dh);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto mf = [](void* p) { return static_cast<float*>(p); };
  size_t smem = bwd_smem_bytes(a.dh, 0, true);
  cudaError_t err = allow_smem(fa_bwd_dkdv_f32_kernel<DN>, smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_f32_kernel<DN><<<dim3(a.bkv, tiles), THREADS, smem, a.stream>>>(
      cf(a.q), cf(a.k), cf(a.v), cf(a.dout), a.lse, a.delta, mf(a.dk), mf(a.dv), a.S, a.dh,
      group, scale, a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = bwd_smem_bytes(a.dh, 0, false);
  if ((err = allow_smem(fa_bwd_dq_f32_kernel<DN>, smem)) != cudaSuccess) return err;
  fa_bwd_dq_f32_kernel<DN><<<dim3(a.bh, tiles), THREADS, smem, a.stream>>>(
      cf(a.q), cf(a.k), cf(a.v), cf(a.dout), a.lse, a.delta, mf(a.dq), a.S, a.dh, group,
      scale, a.window);
  return cudaGetLastError();
}

bool aligned_all(const Args& a) {
  return a.dh % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout) && aligned16(a.dq) && aligned16(a.dk) && aligned16(a.dv);
}

template <int DK>
cudaError_t launch_bf16(const Args& a) {
  const int tiles = (a.S + BQ - 1) / BQ, group = a.bh / a.bkv;
  const float scale = 1.0f / sqrtf((float)a.dh);
  const bool vec = aligned_all(a);
  auto cb = [](const void* p) { return static_cast<const bf16*>(p); };
  auto mb = [](void* p) { return static_cast<bf16*>(p); };
  size_t smem = bwd_smem_bytes(a.dh, 1, true);
  cudaError_t err = allow_smem(fa_bwd_dkdv_bf16_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_bf16_kernel<DK><<<dim3(a.bkv, tiles), TC_THREADS, smem, a.stream>>>(
      cb(a.q), cb(a.k), cb(a.v), cb(a.dout), a.lse, a.delta, mb(a.dk), mb(a.dv), a.S, a.dh,
      group, scale, a.window, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = bwd_smem_bytes(a.dh, 1, false);
  if ((err = allow_smem(fa_bwd_dq_bf16_kernel<DK>, smem)) != cudaSuccess) return err;
  fa_bwd_dq_bf16_kernel<DK><<<dim3(a.bh, tiles), TC_THREADS, smem, a.stream>>>(
      cb(a.q), cb(a.k), cb(a.v), cb(a.dout), a.lse, a.delta, mb(a.dq), a.S, a.dh, group,
      scale, a.window, vec);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int dtype) {
  if (dtype == 0) {
    if (a.dh <= 32) return launch_f32<2>(a);
    if (a.dh <= 64) return launch_f32<4>(a);
    return launch_f32<8>(a);
  }
  switch ((a.dh + 15) / 16) {
    case 1: return launch_bf16<1>(a);
    case 2: return launch_bf16<2>(a);
    case 3: return launch_bf16<3>(a);
    case 4: return launch_bf16<4>(a);
    case 5: return launch_bf16<5>(a);
    case 6: return launch_bf16<6>(a);
    case 7: return launch_bf16<7>(a);
    default: return launch_bf16<8>(a);
  }
}

}  // namespace

extern "C" {

// The largest head dim the backward takes.
int fa_bwd_max_head_dim() { return MAX_BWD_DH; }

// Dynamic shared memory of one block of (b) (dkdv != 0) or (c) at head dim
// dh for dtype (0 = float32, 1 = bfloat16), in bytes; -1 for another dtype.
int fa_bwd_smem_bytes(int dh, int dtype, int dkdv) {
  if (dtype != 0 && dtype != 1) return -1;
  return (int)bwd_smem_bytes(dh, dtype, dkdv != 0);
}

// q, o, dout, dq (bh, S, dh); k, v, dk, dv (bkv, S, dh); all contiguous, one
// dtype (0 = float32, 1 = bfloat16); lse (bh, S) float32 from fa_forward;
// delta (bh, S) float32 scratch that receives D.  bh % bkv == 0,
// 0 < dh <= 128, the 64-row tiles of S at most 65535, window 0 (causal) or
// the local window (>= 1), as in the forward that wrote lse.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq, void* dk,
                void* dv, int bh, int bkv, int S, int dh, int window, int dtype, int device,
                void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv || S <= 0 || dh <= 0 || dh > MAX_BWD_DH || window < 0)
    return cudaErrorInvalidValue;
  if ((S + BQ - 1) / BQ > 65535 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv, bh, bkv, S, dh, window,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dtype == 0 ? launch_delta<float>(o, a, delta)
                                     : launch_delta<bf16>(o, a, delta);
  if (err != cudaSuccess) return err;
  return dispatch(a, dtype);
}

}  // extern "C"
