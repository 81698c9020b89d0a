// Causal GQA flash-attention forward on Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel
//    src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
//    (body _flash_kernel): q (BH, S, Dh); k, v (BKV, S, Dh) with BH = BKV * G,
//    f32 or bf16 -> out (BH, S, Dh) in q's dtype.  Query row b reads kv row
//    b / G, so repeated KV is never materialised.  The math is an online
//    softmax with f32 running max m, sum l and accumulator acc; masked
//    scores are -1e30, fully masked kv tiles are skipped, and the output is
//    acc / max(l, 1e-30), as in the TPU kernel.  The scale is 1/sqrt(Dh);
//    any Dh <= 256 and any S are taken as they are (nothing is padded in
//    device memory; a ragged S is masked in the kernel).
//
// Local attention (window > 0, which the TPU kernel lacks and the reference
// model computes in attend_full / attend_chunked): query qpos sees key kpos
// iff qpos - window < kpos <= qpos.  The kv loop starts at the first tile
// that the window of the tile's first query reaches, as the causal skip ends
// it at the diagonal, and only the tiles that the window's edge or the
// diagonal cut are masked.  A row whose keys in a tile are all masked (an
// early tile, before its window) keeps m = -1e30 there, and its exponents
// are then taken against 0 instead of m, so every p of the tile is 0: the
// bf16 kernel's exp2(s log2 e - m log2 e) would otherwise read the rounding
// error of -1e30 log2 e, ~1e22, and overflow.  Every row < S sees its own
// key, so a later tile sets m.
//
// Bound on an H100 SXM: operations.  The causal function needs about
// 2 * BH * S^2 * Dh FLOPs (QK^T and PV, half of each under the mask); at the
// serving shape (BH = 56, S = 1,024, Dh = 64) that is ~7.5 GFLOP, 7.6 us at
// the 989 TFLOP/s bf16 tensor-core peak, against ~5 us to read q, k, v and
// write out once at 3.35 TB/s.
//
// Two kernels, chosen by dtype in fa_forward.
//
// bf16 (the serving dtype): flash_attention_bf16_kernel, on tensor cores.
//  * One block of 4 warps per (q row, 64-query tile), 16 query rows per
//    warp; the grid is (BH, S/64) with the tile index reversed, so the
//    heaviest tiles (the last ones, which see the most keys) start first
//    across all rows.  The block loops over 64-key tiles up to and
//    including the diagonal tile (the causal skip).
//  * Staging: the q tile once, the k and v tiles double-buffered, all as
//    bf16 in shared memory, Dh zero-filled up to DP, the next multiple of
//    16 (40 -> 48, 33 -> 48), and keys past S zero-filled.  Tile t + 1 is
//    copied with 16-byte cp.async while tile t computes; where the rows are
//    not 16-byte aligned (Dh % 8 != 0, or an offset pointer) the tiles are
//    staged with plain loads instead.  Each shared row holds DP + 8
//    values: the 16-byte pad makes every ldmatrix phase free of bank
//    conflicts.  Each warp keeps its q fragments in registers (ldmatrix)
//    for the whole kv loop.
//  * S = Q K^T with mma.sync m16n8k16 (bf16 operands, f32 accumulation);
//    products of bf16 values are exact in f32, so only the order of
//    summation differs from mha_ref.  S is scaled in f32 (exactly at
//    Dh = 64), masked only on the diagonal tile, and the online softmax
//    keeps (m, l) per row in registers, the row max taken across the four
//    lanes of an accumulator quad with shuffles; p = 2^((s - m) log2 e).
//  * O += P V on the tensor cores with P split in two bf16 parts:
//    P_hi = bf16(P), P_lo = bf16(P - P_hi), and O += P_hi V + P_lo V with
//    the V fragments from ldmatrix.trans; l sums the f32 P.  The split keeps
//    ~16 bits of each probability, so K3 computes in f32 up to summation
//    order, as mha_ref does, and both round once to bf16: they may differ
//    by one bf16 step (chip_smoke.py's FA_TOLERANCE).  A single bf16 P
//    would add ~2^-9 of relative error per probability.  The split costs
//    half again the tensor-core operations of the two products.
//  * Epilogue: acc / max(l, 1e-30) rounded to bf16, staged through the q
//    tile's shared memory so that the stores are 16-byte and coalesced;
//    rows >= S and columns >= Dh are not stored.
//  Shared memory: 5 tiles of 64 x (DP + 8) bf16 (q, and k and v twice),
//  46,080 B at Dh = 64, 87,040 B at Dh = 128 and 168,960 B at Dh = 256.
//  Registers per thread: q fragments DP / 4, scores 32, accumulator DP / 2
//  f32 (64 at Dh = 128); the -Xptxas -v report reads 134 at Dh = 64 and
//  169 at Dh = 128 with no spills, so registers hold an SM to 3 blocks (12
//  warps).  Capping them at 128 for a fourth block spills and runs no
//  faster.  Above Dh = 128 (DP 192 or 256; Dh 129..256 round up to these
//  two) the accumulator alone is up to 128 f32 a thread, so the q fragments
//  stay in shared memory and are read with ldmatrix for each kv tile
//  instead of living in registers (QREG false); shared memory then allows
//  one block an SM.  The -Xptxas -v report reads 173 registers at DK 12
//  with no spill, and 255 at DK 16 with 80 B of spill stores and 52 B of
//  loads a thread (the accumulator's 128 and the scores' 32 floats); at
//  RecurrentGemma-2B's prefill shape it still runs at the share of its
//  bound that Dh 64 and 128 reach (chip_smoke.py's kernel-K3 rows).
//  Halving the scores (two 32-key halves a tile) would free the spilled
//  registers.  The tensor-core rate at this tile is far from the card's
//  peak: wgmma with TMA, warp specialisation and a persistent grid are the
//  later levers.
//
// f32 (the parity dtype): flash_attention_kernel<DP>, on the tensor cores in
// 3xTF32.  One TF32 product misses the 2e-5 check against mha_ref by ~60x;
// three keep f32 accuracy: each operand v is split into hi = v cut to TF32
// and lo = v - hi (cut again by the tensor core), and a b = a_hi b_hi +
// a_lo b_hi + a_hi b_lo on mma.sync m16n8k8 (wgmma takes TF32 only K-major,
// which V in PV is not).  Bound: the same two products, three times over at
// the 495 TFLOP/s TF32 peak (chip_smoke.py's fa_bound): 0.0456 ms at
// Qwen2-0.5B's prefill shape, against 0.1123 at the f32 CUDA-core rate.
//  * The bf16 kernel's layout: one block of 4 warps per (q row, 64-query
//    tile), 16 query rows a warp, the heaviest tiles first; a warp skips a
//    kv tile none of its rows sees (the causal diagonal, the window).
//  * Staging: q (64 rows) once, k and v double-buffered with 16-byte
//    cp.async while the previous tile computes (plain loads where Dh % 4 !=
//    0 or a pointer is not 16-byte aligned), Dh zero-filled up to DP (32,
//    64, 128 or 256), keys past S zero-filled.  Row stride DP + 4 floats
//    (4 mod 32): ldmatrix (4 words a lane of 8 x 4 f32 tiles) reads q and k
//    free of bank conflicts, and so do the scalar reads of V at rows 2 q and
//    2 q + 1, column g (banks 8 q + g, 8 q + 4 + g): no swizzle.
//  * S = (q scale) K^T: q's A fragments and k's B fragments by ldmatrix,
//    split in registers; 64 columns of Dh a chain of mma.sync from 0, the
//    chains added in f32 (the tensor core truncates what it accumulates).
//  * Online softmax as in the bf16 kernel, with expf (f32 accuracy); P
//    feeds PV straight from the score registers: the accumulator holds
//    columns (2 q, 2 q + 1) of each 8-key step, the A fragment wants (q,
//    q + 4), so the step's keys are taken in the order 0, 2, 4, 6, 1, 3, 5,
//    7 and V's rows read in the same order: no shuffle, no shared tile.
//    O = O alpha + P V, each 8-column tile's P V one chain from 0, added in
//    f32 by one FMA that also applies alpha.
//  Keys a tile T: 64 up to Dh 64, 32 above.  Shared memory (64 + 4 T) (DP +
//  4) floats: 87,040 B at Dh 64 and 101,376 B at Dh 128 (2 blocks, 8 warps
//  an SM), 199,680 B at Dh 256 (1 block).  Registers (-Xptxas -v): 127 /
//  163 / 157 / 233 a thread at DP 32 / 64 / 128 / 256, no spill; the
//  accumulator alone is DP / 2 f32, so above Dh 128 the keys a tile halve.
//
// Training (the lse argument, NULL when serving): each row's log-sum-exp of
// its scaled scores, m + log l, is written to an f32 (BH, S) array from the
// registers that hold m and l, once per row; serving does the same work as
// without it but for that branch.
//
// C interface (loaded with ctypes): fa_forward launches on the given stream
// of the given device, leaves the caller's current device as it found it,
// does not synchronise, and returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fa_common.cuh"

namespace {

// -- f32: 3xTF32 on the tensor cores -------------------------------------------

// Keys a kv tile of the f32 kernel at padded head dim DP.
__host__ __device__ constexpr int f32_tk(int dp) { return dp <= 64 ? 64 : 32; }

template <int DP>   // Dh zero-filled up to DP (32, 64, 128 or 256)
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int S, int dh, int group, float scale,
                       int window, bool vec) {
  constexpr int T = f32_tk(DP), LD = f32_ld(DP), NK = T / 8, ND = DP / 8, TILE = T * LD;
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;                          // [BQ][LD]; the output tile last
  float* kvs = qs + BQ * LD;                     // two stages of k [T][LD], v [T][LD]
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;     // heaviest tiles first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;        // accumulator row and column pair
  const int r0 = q0 + warp * 16;                 // this warp's first row
  const float* kb = k + (size_t)(bh / group) * S * dh;
  const float* vb = v + (size_t)(bh / group) * S * dh;
  const int t0 = first_tile<T>(q0, window);
  const int t1 = (min(q0 + BQ, S) - 1) / T;      // the tile of the block's last key

  stage_f32<BQ, DP, TC_THREADS>(qs, q + ((size_t)bh * S + q0) * dh, S - q0, dh, vec);
  stage_f32<T, DP, TC_THREADS>(kvs, kb + (size_t)t0 * T * dh, S - t0 * T, dh, vec);
  stage_f32<T, DP, TC_THREADS>(kvs + TILE, vb + (size_t)t0 * T * dh, S - t0 * T, dh, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float o[ND][4];                     // rows g, g + 8; columns 8 n + 2 tq + {0, 1}
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this lane's part

  for (int t = t0; t <= t1; ++t) {
    const float* ks = kvs + ((t - t0) & 1) * 2 * TILE;
    const float* vs = ks + TILE;
    if (t < t1) {                     // tile t + 1 lands while tile t computes
      float* nk = kvs + ((t + 1 - t0) & 1) * 2 * TILE;
      const int k1 = (t + 1) * T;
      stage_f32<T, DP, TC_THREADS>(nk, kb + (size_t)k1 * dh, S - k1, dh, vec);
      stage_f32<T, DP, TC_THREADS>(nk + TILE, vb + (size_t)k1 * dh, S - k1, dh, vec);
      cp_async_commit();
    }
    const int k0 = t * T;
    // a warp none of whose rows sees a key of the tile (all past its last
    // row, or all before the window of its first) skips it
    if (r0 < S && k0 <= r0 + 15 && (window == 0 || k0 + T - 1 + window > r0)) {
      float s[NK][4];                 // scores: keys 8 n + 2 tq + {0, 1}
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      mma_abt<LD, DP, NK>(s, qs, warp * 16, scale, ks, dh, lane);   // S = (q scale) K^T

      // the tile that the diagonal, the window's edge or S cuts for one of
      // this warp's rows is masked; every other is visible to all 16
      const bool edge = k0 + T - 1 > r0 || k0 + T > S || (window > 0 && k0 + window <= r0 + 15);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + (e >> 1) * 8;
          const int key = k0 + n * 8 + tq * 2 + (e & 1);
          if (edge && (key > row || key >= S || (window > 0 && key + window <= row)))
            s[n][e] = NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float me[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        me[r] = m_new == NEG_INF ? 0.f : m_new;   // all masked so far: p = 0
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - me[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }

      // O = O alpha + P V, P straight from the score registers (keys
      // permuted in each 8-key step, V's rows read in the same order)
      mma_cb<LD, ND, NK>(o, s, vs, dh, alpha[0], alpha[1], lane);
    }
    cp_async_wait_all();
    __syncthreads();   // tile t + 1 is in; the next copy overwrites tile t
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
    const int row = r0 + g + r * 8;
    if (lse != nullptr && tq == 0 && row < S) lse[(size_t)bh * S + row] = m[r] + logf(den[r]);
  }
  // through this warp's own 16 rows of the q tile (no other warp reads
  // them), so that the stores are 16-byte and coalesced
  float* os = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + tq * 2;
    *reinterpret_cast<float2*>(os + g * LD + col) =
        make_float2(o[n][0] / den[0], o[n][1] / den[0]);
    *reinterpret_cast<float2*>(os + (g + 8) * LD + col) =
        make_float2(o[n][2] / den[1], o[n][3] / den[1]);
  }
  __syncwarp();
  const int rows = min(16, S - r0);              // rows >= S are not stored
  float* ob = out + ((size_t)bh * S + r0) * dh;
  if (vec) {
    const int ch = dh / 4;
    for (int e = lane; e < rows * ch; e += 32) {
      const int r = e / ch, c = e - r * ch;
      *reinterpret_cast<float4*>(ob + (size_t)r * dh + c * 4) =
          *reinterpret_cast<const float4*>(os + r * LD + c * 4);
    }
  } else {
    for (int e = lane; e < rows * dh; e += 32) {
      const int r = e / dh, c = e - r * dh;
      ob[(size_t)r * dh + c] = os[r * LD + c];
    }
  }
}

// -- bf16: tensor cores ------------------------------------------------------


template <int DK>   // DP = 16 DK: Dh zero-filled up to a multiple of 16
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            float* __restrict__ lse, int S, int dh, int group, float scale,
                            int window, bool vec) {
  constexpr int DP = 16 * DK, LD = DP + 8, TILE = BQ * LD;
  constexpr bool QREG = DK <= 8;      // q fragments in registers, else read per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]; the output tile last
  bf16* kvs = qs + TILE;                         // two stages of k [TK][LD], v [TK][LD]
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;     // heaviest tiles first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;        // accumulator row and column pair
  const bf16* kb = k + (size_t)(bh / group) * S * dh;
  const bf16* vb = v + (size_t)(bh / group) * S * dh;
  const int t0 = first_tile<TK>(q0, window);
  const bf16* qrow = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  stage_bf16<DP>(qs, q + ((size_t)bh * S + q0) * dh, S - q0, dh, vec);
  stage_bf16<DP>(kvs, kb + (size_t)t0 * TK * dh, S - t0 * TK, dh, vec);
  stage_bf16<DP>(kvs + TILE, vb + (size_t)t0 * TK * dh, S - t0 * TK, dh, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  unsigned qf[QREG ? DK : 1][4];      // this warp's 16 q rows, A fragments
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
  }

  float o[2 * DK][4];                 // rows g, g + 8; columns 8 n + 2 tq + {0, 1}
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this lane's part

  // kv tiles past the diagonal, and before the window of the tile's first
  // row, are fully masked for every row: skipped
  for (int t = t0; t <= qt; ++t) {
    const bf16* ks = kvs + ((t - t0) & 1) * 2 * TILE;
    const bf16* vs = ks + TILE;
    if (t < qt) {                     // tile t + 1 lands while tile t computes
      bf16* nk = kvs + ((t + 1 - t0) & 1) * 2 * TILE;
      const int k1 = (t + 1) * TK;
      stage_bf16<DP>(nk, kb + (size_t)k1 * dh, S - k1, dh, vec);
      stage_bf16<DP>(nk + TILE, vb + (size_t)k1 * dh, S - k1, dh, vec);
      cp_async_commit();
    }

    float s[TK / 8][4];               // scores: keys 8 n + 2 tq + {0, 1}
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      unsigned a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qrow + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        unsigned b[4];                // keys 16 np + [0, 8) and [8, 16)
        ldmatrix_x4(b, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    const int k0 = t * TK;
    // the diagonal tile, and a tile that the window's edge cuts for the
    // tile's last row, are masked; every other tile is visible to every row
    const bool edge = t == qt || (window > 0 && k0 + window <= q0 + BQ - 1);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + warp * 16 + g + (e >> 1) * 8;
        const int key = k0 + n * 8 + tq * 2 + (e & 1);
        float x = s[n][e] * scale;
        if (edge && (key > row || key >= S || (window > 0 && key + window <= row)))
          x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float alpha = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
      ml[r] = m_new == NEG_INF ? 0.f : m_new * LOG2E;   // all masked: p = 0
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < 2 * DK; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], LOG2E, -ml[e >> 1]));
        s[n][e] = p;
        l[e >> 1] += p;
      }

#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {   // keys 16 kk + [0, 16)
      unsigned ph[4], pl[4];          // P as A fragments, hi and lo parts
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DK; ++dp) {
        unsigned b[4];                // columns 16 dp + [0, 8) and [8, 16)
        ldmatrix_x4_trans(b, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                 dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, b[0], b[1]);
        mma_bf16(o[2 * dp], pl, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();   // tile t + 1 is in; the next copy overwrites tile t
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
    const int row = q0 + warp * 16 + g + r * 8;
    if (lse != nullptr && tq == 0 && row < S) lse[(size_t)bh * S + row] = m[r] + logf(den[r]);
  }
  bf16* os = qs + warp * 16 * LD;     // this warp's 16 rows of the q tile
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n) {
    const int col = n * 8 + tq * 2;
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + col) =
        __floats2bfloat162_rn(o[n][0] / den[0], o[n][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[n][2] / den[1], o[n][3] / den[1]);
  }
  __syncwarp();
  const int row0 = q0 + warp * 16;
  const int rows = min(16, S - row0);            // rows >= S are not stored
  bf16* ob = out + ((size_t)bh * S + row0) * dh;
  if (vec) {
    const int ch = dh / 8;
    for (int e = lane; e < rows * ch; e += 32) {
      const int r = e / ch, c = e - r * ch;
      *reinterpret_cast<uint4*>(ob + (size_t)r * dh + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
    }
  } else {
    for (int e = lane; e < rows * dh; e += 32) {
      const int r = e / dh, c = e - r * dh;
      ob[(size_t)r * dh + c] = os[r * LD + c];
    }
  }
}

// -- launch ------------------------------------------------------------------

// The bf16 kernel's DK (Dh zero-filled to 16 DK): each multiple of 16 up to
// 128, then 12 (Dh 129..192) and 16 (Dh 193..256).
int bf16_dk(int dh) {
  const int dk = (dh + 15) / 16;
  return dk <= 8 ? dk : dk <= 12 ? 12 : 16;
}

size_t smem_bytes(int dh, int dtype) {
  if (dtype == 0) {
    const int dp = f32_dp(dh);
    return (size_t)(BQ + 4 * f32_tk(dp)) * f32_ld(dp) * sizeof(float);
  }
  return (size_t)(BQ + 4 * TK) * (16 * bf16_dk(dh) + 8) * sizeof(bf16);
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       int bh, int bkv, int S, int dh, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh, 0);
  auto kernel = flash_attention_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(out);
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, dh, bh / bkv,
      1.0f / sqrtf((float)dh), window, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                         int bh, int bkv, int S, int dh, int window, cudaStream_t stream) {
#define FA_F32(DP) launch_f32<DP>(q, k, v, out, lse, bh, bkv, S, dh, window, stream)
  switch (f32_dp(dh)) {
    case 32: return FA_F32(32);
    case 64: return FA_F32(64);
    case 128: return FA_F32(128);
    default: return FA_F32(256);
  }
#undef FA_F32
}


template <int DK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                        int bh, int bkv, int S, int dh, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh, 1);
  auto kernel = flash_attention_bf16_kernel<DK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = dh % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(out);
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, dh, bh / bkv,
      1.0f / sqrtf((float)dh), window, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                          int bh, int bkv, int S, int dh, int window, cudaStream_t stream) {
#define FA_BF16(DK) launch_bf16<DK>(q, k, v, out, lse, bh, bkv, S, dh, window, stream)
  switch (bf16_dk(dh)) {
    case 1: return FA_BF16(1);
    case 2: return FA_BF16(2);
    case 3: return FA_BF16(3);
    case 4: return FA_BF16(4);
    case 5: return FA_BF16(5);
    case 6: return FA_BF16(6);
    case 7: return FA_BF16(7);
    case 8: return FA_BF16(8);
    case 12: return FA_BF16(12);
    default: return FA_BF16(16);
  }
#undef FA_BF16
}
}  // namespace

extern "C" {

// Dynamic shared memory of one block at head dim dh for dtype (0 = float32,
// 1 = bfloat16), in bytes; -1 for another dtype.
int fa_smem_bytes(int dh, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  return (int)smem_bytes(dh, dtype);
}

// q (bh, S, dh); k, v (bkv, S, dh); out (bh, S, dh); all contiguous, one
// dtype (0 = float32, 1 = bfloat16); bh % bkv == 0, 0 < dh <= 256; the
// 64-query tiles (grid.y) at most 65535; window
// 0 (causal) or the local window (>= 1).  lse: NULL (serving), or (bh, S)
// float32 that receives each row's log-sum-exp m + log l of its scaled
// scores, which the backward (flash_attention_bwd.cu) reads.
int fa_forward(const void* q, const void* k, const void* v, void* out, float* lse,
               int bh, int bkv, int S, int dh, int window, int dtype, int device,
               void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv || S <= 0 || dh <= 0 || dh > 256 || window < 0)
    return cudaErrorInvalidValue;
  if ((S + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(q, k, v, out, lse, bh, bkv, S, dh, window, s);
  if (dtype == 1) return dispatch_bf16(q, k, v, out, lse, bh, bkv, S, dh, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
