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
// S is masked like the forward's.  Any Dh up to 256, as the forward.
//
// Bound on an H100 SXM: operations.  The gradient needs five products over
// the visible (query, key) pairs, 2 Dh operations each (QK^T, dO V^T, P^T dO,
// dS K, dS^T Q; 2.5x the forward's two); at Qwen2-0.5B's training shape
// (BH 56, BKV 8, S 1,024, Dh 64) that is ~18.8 GFLOP, 19 us at the 989
// TFLOP/s bf16 peak, against ~2.3 us to move q, k, v, o, dO, lse in and
// dq, dk, dv out at 3.35 TB/s.  So the design keeps the tensor cores fed.
//
// bf16 (the training dtype), four kernels a call on the caller's stream:
//  (a) fa_bwd_delta_kernel: D = rowsum(dO o O) in f32 (8 lanes a row, 16-byte
//      loads), written beside lse log2 e into rows padded to 64 queries, so
//      that one TMA box brings both for a query tile.
//  (b) fa_bwd_dkdv_bf16_kernel<NP>: dK, dV of one kv row's 64-key tile
//      (two tiles a block, kt and T - 1 - kt: the causal work of the pair is
//      T + 1 query tiles whatever kt is, so every block does the same work)
//      over one chunk of the G query heads of its group.  The chunk count is
//      the divisor of G whose grid takes the fewest waves x tiles a block
//      (Qwen2-0.5B's G 7: 7 chunks, 448 blocks of 17 tiles on 2 x 132
//      slots); with more than one, each block writes its chunk's f32
//      partial sums.
//  (s) fa_bwd_sum_kernel: dK, dV = the chunks' partials summed in chunk
//      order, rounded to bf16 (skipped with one chunk: (b) then writes bf16
//      itself).  A fixed order and no atomics anywhere: two calls give the
//      same bits.  The partials are 2 x BH x S x Dh f32 (29 MB at Qwen2's
//      shape: one pass at HBM rate); a per-tile counter that orders in-place
//      adds (FlashAttention-3's deterministic mode) would serialise the G
//      blocks of a tile instead.
//  (c) fa_bwd_dq_bf16_kernel<NP>: dQ of one (q row, 64-query tile), the
//      heaviest tiles first, over the key tiles the forward visits: S and
//      dP are recomputed (7 products where 5 would do) so that dQ needs no
//      atomics and no dS scratch (~59 MB at Qwen2's shape).
//  Tiles stream through a ring of stages in shared memory (4 deep at Dh <=
//  64; above, 2, or 3 in (b) at Dh 129-192: what two blocks an SM, or one
//  at Dh > 128, leave room for):
//  TMA loads 64 x 64 boxes swizzled by 128 B (zero-filled past S and Dh)
//  against a stage's "full" mbarrier, the consumers wait on it and release
//  the stage on its "empty" one, and warp 0 refills a stage as soon as
//  every warp has released it, so tiles i + 1.. load while tile i computes.
//  Where TMA cannot read the rows (Dh % 8 != 0 or an input not 16-byte
//  aligned) that warp copies the tiles into the same layout (the "copy"
//  route; the wrapper counts the routes).  The loads are issued from a
//  consumer warp, not a producer warp: registers go to warps in groups of
//  four, so a producer warp costs a warpgroup's registers, and ptxas holds
//  every warp to the launch budget whatever setmaxnreg asks (measured: the
//  same spills with the consumers' setmaxnreg at 168 and at 240), which a
//  producer would cut to 168 a thread, below dK's 244 at Dh 256.
//  Every product runs on wgmma m64n64k16 (bf16 in, f32 accumulate):
//   - (b): S^T = K Q^T and dP^T = V dO^T with K and V (A) and Q and dO (B)
//     K-major in shared memory; P^T and dS^T stay in the accumulator
//     registers, whose layout is the A-register layout of the next wgmma,
//     for dV += P^T dO and dK += dS^T Q with dO and Q as MN-major B (the
//     transpose bit).  Up to Dh 128 one warpgroup holds dK and dV (2 NP x
//     32 f32 a thread) at two blocks an SM; above, that would be 256 + 64
//     f32, so warpgroup 0 computes dV and warpgroup 1 dK from the same
//     tiles, both computing S^T (S^T twice a tile).
//   - (c): S = Q K^T and dP = dO V^T, then dQ += dS K, K as MN-major B;
//     above Dh 128 two warpgroups, each the dQ of alternate 64-column
//     panels, both computing S and dP.
//  Registers a thread (-Xptxas -v): (b) 225 / 255 / 196 / 227 at NP 1-4,
//  (c) 134 / 160 / 160 / 160, no spill but (b) at NP 2 (Dh 65-128): its 2 x
//  64 accumulators beside S^T and dP^T fill the 255 a thread can have, and
//  ptxas spills 16 bytes (24 B stored, 28 B loaded a thread).  The dV/dK
//  split that removes it measured slower (0.757 ms against 0.527 at
//  Qwen2.5-14B's heads).
//  Every branch around a wgmma is on a warp-uniform value (the warpgroup
//  index broadcast by __shfl_sync): ptxas serialises wgmmas under a branch
//  it cannot prove uniform.  Products of bf16 inputs are exact in f32.  The
//  f32 P and dS enter the products dV, dK and dQ as hi/lo bf16 pairs (the
//  forward's split of P), so each keeps ~16 bits; the kernel then computes
//  in f32 up to summation order and rounds dq, dk and dv to bf16 once, as
//  mha_bwd_ref does.  The split costs 10 products where the bound counts 5.
//
// f32 (the parity dtype): the bf16 work plan with its five products (seven
// with S and dP recomputed for dQ) as 3xTF32 on mma.sync m16n8k8, the
// forward's arithmetic (fa_common.cuh: hi/lo TF32 splits, chains of at most
// 8 k steps from 0 added in f32, the accumulator fed back as an A fragment
// with its k index permuted).  One TF32 pass misses the 2e-5 check against
// mha_bwd_ref by ~50x; three keep f32 accuracy.  Bound: the five products
// three times over at the 495 TFLOP/s TF32 peak (chip_smoke.py's
// fa_bwd_bound): 0.1140 ms at Qwen2-0.5B's training shape, against 0.2807 at
// the f32 CUDA-core rate.  Kernels a call:
//  (a) fa_bwd_delta_kernel<float, 32>: D (bh, S) in f32.
//  (b) fa_bwd_dkdv_f32_kernel<DP>: dK, dV of one kv row's 64-key tile pair
//      (kt, T - 1 - kt) over one chunk of its G query heads, chunks chosen
//      as bf16's; S^T = K Q^T directly, so P^T and dS^T are in accumulator
//      layout for dV += P^T dO and dK += dS^T Q.  Up to Dh 64 4 warps of 16
//      keys compute all of it; above, warpgroup 0 S^T, P^T (written to
//      shared memory) and dV, warpgroup 1 dP^T, then dS^T and dK: two
//      products each, one barrier between them.
//  (s) fa_bwd_sum_kernel<float>: with more than one chunk, the partials
//      summed in chunk order, written in f32.
//  (c) fa_bwd_dq_f32_kernel<DP>: dQ of one (q row, 64-query tile), the
//      heaviest first, S and dP recomputed, then dQ += dS K.
//  No atomics, a fixed order: two calls give the same bits.  Tiles staged
//  with 16-byte cp.async (plain loads where Dh % 4 != 0 or a pointer is
//  not 16-byte aligned), rows DP + 4 floats (4 mod 32).  Q and dO are read
//  both ways in (b) (ldmatrix rows for S^T and dP^T, scalar columns for dV
//  and dK), and K in (c): the pad serves both patterns, since the permuted
//  k index reads rows 2 q and 2 q + 1 (banks 8 q + g, 8 q + 4 + g), so no
//  swizzle and no second copy.  Streamed tiles: 64 rows in two stages up
//  to Dh 64; above, one stage of 64 queries in (b) at Dh 128 and of 32
//  above, and of 32 keys in (c) (measured faster than two stages of half
//  the rows).  Shared memory: (b) 105,472 / 152,064 / 208,128 B and (c)
//  104,448 / 101,376 / 199,680 B at Dh 64 / 128 / 256.  Registers
//  (-Xptxas -v): (b) 255 a thread from Dh 33 up (at Dh 64 it holds dK, dV,
//  S^T and dP^T, 128 f32), (c) 168 / 204 / 255 at Dh 64 / 128 / 256, no
//  spill.
//
// C interface (loaded with ctypes): fa_backward launches the kernels on the
// given stream of the given device, leaves the caller's current device as
// it found it, does not synchronise, and returns a cudaError_t (0 on
// success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_BWD_DH = 256;
constexpr int THREADS = 256;          // the D and sum passes
enum Route { ROUTE_F32 = 0, ROUTE_TMA = 1, ROUTE_COPY = 2 };

// Whether query `qry` sees key `key` (absolute positions) in the forward.
__device__ __forceinline__ bool visible(int qry, int key, int S, int window) {
  return key <= qry && qry < S && (window == 0 || key + window > qry);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// -- (a) D = rowsum(dO o O) ---------------------------------------------------

// f32: D (bh, S).  bf16: ld (bh, 2, sp) with sp = S rounded up to 64: row
// 2 b holds lse log2 e, row 2 b + 1 holds D, zeros past S, so that TMA
// loads both for a 64-query tile in one box.  LANES lanes an item (a row
// and query): 8 with 16-byte loads (bf16 rows of 16-byte multiples), else
// 32.
template <typename T, int LANES>
__global__ void __launch_bounds__(THREADS)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ out, int bh, int S,
                    int sp, int dh) {
  const int cols = lse == nullptr ? S : sp;   // queries a row: f32 writes D only
  const long long item = ((long long)blockIdx.x * THREADS + threadIdx.x) / LANES;
  const int l = threadIdx.x % LANES;
  const bool live = item < (long long)bh * cols;
  const int b = live ? (int)(item / cols) : 0, i = live ? (int)(item % cols) : 0;
  float acc = 0.f;
  if (live && i < S) {
    const T* orow = o + ((size_t)b * S + i) * dh;
    const T* drow = dout + ((size_t)b * S + i) * dh;
    if constexpr (LANES == 8) {
      for (int c = 8 * l; c < dh; c += 64) {
        const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xp[e]), yf = __bfloat1622float2(yp[e]);
          acc = fmaf(yf.x, xf.x, fmaf(yf.y, xf.y, acc));
        }
      }
    } else {
      for (int c = l; c < dh; c += LANES) acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (!live || l != 0) return;
  if (lse == nullptr) {
    out[(size_t)b * S + i] = acc;
  } else {
    out[(size_t)(2 * b) * sp + i] = i < S ? lse[(size_t)b * S + i] * LOG2E : 0.f;
    out[(size_t)(2 * b + 1) * sp + i] = acc;
  }
}

// -- bf16: wgmma, TMA ring ----------------------------------------------------

// Block shapes.  Registers are allocated to warps in groups of four, so a
// producer warp beside the consumers would cost a warpgroup's registers and
// cap every thread at 168 (ptxas gives the consumers no more than the launch
// budget, setmaxnreg or not), below dK's 223 at Dh 256.  So the blocks are
// consumer warpgroups only, and warp 0 of warpgroup 0 issues the TMA loads
// (one lane; all 32 arrive): it refills a stage once both warpgroups have
// released it.
template <int NP>   // (b) at Dh zero-filled to 64 NP
struct DkdvShape {
  // NP <= 2: one warpgroup computes dK and dV (2 NP x 32 f32 a thread
  // beside S^T and dP^T), two blocks an SM.  NP > 2: that would be 320 f32,
  // so warpgroup 0 computes dV and warpgroup 1 dK, each over all of Dh, from
  // the same tiles; both compute S^T.
  static constexpr int NWG = NP <= 2 ? 1 : 2;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int STAGES = NP == 1 ? 4 : NP == 3 ? 3 : 2;
};

template <int NP>   // (c)
struct DqShape {
  // NP <= 2: one warpgroup, two blocks an SM; NP > 2: two warpgroups, each
  // the dQ of the panels p with p % 2 == its index, both computing S and dP.
  static constexpr int NWG = NP > 2 ? 2 : 1;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int STAGES = NP == 1 ? 4 : 2;
};

template <int NP>
__host__ __device__ constexpr unsigned tile_bytes() { return NP * PANEL_BYTES; }   // 64 rows
constexpr unsigned LD_BYTES = 2 * 64 * sizeof(float);   // a tile's lse log2 e and D rows

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float* ld;            // (bh, 2, sp): lse log2 e and D rows, zero-padded
  bf16 *dq, *dk, *dv;
  float *dk_part, *dv_part;   // (chunks, BKV, S, Dh) f32; unused with one chunk
  int bkv, S, sp, dh, group, heads, chunks, pairs, window, tma;
  float scale;
};

struct Maps {                 // TMA maps: q, k, v, dO (bf16 tiles) and ld
  CUtensorMap q, k, v, dout, ld;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// The copy route: `rows` (<= 64) rows of a contiguous (rows, dh) slab into
// a tile of swizzled panels, zero-filled, by one warp.
template <int NP>
__device__ __forceinline__ void copy_tile(bf16* tile, const bf16* src, int rows, int dh,
                                          int lane) {
  constexpr int W = 64 * NP;
  for (int e = lane; e < 64 * W; e += 32) {
    const int r = e / W, c = e - r * W;
    tile[sw128_offset(r, c)] =
        r < rows && c < dh ? src[(size_t)r * dh + c] : __float2bfloat16(0.f);
  }
}

// Load the 64-row tiles at row0 of matrix n of two (n, S, dh) tensors into
// t0 and t1 and, with `lds`, the tile's ld rows (matrix n's lse and D at
// queries row0..row0 + 63), completing on `bar` (32 arrivals, one a lane of
// the calling warp): by TMA from lane 0, or copied by the warp.
template <int NP>
__device__ __forceinline__ void load_tiles(bf16* t0, bf16* t1, float* lds,
                                           const CUtensorMap* m0, const CUtensorMap* m1,
                                           const Maps& maps, const bf16* s0, const bf16* s1,
                                           int row0, int n, uint64_t* bar, const BwdArgs& a,
                                           int lane) {
  if (a.tma) {
    if (lane == 0) {
      mbar_arrive_tx(bar, 2 * tile_bytes<NP>() + (lds ? LD_BYTES : 0));
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load_3d(t0 + p * PANEL, m0, bar, 64 * p, row0, n);
        tma_load_3d(t1 + p * PANEL, m1, bar, 64 * p, row0, n);
      }
      if (lds) tma_load_2d(lds, &maps.ld, bar, row0, 2 * n);
    } else {
      mbar_arrive(bar);
    }
  } else {
    const size_t off = ((size_t)n * a.S + row0) * a.dh;
    copy_tile<NP>(t0, s0 + off, a.S - row0, a.dh, lane);
    copy_tile<NP>(t1, s1 + off, a.S - row0, a.dh, lane);
    if (lds)
      for (int r = lane; r < 128; r += 32)
        lds[r] = a.ld[(size_t)(2 * n + r / 64) * a.sp + row0 + r % 64];
    fence_proxy_async();
    mbar_arrive(bar);
  }
}

// A consumer warp is done with what a barrier guards: one arrival a warp.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A fragments (hi and lo halves) of columns 16 kk + [0, 16) of a 64 x 64
// accumulator (its 16 x 8 tiles 2 kk and 2 kk + 1), as the forward's P.
__device__ __forceinline__ void split_a(const float (&c)[32], int kk, unsigned (&hi)[4],
                                        unsigned (&lo)[4]) {
  split_bf16(c[8 * kk], c[8 * kk + 1], hi[0], lo[0]);
  split_bf16(c[8 * kk + 2], c[8 * kk + 3], hi[1], lo[1]);
  split_bf16(c[8 * kk + 4], c[8 * kk + 5], hi[2], lo[2]);
  split_bf16(c[8 * kk + 6], c[8 * kk + 7], hi[3], lo[3]);
}

// Byte steps of K-major step kk (16 head-dim columns) and of MN-major step
// kk (16 rows) of panel p in a tile of swizzled panels.
__device__ __forceinline__ unsigned k_step(int kk) { return (kk >> 2) * PANEL_BYTES + (kk & 3) * 32; }
__device__ __forceinline__ unsigned mn_step(int p, int kk) { return p * PANEL_BYTES + kk * 2048; }

// d = A B^T over the 64 NP columns of two K-major tiles at shared addresses
// a and b.
template <int NP>
__device__ __forceinline__ void wgmma_tile(float (&d)[32], unsigned a, unsigned b) {
  wgmma_ss_first(d, a, 0, b, 0);
#pragma unroll
  for (int kk = 1; kk < 4 * NP; ++kk) wgmma_ss(d, a, k_step(kk), b, k_step(kk));
}

// Store the pair (x, y) at columns col, col + 1 of row `row` of a (.., dh)
// slab, the columns < dh only; a pair store where dh is even.
__device__ __forceinline__ void store_pair(bf16* base, size_t row, int col, int dh, float x,
                                           float y) {
  bf16* p = base + row * dh + col;
  if ((dh & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    p[0] = __float2bfloat16(x);
    if (col + 1 < dh) p[1] = __float2bfloat16(y);
  }
}

__device__ __forceinline__ void store_pair(float* base, size_t row, int col, int dh, float x,
                                           float y) {
  float* p = base + row * dh + col;
  if ((dh & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    if (col + 1 < dh) p[1] = y;
  }
}

// Store panel p of a warpgroup's 64-row accumulator (rows row0 + 16 w + g
// (+ 8), columns 64 p + 8 j + 2 tq (+ 1)) times `mul` into a (.., dh) slab,
// rows below `rows` only.
template <typename T>
__device__ __forceinline__ void store_panel(const float (&acc)[32], T* base, size_t row0,
                                            int rows, int p, int dh, float mul, int w, int g,
                                            int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * w + g + 8 * hr, col = 64 * p + 8 * j + 2 * tq;
      if (r < rows && col < dh)
        store_pair(base, row0 + r, col, dh, acc[4 * j + 2 * hr] * mul,
                   acc[4 * j + 2 * hr + 1] * mul);
    }
}

// Shared memory of (b): k, v; STAGES x (q, dO); STAGES x ld rows; barriers.
template <int NP>
constexpr size_t dkdv_smem() {
  constexpr int STAGES = DkdvShape<NP>::STAGES;
  return 1024 + (2 + 2 * STAGES) * (size_t)tile_bytes<NP>() + STAGES * LD_BYTES +
         (2 * STAGES + 2) * sizeof(uint64_t);
}

// Shared memory of (c): q, dO; STAGES x (k, v); barriers.
template <int NP>
constexpr size_t dq_smem() {
  constexpr int STAGES = DqShape<NP>::STAGES;
  return 1024 + (2 + 2 * STAGES) * (size_t)tile_bytes<NP>() +
         (2 * STAGES + 1) * sizeof(uint64_t);
}

// (b)'s work of one block, bf16 (TQ 64) or f32: key tile kt(i) (64 keys)
// for i < nkt, then each head of the chunk, then the query tiles of TQ rows
// that see the key tile, qfirst(i) .. qlast(i); tile n of it in that order.
template <int TQ>
struct DkdvWork {
  int pair, T, nkt, S, window, heads;
  __device__ int kt(int i) const { return i == 0 ? pair : T - 1 - pair; }
  __device__ int qfirst(int i) const { return kt(i) * 64 / TQ; }
  __device__ int qlast(int i) const {
    const int last = (S - 1) / TQ;
    return window > 0 ? min(last, (kt(i) * 64 + 63 + window - 1) / TQ) : last;
  }
  __device__ int len(int i) const { return qlast(i) - qfirst(i) + 1; }
  __device__ int tiles(int i) const { return heads * len(i); }
  __device__ int total() const { return tiles(0) + (nkt == 2 ? tiles(1) : 0); }
  // (head of the chunk, query tile) of tile n
  __device__ void at(int n, int& h, int& qt) const {
    const int i = n < tiles(0) ? 0 : 1, r = i == 0 ? n : n - tiles(0);
    h = r / len(i);
    qt = qfirst(i) + r % len(i);
  }
};

// What a consumer warpgroup of (b) accumulates.
enum Role { DK_AND_DV, DV_ONLY, DK_ONLY };

template <int NP>
struct DkdvSmem {
  bf16 *ks, *vs, *stage0;              // stage s: q at 2 s TILE, dO after
  float* lds0;                         // stage s: 128 floats at 128 s
  uint64_t *full, *empty, *kv_full, *kv_empty;
};

// The issuing warp: tile n of the block's work into stage s.
template <int NP>
__device__ __forceinline__ void issue_dkdv(const DkdvSmem<NP>& sm, const Maps& maps,
                                           const BwdArgs& a, const DkdvWork<64>& wk, int bh0,
                                           int n, int s, int lane) {
  int h, qt;
  wk.at(n, h, qt);
  bf16* qs = sm.stage0 + s * 2 * NP * PANEL;
  load_tiles<NP>(qs, qs + NP * PANEL, sm.lds0 + s * 128, &maps.q, &maps.dout, maps, a.q,
                 a.dout, qt * 64, bh0 + h, &sm.full[s], a, lane);
}

// The consumer side of (b) for one warpgroup (warp w of it, lane `lane`);
// `issuer`: this is warpgroup 0's warp 0, which loads the tiles.
template <int NP, Role ROLE>
__device__ __forceinline__ void dkdv_consumer(const BwdArgs& a, const Maps& maps,
                                              const DkdvSmem<NP>& sm, const DkdvWork<64>& wk,
                                              int bkv, int chunk, int w, int lane,
                                              bool issuer) {
  constexpr int STAGES = DkdvShape<NP>::STAGES;
  constexpr bool DO_V = ROLE != DK_ONLY, DO_K = ROLE != DV_ONLY;
  const int S = a.S, window = a.window;
  const int g = lane >> 2, tq = lane & 3;
  const int bh0 = bkv * a.group + chunk * a.heads;      // this block's first q row
  const float scale_log2 = a.scale * LOG2E;
  const unsigned dk_base = smem_addr(sm.ks), dv_base = smem_addr(sm.vs);
  if (issuer) {                        // k, v and the first STAGES tiles
    load_tiles<NP>(sm.ks, sm.vs, nullptr, &maps.k, &maps.v, maps, a.k, a.v, wk.kt(0) * 64, bkv,
                   sm.kv_full, a, lane);
    for (int n = 0; n < STAGES && n < wk.total(); ++n)
      issue_dkdv<NP>(sm, maps, a, wk, bh0, n, n, lane);
  }
  int it = 0;
  for (int i = 0; i < wk.nkt; ++i) {
    const int kt = wk.kt(i), k0 = kt * 64, qlast = wk.qlast(i);
    float adv[DO_V ? NP : 1][32], adk[DO_K ? NP : 1][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if constexpr (DO_V) adv[p][e] = 0.f;
        if constexpr (DO_K) adk[p][e] = 0.f;
      }
    mbar_wait(sm.kv_full, i);
    for (int h = 0; h < wk.heads; ++h) {
      for (int qt = kt; qt <= qlast; ++qt, ++it) {
        const int s = it % STAGES, q0 = qt * 64;
        const unsigned phase = (it / STAGES) & 1;
        mbar_wait(&sm.full[s], phase);
        const bf16* qs = sm.stage0 + s * 2 * NP * PANEL;
        const unsigned dq_base = smem_addr(qs), ddo_base = smem_addr(qs + NP * PANEL);

        // S^T = K Q^T (and dP^T = V dO^T): keys 16 w + g (+ 8) by queries 8 j + 2 tq
        float st[32], dpt[32];
        wgmma_fence();
        wgmma_tile<NP>(st, dk_base, dq_base);
        if constexpr (DO_K) wgmma_tile<NP>(dpt, dv_base, ddo_base);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        if constexpr (DO_K) fence_regs(dpt);

        // P^T, dS^T; 0 where the forward masks
        const float* lrow = sm.lds0 + s * 128;          // lse log2 e, then D at + 64
        const bool inside = kt < qt && q0 + 64 <= S && (window == 0 || k0 + window > q0 + 63);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ql = 8 * j + 2 * tq;
          const float2 l2 = *reinterpret_cast<const float2*>(lrow + ql);
          const float2 d2 = DO_K ? *reinterpret_cast<const float2*>(lrow + 64 + ql) : l2;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 16 * w + g + 8 * (e >> 1);
            const int qry = q0 + ql + (e & 1);
            const float lv = (e & 1) ? l2.y : l2.x, dd = (e & 1) ? d2.y : d2.x;
            const float p = inside || visible(qry, key, S, window)
                                ? exp2f(fmaf(st[4 * j + e], scale_log2, -lv)) : 0.f;
            st[4 * j + e] = p;
            if constexpr (DO_K) dpt[4 * j + e] = p * (dpt[4 * j + e] - dd);
          }
        }
        unsigned phi[DO_V ? 4 : 1][4], plo[DO_V ? 4 : 1][4];   // P^T, hi and lo
        unsigned dhi[DO_K ? 4 : 1][4], dlo[DO_K ? 4 : 1][4];   // dS^T, hi and lo
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (DO_V) split_a(st, kk, phi[kk], plo[kk]);
          if constexpr (DO_K) split_a(dpt, kk, dhi[kk], dlo[kk]);
        }

        // dV += P^T dO, dK += dS^T Q over the tile's queries 16 kk + [0, 16).
        // The operands' registers are fenced first: a conversion that the
        // compiler sank past wgmma.fence would make ptxas serialise the batch.
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if constexpr (DO_V) fence_regs(adv[p]);
          if constexpr (DO_K) fence_regs(adk[p]);
        }
        if constexpr (DO_V) {
          fence_regs(phi);
          fence_regs(plo);
        }
        if constexpr (DO_K) {
          fence_regs(dhi);
          fence_regs(dlo);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            if constexpr (DO_V) {
              wgmma_rs(adv[p], phi[kk], ddo_base, mn_step(p, kk));
              wgmma_rs(adv[p], plo[kk], ddo_base, mn_step(p, kk));
            }
            if constexpr (DO_K) {
              wgmma_rs(adk[p], dhi[kk], dq_base, mn_step(p, kk));
              wgmma_rs(adk[p], dlo[kk], dq_base, mn_step(p, kk));
            }
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if constexpr (DO_V) fence_regs(adv[p]);
          if constexpr (DO_K) fence_regs(adk[p]);
        }
        if constexpr (DO_V) {
          fence_regs(phi);
          fence_regs(plo);
        }
        if constexpr (DO_K) {
          fence_regs(dhi);
          fence_regs(dlo);
        }
        release(&sm.empty[s], lane);
        if (issuer && it + STAGES < wk.total()) {   // refill once every warp left it
          mbar_wait(&sm.empty[s], phase);
          issue_dkdv<NP>(sm, maps, a, wk, bh0, it + STAGES, s, lane);
        }
      }
    }

    // dK = scale sum dS^T Q, dV: this chunk's sums, bf16 or f32 partials
    const size_t part = ((size_t)chunk * a.bkv + bkv) * S + k0;
    const size_t row0 = (size_t)bkv * S + k0;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (a.chunks == 1) {
        if constexpr (DO_K) store_panel(adk[p], a.dk, row0, S - k0, p, a.dh, a.scale, w, g, tq);
        if constexpr (DO_V) store_panel(adv[p], a.dv, row0, S - k0, p, a.dh, 1.f, w, g, tq);
      } else {
        if constexpr (DO_K) store_panel(adk[p], a.dk_part, part, S - k0, p, a.dh, 1.f, w, g, tq);
        if constexpr (DO_V) store_panel(adv[p], a.dv_part, part, S - k0, p, a.dh, 1.f, w, g, tq);
      }
    }
    release(sm.kv_empty, lane);        // k and v may be replaced
    if (issuer && i + 1 < wk.nkt) {
      mbar_wait(sm.kv_empty, 0);
      load_tiles<NP>(sm.ks, sm.vs, nullptr, &maps.k, &maps.v, maps, a.k, a.v, wk.kt(i + 1) * 64,
                     bkv, sm.kv_full, a, lane);
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(DkdvShape<NP>::THREADS, DkdvShape<NP>::MIN_BLOCKS)
fa_bwd_dkdv_bf16_kernel(const __grid_constant__ Maps maps, const BwdArgs a) {
  using Sh = DkdvShape<NP>;
  constexpr int STAGES = Sh::STAGES, TILE = NP * PANEL;
  extern __shared__ unsigned char smem_raw[];
  DkdvSmem<NP> sm;
  sm.ks = reinterpret_cast<bf16*>(align1024(smem_raw));
  sm.vs = sm.ks + TILE;
  sm.stage0 = sm.vs + TILE;
  sm.lds0 = reinterpret_cast<float*>(sm.stage0 + STAGES * 2 * TILE);
  sm.full = reinterpret_cast<uint64_t*>(sm.lds0 + STAGES * 128);
  sm.empty = sm.full + STAGES;
  sm.kv_full = sm.empty + STAGES;
  sm.kv_empty = sm.kv_full + 1;

  const int T = (a.S + 63) / 64;
  const int pair = blockIdx.x % a.pairs;
  const int rest = blockIdx.x / a.pairs;
  const int chunk = rest % a.chunks, bkv = rest / a.chunks;
  const DkdvWork<64> wk{pair, T, pair == T - 1 - pair ? 1 : 2, a.S, a.window, a.heads};
  const int wg = warpgroup_index(), w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], 4 * Sh::NWG);
    }
    mbar_init(sm.kv_full, 32);
    mbar_init(sm.kv_empty, 4 * Sh::NWG);
    mbar_init_fence();
  }
  __syncthreads();
  if constexpr (Sh::NWG == 1) {
    dkdv_consumer<NP, DK_AND_DV>(a, maps, sm, wk, bkv, chunk, w, lane, w == 0);
  } else if (wg == 0) {
    dkdv_consumer<NP, DV_ONLY>(a, maps, sm, wk, bkv, chunk, w, lane, w == 0);
  } else {
    dkdv_consumer<NP, DK_ONLY>(a, maps, sm, wk, bkv, chunk, w, lane, false);
  }
}

// (s): dk = scale sum_c dk_part[c], dv = sum_c dv_part[c], in chunk order,
// written in T (bf16, or f32 for the f32 route).
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_bwd_sum_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                  T* __restrict__ dk, T* __restrict__ dv, size_t n, int chunks, float scale) {
  for (size_t e = blockIdx.x * (size_t)THREADS + threadIdx.x; e < 2 * n;
       e += (size_t)gridDim.x * THREADS) {
    const bool is_k = e < n;
    const size_t i = is_k ? e : e - n;
    const float* src = (is_k ? dk_part : dv_part) + i;
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += src[(size_t)c * n];
    if (is_k) put(dk + i, acc * scale);
    else put(dv + i, acc);
  }
}

template <int NP>
__global__ void __launch_bounds__(DqShape<NP>::THREADS, DqShape<NP>::MIN_BLOCKS)
fa_bwd_dq_bf16_kernel(const __grid_constant__ Maps maps, const BwdArgs a) {
  using Sh = DqShape<NP>;
  constexpr int STAGES = Sh::STAGES, TILE = NP * PANEL;
  constexpr int PPW = (NP + Sh::NWG - 1) / Sh::NWG;    // panels a warpgroup owns, at most
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* dos = qs + TILE;
  bf16* stage0 = dos + TILE;                            // stage s: k at 2 s TILE, v after
  uint64_t* full = reinterpret_cast<uint64_t*>(stage0 + STAGES * 2 * TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int S = a.S, window = a.window;
  const int bh = blockIdx.x, bkv = bh / a.group;
  const int qt = gridDim.y - 1 - blockIdx.y;            // heaviest tiles first
  const int q0 = qt * 64;
  const int t0 = first_tile<64>(q0, window);
  const int wg = warpgroup_index(), w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const bool issuer = wg == 0 && w == 0;                // loads the tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4 * Sh::NWG);
    }
    mbar_init(q_full, 32);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int t, int s) {
    bf16* ks = stage0 + s * 2 * TILE;
    load_tiles<NP>(ks, ks + TILE, nullptr, &maps.k, &maps.v, maps, a.k, a.v, t * 64, bkv,
                   &full[s], a, lane);
  };
  int next = t0;                       // the next key tile to load
  if (issuer) {
    load_tiles<NP>(qs, dos, nullptr, &maps.q, &maps.dout, maps, a.q, a.dout, q0, bh, q_full, a,
                   lane);
    for (int s = 0; s < STAGES && next <= qt; ++s, ++next) issue(next, s);
  }

  // warpgroup wg owns the dQ panels wg, wg + NWG, ...
  const int g = lane >> 2, tq = lane & 3;
  const float scale_log2 = a.scale * LOG2E;
  const unsigned dq_base = smem_addr(qs), ddo_base = smem_addr(dos);
  float rl[2], rd[2];                  // lse log2 e and D of rows 16 w + g (+ 8)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + 16 * w + g + 8 * hr;        // < sp: the rows past S hold zeros
    rl[hr] = a.ld[(size_t)(2 * bh) * a.sp + row];
    rd[hr] = a.ld[(size_t)(2 * bh + 1) * a.sp + row];
  }
  float adq[PPW][32];
#pragma unroll
  for (int ii = 0; ii < PPW; ++ii)
#pragma unroll
    for (int e = 0; e < 32; ++e) adq[ii][e] = 0.f;
  mbar_wait(q_full, 0);

  for (int t = t0, it = 0; t <= qt; ++t, ++it) {
    const int s = it % STAGES, k0 = t * 64;
    const unsigned phase = (it / STAGES) & 1;
    mbar_wait(&full[s], phase);
    const bf16* ks = stage0 + s * 2 * TILE;
    const unsigned dk_base = smem_addr(ks), dv_base = smem_addr(ks + TILE);

    // S = Q K^T, dP = dO V^T: queries 16 w + g (+ 8) by keys 8 j + 2 tq
    float st[32], dpt[32];
    wgmma_fence();
    wgmma_tile<NP>(st, dq_base, dk_base);
    wgmma_tile<NP>(dpt, ddo_base, dv_base);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // dS = P o (dP - D); 0 where the forward masks
    const bool inside = t < qt && q0 + 64 <= S && (window == 0 || k0 + window > q0 + 63);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qry = q0 + 16 * w + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        const float p = inside || visible(qry, key, S, window)
                            ? exp2f(fmaf(st[4 * j + e], scale_log2, -rl[e >> 1])) : 0.f;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - rd[e >> 1]);
      }
    unsigned dhi[4][4], dlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_a(dpt, kk, dhi[kk], dlo[kk]);

    // dQ += dS K over the tile's keys 16 kk + [0, 16), operands fenced first
#pragma unroll
    for (int ii = 0; ii < PPW; ++ii) fence_regs(adq[ii]);
    fence_regs(dhi);
    fence_regs(dlo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int ii = 0; ii < PPW; ++ii) {
        const int p = wg + ii * Sh::NWG;
        if (p < NP) {
          wgmma_rs(adq[ii], dhi[kk], dk_base, mn_step(p, kk));
          wgmma_rs(adq[ii], dlo[kk], dk_base, mn_step(p, kk));
        }
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ii = 0; ii < PPW; ++ii) fence_regs(adq[ii]);
    fence_regs(dhi);
    fence_regs(dlo);
    release(&empty[s], lane);
    if (issuer && next <= qt) {        // refill the stage once every warp left it
      mbar_wait(&empty[s], phase);
      issue(next++, s);
    }
  }

#pragma unroll
  for (int ii = 0; ii < PPW; ++ii) {
    const int p = wg + ii * Sh::NWG;
    if (p < NP)
      store_panel(adq[ii], a.dq, (size_t)bh * S + q0, S - q0, p, a.dh, a.scale, w, g, tq);
  }
}

// -- f32: 3xTF32 on mma.sync --------------------------------------------------

// (b) at padded head dim DP: 4 warps (NWG 1) computing dK and dV of 16 keys
// each, or above Dh 64 8 warps over the same 64 keys, warpgroup 0 S^T, P
// and dV, warpgroup 1 dP^T, dS and dK, P passed through shared memory (two
// products each); query tiles of TQ rows, double-buffered up to Dh 64,
// single above, where larger tiles measured faster than double-buffered
// smaller ones (chip_smoke.py --compare-parent's rows).
template <int DP>
struct DkdvF32 {
  static constexpr int NWG = DP <= 64 ? 1 : 2;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int TQ = DP <= 128 ? 64 : 32;
  static constexpr int STAGES = DP <= 64 ? 2 : 1;
  static constexpr int LD = f32_ld(DP);
};

// (c): 4 warps of 16 query rows, key tiles of TK rows, double-buffered up
// to Dh 64, single above.
template <int DP>
struct DqF32 {
  static constexpr int TK = DP <= 64 ? 64 : 32;
  static constexpr int STAGES = DP <= 64 ? 2 : 1;
  static constexpr int LD = f32_ld(DP);
};

// Shared memory of (b): k, v; STAGES stages of (q, dO) and of (lse, D)
// rows; with two warpgroups, P of 64 keys x TQ queries.
template <int DP>
constexpr size_t dkdv_f32_smem() {
  using Sh = DkdvF32<DP>;
  return ((2 * 64 + 2 * Sh::STAGES * Sh::TQ) * (size_t)Sh::LD + 2 * Sh::STAGES * Sh::TQ +
          (Sh::NWG == 2 ? 64 * Sh::TQ : 0)) * sizeof(float);
}

// Shared memory of (c): q, dO; STAGES stages of (k, v).
template <int DP>
constexpr size_t dq_f32_smem() {
  using Sh = DqF32<DP>;
  return (2 * 64 + 2 * Sh::STAGES * Sh::TK) * (size_t)Sh::LD * sizeof(float);
}

struct F32Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv;
  float *dk_part, *dv_part;   // (chunks, BKV, S, Dh); unused with one chunk
  int bkv, S, dh, group, heads, chunks, pairs, window, vec;
  float scale;
};

// The whole of (b) for the warps of one role (warp w of its warpgroup):
// every warp of the block stages the tiles and meets every barrier.  Roles:
// DK_AND_DV all of it; DV_ONLY S^T, P (written to shared memory) and dV;
// DK_ONLY dP^T, then (P read back) dS and dK.
template <int DP, Role ROLE>
__device__ __forceinline__ void dkdv_f32(const F32Args& a, float* smem,
                                         const DkdvWork<DkdvF32<DP>::TQ>& wk, int bkv,
                                         int chunk, int w, int lane) {
  using Sh = DkdvF32<DP>;
  constexpr int TQ = Sh::TQ, LD = Sh::LD, NQ = TQ / 8, ND = DP / 8, NT = Sh::THREADS;
  constexpr int STAGES = Sh::STAGES;
  constexpr bool DO_V = ROLE != DK_ONLY, DO_K = ROLE != DV_ONLY, SPLIT = ROLE != DK_AND_DV;
  float* ks = smem;                    // [64][LD]
  float* vs = ks + 64 * LD;            // [64][LD]
  float* stage0 = vs + 64 * LD;        // stage s: q [TQ][LD] at 2 s TQ LD, dO after
  float* rows0 = stage0 + 2 * STAGES * TQ * LD;   // stage s: lse [TQ] at 2 s TQ, D after
  float* pw = rows0 + 2 * STAGES * TQ + w * 16 * TQ + lane;   // this warp's P, lane-major
  const int S = a.S, window = a.window, g = lane >> 2, tq = lane & 3;
  const int bh0 = bkv * a.group + chunk * a.heads;   // this block's first q row
  auto issue = [&](int n) {            // item n into stage n % STAGES
    int h, qt;
    wk.at(n, h, qt);
    const int q0 = qt * TQ, bh = bh0 + h;
    float* qs = stage0 + (n % STAGES) * 2 * TQ * LD;
    const size_t off = ((size_t)bh * S + q0) * a.dh;
    stage_f32<TQ, DP, NT>(qs, a.q + off, S - q0, a.dh, a.vec);
    stage_f32<TQ, DP, NT>(qs + TQ * LD, a.dout + off, S - q0, a.dh, a.vec);
    float* lr = rows0 + (n % STAGES) * 2 * TQ;
    for (int r = threadIdx.x; r < 2 * TQ; r += NT) {
      const float* src = (r < TQ ? a.lse : a.delta) + (size_t)bh * S;
      const int qi = q0 + r % TQ;
      cp_async4(lr + r, qi < S ? src + qi : src, qi < S ? 4 : 0);
    }
    cp_async_commit();
  };
  auto load_kv = [&](int i) {
    const int k0 = wk.kt(i) * 64;
    const size_t off = ((size_t)bkv * S + k0) * a.dh;
    stage_f32<64, DP, NT>(ks, a.k + off, S - k0, a.dh, a.vec);
    stage_f32<64, DP, NT>(vs, a.v + off, S - k0, a.dh, a.vec);
    cp_async_commit();
  };

  const int total = wk.total();
  load_kv(0);
  issue(0);
  cp_async_wait_all();
  __syncthreads();
  for (int i = 0, n = 0; i < wk.nkt; ++i) {
    const int kw = wk.kt(i) * 64 + 16 * w;        // this warp's first key
    float adv[DO_V ? ND : 1][4], adk[DO_K ? ND : 1][4];
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (DO_V) adv[c][e] = 0.f;
        if constexpr (DO_K) adk[c][e] = 0.f;
      }
    for (int end = n + wk.tiles(i); n < end; ++n) {
      if (STAGES == 2 && n + 1 < total) issue(n + 1);   // lands while item n computes
      int h, qt;
      wk.at(n, h, qt);
      const int q0 = qt * TQ;
      const float* qs = stage0 + (n % STAGES) * 2 * TQ * LD;
      const float* dos = qs + TQ * LD;
      const float* lr = rows0 + (n % STAGES) * 2 * TQ;
      // a warp whose keys no query of the tile sees skips it
      const bool live = kw < S && kw <= q0 + TQ - 1 && (window == 0 || kw + 15 + window > q0);
      // S^T = K Q^T (and dP^T = V dO^T): keys g (+ 8) by queries 8 j + 2 tq
      float st[NQ][4], dpt[DO_K ? NQ : 1][4];
      if (live) {
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] = 0.f;
            if constexpr (DO_K) dpt[j][e] = 0.f;
          }
        if constexpr (ROLE != DK_ONLY) {
          mma_abt<LD, DP, NQ>(st, ks, 16 * w, 1.f, qs, a.dh, lane);
          // P^T; 0 where the forward masks
          const bool inside =
              kw + 15 <= q0 && q0 + TQ <= S && (window == 0 || kw + window > q0 + TQ - 1);
#pragma unroll
          for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kw + g + 8 * (e >> 1), ql = 8 * j + 2 * tq + (e & 1);
              st[j][e] = inside || visible(q0 + ql, key, S, window)
                             ? expf(fmaf(st[j][e], a.scale, -lr[ql])) : 0.f;
              if constexpr (SPLIT) pw[(4 * j + e) * 32] = st[j][e];
            }
        }
        if constexpr (DO_K) mma_abt<LD, DP, NQ>(dpt, vs, 16 * w, 1.f, dos, a.dh, lane);
      }
      if constexpr (SPLIT) __syncthreads();        // P is in shared memory
      if (live) {
        if constexpr (DO_K) {
          // dS^T = P^T o (dP^T - D)
#pragma unroll
          for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = SPLIT ? pw[(4 * j + e) * 32] : st[j][e];
              dpt[j][e] = p * (dpt[j][e] - lr[TQ + 8 * j + 2 * tq + (e & 1)]);
            }
        }
        // dV += P^T dO, dK += dS^T Q over the tile's queries
        if constexpr (DO_V) mma_cb<LD, ND, NQ>(adv, st, dos, a.dh, 1.f, 1.f, lane);
        if constexpr (DO_K) mma_cb<LD, ND, NQ>(adk, dpt, qs, a.dh, 1.f, 1.f, lane);
      }
      if (STAGES == 1 && n + 1 < total) {
        __syncthreads();               // every warp has left item n
        issue(n + 1);
      }
      cp_async_wait_all();
      __syncthreads();                 // item n + 1 is in; the next copy overwrites item n
    }

    // dK = scale sum dS^T Q, dV: this chunk's sums, f32, or its partials
    const bool one = a.chunks == 1;
    const size_t row0 = (one ? (size_t)bkv : (size_t)chunk * a.bkv + bkv) * S + kw;
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = g + 8 * hr, col = 8 * c + 2 * tq;
        if (kw + r >= S || col >= a.dh) continue;
        if constexpr (DO_K)
          store_pair(one ? a.dk : a.dk_part, row0 + r, col, a.dh,
                     adk[c][2 * hr] * (one ? a.scale : 1.f),
                     adk[c][2 * hr + 1] * (one ? a.scale : 1.f));
        if constexpr (DO_V)
          store_pair(one ? a.dv : a.dv_part, row0 + r, col, a.dh, adv[c][2 * hr],
                     adv[c][2 * hr + 1]);
      }
    if (i + 1 < wk.nkt) {              // every warp has left k and v (the barrier above)
      load_kv(i + 1);
      cp_async_wait_all();
      __syncthreads();
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DkdvF32<DP>::THREADS, DkdvF32<DP>::MIN_BLOCKS)
fa_bwd_dkdv_f32_kernel(const F32Args a) {
  using Sh = DkdvF32<DP>;
  extern __shared__ __align__(16) float smem_f32[];
  const int T = (a.S + 63) / 64;
  const int pair = blockIdx.x % a.pairs;
  const int rest = blockIdx.x / a.pairs;
  const int chunk = rest % a.chunks, bkv = rest / a.chunks;
  const DkdvWork<Sh::TQ> wk{pair, T, pair == T - 1 - pair ? 1 : 2, a.S, a.window, a.heads};
  const int warp = threadIdx.x / 32, w = warp % 4, lane = threadIdx.x % 32;
  if constexpr (Sh::NWG == 1) {
    dkdv_f32<DP, DK_AND_DV>(a, smem_f32, wk, bkv, chunk, w, lane);
  } else if (warp < 4) {
    dkdv_f32<DP, DV_ONLY>(a, smem_f32, wk, bkv, chunk, w, lane);
  } else {
    dkdv_f32<DP, DK_ONLY>(a, smem_f32, wk, bkv, chunk, w, lane);
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
fa_bwd_dq_f32_kernel(const F32Args a) {
  constexpr int T = DqF32<DP>::TK, LD = DqF32<DP>::LD, NK = T / 8, ND = DP / 8;
  constexpr int TILE = T * LD, STAGES = DqF32<DP>::STAGES;
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;                // [64][LD]
  float* dos = qs + 64 * LD;           // [64][LD]
  float* stage0 = dos + 64 * LD;       // stage s: k [T][LD] at 2 s TILE, v after (s < STAGES)
  const int S = a.S, window = a.window;
  const int bh = blockIdx.x, bkv = bh / a.group;
  const int qt = gridDim.y - 1 - blockIdx.y;       // heaviest tiles first
  const int q0 = qt * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = q0 + 16 * warp;                   // this warp's first row
  const int t0 = first_tile<T>(q0, window);
  const int t1 = (min(q0 + 64, S) - 1) / T;        // the tile of the block's last key
  const float* kb = a.k + (size_t)bkv * S * a.dh;
  const float* vb = a.v + (size_t)bkv * S * a.dh;
  auto issue = [&](int t) {
    float* ks = stage0 + ((t - t0) % STAGES) * 2 * TILE;
    const int k0 = t * T;
    stage_f32<T, DP, TC_THREADS>(ks, kb + (size_t)k0 * a.dh, S - k0, a.dh, a.vec);
    stage_f32<T, DP, TC_THREADS>(ks + TILE, vb + (size_t)k0 * a.dh, S - k0, a.dh, a.vec);
    cp_async_commit();
  };

  const size_t off = ((size_t)bh * S + q0) * a.dh;
  stage_f32<64, DP, TC_THREADS>(qs, a.q + off, S - q0, a.dh, a.vec);
  stage_f32<64, DP, TC_THREADS>(dos, a.dout + off, S - q0, a.dh, a.vec);
  issue(t0);
  float rl[2], rd[2];                  // lse and D of rows r0 + g (+ 8)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    rl[hr] = row < S ? a.lse[(size_t)bh * S + row] : 0.f;
    rd[hr] = row < S ? a.delta[(size_t)bh * S + row] : 0.f;
  }
  float adq[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[c][e] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  for (int t = t0; t <= t1; ++t) {
    if (STAGES == 2 && t < t1) issue(t + 1);   // lands while tile t computes
    const float* ks = stage0 + ((t - t0) % STAGES) * 2 * TILE;
    const float* vs = ks + TILE;
    const int k0 = t * T;
    if (r0 < S && k0 <= r0 + 15 && (window == 0 || k0 + T - 1 + window > r0)) {
      // S = Q K^T, dP = dO V^T: rows g (+ 8) by keys 8 j + 2 tq
      float st[NK][4], dpt[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_abt<LD, DP, NK>(st, qs, 16 * warp, 1.f, ks, a.dh, lane);
      mma_abt<LD, DP, NK>(dpt, dos, 16 * warp, 1.f, vs, a.dh, lane);
      // dS = P o (dP - D); 0 where the forward masks
      const bool inside =
          k0 + T - 1 <= r0 && r0 + 16 <= S && (window == 0 || k0 + window > r0 + 15);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qry = r0 + g + 8 * (e >> 1), key = k0 + 8 * j + 2 * tq + (e & 1);
          const float p = inside || visible(qry, key, S, window)
                              ? expf(fmaf(st[j][e], a.scale, -rl[e >> 1])) : 0.f;
          dpt[j][e] = p * (dpt[j][e] - rd[e >> 1]);
        }
      // dQ += dS K over the tile's keys
      mma_cb<LD, ND, NK>(adq, dpt, ks, a.dh, 1.f, 1.f, lane);
    }
    if (STAGES == 1 && t < t1) {
      __syncthreads();                 // every warp has left tile t
      issue(t + 1);
    }
    cp_async_wait_all();
    __syncthreads();                   // tile t + 1 is in; the next copy overwrites tile t
  }

#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + g + 8 * hr, col = 8 * c + 2 * tq;
      if (row < S && col < a.dh)
        store_pair(a.dq, (size_t)bh * S + row, col, a.dh, adq[c][2 * hr] * a.scale,
                   adq[c][2 * hr + 1] * a.scale);
    }
}

// -- launch --------------------------------------------------------------------

// Dynamic shared memory of one block of (b) (`dkdv`) or (c), in bytes.
size_t bwd_smem_bytes(int dh, int dtype, bool dkdv) {
  if (dtype == 0) {
    switch (f32_dp(dh)) {
      case 32: return dkdv ? dkdv_f32_smem<32>() : dq_f32_smem<32>();
      case 64: return dkdv ? dkdv_f32_smem<64>() : dq_f32_smem<64>();
      case 128: return dkdv ? dkdv_f32_smem<128>() : dq_f32_smem<128>();
      default: return dkdv ? dkdv_f32_smem<256>() : dq_f32_smem<256>();
    }
  }
  switch ((dh + 63) / 64) {
    case 1: return dkdv ? dkdv_smem<1>() : dq_smem<1>();
    case 2: return dkdv ? dkdv_smem<2>() : dq_smem<2>();
    case 3: return dkdv ? dkdv_smem<3>() : dq_smem<3>();
    default: return dkdv ? dkdv_smem<4>() : dq_smem<4>();
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* scratch;
  long long scratch_floats;
  int bh, bkv, S, dh, window;
  cudaStream_t stream;
};

int padded(int S) { return (S + 63) / 64 * 64; }

// Blocks of `kernel` that an SM holds at once (its registers and shared
// memory), or 1 if the runtime cannot say.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  int n = 0;
  if (allow_smem(kernel, smem) == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) == cudaSuccess &&
      n > 0)
    return n;
  return 1;
}

// Blocks of (b) that an SM holds at once at this Dh, asked of the runtime
// once an instantiation.
template <int NP>
int dkdv_blocks_per_sm() {
  static const int blocks =
      blocks_per_sm(fa_bwd_dkdv_bf16_kernel<NP>, DkdvShape<NP>::THREADS, dkdv_smem<NP>());
  return blocks;
}

template <int DP>
int dkdv_f32_blocks_per_sm() {
  static const int blocks =
      blocks_per_sm(fa_bwd_dkdv_f32_kernel<DP>, DkdvF32<DP>::THREADS, dkdv_f32_smem<DP>());
  return blocks;
}

int dkdv_slots(int dh, int dtype, int sms) {
  if (dtype == 0) {
    switch (f32_dp(dh)) {
      case 32: return sms * dkdv_f32_blocks_per_sm<32>();
      case 64: return sms * dkdv_f32_blocks_per_sm<64>();
      case 128: return sms * dkdv_f32_blocks_per_sm<128>();
      default: return sms * dkdv_f32_blocks_per_sm<256>();
    }
  }
  switch ((dh + 63) / 64) {
    case 1: return sms * dkdv_blocks_per_sm<1>();
    case 2: return sms * dkdv_blocks_per_sm<2>();
    case 3: return sms * dkdv_blocks_per_sm<3>();
    default: return sms * dkdv_blocks_per_sm<4>();
  }
}

// The G-chunks of (b), bf16 and f32 alike: the divisor c of G whose grid (BKV x pairs x c
// blocks of G / c heads each, equal work) takes the fewest waves x tiles a
// block on `slots` concurrent blocks; the smallest on ties (each chunk
// beyond one costs the sum pass over its partials).  Qwen2-0.5B's
// training shape: 7 (448 blocks of 17 tiles); Qwen2.5-14B's heads at Dh
// 128: 1 (256 blocks, within a wave); RecurrentGemma-2B's: 10.
int head_chunks(int bkv, int group, int S, int slots) {
  const long long pairs = ((S + 63) / 64 + 1) / 2;
  int best = group;
  long long best_cost = -1;
  for (int c = 1; c <= group; ++c) {
    if (group % c) continue;
    const long long waves = (bkv * pairs * c + slots - 1) / slots;
    const long long cost = waves * (group / c);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

// Floats of the f32 D rows (bh, S), rounded up to 4 so that the partials
// after them stay 16-byte aligned.
long long f32_delta_floats(int bh, int S) { return ((long long)bh * S + 3) / 4 * 4; }

// Scratch floats: f32 the D rows, bf16 the ld rows (bh, 2, sp); with more
// than one G-chunk, then the chunks' partial dK and dV.
long long scratch_floats(int bh, int bkv, int S, int dh, int dtype, int sms) {
  const int chunks = head_chunks(bkv, bh / bkv, S, dkdv_slots(dh, dtype, sms));
  const long long rows = dtype == 0 ? f32_delta_floats(bh, S) : 2LL * bh * padded(S);
  return rows + (chunks == 1 ? 0 : 2LL * chunks * bkv * (long long)S * dh);
}

template <typename T, int LANES>
cudaError_t launch_delta(const Args& a, const float* lse, float* out) {
  const long long items = (long long)a.bh * (lse == nullptr ? a.S : padded(a.S));
  fa_bwd_delta_kernel<T, LANES><<<(unsigned)((items * LANES + THREADS - 1) / THREADS), THREADS,
                                  0, a.stream>>>(static_cast<const T*>(a.o),
                                                 static_cast<const T*>(a.dout), lse, out, a.bh,
                                                 a.S, padded(a.S), a.dh);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const Args& a, int sms) {
  const int T = (a.S + 63) / 64, group = a.bh / a.bkv;
  const int chunks = head_chunks(a.bkv, group, a.S, dkdv_slots(a.dh, 0, sms));
  const long long n = (long long)a.bkv * a.S * a.dh;
  if (a.scratch_floats < scratch_floats(a.bh, a.bkv, a.S, a.dh, 0, sms))
    return cudaErrorInvalidValue;
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto mf = [](void* p) { return static_cast<float*>(p); };
  float* delta = a.scratch;
  float* part = delta + f32_delta_floats(a.bh, a.S);
  const bool vec = a.dh % 4 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                   aligned16(a.dout);
  const F32Args b{cf(a.q), cf(a.k), cf(a.v), cf(a.dout), a.lse, delta, mf(a.dq), mf(a.dk),
                  mf(a.dv), part, part + (chunks > 1 ? chunks * n : 0), a.bkv, a.S, a.dh,
                  group, group / chunks, chunks, (T + 1) / 2, a.window, vec ? 1 : 0,
                  1.0f / sqrtf((float)a.dh)};
  cudaError_t err = launch_delta<float, 32>(a, nullptr, delta);
  if (err != cudaSuccess) return err;
  size_t smem = dkdv_f32_smem<DP>();
  if ((err = allow_smem(fa_bwd_dkdv_f32_kernel<DP>, smem)) != cudaSuccess) return err;
  fa_bwd_dkdv_f32_kernel<DP><<<a.bkv * chunks * b.pairs, DkdvF32<DP>::THREADS, smem,
                               a.stream>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (chunks > 1) {
    const long long blocks = (2 * n + THREADS - 1) / THREADS;
    fa_bwd_sum_kernel<float><<<(unsigned)(blocks < 8 * sms ? blocks : 8 * sms), THREADS, 0,
                               a.stream>>>(b.dk_part, b.dv_part, b.dk, b.dv, (size_t)n, chunks,
                                           b.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  smem = dq_f32_smem<DP>();
  if ((err = allow_smem(fa_bwd_dq_f32_kernel<DP>, smem)) != cudaSuccess) return err;
  fa_bwd_dq_f32_kernel<DP><<<dim3(a.bh, T), TC_THREADS, smem, a.stream>>>(b);
  return cudaGetLastError();
}

bool tma_route(const Args& a) {
  return a.dh % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
         aligned16(a.dout);
}

// The (bh, 2, sp) ld rows as 64 x 2 boxes (lse log2 e and D of 64 queries).
cudaError_t ld_map(EncodeTiled encode, CUtensorMap* map, const float* ld, int bh, int sp) {
  const cuuint64_t dims[2] = {(cuuint64_t)sp, 2 * (cuuint64_t)bh};
  const cuuint64_t strides[1] = {(cuuint64_t)sp * sizeof(float)};
  const cuuint32_t box[2] = {64, 2};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ld),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NP>
cudaError_t launch_bf16(const Args& a, int sms, int* route) {
  const int T = (a.S + 63) / 64, group = a.bh / a.bkv, sp = padded(a.S);
  const int chunks = head_chunks(a.bkv, group, a.S, dkdv_slots(a.dh, 1, sms));
  const long long n = (long long)a.bkv * a.S * a.dh;
  if (a.scratch_floats < scratch_floats(a.bh, a.bkv, a.S, a.dh, 1, sms))
    return cudaErrorInvalidValue;
  float* ld = a.scratch;
  float* part = ld + 2LL * a.bh * sp;
  BwdArgs b{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), ld,
            static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
            part, part + (chunks > 1 ? chunks * n : 0), a.bkv, a.S, sp, a.dh, group,
            group / chunks, chunks, (T + 1) / 2, a.window, tma_route(a) ? 1 : 0,
            1.0f / sqrtf((float)a.dh)};
  Maps maps = {};                      // the bf16 maps unused on the copy route
  if (b.tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    const void* bases[4] = {a.q, a.k, a.v, a.dout};
    const int rows[4] = {a.bh, a.bkv, a.bkv, a.bh};
    CUtensorMap* out[4] = {&maps.q, &maps.k, &maps.v, &maps.dout};
    for (int i = 0; i < 4; ++i) {
      const cudaError_t err = bf16_tile_map(encode, out[i], bases[i], rows[i], a.S, a.dh);
      if (err != cudaSuccess) return err;
    }
    const cudaError_t err = ld_map(encode, &maps.ld, ld, a.bh, sp);
    if (err != cudaSuccess) return err;
  }
  *route = b.tma ? ROUTE_TMA : ROUTE_COPY;

  const bool vec = a.dh % 8 == 0 && aligned16(a.o) && aligned16(a.dout);
  cudaError_t err =
      vec ? launch_delta<bf16, 8>(a, a.lse, ld) : launch_delta<bf16, 32>(a, a.lse, ld);
  if (err != cudaSuccess) return err;
  size_t smem = dkdv_smem<NP>();
  if ((err = allow_smem(fa_bwd_dkdv_bf16_kernel<NP>, smem)) != cudaSuccess) return err;
  fa_bwd_dkdv_bf16_kernel<NP><<<a.bkv * chunks * b.pairs, DkdvShape<NP>::THREADS, smem,
                                a.stream>>>(maps, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (chunks > 1) {
    const long long blocks = (2 * n + THREADS - 1) / THREADS;
    fa_bwd_sum_kernel<bf16><<<(unsigned)(blocks < 8 * sms ? blocks : 8 * sms), THREADS, 0,
                              a.stream>>>(b.dk_part, b.dv_part, b.dk, b.dv, (size_t)n, chunks,
                                    b.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  smem = dq_smem<NP>();
  if ((err = allow_smem(fa_bwd_dq_bf16_kernel<NP>, smem)) != cudaSuccess) return err;
  fa_bwd_dq_bf16_kernel<NP><<<dim3(a.bh, T), DqShape<NP>::THREADS, smem, a.stream>>>(maps, b);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int dtype, int sms, int* route) {
  if (dtype == 0) {
    *route = ROUTE_F32;
    switch (f32_dp(a.dh)) {
      case 32: return launch_f32<32>(a, sms);
      case 64: return launch_f32<64>(a, sms);
      case 128: return launch_f32<128>(a, sms);
      default: return launch_f32<256>(a, sms);
    }
  }
  switch ((a.dh + 63) / 64) {
    case 1: return launch_bf16<1>(a, sms, route);
    case 2: return launch_bf16<2>(a, sms, route);
    case 3: return launch_bf16<3>(a, sms, route);
    default: return launch_bf16<4>(a, sms, route);
  }
}

cudaError_t sm_count(int device, int* sms) {
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

extern "C" {

// The largest head dim the backward takes.
int fa_bwd_max_head_dim() { return MAX_BWD_DH; }

// Dynamic shared memory of one block of (b) (dkdv != 0) or (c) at head dim
// dh for dtype (0 = float32, 1 = bfloat16), in bytes; -1 for another dtype.
int fa_bwd_smem_bytes(int dh, int dtype, int dkdv) {
  if ((dtype != 0 && dtype != 1) || dh <= 0 || dh > MAX_BWD_DH) return -1;
  return (int)bwd_smem_bytes(dh, dtype, dkdv != 0);
}

// Floats of f32 scratch that fa_backward needs for these shapes on
// `device`, or -1 for a bad shape or dtype or if the device's SM count
// cannot be read.
long long fa_bwd_scratch_floats(int bh, int bkv, int S, int dh, int dtype, int device) {
  int sms = 0;
  if (bkv <= 0 || bh % bkv || S <= 0 || (dtype != 0 && dtype != 1) ||
      sm_count(device, &sms) != cudaSuccess)
    return -1;
  return scratch_floats(bh, bkv, S, dh, dtype, sms);
}

// q, o, dout, dq (bh, S, dh); k, v, dk, dv (bkv, S, dh); all contiguous, one
// dtype (0 = float32, 1 = bfloat16); lse (bh, S) float32 from fa_forward;
// scratch at least fa_bwd_scratch_floats floats, 16-byte aligned.  bh % bkv
// == 0, 0 < dh <= 256, the 64-row tiles of S at most 65535, window 0
// (causal) or the local window (>= 1), as in the forward that wrote lse.
// *route receives 0 (f32), 1 (bf16, TMA) or 2 (bf16, tiles copied by a
// warp).
int fa_backward(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, void* dq, void* dk, void* dv, float* scratch,
                long long scratch_floats_given, int bh, int bkv, int S, int dh, int window,
                int dtype, int device, void* stream, int* route) {
  if (bh <= 0 || bkv <= 0 || bh % bkv || S <= 0 || dh <= 0 || dh > MAX_BWD_DH || window < 0)
    return cudaErrorInvalidValue;
  if ((S + 63) / 64 > 65535 || (dtype != 0 && dtype != 1) || !aligned16(scratch))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  // Make the device's primary context current on this host thread, as the
  // driver's cuTensorMapEncodeTiled needs and no earlier call may have done
  // (autograd runs the backward on threads of its own).
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(device, &sms)) != cudaSuccess) return err;
  if (scratch_floats_given < scratch_floats(bh, bkv, S, dh, dtype, sms))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, scratch, scratch_floats_given,
               bh, bkv, S, dh, window, static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, sms, route);
}

}  // extern "C"
