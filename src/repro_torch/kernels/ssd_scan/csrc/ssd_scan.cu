// Mamba-2 SSD chunked scan on Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel
//    src/repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas (body _ssd_kernel):
//    per chunk of Q positions,
//        y = (C B^T ⊙ L)(dt·x) + exp(cum) · C h^T,   L[i,j] = exp(cum_i - cum_j), j <= i
//        h <- exp(cum_Q) h + sum_s exp(cum_Q - cum_s) (dt·x)_s ⊗ B_s
//    with cum the running sum of a = dt·A inside the chunk, and the final
//    (P, N) state emitted.  B and C (ngroups = 1) are shared across heads.
//    f32 in, f32 out.
//
// Layout.  The model's own: x (batch, S, H, P), dt (batch, S, H), A (H,),
// B and C (batch, S, N), optional h0 (batch, H, P, N); y (batch, S, H, P)
// and h (batch, H, P, N).  All contiguous; the kernels compute their own
// offsets, so the TPU wrapper's head-major copies are not needed.
//
// Bound on an H100 SXM at the serving micro-batch of Mamba2-130M (batch 4,
// S 1,024, H 24, P 64, N 128), chunk Q = 64.  Bytes: the function moves
// ~58 MB (x and y 25.2 MB each, B and C 4.2, h 3.1), 17 us at 3.35 TB/s.
// Operations: 3.667 GFLOP in chunked form, of which 3.63 are the four
// matrix products (C B^T once per batch row and chunk on its lower
// triangle; per head and chunk the intra-chunk product, the carry-in
// C h^T and the state update) and the rest the decays.  On the CUDA
// cores in f32 that is 55 us at 67 TFLOP/s.  One TF32 pass misses the 2e-4
// check against the float64 recurrence, so the products run as 3xTF32
// (three tensor-core passes, below): 3 x 3.63 GFLOP at 495 TFLOP/s plus the
// decays at 67 is 22 us, the bound on this route.
//
// Design.  The TPU grid (B·H, S/Q) carries the state across its sequential
// chunk axis.  Here the sequence is cut into spans of SPAN = 4 chunks (256
// positions) whose states are found in parallel and then joined, in three
// kernels launched in order on one stream; a span block of kernels 1 and 3
// is one (head, P tile of PT = 64, span):
//  1. ssd_scan_state_kernel, grid (batch·H, P / PT, spans + a few), 256
//     threads (two blocks an SM):
//     * each span block: the span's local state from zero, sum_s
//       exp(sum_{s<t<=end} a_t) dt_s x_s ⊗ B_s, as one product of depth the
//       span's length accumulated in registers across its 64-position
//       panels (B and x panels double-buffered), and the span's summed a.
//       The span states take 12.6 MB at the serving shape;
//     * the launch's last blocks, two per (batch row, chunk), which fill the
//       SMs the span blocks leave in the last wave: C B^T of that chunk,
//       once (B and C are shared by all heads and P tiles), the tiles on or
//       below the diagonal only, stored transposed as cbt[b][c][j][i] =
//       C_i · B_j (zero for j > i): a (batch, chunks, Q, Q) scratch, 1 MB.
//  2. ssd_scan_pass_kernel, grid (batch·H, P·N / 512): one thread per state
//     element walks the spans in order, h_in[k + 1] = exp(sum a over span k)
//     h_in[k] + local[k] from h0 (or 0), writes h_in in place over the
//     local states and the final state to hout.  Elementwise, coalesced.
//     Where a gradient is needed the wrapper keeps these entering states
//     for the backward (ssd_scan_bwd.cu).
//  3. ssd_scan_out_kernel, grid (batch·H, P / PT, spans), 512 threads: each
//     block starts from its span's h_in and walks the span's chunks: y =
//     (C B^T ⊙ L)(dt·x) + exp(cum) C h^T, stored in the model layout, then the
//     state update for every chunk but the span's last.  Staging runs a
//     chunk ahead: C, the cbt tile, dt and x in two buffers where they fit
//     (N <= 128), B in one, refilled as soon as the chunk's update is done
//     with it.
//  * Decays.  Every decay is a segment sum of a, summed by warp-shuffle
//    scans (two 32-lane scans per 64 values): cum_i (prefix), the suffix
//    sums inside a chunk or panel, and, for L, each column j of the Q x Q
//    triangle summed over rows j+1..i: 8 threads a column, each a running
//    sum over 8 rows plus an exclusive scan of the blocks before it across
//    the 8 (all 64 columns at once).  Sums across panels add whole panels'
//    sums.  Never exp(cum_i - cum_j): the difference of two
//    running sums loses digits where a head decays fast (1.1e-3 against
//    the float64 recurrence at the serving shape, where 2e-4 is asked); a
//    scan adds only the terms of each segment.  exp is taken only where
//    j <= i (above the diagonal it would overflow).
//  * Products.  All four on mma.sync m16n8k8 TF32 with f32 accumulation,
//    each operand split hi/lo (split_tf32) and acc += a_hi b_hi plus the
//    small terms a_lo b_hi + a_hi b_lo, summed first in an accumulator of
//    their own: within the 2e-4 check for 3 tensor-core passes, where one
//    pass is not (PERF.md has the error on the card).  The weights (dt,
//    the decays) are applied to an operand before the split.  Each warp
//    owns a 16-row band of an output and 8-column tiles of it; C B^T skips
//    the tiles above the diagonal, the intra-chunk product the k-steps past
//    it.  The carry-in, the largest product, has both operands with k
//    contiguous (C's rows, the state's rows), so its fragments come by
//    ldmatrix; the others are read a word at a time.
//  * Staging.  16-byte cp.async (4-byte for dt); where N or P is not a
//    multiple of 4, or a pointer is not 16-byte aligned, plain loads
//    instead.  N is zero-filled to a multiple of 8 (32 for B and h) and P to
//    PT in shared memory only; a ragged last chunk is zero-filled (dt = 0
//    there: it adds nothing and decays nothing), and its rows past S are not
//    stored.  The out kernel's (PT, N) state slice stays in shared memory.
//    Row pads keep every fragment read free of bank conflicts: rows read as
//    a (row, k) operand are 4 mod 32 floats apart, rows read as a
//    (k, column) operand 8 mod 32.  Shared memory a block (smem_bytes) at
//    N = 128: state 108,560 B, out 210,960; the out kernel single-buffers
//    where two buffers would not fit (N > 128).  PT is 64 up to N = 128 and
//    32 above (tile_of): at PT 64 the state kernel's eight warps would hold
//    more than two (16-row band, 32-column) items each.  The span (4) and
//    the P tile (64) were chosen by measuring spans of 2, 4 and 8 at PT 32
//    and 64 (PERF.md).
//
// What it issues at the serving shape (span 4, PT 64): products of 4.98
// GFLOP (C B^T 0.04; state kernel 1.61; out kernel: carry-in 1.61, intra
// 0.50, state update on 12 of 16 chunks 1.21), 14.9 GFLOP of TF32 mma with
// the split; the state update runs twice over 3 of every 4 chunks.  About 130 MB of device
// memory traffic: x twice, y once, the span states four times (written,
// read and rewritten, read), B and C once per kernel that reads them and
// then again from L2 for every head, cbt twice.  The measured time and
// where it goes are in PERF.md.
//
// The staging and 3xTF32 helpers and cb_tiles live in ssd_common.cuh, which
// the backward (ssd_scan_bwd.cu) shares.
//
// C interface (loaded with ctypes): ssd_forward launches the three kernels
// on the given stream of the given device, leaves the caller's current
// device as it found it, does not synchronise, allocates nothing (the
// caller passes the scratch), and returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "ssd_common.cuh"

namespace {

constexpr int THREADS = 512;           // cb, pass and out kernels
constexpr int WARPS = THREADS / 32;
constexpr int STATE_THREADS = 256;     // state kernel: two blocks an SM
static_assert(THREADS == 8 * 64, "the out kernel sums L's 64 columns 8 threads a column");
constexpr int STATE_WARPS = STATE_THREADS / 32;
constexpr int MAX_N = 256;
constexpr int SPAN = 4;                // chunks a span: 256 positions
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory of one block
constexpr int LDM = Q + 8;             // row stride of the cbt / M tile

__host__ __device__ constexpr int ldx(int pt) { return pt + 8; }

// Shared memory, in floats.
__host__ __device__ constexpr int state_stage(int N, int pt) {
  return Q * ld8(N) + Q * ldx(pt);                  // B, x
}
__host__ __device__ constexpr int state_floats(int N, int pt, int stages) {
  return stages * state_stage(N, pt) + 2 * SPAN * Q + SPAN;   // + weights, sums
}
__host__ __device__ constexpr int out_floats(int N, int pt, int ab) {
  return ab * (Q * ld4(N) + Q * LDM + Q) + Q * ld8(N)   // C, cbt and dt ab times, B
         + 2 * Q * ldx(pt) + pt * ld4(N) + 2 * Q + 4;   // x twice, h, exp(cum), w, decay
}

// -- device helpers -----------------------------------------------------------

// x[j][p] *= dt_j for the Q rows of a staged (Q x PT) x tile.
template <int PT>
__device__ __forceinline__ void scale_rows(float* __restrict__ xs, const float* __restrict__ ds) {
  for (int e = threadIdx.x; e < Q * PT; e += THREADS) {
    const int r = e / PT, c = e - r * PT;
    xs[r * ldx(PT) + c] *= ds[r];
  }
}

// h[PT][ldh] <- decay h + (w ⊙ xdt)^T B for the block's state slice: A = the
// (PT x Q) transpose of dt·x (rows scaled by w), B = the (Q x N32) B tile, N32 =
// N rounded up to 32 (B and h zero past N).  Work items are (16-row band,
// 32 columns), dealt to the warps in turn.
template <int PT>
__device__ __forceinline__ void state_update(float* __restrict__ hs, int ldh,
                                             const float* __restrict__ xs,
                                             const float* __restrict__ bs, int ldb,
                                             const float* __restrict__ w, float decay, int N32) {
  constexpr int BANDS = PT / 16;
  constexpr int LX = ldx(PT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int item = warp; item < BANDS * (N32 / 32); item += WARPS) {
    const int band = item % BANDS, c0 = 32 * (item / BANDS);
    float* ht = hs + 16 * band * ldh + c0;
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = 8 * t + 2 * q;
      acc[t][0] = decay * ht[g * ldh + c];
      acc[t][1] = decay * ht[g * ldh + c + 1];
      acc[t][2] = decay * ht[(g + 8) * ldh + c];
      acc[t][3] = decay * ht[(g + 8) * ldh + c + 1];
    }
    mma3<4>(acc, 0, Q, 0, 4,
            [&](int r, int k) { return xs[k * LX + 16 * band + r] * w[k]; },
            [&](int k, int c) { return bs[k * ldb + c0 + c]; });
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = 8 * t + 2 * q;
      ht[g * ldh + c] = acc[t][0];
      ht[g * ldh + c + 1] = acc[t][1];
      ht[(g + 8) * ldh + c] = acc[t][2];
      ht[(g + 8) * ldh + c + 1] = acc[t][3];
    }
  }
}

// -- kernels ------------------------------------------------------------------

// Span-local states: h_local = sum over the span's positions s of
// exp(sum_{s<t<=end} a_t) dt_s x_s ⊗ B_s, one product of depth the span's
// length, accumulated in registers across its 64-position panels.  The
// weights are segment sums too: the suffix inside a panel plus the sums of
// the panels after it.
template <int PT>
__global__ void __launch_bounds__(STATE_THREADS, 2)
ssd_scan_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ cbt,
                      float* __restrict__ states, float* __restrict__ logdec, int batch,
                      int S, int H, int P, int N, int n_spans, int stages,
                      int x_vec, int bc_vec) {
  extern __shared__ __align__(16) float smem[];
  const int nc = (S + Q - 1) / Q;
  if ((int)blockIdx.z >= n_spans) {   // the launch's last blocks: C B^T, two per chunk
    const int id = ((blockIdx.z - n_spans) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (id < 2 * nc * batch)
      cb_tiles(Bm, Cm, cbt, smem, id / 2 / nc, id / 2 % nc, id % 2, nc, S, N, bc_vec);
    return;
  }
  const int LB = ld8(N), N32 = round_up(N, 32);
  constexpr int LX = ldx(PT);
  constexpr int BANDS = PT / 16;
  const int stage = state_stage(N, PT);
  float* wd = smem + stages * stage;  // [SPAN Q] dt, then dt exp(sum_{s<t<=end} a_t)
  float* sfx = wd + SPAN * Q;         // [SPAN Q] suffix sums of a inside each panel
  float* tot = sfx + SPAN * Q;        // [SPAN] each panel's sum of a

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PT, pw = min(PT, P - p0);
  const int c0 = blockIdx.z * SPAN, c1 = min(nc, c0 + SPAN), np = c1 - c0;
  const float a_h = A[h];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;

  auto stage_panel = [&](float* buf, int c) {
    const int s0 = c * Q, len = min(Q, S - s0);
    const size_t row0 = (size_t)b * S + s0;
    stage_rows(buf, LB, Bm + row0 * N, N, len, N, N32, bc_vec);
    stage_rows(buf + Q * LB, LX, x + (row0 * H + h) * P + p0, (size_t)H * P, len, pw, PT,
               x_vec);
  };
  stage_panel(smem, c0);
  cp_async_commit();

  for (int s = threadIdx.x; s < np * Q; s += STATE_THREADS) {
    const int pos = c0 * Q + s;
    wd[s] = pos < S ? dt[((size_t)b * S + pos) * H + h] : 0.f;
  }
  __syncthreads();
  for (int pnl = warp; pnl < np; pnl += STATE_WARPS) {
    const float* d = wd + pnl * Q;
    float* f = sfx + pnl * Q;
    const float r0 = warp_scan(d[63 - lane] * a_h);      // sum_{t >= 63 - lane}
    const float r1 = warp_scan(d[31 - lane] * a_h) + __shfl_sync(FULL, r0, 31);
    f[62 - lane] = r0;
    if (lane < 31) f[30 - lane] = r1;
    if (lane == 0) f[63] = 0.f;
    if (lane == 31) tot[pnl] = r1;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < np * Q; s += STATE_THREADS) {
    float later = 0.f;
    for (int k = s / Q + 1; k < np; ++k) later += tot[k];
    wd[s] *= expf(sfx[s] + later);
  }

  // warp: items (16-row band, 32 columns) warp and warp + STATE_WARPS
  const int items = BANDS * (N32 / 32);
  float acc[2][4][4] = {};
  for (int c = c0; c < c1; ++c) {
    float* buf = smem + (stages == 2 ? ((c - c0) & 1) * stage : 0);
    if (stages == 2 && c + 1 < c1) {
      stage_panel(smem + ((c - c0 + 1) & 1) * stage, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bs = buf;
    const float* xs = buf + Q * LB;
    const float* coef = wd + (c - c0) * Q;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int item = warp + j * STATE_WARPS;
      if (item >= items) break;
      const int band = item % BANDS, cb = 32 * (item / BANDS);
      mma3<4>(acc[j], 0, Q, 0, 4,
              [&](int r, int k) { return xs[k * LX + 16 * band + r] * coef[k]; },
              [&](int k, int col) { return bs[k * LB + cb + col]; });
    }
    __syncthreads();
    if (stages == 1 && c + 1 < c1) {
      stage_panel(smem, c + 1);
      cp_async_commit();
    }
  }

  float* dst = states + (((size_t)bh * n_spans + blockIdx.z) * P + p0) * N;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int item = warp + j * STATE_WARPS;
    if (item >= items) break;
    const int band = item % BANDS, cb = 32 * (item / BANDS);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = cb + 8 * t + 2 * q;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * band + g + 8 * hf;
        if (r >= pw) continue;
        if (col < N) dst[(size_t)r * N + col] = acc[j][t][2 * hf];
        if (col + 1 < N) dst[(size_t)r * N + col + 1] = acc[j][t][2 * hf + 1];
      }
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    float sum = 0.f;
    for (int k = 0; k < np; ++k) sum += tot[k];
    logdec[(size_t)bh * n_spans + blockIdx.z] = sum;
  }
}

// State passing across spans, one thread per state element: h_in[0] = h0
// (or 0), h_in[k + 1] = exp(sum a over span k) h_in[k] + local[k], written in
// place over the local states; the last carries on into hout.  Eight spans'
// loads are in flight at a time.
__global__ void __launch_bounds__(THREADS)
ssd_scan_pass_kernel(const float* __restrict__ h0, float* __restrict__ states,
                     const float* __restrict__ logdec, float* __restrict__ hout, int PN,
                     int n_spans) {
  const int bh = blockIdx.x;
  const int e = blockIdx.y * THREADS + threadIdx.x;
  if (e >= PN) return;
  float hv = h0 != nullptr ? h0[(size_t)bh * PN + e] : 0.f;
  float* st = states + (size_t)bh * n_spans * PN + e;
  const float* ld = logdec + (size_t)bh * n_spans;
  for (int k0 = 0; k0 < n_spans; k0 += 8) {
    float local[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k0 + k < n_spans) local[k] = st[(size_t)(k0 + k) * PN];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k0 + k >= n_spans) break;
      st[(size_t)(k0 + k) * PN] = hv;
      hv = fmaf(expf(ld[k0 + k]), hv, local[k]);
    }
  }
  hout[(size_t)bh * PN + e] = hv;
}

// y over a span from the state entering it (hin, from the pass kernel).
//
// Staging runs a chunk ahead.  Group A of chunk c + 1 (C, the cbt tile, dt
// and x) goes into the second of AB buffers: with AB = 2 it is issued as
// chunk c starts, with AB = 1 once chunk c's y is done with the one buffer.
// Group B (B, one buffer) of chunk c + 1 is issued once chunk c's state
// update is done with it.
template <int PT, int AB>
__global__ void __launch_bounds__(THREADS)
ssd_scan_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ cbt,
                    const float* __restrict__ hin, float* __restrict__ y, int S, int H,
                    int P, int N, int x_vec, int bc_vec) {
  extern __shared__ __align__(16) float smem[];
  const int LC = ld4(N), LB = ld8(N), NP = round_up(N, 8), N32 = round_up(N, 32);
  constexpr int LX = ldx(PT);
  constexpr int NB = PT / 32;         // 8-column tiles of y per warp (4 warps a band)
  const int abuf = Q * LC + Q * LDM + Q;
  float* abufs = smem;                // [AB] C [Q][LC], cbt^T tile [Q][LDM], dt [Q]
  float* bs = abufs + AB * abuf;      // [Q][LB] B rows
  float* xbuf = bs + Q * LB;          // [2][Q][LX] x -> dt·x, by chunk parity
  float* hs = xbuf + 2 * Q * LX;      // [PT][LC] the block's state slice
  float* ec = hs + PT * LC;           // [Q] exp(cum_i)
  float* w = ec + Q;                  // [Q] exp(sum_{s>j} a_s)
  float* decay = w + Q;               // [1] exp(sum a over the chunk)

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PT, pw = min(PT, P - p0);
  const int nc = (S + Q - 1) / Q;
  const int c0 = blockIdx.z * SPAN, c1 = min(nc, c0 + SPAN);
  const float a_h = A[h];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;

  auto stage_a = [&](int c) {
    const int s0 = c * Q, len = min(Q, S - s0);
    const size_t row0 = (size_t)b * S + s0;
    float* a_c = abufs + (AB == 2 ? (c - c0) & 1 : 0) * abuf;
    stage_rows(a_c, LC, Cm + row0 * N, N, len, N, NP, bc_vec);
    stage_rows(a_c + Q * LC, LDM, cbt + ((size_t)b * nc + c) * Q * Q, Q, Q, Q, Q, true);
    stage_dt(a_c + Q * LC + Q * LDM, dt, row0 * H + h, H, len);
    stage_rows(xbuf + ((c - c0) & 1) * Q * LX, LX, x + (row0 * H + h) * P + p0,
               (size_t)H * P, len, pw, PT, x_vec);
  };
  auto stage_b = [&](int c) {       // only for chunks followed by an update
    const int s0 = c * Q, len = min(Q, S - s0);
    stage_rows(bs, LB, Bm + ((size_t)b * S + s0) * N, N, len, N, N32, bc_vec);
  };
  stage_a(c0);
  stage_rows(hs, LC, hin + (((size_t)bh * gridDim.z + blockIdx.z) * P + p0) * N, N, pw, N,
             N32, bc_vec, PT);
  cp_async_commit();
  if (c0 + 1 < c1) stage_b(c0);
  cp_async_commit();

  for (int c = c0; c < c1; ++c) {
    const bool more = c + 1 < c1;
    const int s0 = c * Q, len = min(Q, S - s0);
    float* xs = xbuf + ((c - c0) & 1) * Q * LX;
    const float* cs = abufs + (AB == 2 ? (c - c0) & 1 : 0) * abuf;   // C rows of the chunk
    float* ms = const_cast<float*>(cs) + Q * LC;   // cbt^T tile -> (C B^T ⊙ L)^T
    const float* ds = ms + Q * LDM;                // dt
    if constexpr (AB == 2) {
      if (more) stage_a(c + 1);     // into the buffers chunk c - 1 left
      cp_async_commit();
      cp_async_wait<2>();           // group A of c (B of c and A of c + 1 may be in flight)
    } else {
      cp_async_wait<1>();           // group A of c (B of c may be in flight)
    }
    __syncthreads();

    // 1. decays; x -> dt·x; M^T[j][i] = cbt[j][i] exp(sum_{j<s<=i} a_s) for
    //    i >= j, else 0
    chunk_decays(ds, a_h, ec, w, decay);    // warps 0 and 1
    scale_rows<PT>(xs, ds);
    {
      // thread: rows i0 .. i0 + 7 of column j: a running sum of a_i (i > j)
      // over its rows, plus the sum over the column's earlier row blocks,
      // an exclusive scan across the column's 8 lanes
      const int j = threadIdx.x >> 3, r = threadIdx.x & 7, i0 = 8 * r;
      const float4 d0 = *reinterpret_cast<const float4*>(ds + i0);
      const float4 d1 = *reinterpret_cast<const float4*>(ds + i0 + 4);
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      float run[8], total = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        total += i0 + u > j ? d[u] * a_h : 0.f;
        run[u] = total;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        const float t = __shfl_up_sync(FULL, total, off, 8);
        if (r >= off) total += t;
      }
      float before = __shfl_up_sync(FULL, total, 1, 8);
      if (r == 0) before = 0.f;
      float4* mrow = reinterpret_cast<float4*>(ms + j * LDM + i0);
      float4 m[2] = {mrow[0], mrow[1]};
      float* mv = reinterpret_cast<float*>(m);
#pragma unroll
      for (int u = 0; u < 8; ++u)   // __expf: relative error ~1e-6 where it matters
        mv[u] = i0 + u >= j ? mv[u] * __expf(before + run[u]) : 0.f;
      mrow[0] = m[0];
      mrow[1] = m[1];
    }
    __syncthreads();

    // 2. y rows of band warp / 4, columns pc .. pc + 8 NB: the carry-in
    //    C h^T scaled by exp(cum_i), then the intra-chunk M (dt·x) up to the
    //    diagonal.  Warp w runs on scheduler w % 4, so each scheduler gets one
    //    warp of every band and the same share of the triangle.
    {
      const int band = warp >> 2, pc = (warp & 3) * NB * 8;
      float acc[NB][4] = {};
      mma3_ldsm<NB>(acc, cs + 16 * band * LC, LC, hs + pc * LC, LC, NP);
      const float e0 = ec[16 * band + g], e1 = ec[16 * band + g + 8];
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        acc[t][0] *= e0;
        acc[t][1] *= e0;
        acc[t][2] *= e1;
        acc[t][3] *= e1;
      }
      mma3<NB>(acc, 0, 16 * band + 16, 0, NB,
               [&](int r, int k) { return ms[k * LDM + 16 * band + r]; },
               [&](int k, int col) { return xs[k * LX + pc + col]; });
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const int col = pc + 8 * t + 2 * q;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * band + g + 8 * hf;
          if (i >= len) continue;
          float* dst = y + (((size_t)b * S + s0 + i) * H + h) * P + p0;
          if (col < pw) dst[col] = acc[t][2 * hf];
          if (col + 1 < pw) dst[col + 1] = acc[t][2 * hf + 1];
        }
      }
    }
    __syncthreads();                // C, cbt, dt and hs read; the other x buffer free
    if constexpr (AB == 1) {
      if (more) stage_a(c + 1);
      cp_async_commit();
    }

    // 3. the state entering the next chunk of the span
    if (more) {
      cp_async_wait<1>();           // group B of c
      __syncthreads();
      state_update<PT>(hs, LC, xs, bs, LB, w, *decay, N32);
      __syncthreads();              // B read
      if (c + 2 < c1) stage_b(c + 1);
    }
    cp_async_commit();
  }
}

// Stages of the state kernel's panels: two where they fit.
int state_stages(int N, int pt) {
  return state_floats(N, pt, 2) * (int)sizeof(float) <= SMEM_LIMIT ? 2 : 1;
}

// The state kernel's dynamic shared memory: its spans' blocks' or, if more,
// its C B^T blocks'.
int state_smem_bytes(int N, int pt) {
  const int floats = state_floats(N, pt, state_stages(N, pt));
  return (floats > cb_floats(N) ? floats : cb_floats(N)) * (int)sizeof(float);
}

// Buffers for the out kernel's group A: two where they fit.
int out_buffers(int N, int pt) {
  return out_floats(N, pt, 2) * (int)sizeof(float) <= SMEM_LIMIT ? 2 : 1;
}

// The P tile: 64 up to N = 128, else 32.  The state kernel's warps hold at
// most two (16-row band, 32-column) items each, PT / 16 * ceil(N / 32) <=
// 2 * STATE_WARPS, which PT 64 meets only up to N = 128; PT 32 meets it, and
// fits the out kernel's shared memory, up to MAX_N.
constexpr int TILE_MAX_N = 128;
static_assert(64 / 16 * (TILE_MAX_N / 32) <= 2 * STATE_WARPS, "PT 64 state items");
static_assert(32 / 16 * (MAX_N / 32) <= 2 * STATE_WARPS, "PT 32 state items");
static_assert(out_floats(TILE_MAX_N, 64, 1) * 4 <= SMEM_LIMIT, "PT 64 out smem");
static_assert(out_floats(MAX_N, 32, 1) * 4 <= SMEM_LIMIT, "PT 32 out smem");
int tile_of(int N) { return N <= TILE_MAX_N ? 64 : 32; }

template <int PT>
cudaError_t launch_spans(const float* x, const float* dt, const float* A, const float* Bm,
                         const float* Cm, float* cbt, float* states, float* logdec,
                         float* y, int batch, int S, int H, int P, int N,
                         int n_spans, int x_vec, int bc_vec, bool out_phase,
                         cudaStream_t stream) {
  const dim3 grid(batch * H, (P + PT - 1) / PT, n_spans);
  if (!out_phase) {
    // C B^T rides in extra z-slices after the spans' blocks (2 per chunk)
    const int nc = (S + Q - 1) / Q, per_z = grid.x * grid.y;
    const dim3 with_cb(grid.x, grid.y, n_spans + (2 * nc * batch + per_z - 1) / per_z);
    const int stages = state_stages(N, PT);
    const int smem = state_smem_bytes(N, PT);
    cudaError_t err = cudaFuncSetAttribute(ssd_scan_state_kernel<PT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ssd_scan_state_kernel<PT><<<with_cb, STATE_THREADS, smem, stream>>>(
        x, dt, A, Bm, Cm, cbt, states, logdec, batch, S, H, P, N, n_spans, stages,
        x_vec, bc_vec);
    return cudaGetLastError();
  }
  const int ab = out_buffers(N, PT);
  const int smem = out_floats(N, PT, ab) * (int)sizeof(float);
  const auto kernel = ab == 2 ? ssd_scan_out_kernel<PT, 2> : ssd_scan_out_kernel<PT, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(x, dt, A, Bm, Cm, cbt, states, y, S, H, P, N, x_vec,
                                          bc_vec);
  return cudaGetLastError();
}

cudaError_t launch_spans_tiled(int pt, const float* x, const float* dt, const float* A,
                               const float* Bm, const float* Cm, float* cbt,
                               float* states, float* logdec, float* y, int batch, int S,
                               int H, int P, int N, int n_spans, int x_vec, int bc_vec,
                               bool out_phase, cudaStream_t stream) {
  if (pt == 64)
    return launch_spans<64>(x, dt, A, Bm, Cm, cbt, states, logdec, y, batch, S, H, P, N,
                            n_spans, x_vec, bc_vec, out_phase, stream);
  return launch_spans<32>(x, dt, A, Bm, Cm, cbt, states, logdec, y, batch, S, H, P, N, n_spans,
                          x_vec, bc_vec, out_phase, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of a phase (0 state, 1 pass, 2 out) at
// state size N, in bytes; -1 for another phase.
int ssd_smem_bytes(int phase, int N) {
  const int t = tile_of(N);
  switch (phase) {
    case 0: return state_smem_bytes(N, t);
    case 1: return 0;
    case 2: return out_floats(N, t, out_buffers(N, t)) * (int)sizeof(float);
    default: return -1;
  }
}

// x (batch, S, H, P), dt (batch, S, H), A (H,), Bm and Cm (batch, S, N),
// h0 (batch, H, P, N) or null; y (batch, S, H, P), hout (batch, H, P, N).
// Scratch from the caller: cbt (batch, ceil(S / 64), 64, 64), states
// (batch·H, n_spans, P, N) and logdec (batch·H, n_spans) with n_spans =
// ceil(ceil(S / 64) / 4).  All float32 and contiguous; 0 < N <= 256.
int ssd_forward(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* h0, void* y, void* hout, void* cbt,
                void* states, void* logdec, int batch, int S, int H, int P, int N,
                int device, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      (long long)batch * H > INT_MAX || (long long)P * N > INT_MAX)
    return cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q, n_spans = (nc + SPAN - 1) / SPAN;
  const int tile = tile_of(N);
  const int PN = P * N;
  if (batch > 65535 || (P + tile - 1) / tile > 65535 || n_spans > 65535 ||
      (PN + THREADS - 1) / THREADS > 65535)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *dtf = static_cast<const float*>(dt),
              *Af = static_cast<const float*>(A), *Bf = static_cast<const float*>(Bm),
              *Cf = static_cast<const float*>(Cm);
  float *cbtf = static_cast<float*>(cbt), *stf = static_cast<float*>(states),
        *ldf = static_cast<float*>(logdec);
  const int x_vec = P % 4 == 0 && aligned16(x);
  const int bc_vec = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);

  cudaError_t err = launch_spans_tiled(tile, xf, dtf, Af, Bf, Cf, cbtf, stf, ldf, nullptr, batch,
                                       S, H, P, N, n_spans, x_vec, bc_vec, false, s);
  if (err != cudaSuccess) return err;
  ssd_scan_pass_kernel<<<dim3(batch * H, (PN + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(h0), stf, ldf, static_cast<float*>(hout), PN, n_spans);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_spans_tiled(tile, xf, dtf, Af, Bf, Cf, cbtf, stf, ldf, static_cast<float*>(y),
                            batch, S, H, P, N, n_spans, x_vec, bc_vec, true, s);
}

}  // extern "C"
