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
// f32 in, f32 out.  The plain version is ref.py::ssd_bwd_ref: the same
// chunked formulas, though these kernels group them otherwise (below: the
// adjoint walked in one pass, LD B and LD^T C once per group of heads).
//
// Layout.  The model's own, as the forward's: x and dy (batch, S, H, P), dt
// (batch, S, H), A (H,), B and C (batch, S, N), dh and dh0 (batch, H, P,
// N); and the forward's span states (batch·H, n_spans, P, N), the state
// entering each span of SPAN = 4 chunks of Q = 64 positions, which the
// forward keeps when a gradient is needed.
//
// Design: chunks of Q positions (the last zero-filled past S: dt = 0 there
// decays nothing and adds nothing), three kernels in order on one stream.
//  1. ssd_bwd_carry_kernel, grid (batch·H, P / WT, 1 + spans + a few), 512
//     threads, three kinds of block; a walk keeps a (WT x N) state tile in
//     registers (WT 64 up to N 128, else 32: one (16-row band, 32-column)
//     item a warp) and updates it by 3xTF32 products:
//     * z = 0, the adjoint: walks a head's chunks backwards from dh (or 0),
//       writing R_c (the adjoint entering chunk c from its right) before
//       each update R_{c-1} = exp(sum a over c) R_c + (ec ⊙ dy)^T C, ec_t =
//       exp(cum_t), cum the running sum of a from the chunk's start; dh0 at
//       the start.  One pass: no chunk-local adjoints in device memory;
//     * z = 1 .. spans, the state: from the span's saved state, the state
//       entering each chunk of the span, h <- exp(sum a) h + (w dt ⊙ x)^T B,
//       w_t = exp(sum_{s>t} a_s), as the forward's out kernel walks it;
//     * the last z-slices, one block per (batch row, chunk): C B^T of that
//       chunk, once for all heads (ssd_common.cuh's cb_tiles, the forward's),
//       as cbt[b][c][j][i] = C_i · B_j, zero above the diagonal.
//     Panels (B or C rows, x or dy columns, dt) are double-buffered by
//     cp.async.  R and h_in are written with the chunk kernel's row strides
//     (r_ld, h_ld), so that a head's tile is one contiguous run.
//  2. ssd_bwd_chunk_kernel, grid (batch x head groups, chunks), 512 threads,
//     one block a group of `group` heads (at most 6, host-chosen so that
//     the waves of one block an SM are fewest) of one chunk: for each head
//     the dual quadratic form, with L[j][k] = exp(sum_{k<s<=j} a_s) for j >= k,
//     M = L ⊙ C B^T, DX = dy (dt x)^T, LD = L ⊙ DX, K = M ⊙ DX, D = exp(sum a),
//     R and h_in from 1:
//        g B = M^T dy + (w ⊙ B) R^T  ->  dx = dt ⊙ g B, <x, g B>;
//        v_k = ((w dt ⊙ x) R)_k · B_k,  u_j = ((ec ⊙ dy) h_in)_j · C_j;
//        da_i = sum_{j>=i>k} K[j][k] + sum_{j>=i} u_j + sum_{k<i} v_k
//               + D <R, h_in>,
//     and ddt; the group's dB rows sum (w dt ⊙ x) R over its heads and add
//     LDsum^T C once, its dC rows (ec ⊙ dy) h_in and LDsum B, LDsum = the
//     heads' LD summed in head order.  The group's rows and each head's sum
//     of dt·da go to scratch.
//  3. ssd_bwd_sum_kernel: dB and dC as the sum of the groups' rows, group 0
//     first, and dA_h as the sum of its (batch row, chunk) partials, in
//     order.  Every sum runs in a fixed order: two calls give the same bits.
//  * da is formed as the inner product itself, split by where the state's
//    and the adjoint's terms come from; the textbook route (a reverse
//    cumsum of the rows and columns of dL ⊙ L) subtracts large terms where
//    heads decay fast.  Every decay is a segment sum of a (warp scans, or a
//    running sum down a column of L), never exp(cum_i - cum_j), whose
//    difference of two running sums loses digits (ssd_scan.cu's note).
//  * Products: mma.sync m16n8k8 TF32 with each operand split hi/lo
//    (ssd_common.cuh's mma3), the weights (dt, ec, w) applied to an operand
//    before the split and L's mask to DX after it (LD, K); one TF32 pass
//    misses the check against float64 (tests/test_torch_ssd_scan.py
//    emulates both).  Not wgmma: its TF32 operands must be K-major in shared
//    memory, and M^T dy, (w ⊙ B) R^T and LD^T C read theirs transposed.
//    Triangles: DX's tiles above the diagonal are skipped, and M^T dy,
//    LDsum B and LDsum^T C start or stop their k-steps at the diagonal band.
//  * The chunk kernel holds one (P, N) tile of 64 x 128 (larger P or N loop
//    over tiles, restaged where needed, and N > 128 takes groups of one
//    head) in 230,992 B of shared memory, one block an SM.  Where P and N
//    fit one tile, B and C are staged once a block and a head's loads are
//    spread so that they land under products: R and h_in as two bulk copies
//    completing on an mbarrier (issued by one thread as the head starts),
//    dt and dy a head ahead into the other of two buffers, x as soon as the
//    previous head's (w dt ⊙ x) R is done.  cp.async issued by every thread
//    at one point stalls them all while the bytes arrive, and bulk copies a
//    row at a time were slower still (PERF.md).  L's columns are summed with
//    a warp's 32 lanes on 32 columns of one row, so its stores hit 32 banks.
//
// Bound on an H100 SXM at the training microbatch of Mamba2-130M (batch 4,
// S 1,024, H 24, P 64, N 128), chunk 64.  Bytes: x, dy and dx 25.2 MB
// each, dt and ddt 0.4 each, B, C, dB and dC 2.1 each, the span states
// 12.6: ~98 MB, 29 us at 3.35 TB/s.  Operations in chunked form, a
// multiply-add counted as 2: per batch row and chunk C B^T on the 2,080
// lower pairs (2 N each); per head and chunk on those pairs dy (dt x)^T
// and M^T dy (2 P each), LD B and LD^T C (2 N each), and the four full
// products dy h_in, (dt x) R, B R^T and the local adjoint (2 Q P N each):
// 8.9 GFLOP, 54 us as 3xTF32 on the tensor cores, which bounds it.
// What these kernels issue: products of 9.04 GFLOP (the adjoint walk 1.61,
// the state walk 1.21 on 12 of 16 chunks, C B^T 0.04; per head and chunk
// the three full products (w ⊙ B) R^T, (ec ⊙ dy) h_in and (w dt ⊙ x) R
// 1.61 each, DX on 20 of 32 tiles 0.50, M^T dy from the diagonal band
// 0.50; LDsum B and LDsum^T C 0.34 for 4 groups of 6 heads), 27.1 GFLOP of
// TF32 mma with the split; ~400 MB of traffic (carry ~171: dy, x and the
// span states read, R and h_in 52 and 54 MB written with their row pads;
// chunk ~207: R, h_in, x and dy read, dx written, the groups' dB and dC
// rows 8.4 MB each; sum 21), and B, C and cbt again from L2 for every
// block.  The five kernels before this design issued ~14 GFLOP of f32 FMA
// on the CUDA cores and ~300 MB on their own estimate.  The measured time
// is in PERF.md.
//
// C interface (loaded with ctypes): ssd_backward launches the three kernels
// on the given stream of the given device, leaves the caller's current
// device as it found it, does not synchronise, allocates nothing (the
// caller passes the scratch), checks every launch and attribute call, and
// returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "ssd_common.cuh"

namespace {

constexpr int SPAN = 4;                // chunks per span of the saved states
constexpr int MAX_N = 256;
// carry kernel: a (WT x N) state tile, WT 64 up to N 128 else 32, items
// (16-row band, 32 columns), at most one a warp
constexpr int CARRY_THREADS = 512;
constexpr int CARRY_WARPS = CARRY_THREADS / 32;
static_assert(64 / 16 * (128 / 32) <= CARRY_WARPS, "WT 64 items");
static_assert(32 / 16 * (MAX_N / 32) <= CARRY_WARPS, "WT 32 items");
// chunk kernel
constexpr int CHUNK_THREADS = 512;
constexpr int CHUNK_WARPS = CHUNK_THREADS / 32;
static_assert(CHUNK_THREADS == 8 * Q, "L's columns 8 threads a column");
constexpr int PT = 64;                 // P tile
constexpr int NT = 128;                // N tile
constexpr int MAX_GROUP = 6;           // heads a chunk block covers at most
constexpr int LQ = Q + 8;              // Q x Q matrices L/K/LDsum and M: 8 mod 32
constexpr int LP = PT + 4;             // dy and x tiles: 4 mod 32
constexpr int LB = NT + 4;             // B and R tiles: 4 mod 32
constexpr int LC = NT + 8;             // C and h_in tiles: 8 mod 32
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory of one block

// The chunk kernel's shared memory, in floats: B, C, R, h_in; L/K and M;
// dy (two heads), x; dt (two heads), ec, w, da1, sfx; u, v and <x, g B>
// by column quarter; <R, h_in> by warp; exp(sum a).
constexpr int CHUNK_FLOATS = Q * LB + Q * LC + PT * LB + PT * LC + 2 * Q * LQ + 3 * Q * LP +
                             6 * Q + 12 * Q + CHUNK_WARPS + 2 + 2;
static_assert(CHUNK_FLOATS * 4 <= SMEM_LIMIT, "chunk kernel shared memory");

// Row strides of R and h_in in device memory: where N fits one tile, the
// chunk kernel's own (LB, LC), the columns from N to N rounded up to 32
// zero, so that a head's (P, N) tile is one contiguous run that lands in
// shared memory as it lies, padding included; else N.
__host__ __device__ constexpr int r_ld(int N) { return N <= NT ? LB : N; }
__host__ __device__ constexpr int h_ld(int N) { return N <= NT ? LC : N; }

// The carry kernel's, in floats: two stages of (B or C panel, x or dy
// panel, dt), then ec, w and exp(sum a); or a C B^T block's.
__host__ __device__ constexpr int carry_stage(int N, int wt) {
  return Q * ld8(N) + Q * (wt + 8) + Q;
}
__host__ __device__ constexpr int carry_floats(int N, int wt) {
  return 2 * carry_stage(N, wt) + 2 * Q + 4 > cb_floats(N) ? 2 * carry_stage(N, wt) + 2 * Q + 4
                                                           : cb_floats(N);
}
static_assert(carry_floats(MAX_N, 32) * 4 <= SMEM_LIMIT, "carry kernel shared memory");
static_assert(carry_floats(128, 64) * 4 <= SMEM_LIMIT, "carry kernel shared memory");

// dst[r * ld + c] = v0 and dst[r * ld + c + 1] = v1 where r < rows and the
// column < cols; one 8-byte store where both columns are in and the address
// is 8-byte aligned.
__device__ __forceinline__ void store_pair(float* __restrict__ dst, int ld, int r, int c,
                                           int rows, int cols, float v0, float v1) {
  if (r >= rows) return;
  float* p = dst + (size_t)r * ld + c;
  if (c + 1 < cols && (reinterpret_cast<size_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (c < cols) p[0] = v0;
    if (c + 1 < cols) p[1] = v1;
  }
}

// -- kernels ------------------------------------------------------------------

// The carries (see the note): the adjoint walk (z = 0), the state walks
// (z = 1 .. n_spans) and C B^T (the z-slices after them).
template <int WT>
__global__ void __launch_bounds__(CARRY_THREADS)
ssd_bwd_carry_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ dy,
                     const float* __restrict__ dh, const float* __restrict__ states,
                     float* __restrict__ R, float* __restrict__ hin, float* __restrict__ dh0,
                     float* __restrict__ cbt, int batch, int S, int H, int P, int N,
                     int n_spans, int x_vec, int bc_vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LW = WT + 8;          // row stride of the (Q x WT) panel: 8 mod 32
  constexpr int BANDS = WT / 16;
  const int nc = (S + Q - 1) / Q, z = blockIdx.z;
  if (z > n_spans) {
    const int id = ((z - 1 - n_spans) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (id < nc * batch) cb_tiles(Bm, Cm, cbt, smem, id / nc, id % nc, 0, nc, S, N, bc_vec);
    return;
  }
  const bool adjoint = z == 0;
  const int LBP = ld8(N), N32 = round_up(N, 32), stage = carry_stage(N, WT);
  float* ec = smem + 2 * stage;       // [Q] exp(cum_i)
  float* w = ec + Q;                  // [Q] exp(sum_{s>i} a_s)
  float* decay = w + Q;               // [1] exp(sum a over the chunk)
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * WT, pw = min(WT, P - p0);
  const float a_h = A[h];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int items = BANDS * (N32 / 32);

  // the adjoint: chunks nc - 1 .. 0, each updated; a state walk: the span's
  // chunks, all but the last updated
  const int first = adjoint ? nc - 1 : (z - 1) * SPAN;
  const int count = adjoint ? nc : min(nc, first + SPAN) - first;
  const int step = adjoint ? -1 : 1, updates = adjoint ? count : count - 1;
  const float* asrc = adjoint ? dy : x;
  const float* bsrc = adjoint ? Cm : Bm;
  float* out = adjoint ? R : hin;
  const int ld_out = adjoint ? r_ld(N) : h_ld(N);
  const float* init = adjoint ? (dh != nullptr ? dh + (size_t)bh * P * N : nullptr)
                              : states + ((size_t)bh * n_spans + z - 1) * P * N;

  auto stage_panel = [&](float* buf, int c) {
    const int s0 = c * Q, len = min(Q, S - s0);
    const size_t row0 = (size_t)b * S + s0;
    stage_rows(buf, LBP, bsrc + row0 * N, N, len, N, N32, bc_vec);
    stage_rows(buf + Q * LBP, LW, asrc + (row0 * H + h) * P + p0, (size_t)H * P, len, pw, WT,
               x_vec);
    stage_dt(buf + Q * LBP + Q * LW, dt, row0 * H + h, H, len);
    cp_async_commit();
  };
  if (updates > 0) stage_panel(smem, first);

  // the state tile: the warp's item is (band, 32 columns from cb)
  const int band = warp % BANDS, cb = 32 * (warp / BANDS);
  const bool on = warp < items;       // warp-uniform
  float acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * band + g + 8 * (e >> 1), col = cb + 8 * t + 2 * q + (e & 1);
      acc[t][e] = init != nullptr && on && r < pw && col < N ? init[(size_t)(p0 + r) * N + col]
                                                             : 0.f;
    }
  // dst: row p0 of a (P, cols) state, row stride ld; columns N .. cols hold
  // zeros (the B or C panel is zero there)
  auto store_tile = [&](float* dst, int ld, int cols) {
    if (!on) return;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_pair(dst, ld, 16 * band + g + 8 * hf, cb + 8 * t + 2 * q, pw, cols,
                   acc[t][2 * hf], acc[t][2 * hf + 1]);
  };

  for (int k = 0; k < count; ++k) {
    const int c = first + step * k;
    store_tile(out + (((size_t)bh * nc + c) * P + p0) * ld_out, ld_out, ld_out > N ? N32 : N);
    if (k == updates) break;
    if (k + 1 < updates) {
      stage_panel(smem + ((k + 1) & 1) * stage, c + step);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bp = smem + (k & 1) * stage;
    const float* ap = bp + Q * LBP;
    const float* ds = ap + Q * LW;
    chunk_decays(ds, a_h, ec, w, decay);  // warps 0 and 1
    __syncthreads();
    const float d = *decay;
    if (on) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] *= d;
      if (adjoint)
        mma3<4>(acc, 0, Q, 0, 4,
                [&](int r, int kk) { return ap[kk * LW + 16 * band + r] * ec[kk]; },
                [&](int kk, int col) { return bp[kk * LBP + cb + col]; });
      else
        mma3<4>(acc, 0, Q, 0, 4,
                [&](int r, int kk) { return ap[kk * LW + 16 * band + r] * (w[kk] * ds[kk]); },
                [&](int kk, int col) { return bp[kk * LBP + cb + col]; });
    }
    __syncthreads();                  // the panel and the decays read
  }
  if (adjoint) store_tile(dh0 + ((size_t)bh * P + p0) * N, N, N);
}

// One chunk of a group of heads: dx, ddt, the group's dB and dC rows, and
// each head's sum of dt·da (see the note).  Warp w owns the 16-row band w / 4
// of every (Q x .) product and its quarter w % 4 of the columns.
//
// Staging where P and N fit one tile (`single`): B and C once; a head's R and
// h_in as two bulk copies issued by one thread as the head starts, landing
// under its decays, L, DX and K; its dy (and dt) a head ahead, into the other
// of two buffers; its x once the previous head's (w dt ⊙ x) R is done.  So a
// head's loads land under products instead of stalling the block at once.
// Otherwise each tile is staged (cp.async) where it is needed.
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ dy,
                     const float* __restrict__ R, const float* __restrict__ hin,
                     const float* __restrict__ cbt, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dBp, float* __restrict__ dCp,
                     float* __restrict__ dApart, int S, int H, int P, int N, int group,
                     int n_groups, int x_vec, int bc_vec, int rh_vec) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                   // [Q][LB] B, an N tile
  float* cs = bs + Q * LB;            // [Q][LC] C, an N tile
  float* rs = cs + Q * LC;            // [PT][LB] R, a (P, N) tile
  float* hs = rs + PT * LB;           // [PT][LC] h_in, a (P, N) tile
  float* lk = hs + PT * LC;           // [Q][LQ] L, K, K's exclusive row sums, LDsum
  float* ms = lk + Q * LQ;            // [Q][LQ] M
  float* ys2 = ms + Q * LQ;           // [2][Q][LP] dy, a P tile, by head parity
  float* xs = ys2 + 2 * Q * LP;       // [Q][LP] x, a P tile
  float* dts = xs + Q * LP;           // [2][Q] dt, by head parity
  float* ec = dts + 2 * Q;            // [Q] exp(cum_i)
  float* w = ec + Q;                  // [Q] exp(sum_{s>i} a_s)
  float* da1 = w + Q;                 // [Q] sum_{j>=i>k} K[j][k]
  float* sfx = da1 + Q;               // [Q] sum_{j>=i} u_j
  float* up = sfx + Q;                // [4][Q] u_j by column quarter
  float* vp = up + 4 * Q;             // [4][Q] v_k by column quarter
  float* tp = vp + 4 * Q;             // [4][Q] <x_k, (g B)_k> by column quarter
  float* red = tp + 4 * Q;            // [CHUNK_WARPS] <R, h_in> by warp
  float* decay = red + CHUNK_WARPS;   // [2] exp(sum a)
  uint64_t* bar = reinterpret_cast<uint64_t*>(decay + 2);   // R and h_in by bulk copy

  const int b = blockIdx.x / n_groups, grp = blockIdx.x - b * n_groups;
  const int h_lo = grp * group, h_hi = min(H, h_lo + group);
  const int nc = (S + Q - 1) / Q, c = blockIdx.y, s0 = c * Q, len = min(Q, S - s0);
  const size_t row0 = (size_t)b * S + s0;
  const int n_pt = (P + PT - 1) / PT, n_nt = (N + NT - 1) / NT;
  const bool single = n_pt == 1 && n_nt == 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int band = warp >> 2, quad = warp & 3;
  const float* cbt_c = cbt + ((size_t)b * nc + c) * Q * Q;

  auto p_width = [&](int pt) { return min(PT, P - pt * PT); };
  auto n_width = [&](int nt) { return min(NT, N - nt * NT); };
  auto stage_dy = [&](float* ys, int h, int pt) {
    stage_rows(ys, LP, dy + (row0 * H + h) * P + pt * PT, (size_t)H * P, len, p_width(pt), PT,
               x_vec);
  };
  auto stage_x = [&](int h, int pt) {
    stage_rows(xs, LP, x + (row0 * H + h) * P + pt * PT, (size_t)H * P, len, p_width(pt), PT,
               x_vec);
  };
  // tile (pt, nt) of R and h_in
  auto stage_rh = [&](int h, int tile) {
    const int pt = tile / n_nt, nt = tile - pt * n_nt, nw = n_width(nt);
    const size_t row = (((size_t)b * H + h) * nc + c) * P + pt * PT;
    stage_rows(rs, LB, R + row * r_ld(N) + nt * NT, r_ld(N), p_width(pt), nw, round_up(nw, 32),
               rh_vec, PT);
    stage_rows(hs, LC, hin + row * h_ld(N) + nt * NT, h_ld(N), p_width(pt), nw,
               round_up(nw, 32), rh_vec, PT);
  };
  auto stage_bc = [&](int nt) {
    const int nw = n_width(nt);
    stage_rows(bs, LB, Bm + row0 * N + nt * NT, N, len, nw, round_up(nw, 32), bc_vec);
    stage_rows(cs, LC, Cm + row0 * N + nt * NT, N, len, nw, round_up(nw, 32), bc_vec);
  };
  // the tiles staged now; another is staged (synchronously) where it is needed
  int have_yx = -1, have_rh = -1, have_bc = -1;
  auto restage = [&](int& have, int want, auto stage) {
    if (have == want) return;
    __syncthreads();                  // the old tile read
    stage(want);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    have = want;
  };

  if (tid < 4 * Q) up[tid] = vp[tid] = tp[tid] = 0.f;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  if (single) {                       // R's and h_in's rows past P, never copied
    for (int e = P * LB + tid; e < PT * LB; e += CHUNK_THREADS) rs[e] = 0.f;
    for (int e = P * LC + tid; e < PT * LC; e += CHUNK_THREADS) hs[e] = 0.f;
  }
  __syncthreads();
  if (single) {
    stage_bc(0);
    stage_dt(dts, dt, row0 * H + h_lo, H, len);
    stage_dy(ys2, h_lo, 0);
    stage_x(h_lo, 0);
    cp_async_commit();
    have_bc = 0;
  }

  float ldsum[2][4] = {};             // LDsum on the warp's two DX tiles
  float dca[4][4] = {}, dba[4][4] = {};   // the group's dC and dB rows, the warp's tile
  // the warp's DX tiles: columns 16 quad .. + 16 of its band, those on or
  // below the diagonal
  const int dx_tiles = min(2, max(0, 2 * band + 2 - 2 * quad));
  const int r_lo = 16 * band + g, r_hi = r_lo + 8;     // the thread's rows of a band

  for (int h = h_lo; h < h_hi; ++h) {
    const int bh = b * H + h;
    const bool last = h + 1 == h_hi, ahead = single && !last;
    const float a_h = A[h];
    const float* ds = dts + ((h - h_lo) & 1) * Q;
    float* ys = ys2 + (single ? (h - h_lo) & 1 : 0) * Q * LP;
    auto need_yx = [&](int pt) {
      restage(have_yx, pt, [&](int t) {
        stage_dy(ys, h, t);
        stage_x(h, t);
      });
    };
    auto need_rh = [&](int tile) {
      restage(have_rh, tile, [&](int t) { stage_rh(h, t); });
    };
    auto need_bc = [&](int nt) { restage(have_bc, nt, stage_bc); };
    if (single) {
      have_yx = have_rh = 0;
    } else {
      have_yx = have_rh = -1;
      stage_dt(dts + ((h - h_lo) & 1) * Q, dt, row0 * H + h, H, len);
      cp_async_commit();
    }
    cp_async_wait<0>();               // dt, dy and x of this head
    fence_proxy_async();              // the last head's reads of R and h_in before the copies
    __syncthreads();
    if (single && tid == 0) {         // R and h_in: two bulk copies, landing under 1-4
      const size_t row = (((size_t)b * H + h) * nc + c) * P;
      mbar_arrive_tx(bar, P * (LB + LC) * 4);
      bulk_copy(rs, R + row * LB, P * LB * 4, bar);
      bulk_copy(hs, hin + row * LC, P * LC * 4, bar);
    }

    // 1. decays; L and M = L ⊙ C B^T: thread (column k, rows 8 r .. 8 r + 7),
    //    a running sum of a_j (j > k) over its rows plus the sums of the
    //    column's earlier row blocks (through `blk`, the other dy buffer);
    //    a warp's 32 columns share a row, so its stores hit 32 banks
    chunk_decays(ds, a_h, ec, w, decay);    // warps 0 and 1
    {
      float* blk = ys2 + (single ? 1 - ((h - h_lo) & 1) : 1) * Q * LP;   // [8][Q]
      const int k = tid & (Q - 1), r = tid >> 6, j0 = 8 * r;
      const float4 m0 = *reinterpret_cast<const float4*>(cbt_c + k * Q + j0);
      const float4 m1 = *reinterpret_cast<const float4*>(cbt_c + k * Q + j0 + 4);
      const float4 d0 = *reinterpret_cast<const float4*>(ds + j0);
      const float4 d1 = *reinterpret_cast<const float4*>(ds + j0 + 4);
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      float run[8], total = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        total += j0 + u > k ? d[u] * a_h : 0.f;
        run[u] = total;
      }
      blk[r * Q + k] = total;
      __syncthreads();
      float before = 0.f;
      for (int rr = 0; rr < r; ++rr) before += blk[rr * Q + k];
      const float cb[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};   // C_j · B_k
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float l = j0 + u >= k ? expf(before + run[u]) : 0.f;
        lk[(j0 + u) * LQ + k] = l;
        ms[(j0 + u) * LQ + k] = l * cb[u];
      }
    }

    // 2. DX = dy (dt x)^T on the warp's tiles (registers)
    const float dt_lo = ds[16 * quad + g], dt_hi = ds[16 * quad + 8 + g];   // B's columns
    float dxr[2][4] = {};
    for (int pt = 0; pt < n_pt; ++pt) {
      need_yx(pt);
      if (dx_tiles > 0)
        mma3<2>(dxr, 0, round_up(p_width(pt), 8), 0, dx_tiles,
                [&](int r, int kk) { return ys[(16 * band + r) * LP + kk]; },
                [&](int kk, int col) {
                  return xs[(16 * quad + col) * LP + kk] * (col & 8 ? dt_hi : dt_lo);
                });
    }
    __syncthreads();                  // L and M written

    // 3. LDsum += L ⊙ DX; K = M ⊙ DX over L in lk (zero above the diagonal)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * band + g + 8 * (e >> 1), k = 16 * quad + 8 * t + 2 * q + (e & 1);
        ldsum[t][e] = fmaf(lk[j * LQ + k], dxr[t][e], ldsum[t][e]);
        dxr[t][e] *= ms[j * LQ + k];
      }
    __syncthreads();                  // L read
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * band + g + 8 * (e >> 1), k = 16 * quad + 8 * t + 2 * q + (e & 1);
        lk[j * LQ + k] = dxr[t][e];
      }
    __syncthreads();

    // 4. the first term of da, sum_{j>=i} sum_{k<i} K[j][k]: each row's
    //    exclusive prefix sums (a warp a row), then each column's sum from
    //    the diagonal down (8 threads a column)
    for (int j = warp; j < Q; j += CHUNK_WARPS) {
      const float s0v = warp_scan(lk[j * LQ + lane]);
      const float tot = __shfl_sync(FULL, s0v, 31);
      const float s1v = warp_scan(lk[j * LQ + lane + 32]) + tot;
      float e0 = __shfl_up_sync(FULL, s0v, 1), e1 = __shfl_up_sync(FULL, s1v, 1);
      if (lane == 0) {
        e0 = 0.f;
        e1 = tot;
      }
      lk[j * LQ + lane] = e0;
      lk[j * LQ + lane + 32] = e1;
    }
    __syncthreads();
    {
      const int k = tid >> 3, r = tid & 7;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {   // rows r, r + 8, ..: two-way bank conflicts at most
        const int j = 8 * u + r;
        if (j >= k) s += lk[j * LQ + k];
      }
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      s += __shfl_xor_sync(FULL, s, 4);
      if (r == 0) da1[k] = s;
    }
    if (ahead) {                      // the next head's dt and dy, a head ahead
      stage_dt(dts + ((h + 1 - h_lo) & 1) * Q, dt, row0 * H + h + 1, H, len);
      stage_dy(ys2 + ((h + 1 - h_lo) & 1) * Q * LP, h + 1, 0);
      cp_async_commit();
      cp_async_wait<1>();             // all but the next head's dt and dy
    } else {
      cp_async_wait<0>();
    }
    if (single) mbar_wait(bar, (h - h_lo) & 1);
    __syncthreads();                  // and lk's row sums read
    if (last) {                       // lk is free: LDsum, complete, for the group's end
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * band + g + 8 * (e >> 1), k = 16 * quad + 8 * t + 2 * q + (e & 1);
          lk[j * LQ + k] = ldsum[t][e];
        }
    }

    // 5. g B = (w ⊙ B) R^T + M^T dy on the warp's 16 rows and 16 P columns;
    //    dx = dt ⊙ g B and <x, g B> by row
    const float w_lo = w[r_lo], w_hi = w[r_hi];
    const float ec_lo = ec[r_lo], ec_hi = ec[r_hi];
    const float wd_lo = w_lo * ds[r_lo], wd_hi = w_hi * ds[r_hi];
    for (int pt = 0; pt < n_pt; ++pt) {
      float gb[2][4] = {};
      for (int nt = 0; nt < n_nt; ++nt) {
        need_rh(pt * n_nt + nt);
        need_bc(nt);
        mma3<2>(gb, 0, round_up(n_width(nt), 8), 0, 2,
                [&](int r, int kk) {
                  return bs[(16 * band + r) * LB + kk] * (r & 8 ? w_hi : w_lo);
                },
                [&](int kk, int col) { return rs[(16 * quad + col) * LB + kk]; });
      }
      need_yx(pt);
      mma3<2>(gb, 16 * band, Q, 0, 2,
              [&](int r, int kk) { return ms[kk * LQ + 16 * band + r]; },
              [&](int kk, int col) { return ys[kk * LP + 16 * quad + col]; });
      const int pw = p_width(pt);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = 16 * band + g + 8 * hf;
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int p = 16 * quad + 8 * t + 2 * q;
          part = fmaf(xs[k * LP + p], gb[t][2 * hf], part);
          part = fmaf(xs[k * LP + p + 1], gb[t][2 * hf + 1], part);
          store_pair(dx + (row0 * H + h) * P + pt * PT, H * P, k, p, len, pw,
                     gb[t][2 * hf] * ds[k], gb[t][2 * hf + 1] * ds[k]);
        }
        part += __shfl_xor_sync(FULL, part, 1);
        part += __shfl_xor_sync(FULL, part, 2);
        if (q == 0) tp[quad * Q + k] += part;
      }
    }

    // 6. by N tile: (w dt ⊙ x) R (v, and into dB) and <R, h_in>, then ec ⊙
    //    dy h_in (u, and into dC), on the warp's 16 rows and 32 columns; at
    //    the group's last head LDsum^T C and LDsum B join them and they are
    //    stored
    float rh = 0.f;
    for (int nt = 0; nt < n_nt; ++nt) {
      const int n32 = round_up(n_width(nt), 32), c0 = 32 * quad;
      const bool on = c0 < n32;       // warp-uniform
      float tmp[4][4] = {};
      auto row_dots = [&](const float* m, int ld, float* dst) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = 16 * band + g + 8 * hf;
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              part = fmaf(tmp[t][2 * hf + e], m[j * ld + c0 + 8 * t + 2 * q + e], part);
          part += __shfl_xor_sync(FULL, part, 1);
          part += __shfl_xor_sync(FULL, part, 2);
          if (q == 0) dst[quad * Q + j] += part;
        }
      };
      auto fold = [&](float (&acc)[4][4]) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[t][e] += tmp[t][e];
            tmp[t][e] = 0.f;
          }
      };
      for (int pt = 0; pt < n_pt; ++pt) {
        need_yx(pt);
        need_rh(pt * n_nt + nt);
        if (on)
          mma3<4>(tmp, 0, round_up(p_width(pt), 8), 0, 4,
                  [&](int r, int kk) {
                    return xs[(16 * band + r) * LP + kk] * (r & 8 ? wd_hi : wd_lo);
                  },
                  [&](int kk, int col) { return rs[kk * LB + c0 + col]; });
        for (int r = warp; r < PT; r += CHUNK_WARPS)
          for (int cc = lane; cc < n32; cc += 32) rh = fmaf(rs[r * LB + cc], hs[r * LC + cc], rh);
      }
      need_bc(nt);
      if (on) {
        row_dots(bs, LB, vp);
        fold(dba);
      }
      if (ahead) {                    // x is read no more: the next head's
        __syncthreads();
        stage_x(h + 1, 0);
        cp_async_commit();
      }
      for (int pt = 0; pt < n_pt; ++pt) {
        need_yx(pt);
        need_rh(pt * n_nt + nt);
        if (on)
          mma3<4>(tmp, 0, round_up(p_width(pt), 8), 0, 4,
                  [&](int r, int kk) {
                    return ys[(16 * band + r) * LP + kk] * (r & 8 ? ec_hi : ec_lo);
                  },
                  [&](int kk, int col) { return hs[kk * LC + c0 + col]; });
      }
      need_bc(nt);
      if (on) {
        row_dots(cs, LC, up);
        fold(dca);
      }
      if (last) {
        __syncthreads();              // LDsum in lk
        if (on) {
          mma3<4>(dca, 0, 16 * band + 16, 0, 4,
                  [&](int r, int kk) { return lk[(16 * band + r) * LQ + kk]; },
                  [&](int kk, int col) { return bs[kk * LB + c0 + col]; });
          mma3<4>(dba, 16 * band, Q, 0, 4,
                  [&](int r, int kk) { return lk[kk * LQ + 16 * band + r]; },
                  [&](int kk, int col) { return cs[kk * LC + c0 + col]; });
          const int nw = n_width(nt);
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int j = 16 * band + g + 8 * hf, n = c0 + 8 * t + 2 * q;
              const size_t at = (row0 * n_groups + grp) * N + nt * NT;
              store_pair(dCp + at, n_groups * N, j, n, len, nw, dca[t][2 * hf],
                         dca[t][2 * hf + 1]);
              store_pair(dBp + at, n_groups * N, j, n, len, nw, dba[t][2 * hf],
                         dba[t][2 * hf + 1]);
            }
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) dca[t][e] = dba[t][e] = 0.f;
        }
      }
    }

    // 7. da, ddt and this head's sum of dt·da
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) rh += __shfl_xor_sync(FULL, rh, off);
    if (lane == 0) red[warp] = rh;
    __syncthreads();                  // also: every read of this head's R and h_in done
    if (warp == 0) {
      float tot = 0.f;
      for (int i = 0; i < CHUNK_WARPS; ++i) tot += red[i];
      const float E = *decay * tot;
      auto sum4 = [&](const float* v, int i) {
        return ((v[i] + v[Q + i]) + v[2 * Q + i]) + v[3 * Q + i];
      };
      const float r0 = warp_scan(sum4(up, 63 - lane));          // sum_{j >= 63 - lane} u_j
      const float r1 = warp_scan(sum4(up, 31 - lane)) + __shfl_sync(FULL, r0, 31);
      sfx[63 - lane] = r0;
      sfx[31 - lane] = r1;
      const float v0 = warp_scan(sum4(vp, lane));
      const float vt = __shfl_sync(FULL, v0, 31);
      const float v1 = warp_scan(sum4(vp, lane + 32)) + vt;
      float e0 = __shfl_up_sync(FULL, v0, 1), e1 = __shfl_up_sync(FULL, v1, 1);   // sum_{k<i} v_k
      if (lane == 0) {
        e0 = 0.f;
        e1 = vt;
      }
      __syncwarp();
      float part = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = lane + 32 * hf;
        const float d = ((da1[i] + sfx[i]) + (hf ? e1 : e0)) + E;
        if (i < len) ddt[(row0 + i) * H + h] = fmaf(a_h, d, sum4(tp, i));
        part = fmaf(ds[i], d, part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
      if (lane == 0) dApart[(size_t)bh * nc + c] = part;
      __syncwarp();
      for (int e = lane; e < 4 * Q; e += 32) up[e] = vp[e] = tp[e] = 0.f;
    }
  }
}

// dB and dC: the groups' rows summed, group 0 first; the last block: dA_h,
// the sum of its (batch row, chunk) partials in order.
__global__ void __launch_bounds__(256)
ssd_bwd_sum_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                   const float* __restrict__ dApart, float* __restrict__ dB,
                   float* __restrict__ dC, float* __restrict__ dA, int batch, int S, int H,
                   int N, int n_groups) {
  const int nc = (S + Q - 1) / Q;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
      for (int b = 0; b < batch; ++b)
        for (int c = 0; c < nc; ++c) s += dApart[((size_t)b * H + h) * nc + c];
      dA[h] = s;
    }
    return;
  }
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)batch * S * N) return;
  const size_t row = e / N, n = e - row * N;
  const float* pb = dBp + row * n_groups * N + n;
  const float* pc = dCp + row * n_groups * N + n;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < n_groups; ++g) {
    sb += pb[(size_t)g * N];
    sc += pc[(size_t)g * N];
  }
  dB[e] = sb;
  dC[e] = sc;
}

// Heads a chunk block covers: one where N spans several tiles (the group's
// dB and dC rows then could not stay in registers across heads), else the
// size up to MAX_GROUP whose waves of one block an SM take the fewest
// head-chunks of time, the larger on a tie.
int group_of(int batch, int nc, int H, int N, int sms) {
  if (N > NT) return 1;
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int g = 1; g <= MAX_GROUP && g <= H; ++g) {
    const long long blocks = (long long)batch * nc * ((H + g - 1) / g);
    const long long cost = (blocks + sms - 1) / sms * g;
    if (cost <= best_cost) {
      best_cost = cost;
      best = g;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// x (batch, S, H, P), dt (batch, S, H), A (H,), Bm and Cm (batch, S, N), dy
// (batch, S, H, P), dh (batch, H, P, N) or null, states (batch·H, n_spans,
// P, N) the forward's span states.  Scratch: R and hin (batch·H, nc, P,
// ssd_bwd_state_ld(N)),
// cbt (batch, nc, 64, 64), dApart (batch·H, nc), dBp and dCp (batch, S, H,
// N) (the groups' rows use the first batch·S·n_groups·N), with nc =
// ceil(S / 64) and n_spans = ceil(nc / 4).  Out: dx (batch, S, H, P), ddt
// (batch, S, H), dA (H,), dB and dC (batch, S, N), dh0 (batch, H, P, N).
// All float32 and contiguous; 0 < N <= 256.
int ssd_backward(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* dy, const void* dh, const void* states,
                 void* R, void* hin, void* cbt, void* dBp, void* dCp, void* dApart,
                 void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0, int batch,
                 int S, int H, int P, int N, int device, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      (long long)batch * H > INT_MAX || (long long)P * N > INT_MAX)
    return cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q, n_spans = (nc + SPAN - 1) / SPAN;
  const int wt = N <= NT ? 64 : 32, tiles_p = (P + wt - 1) / wt;
  const long long sum_blocks = ((long long)batch * S * N + 255) / 256 + 1;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int group = group_of(batch, nc, H, N, sms), n_groups = (H + group - 1) / group;
  const long long per_z = (long long)batch * H * tiles_p;
  const long long cb_z = ((long long)nc * batch + per_z - 1) / per_z;
  if (tiles_p > 65535 || 1 + n_spans + cb_z > 65535 || nc > 65535 ||
      (long long)batch * n_groups > INT_MAX || sum_blocks > INT_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *dtf = static_cast<const float*>(dt),
              *Af = static_cast<const float*>(A), *Bf = static_cast<const float*>(Bm),
              *Cf = static_cast<const float*>(Cm), *dyf = static_cast<const float*>(dy);
  float *Rf = static_cast<float*>(R), *hinf = static_cast<float*>(hin),
        *cbtf = static_cast<float*>(cbt), *dApf = static_cast<float*>(dApart),
        *dBpf = static_cast<float*>(dBp), *dCpf = static_cast<float*>(dCp);
  const int x_vec = P % 4 == 0 && aligned16(x) && aligned16(dy);
  const int bc_vec = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  if (!aligned16(R) || !aligned16(hin)) return cudaErrorInvalidValue;   // bulk copies
  const int rh_vec = N % 4 == 0;

  const int carry_smem = carry_floats(N, wt) * (int)sizeof(float);
  const auto carry = wt == 64 ? ssd_bwd_carry_kernel<64> : ssd_bwd_carry_kernel<32>;
  err = cudaFuncSetAttribute(carry, cudaFuncAttributeMaxDynamicSharedMemorySize, carry_smem);
  if (err != cudaSuccess) return err;
  carry<<<dim3(batch * H, tiles_p, 1 + n_spans + (int)cb_z), CARRY_THREADS, carry_smem, s>>>(
      xf, dtf, Af, Bf, Cf, dyf, static_cast<const float*>(dh),
      static_cast<const float*>(states), Rf, hinf, static_cast<float*>(dh0), cbtf, batch, S, H,
      P, N, n_spans, x_vec, bc_vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int chunk_smem = CHUNK_FLOATS * (int)sizeof(float);
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             chunk_smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<<<dim3(batch * n_groups, nc), CHUNK_THREADS, chunk_smem, s>>>(
      xf, dtf, Af, Bf, Cf, dyf, Rf, hinf, cbtf, static_cast<float*>(dx),
      static_cast<float*>(ddt), dBpf, dCpf, dApf, S, H, P, N, group, n_groups, x_vec, bc_vec,
      rh_vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_sum_kernel<<<(unsigned)sum_blocks, 256, 0, s>>>(
      dBpf, dCpf, dApf, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), batch, S, H, N, n_groups);
  return cudaGetLastError();
}

// Row stride of the R and h_in scratch at state size N: each holds
// (batch·H, nc, P, ssd_bwd_state_ld(N)) floats.
int ssd_bwd_state_ld(int N) { return N <= NT ? LC : N; }

// Heads a block of the chunk kernel covers at this shape on `device` (the
// dB and dC rows summed in a block before the sum kernel), or -1.
int ssd_bwd_group(int batch, int S, int H, int N, int device) {
  int sms = 0;
  if (batch <= 0 || S <= 0 || H <= 0 || N <= 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return group_of(batch, (S + Q - 1) / Q, H, N, sms);
}

}  // extern "C"
