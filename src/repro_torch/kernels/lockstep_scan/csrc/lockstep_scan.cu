// Lockstep seed scans of the fast replay on Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package runs these two recurrences as
// jax.vmap(lax.scan) over a seed axis (src/repro/sim/batched.py:1559-1577,
// lockstep_completion_times, and :1698-1722, _grid_scan_fn), which XLA
// compiles into one fused loop; a PyTorch loop would launch a few kernels
// for every step, thousands a call.  Here each recurrence is one launch:
//
//  * lockstep_chain_kernel: one static single-partition cell, S seeds.
//    For seed s and message i, in float32,
//        dt     = means[i] * exp(a + b * z[s][i])
//        finish = max(appends[i], finish) + dt      (finish starts at 0)
//    out[s][i] = finish.
//  * grid_lockstep_kernel: a controller-driven cell whose dispatch
//    trajectory (ready floor, partition p_k, container c_k of invocation k)
//    is frozen from one reference replay.  For seed s and invocation k,
//        finish = max(floor[k], max(part_last[p_k], cont_last[c_k])) + dt[s][k]
//    then part_last[p_k] = cont_last[c_k] = out[s][k] = finish.
//
// Arithmetic.  The reference's float32 operations in the reference's order:
// every product and sum rounded on its own (__fmul_rn/__fadd_rn, so nvcc
// contracts nothing into an FMA), expf (not __expf), and a max that is
// NaN where either operand is NaN, as torch.maximum and jnp.maximum are
// (PTX max.NaN.f32, one FMNMX.NAN; fmaxf alone drops a NaN operand).  Max
// is exact, so the operands of one step's max may be taken in any order;
// the add is never reassociated.  Each seed's chain runs in order in one
// thread and no two threads write one word: the result is the plain
// PyTorch version's on the same card, bit for bit, NaN positions included.
//
// Bound.  The byte bound (z or dt read once, the finishes written once: 8
// bytes a step and seed, ~8.5 MB for 1,024 seeds x 1,041 steps, 2.5 us at
// 3.35 TB/s) is far below what a bit-exact walk allows: a seed's steps run
// one after another, so a call takes at least steps x the latency of the
// carried instructions (the chain's max and add, ~4 cycles each), however
// many seeds there are, until the seeds fill the card.
//
// Design.  A block holds 32 seeds, one lane each of its first warp, the
// walker, which runs only the carried chain, on operands loaded into
// registers a few steps early (so no load waits on the chain), with a warp
// scheduler to itself.  Six helper warps stage its inputs a tile of T steps
// ahead and write its finishes back.  Helper h takes step h % T of every
// RSTEP-th row, so a warp reads and writes 32 consecutive floats of one row
// of z, dt or out (coalesced; rows of n floats are not 16-byte aligned, so
// 4 bytes each), loaded into registers a whole phase before they are stored
// to a shared buffer whose rows hold T + 1 floats: the walker's lane s
// reading step i hits bank (s + i) % 32.  The walker writes each finish over the input it
// consumed; the helpers copy the tile back a phase later.  Three buffers
// rotate: the walker's tile, the tile before it (being written back), the
// next (going in).  Phases end on one barrier of the walker and the
// helpers; the helpers also sync among themselves.
//
//  * chain: the helpers compute dt = means * expf(a + b * z) (the same three
//    rounded operations) for the next tile and stage appends; a step of the
//    walker is then FMNMX.NAN and FADD.
//  * grid: the trajectory is the same for every seed, so the last earlier
//    step in range that wrote slot p_k (and c_k) is known before the walk;
//    its finish is part_last[p_k] (0.0 if none).  The helpers find these
//    last writers for the next tile (among a warp's 32 steps with
//    __match_any_sync, before them in a table of each slot's last writer;
//    past CAP slots, by a backward scan of device memory) and fold every
//    operand older than the walker's tile and the one before it into
//    pre[s][k] = max(floor[k], those finishes).  The walker folds the
//    rest: the finishes of the last three steps from registers, older ones
//    of this tile and the last from the buffers (each load issued three
//    steps early, after the step that wrote it).  No device scratch, any
//    n_parts + n_conts.  A step whose index is out of range gets a NaN
//    floor and is nobody's writer: its finish is NaN and the state stays.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int LANES = 32;                 // seeds a block, one walker lane each
constexpr int T = 96;                     // steps a tile
constexpr int ROW = T + 1;                // a tile row, padded against bank conflicts
constexpr int TILE = LANES * ROW;         // floats a tile buffer
constexpr int NBUF = 3;                   // rotating tile buffers
// Eight warps: the walker (warp 0), an idle warp 4, six helpers.  A warp
// issues from scheduler warp % 4, so the walker has its own and the helpers
// two on each of the other three; a helper beside the walker took issue
// slots from its chain.
constexpr int IDLE_WARP = 4;
constexpr int HELPERS = 6;                // helper warps a block
constexpr int NH = HELPERS * 32;          // helper threads
constexpr int BLOCK = 8 * 32;
constexpr int SYNCED = 32 + NH;           // threads at the walker/helper barrier
constexpr int AHEAD = 3;                  // grid: the walker loads a step's operands this many steps early
constexpr int CHAIN_AHEAD = 8;            // chain: likewise
constexpr int CAP = 512;                  // grid: slots of each kind the last-writer table holds
static_assert(NH == 2 * T, "a helper a (step, slot kind) in the grid's last-writer search");
static_assert((LANES * T) % NH == 0 && T % 32 == 0, "whole helper rounds, rows a warp wide");

__device__ __forceinline__ float max_nan(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// the walker and the helpers (barrier 2), and the helpers alone (barrier 1)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 2, %0;" ::"n"(SYNCED) : "memory");
}
__device__ __forceinline__ void helper_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NH) : "memory");
}

// the helper index of this thread (0..NH-1), or -1 in the idle warp
__device__ __forceinline__ int helper_index() {
  const int w = threadIdx.x / 32;
  return w == IDLE_WARP ? -1 : (w < IDLE_WARP ? w - 1 : w - 2) * 32 + threadIdx.x % 32;
}

// The helpers' share of a tile: helper h takes the tile's step h % T in
// rows h / T + RSTEP * m, m < ROUNDS, so a warp covers 32 consecutive steps
// of a row (coalesced in device memory, one bank each in shared memory).
// Each round's loads are issued together, into registers, before any of
// them is used or stored.
constexpr int RSTEP = NH / T, ROUNDS = LANES / RSTEP;

// helper h's elements of rows s0.. of src (S, n) at steps k0.., 0 outside.
// The helpers are bound by their issue, so a whole column (every row in
// range, the common case) takes no test per element and the rows' addresses
// are a pointer stepped by RSTEP rows.
__device__ __forceinline__ void load_rows(float (&v)[ROUNDS], const float* __restrict__ src,
                                          int h, int s0, int k0, int S, int n) {
  const int k = k0 + h % T, r = s0 + h / T;
  const float* p = src + (size_t)r * n + k;
  const size_t step = (size_t)RSTEP * n;
  if (k < n && s0 + LANES <= S) {
#pragma unroll
    for (int m = 0; m < ROUNDS; ++m, p += step) v[m] = __ldg(p);
  } else {
#pragma unroll
    for (int m = 0; m < ROUNDS; ++m, p += step) v[m] = k < n && r + RSTEP * m < S ? __ldg(p) : 0.0f;
  }
}

__device__ __forceinline__ void store_tile(float* tile, const float (&v)[ROUNDS], int h) {
  float* q = tile + (h / T) * ROW + h % T;
#pragma unroll
  for (int m = 0; m < ROUNDS; ++m) q[m * RSTEP * ROW] = v[m];
}

// helper h's elements of a tile buffer back to rows s0.. of out (S, n), steps k0..
__device__ __forceinline__ void write_back(const float* tile, float* __restrict__ out, int h,
                                           int s0, int k0, int S, int n) {
  float v[ROUNDS];
  const float* q = tile + (h / T) * ROW + h % T;
#pragma unroll
  for (int m = 0; m < ROUNDS; ++m) v[m] = q[m * RSTEP * ROW];
  const int k = k0 + h % T, r = s0 + h / T;
  float* p = out + (size_t)r * n + k;
  const size_t step = (size_t)RSTEP * n;
  if (k < n && s0 + LANES <= S) {
#pragma unroll
    for (int m = 0; m < ROUNDS; ++m, p += step) *p = v[m];
  } else {
#pragma unroll
    for (int m = 0; m < ROUNDS; ++m, p += step)
      if (k < n && r + RSTEP * m < S) *p = v[m];
  }
}

__global__ void __launch_bounds__(BLOCK)
lockstep_chain_kernel(const float* __restrict__ appends, const float* __restrict__ means,
                      const float* __restrict__ z, float a, float b,
                      float* __restrict__ out, int S, int n) {
  __shared__ float buf[NBUF][TILE];     // dt, then the finishes
  __shared__ float app[NBUF][T];
  const int s0 = blockIdx.x * LANES;
  const int tiles = (n + T - 1) / T;
  if (threadIdx.x < 32) {               // the walker
    float* const row0 = &buf[0][threadIdx.x * ROW];
    float finish = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      block_sync();                     // tile t's dt and appends are staged
      float* const row = row0 + (t % NBUF) * TILE;
      const float* const ap = app[t % NBUF];
      // operands in registers, loaded CHAIN_AHEAD steps early: issued
      // before the step's chain in program order, they do not wait on it
      constexpr int SLOTS = CHAIN_AHEAD + 1;
      float av[SLOTS], dv[SLOTS];
#pragma unroll
      for (int i = 0; i < CHAIN_AHEAD; ++i) {
        av[i] = ap[i];
        dv[i] = row[i];
      }
#pragma unroll
      for (int i = 0; i < T; ++i) {
        if (i + CHAIN_AHEAD < T) {
          av[(i + CHAIN_AHEAD) % SLOTS] = ap[i + CHAIN_AHEAD];
          dv[(i + CHAIN_AHEAD) % SLOTS] = row[i + CHAIN_AHEAD];
        }
        finish = __fadd_rn(max_nan(av[i % SLOTS], finish), dv[i % SLOTS]);
        row[i] = finish;
      }
    }
    block_sync();
    return;
  }
  // The helpers: tile t+1's dt and appends go in while the walker walks
  // tile t (its buffer held tile t-2, written back a phase ago), then tile
  // t-1 goes back to out, and tile t+2's z, append and mean are loaded into
  // registers, to be used a phase later.
  const int h = helper_index(), col = h % T;
  if (h < 0) return;
  float zr[ROUNDS], ar = 0.0f, mr = 0.0f;
  auto load = [&](int t) {
    load_rows(zr, z, h, s0, t * T, S, n);
    const int k = t * T + col;
    ar = k < n ? __ldg(appends + k) : 0.0f;
    mr = k < n ? __ldg(means + k) : 0.0f;
  };
  auto put = [&](int t) {
#pragma unroll
    for (int m = 0; m < ROUNDS; ++m) zr[m] = __fmul_rn(mr, expf(__fadd_rn(a, __fmul_rn(b, zr[m]))));
    store_tile(buf[t % NBUF], zr, h);
    if (h < T) app[t % NBUF][col] = ar;
  };
  load(0);
  put(0);
  if (tiles > 1) load(1);
  for (int t = 0; t < tiles; ++t) {
    block_sync();                       // the walker takes tile t
    if (t + 1 < tiles) put(t + 1);      // mostly arithmetic: the walker's first loads go first
    if (t >= 1) write_back(buf[(t - 1) % NBUF], out, h, s0, (t - 1) * T, S, n);
    if (t + 2 < tiles) load(t + 2);
  }
  block_sync();                         // the walker is done
  write_back(buf[(tiles - 1) % NBUF], out, h, s0, (tiles - 1) * T, S, n);
}

// What the walker needs of step k besides dt: byte offsets (from buf[0][0],
// lane 0's row) of two earlier finishes to fold, and which of the last three
// finishes to fold (bit d for step k-d: one R2P sets the three predicates).
struct __align__(16) StepCode {
  int off_a, off_b, mask, unused;
};

struct GridShared {                     // 70 KB: dynamic shared memory
  float buf[NBUF][TILE];                // dt, then the finishes; column T is -inf
  float pre[2][TILE];                   // max(floor, finishes older than the last tile)
  StepCode code[2][T];
  int writer[2][T];                     // last writers of the tile being prepared (part, cont)
  int last_w[2][CAP];                   // a slot's last writer before the tile being prepared
  float floor_of[T];                    // its floors, NaN for a step out of range
};

__global__ void __launch_bounds__(BLOCK)
grid_lockstep_kernel(const float* __restrict__ floors, const int* __restrict__ parts,
                     const int* __restrict__ conts, const float* __restrict__ dt,
                     float* __restrict__ out, int S, int n, int n_parts, int n_conts) {
  extern __shared__ __align__(16) unsigned char grid_shared[];
  GridShared& sh = *reinterpret_cast<GridShared*>(grid_shared);
  auto& buf = sh.buf;
  auto& pre = sh.pre;
  auto& code = sh.code;
  auto& writer = sh.writer;
  auto& last_w = sh.last_w;
  auto& floor_of = sh.floor_of;
  const int s0 = blockIdx.x * LANES;
  const int tiles = (n + T - 1) / T;
  constexpr int NONE = T * 4;           // the offset of lane 0's -inf pad in buf[0]
  if (threadIdx.x < 32) {               // the walker
    const int lane = threadIdx.x;
    const char* const ring = reinterpret_cast<const char*>(&buf[0][lane * ROW]);
    auto at = [&](int off) { return *reinterpret_cast<const float*>(ring + off); };
    float prev = 0.0f, prev2 = 0.0f, prev3 = 0.0f;   // the finishes of steps k-1, k-2, k-3
    for (int t = 0; t < tiles; ++t) {
      block_sync();                     // tile t's dt, pre and codes are ready
      float* const row = &buf[t % NBUF][lane * ROW];
      const float* const pr = &pre[t % 2][lane * ROW];
      const StepCode* const cd = code[t % 2];
      // Step i's operands sit in slot i % (AHEAD + 1) of these registers,
      // loaded AHEAD steps early (a finish at least AHEAD + 1 steps back, so
      // stored by then), its code 2 * AHEAD steps early: issued before the
      // chain in program order, no load waits on it.
      constexpr int SLOTS = AHEAD + 1, CODES = 2 * AHEAD;
      StepCode cq[CODES];
      float va[SLOTS], vb[SLOTS], pv[SLOTS], dv[SLOTS];
      int mk[SLOTS];
      auto fetch = [&](int i) {         // step i's operands into its slot
        const StepCode& c = cq[i % CODES];
        va[i % SLOTS] = at(c.off_a);
        vb[i % SLOTS] = at(c.off_b);
        mk[i % SLOTS] = c.mask;
        pv[i % SLOTS] = pr[i];
        dv[i % SLOTS] = row[i];
      };
#pragma unroll
      for (int i = 0; i < CODES; ++i) cq[i] = cd[i];
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) fetch(i);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        if (i + AHEAD < T) fetch(i + AHEAD);
        if (i + CODES < T) cq[i % CODES] = cd[i + CODES];
        const int q = i % SLOTS, mask = mk[q];
        float m = max_nan(pv[q], max_nan(va[q], vb[q]));
        if (mask & 8) m = max_nan(m, prev3);
        if (mask & 4) m = max_nan(m, prev2);
        if (mask & 2) m = max_nan(m, prev);
        const float fin = __fadd_rn(m, dv[q]);
        row[i] = fin;
        prev3 = prev2;
        prev2 = prev;
        prev = fin;
      }
    }
    block_sync();
    return;
  }
  // The helpers.  Helper h's step of each tile is col = h % T; it keeps that
  // step's partition, container and floor in registers, loaded a phase
  // early like dt, and finds the step's last writer of slot kind h / T
  // (0: partition, 1: container).
  const int h = helper_index(), col = h % T, kind = h / T, lane = h % 32;
  if (h < 0) return;
  float dr[ROUNDS], fr = 0.0f;
  int pr_ = -1, cr = -1;
  auto load = [&](int t) {              // tile t's dt, and its step col's slots and floor
    load_rows(dr, dt, h, s0, t * T, S, n);
    const int k = t * T + col;
    pr_ = k < n ? __ldg(parts + k) : -1;
    cr = k < n ? __ldg(conts + k) : -1;
    fr = k < n ? __ldg(floors + k) : 0.0f;
  };
  auto in_range = [&](int p, int c) {
    return (unsigned)p < (unsigned)n_parts && (unsigned)c < (unsigned)n_conts;
  };
  // Where every slot is below CAP, a table keeps each slot's last writer
  // before the tile; a warp finds earlier writers among its own 32 steps
  // with __match_any_sync, the first half-tile's warps look up and update
  // the table, then the second's.  Otherwise a backward scan of device
  // memory, eight candidates at a time.
  const bool table = n_parts <= CAP && n_conts <= CAP;
  for (int i = h; i < 2 * CAP; i += NH) last_w[i / CAP][i % CAP] = -1;
  helper_sync();
  // The codes and pre of tile u, while the walker walks tile u-1: finishes
  // of tiles before u-1 are complete (tile u-2 in its buffer, older ones
  // written back to out) and folded here; those of tiles u-1 and u are the
  // walker's.
  auto prepare = [&](int u) {
    const int k0 = u * T, fold_below = k0 - T, k = k0 + col;
    store_tile(buf[u % NBUF], dr, h);
    {                                   // last writers: one helper a (step, kind)
      const bool live = k < n && in_range(pr_, cr);
      const int slot = kind == 0 ? pr_ : cr;
      int w = k >= n ? -1 : live ? -1 : -2;
      if (table) {
        const unsigned same = __match_any_sync(0xffffffffu, live ? slot : -1 - lane);
        const unsigned before = same & ((1u << lane) - 1u);
        if (before) w = k - lane + (31 - __clz(before));
        const bool last_of_slot = live && !(same >> lane >> 1);
        for (int half = 0; half < T / 32; ++half) {   // in order: the table is the past
          if (col / 32 == half) {
            if (live && !before) w = last_w[kind][slot];
            __syncwarp();                 // every lookup before any update
            if (last_of_slot) last_w[kind][slot] = k;
          }
          helper_sync();
        }
      } else if (live) {
        const int* const slots = kind == 0 ? parts : conts;
        for (int j0 = k - 1; j0 >= 0 && w < 0; j0 -= 8) {
          int hit = -1;
#pragma unroll
          for (int q = 7; q >= 0; --q) {          // nearest last, so it wins
            const int j = j0 - q, jj = j < 0 ? 0 : j;
            const bool ok = in_range(__ldg(parts + jj), __ldg(conts + jj));
            hit = j >= 0 && ok && __ldg(slots + jj) == slot ? j : hit;
          }
          w = hit;
        }
      }
      writer[kind][col] = w;
    }
    helper_sync();
    if (h < T) {                        // the walker's share of each step
      const int wa = writer[0][h], wb = writer[1][h];
      StepCode c{NONE, NONE, 0, 0};
      auto place = [&](int j, int& off) {
        if (j < 0 || j < fold_below) return;      // none, or folded into pre
        if (k - j <= AHEAD) c.mask |= 1 << (k - j);
        else off = (((j / T) % NBUF) * TILE + j % T) * 4;
      };
      if (wa != -2) {
        place(wa, c.off_a);
        place(wb, c.off_b);
      }
      code[u % 2][h] = c;
      floor_of[h] = wa == -2 ? NAN : fr;
    }
    helper_sync();
    {                                   // pre = max(floor, 0.0 if no writer, folded finishes)
      const int i = h % T, wa = writer[0][i], wb = writer[1][i];
      float v[ROUNDS];
#pragma unroll
      for (int m = 0; m < ROUNDS; ++m) v[m] = floor_of[i];
      auto fold = [&](int j) {
        if (j == -1) {
#pragma unroll
          for (int m = 0; m < ROUNDS; ++m) v[m] = max_nan(v[m], 0.0f);
        } else if (j >= fold_below - T && j < fold_below) {   // tile u-2, in its buffer
          const float* f = &buf[(j / T) % NBUF][(h / T) * ROW + j % T];
#pragma unroll
          for (int m = 0; m < ROUNDS; ++m) v[m] = max_nan(v[m], f[m * RSTEP * ROW]);
        } else if (j >= 0 && j < fold_below) {                 // older, written back
          const float* p = out + (size_t)(s0 + h / T) * n + j;
#pragma unroll
          for (int m = 0; m < ROUNDS; ++m, p += (size_t)RSTEP * n)
            v[m] = max_nan(v[m], s0 + h / T + RSTEP * m < S ? __ldcg(p) : 0.0f);
        }
      };
      if (wa != -2) {
        fold(wa);
        fold(wb);
      }
      store_tile(pre[u % 2], v, h);
    }
  };
  // Tile t+1's dt (loaded a phase early; its buffer held tile t-2, written
  // back a phase ago), codes and pre go in while the walker walks tile t;
  // tile t-1 goes back to out; tile t+2's operands are loaded.
  for (int i = h; i < NBUF * LANES; i += NH) buf[i / LANES][(i % LANES) * ROW + T] = -INFINITY;
  load(0);
  prepare(0);
  if (tiles > 1) load(1);
  for (int t = 0; t < tiles; ++t) {
    block_sync();                       // the walker takes tile t
    if (t + 1 < tiles) prepare(t + 1);
    if (t >= 1) write_back(buf[(t - 1) % NBUF], out, h, s0, (t - 1) * T, S, n);
    if (t + 2 < tiles) load(t + 2);
  }
  block_sync();                         // the walker is done
  write_back(buf[(tiles - 1) % NBUF], out, h, s0, (tiles - 1) * T, S, n);
}

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

// appends (n,), means (n,), z (S, n), out (S, n): float32, contiguous.
int lockstep_chain(const void* appends, const void* means, const void* z, float a, float b,
                   void* out, int S, int n, int device, void* stream) {
  if (S <= 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  lockstep_chain_kernel<<<(S + LANES - 1) / LANES, BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(appends), static_cast<const float*>(means),
      static_cast<const float*>(z), a, b, static_cast<float*>(out), S, n);
  return cudaGetLastError();
}

// floors (n,) float32, parts and conts (n,) int32, dt (S, n) and out (S, n)
// float32, all contiguous.
int grid_lockstep(const void* floors, const void* parts, const void* conts, const void* dt,
                  void* out, int S, int n, int n_parts, int n_conts, int device, void* stream) {
  if (S <= 0 || n < 0 || n_parts <= 0 || n_conts <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  constexpr int bytes = sizeof(GridShared);
  const cudaError_t err = cudaFuncSetAttribute(
      grid_lockstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  grid_lockstep_kernel<<<(S + LANES - 1) / LANES, BLOCK, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(floors), static_cast<const int*>(parts),
      static_cast<const int*>(conts), static_cast<const float*>(dt),
      static_cast<float*>(out), S, n, n_parts, n_conts);
  return cudaGetLastError();
}

}  // extern "C"
