// Helpers shared by K4's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu):
// the warp scan behind every decay, a chunk's decays from its dt, the device
// guard of the C entry points, and the tensor-core route both take: cp.async
// staging (and, in the backward, bulk row copies completing on mbarriers),
// the hi/lo TF32 split and its three mma.sync passes (3xTF32), and C B^T of
// a chunk once for all heads.  Each source includes this once.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int Q = 64;                  // positions per chunk, forward and backward

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// Row strides: 4 mod 32 floats for rows read as a (row, k) operand,
// 8 mod 32 for rows read as a (k, column) operand.
__host__ __device__ constexpr int ld4(int n) { return round_up(n, 32) + 4; }
__host__ __device__ constexpr int ld8(int n) { return round_up(n, 32) + 8; }

// Shared memory of a C B^T block (cb_tiles), in floats.
__host__ __device__ constexpr int cb_floats(int N) { return 2 * Q * ld4(N); }

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// Inclusive sum over the warp's lanes.
__device__ __forceinline__ float warp_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Decays of one 64-position chunk from its dt (a = dt·A), as segment sums
// by warp scans.  Warp 0: ec[i] = exp(cum_i), cum_i = sum_{s<=i} a_s, *decay
// = exp(cum_63) and, if given, *logsum = cum_63.  Warp 1: w[j] =
// exp(sum_{s>j} a_s).
__device__ __forceinline__ void chunk_decays(const float* ds, float a_h, float* ec,
                                             float* w, float* decay,
                                             float* logsum = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    const float s0 = warp_scan(ds[lane] * a_h);
    const float s1 = warp_scan(ds[lane + 32] * a_h) + __shfl_sync(FULL, s0, 31);
    ec[lane] = expf(s0);
    ec[lane + 32] = expf(s1);
    if (lane == 31) {
      *decay = expf(s1);
      if (logsum != nullptr) *logsum = s1;
    }
  } else if (warp == 1) {
    // suffix sums in reverse order: r0 = sum_{s >= 63 - lane}, r1 = sum_{s >= 31 - lane}
    const float r0 = warp_scan(ds[63 - lane] * a_h);
    const float r1 = warp_scan(ds[31 - lane] * a_h) + __shfl_sync(FULL, r0, 31);
    w[62 - lane] = expf(r0);
    if (lane < 31) w[30 - lane] = expf(r1);
    if (lane == 0) w[63] = 1.f;
  }
}

// Makes `device` current for one call and gives the caller's device back.
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

// -- staging --------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Stage `rows` rows of `cols` floats (row stride rs) into dst[nrows][ld]
// (nrows = Q unless given), zero-filling rows rows..nrows and columns
// cols..cols_pad.  vec: 16-byte cp.async (cols % 4 == 0, src and rs 16-byte
// aligned), left for the caller to commit; else plain loads.
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld,
                                           const float* __restrict__ src, size_t rs,
                                           int rows, int cols, int cols_pad, bool vec,
                                           int nrows = Q) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += blockDim.x >> 5) {
    if (vec) {
      for (int c = 4 * lane; c < cols_pad; c += 128) {
        const bool in = r < rows && c < cols;
        cp_async16(dst + r * ld + c, in ? src + r * rs + c : src, in ? 16 : 0);
      }
    } else {
      for (int c = lane; c < cols_pad; c += 32)
        dst[r * ld + c] = r < rows && c < cols ? src[r * rs + c] : 0.f;
    }
  }
}

// -- bulk copies on mbarriers ------------------------------------------------

constexpr unsigned long long WAIT_LIMIT_NS = 10'000'000'000ull;   // 10 s

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(unsigned addr, unsigned parity) {
  unsigned done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete.  A phase that does not
// complete within WAIT_LIMIT_NS (a launch here takes a millisecond) is a
// fault: trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  if (mbar_try(addr, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(addr, parity))
    if (globaltimer() - t0 > WAIT_LIMIT_NS) __trap();
}

// The executing thread's generic-proxy accesses to shared memory ordered
// before later async-proxy (bulk copy) writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) global -> shared in one bulk copy, both
// 16-byte aligned, completing on `bar`, whose expected bytes the caller set.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// One warp: `rows` rows of `row_floats` floats (row stride rs; 16-byte
// aligned rows, row_floats % 4 == 0) into dst[r][ld] (ld % 4 == 0), a bulk
// copy a row completing on `bar`, whose expected bytes the caller has set.
__device__ __forceinline__ void bulk_rows(float* dst, int ld, const float* src, size_t rs,
                                          int rows, int row_floats, uint64_t* bar) {
  for (int r = threadIdx.x & 31; r < rows; r += 32)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst + r * ld)), "l"(src + r * rs), "r"(row_floats * 4),
           "r"(smem_addr(bar)) : "memory");
}

// dt of positions s0 .. s0 + Q of head h (stride H), zero past `rows`.
__device__ __forceinline__ void stage_dt(float* dst, const float* __restrict__ dt,
                                         size_t first, int H, int rows) {
  if (threadIdx.x < Q) {
    const bool in = threadIdx.x < rows;
    cp_async4(dst + threadIdx.x, in ? dt + first + (size_t)threadIdx.x * H : dt, in ? 4 : 0);
  }
}

// -- 3xTF32 on the tensor cores ---------------------------------------------------

// v as hi + lo, both TF32 operands: hi = v cut to TF32 (its 13 low bits
// cleared), lo = v - hi (exact in f32), which the tensor core reads cut to
// TF32 too (it ignores an operand's 13 low bits).  hi + lo keeps all but at
// most the 2 lowest of v's 24 bits: an error below 2^-21 |v|.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row-major) b (8 x 8, tf32, col-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc[t] (16 x 8) += A (16 x K) B (K x 8) for the 8-column tiles
// tlo <= t < thi, over k in [k0, k1) (multiples of 8), 3xTF32: the small
// terms a_lo b_hi + a_hi b_lo summed in an accumulator of their own (two
// independent mma chains a tile), added to acc at the end.  fa(r, k) is
// A[r][k] (r < 16); fb(k, c) is B[k][c] with c = 8 t + column.  Fragment
// layouts of mma.m16n8k8 (g = lane / 4, q = lane % 4): a0 (g, q), a1
// (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); b0 (q, g), b1 (q + 4, g);
// acc (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).
template <int NB, class FA, class FB>
__device__ __forceinline__ void mma3(float (&acc)[NB][4], int k0, int k1, int tlo, int thi,
                                     FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float small[NB][4] = {};
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    unsigned ah[4], al[4];
    split_tf32(fa(g, k + q), ah[0], al[0]);
    split_tf32(fa(g + 8, k + q), ah[1], al[1]);
    split_tf32(fa(g, k + q + 4), ah[2], al[2]);
    split_tf32(fa(g + 8, k + q + 4), ah[3], al[3]);
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      if (t < tlo || t >= thi) continue;
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(fb(k + q, 8 * t + g), bh0, bl0);
      split_tf32(fb(k + q + 4, 8 * t + g), bh1, bl1);
      mma_tf32(small[t], al, bh0, bh1);
      mma_tf32(small[t], ah, bl0, bl1);
      mma_tf32(acc[t], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] += small[t][e];
}

// Four (two) 8 x 4 f32 tiles from shared memory, as ldmatrix's 8 x 8 b16
// tiles: lane 8 i + r gives the address of row r of tile i (16 bytes, 16-byte
// aligned), and every lane gets word (lane / 4, lane % 4) of each tile.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// mma3 for A (16 x K) and B^T (8 NB x K) both stored with k contiguous (row
// strides lda, ldb 16-byte multiples, 4 mod 32 floats): the fragments come
// by ldmatrix, one instruction for A's four registers and one for two
// tiles of B.
template <int NB>
__device__ __forceinline__ void mma3_ldsm(float (&acc)[NB][4], const float* a, int lda,
                                          const float* bt, int ldb, int K) {
  const int lane = threadIdx.x & 31, tile = lane >> 3, row = lane & 7;
  const float* pa = a + (row + 8 * (tile & 1)) * lda + 4 * (tile >> 1);
  const float* pb = bt + (row + 8 * (tile >> 1)) * ldb + 4 * (tile & 1);
  float small[NB][4] = {};
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    unsigned ar[4], ah[4], al[4];
    ldsm_x4(ar, pa + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(ar[i]), ah[i], al[i]);
#pragma unroll
    for (int t = 0; t < NB; t += 2) {
      unsigned br[4] = {}, bh[4], bl[4];
      if constexpr (NB == 1) {
        unsigned b2[2];
        ldsm_x2(b2, pb + k);
        br[0] = b2[0];
        br[1] = b2[1];
      } else {
        ldsm_x4(br, pb + 8 * t * ldb + k);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(br[i]), bh[i], bl[i]);
#pragma unroll
      for (int u = 0; u < 2 && t + u < NB; ++u) {
        mma_tf32(small[t + u], al, bh[2 * u], bh[2 * u + 1]);
        mma_tf32(small[t + u], ah, bl[2 * u], bl[2 * u + 1]);
        mma_tf32(acc[t + u], ah, bh[2 * u], bh[2 * u + 1]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NB; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] += small[t][e];
}

// cbt[b][c][j][i] = C_{s0+i} · B_{s0+j} for j <= i, else 0 (s0 = c Q): with 8
// warps the row bands `half` and 3 - half (10 of the 20 tiles on or below
// the diagonal), with 16 all four; smem holds cb_floats(N).
__device__ __forceinline__ void cb_tiles(const float* __restrict__ Bm,
                                         const float* __restrict__ Cm, float* __restrict__ cbt,
                                         float* smem, int b, int c, int half, int nc, int S,
                                         int N, int bc_vec) {
  const int LC = ld4(N), NP = round_up(N, 8);
  float* bs = smem;                   // [Q][LC] B rows of the chunk
  float* cs = bs + Q * LC;            // [Q][LC] C rows
  const int s0 = c * Q, len = min(Q, S - s0);
  const size_t row0 = (size_t)b * S + s0;
  stage_rows(bs, LC, Bm + row0 * N, N, len, N, NP, bc_vec);
  stage_rows(cs, LC, Cm + row0 * N, N, len, N, NP, bc_vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // warp: rows j of its band, column tiles t0, t0 + 1; the tiles wholly
  // above the diagonal (i < j everywhere) stay zero
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int band = blockDim.x == 512 ? warp >> 2 : warp < 4 ? half : 3 - half;
  const int t0 = 2 * (warp & 3);
  float acc[2][4] = {};
  mma3<2>(acc, 0, NP, max(0, 2 * band - t0), 2,
          [&](int r, int k) { return bs[(16 * band + r) * LC + k]; },
          [&](int k, int col) { return cs[(8 * t0 + col) * LC + k]; });
  float* out = cbt + ((size_t)b * nc + c) * Q * Q;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = 8 * (t0 + t) + 2 * q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = 16 * band + g + 8 * hf;
      const float2 v = make_float2(i >= j ? acc[t][2 * hf] : 0.f,
                                   i + 1 >= j ? acc[t][2 * hf + 1] : 0.f);
      *reinterpret_cast<float2*>(out + j * Q + i) = v;
    }
  }
}

}  // namespace
