// Shared by the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): tile sizes, cp.async, the bf16 tensor-core
// primitives (ldmatrix, mma.sync m16n8k16, the hi/lo split of an f32 pair
// into two bf16 pairs) and the f32 ones (3xTF32 on mma.sync m16n8k8: the
// hi/lo TF32 split, f32 fragments by ldmatrix, the f32 tile staging).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int TK = 64;                // keys per kv tile (bf16)
constexpr float NEG_INF = -1e30f;

// The first kv tile of R keys that a query tile starting at row q0 sees: 0
// without a window, else the tile of key q0 - window + 1.
template <int R>
__device__ __forceinline__ int first_tile(int q0, int window) {
  return window > 0 ? max(0, q0 - window + 1) / R : 0;
}


// -- bf16: tensor cores ------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;       // 4 warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of the i-th.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi).
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Stage `rows` (<= 64) rows of a contiguous (rows, dh) slab into
// tile[64][DP + 8], zero-filling rows past the slab and columns dh..DP.
// `vec`: 16-byte cp.async copies (dh % 8 == 0, 16-byte aligned src), left
// in flight for the caller to commit and wait on; else plain loads.
template <int DP>
__device__ __forceinline__ void stage_bf16(bf16* __restrict__ tile,
                                           const bf16* __restrict__ src, int rows,
                                           int dh, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;          // 16-byte chunks of a row
    for (int e = threadIdx.x; e < 64 * CH; e += TC_THREADS) {
      const int r = e / CH, c = e - r * CH;
      const bool in = r < rows && c * 8 < dh;
      cp_async16(tile + r * LD + c * 8, in ? src + (size_t)r * dh + c * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < 64 * DP; e += TC_THREADS) {
      const int r = e / DP, c = e - r * DP;
      tile[r * LD + c] = r < rows && c < dh ? src[(size_t)r * dh + c]
                                            : __float2bfloat16(0.f);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }


// -- f32: 3xTF32 on the tensor cores ------------------------------------------

// Row stride of an f32 tile of DP columns (DP a multiple of 32): 4 mod 32
// floats.  ldmatrix's 8 rows of 16 bytes then fall on 8 distinct 16-byte
// bank groups, and so do the scalar reads of a (k, column) operand at rows
// 2 q and 2 q + 1, column g (banks 8 q + g and 8 q + 4 + g): one pad frees
// both of the patterns in which a tile is read.
__host__ __device__ constexpr int f32_ld(int dp) { return dp + 4; }

// 4 bytes global -> shared, asynchronously; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// v as hi + lo, both TF32 operands: hi = v cut to TF32 (its 13 low bits
// cleared), lo = v - hi (exact in f32), which the tensor core reads cut to
// TF32 too.  hi + lo keeps all but at most the 2 lowest of v's 24 bits.
// (K4's split, ssd_scan/csrc/ssd_common.cuh, copied: a source is rebuilt
// when a file of its own csrc/ changes.)
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row-major) b (8 x 8, tf32, col-major).
// Fragments (g = lane / 4, q = lane % 4): a0 (g, q), a1 (g + 8, q), a2
// (g, q + 4), a3 (g + 8, q + 4); b0 (q, g), b1 (q + 4, g); d (g, 2 q),
// (g, 2 q + 1), (g + 8, 2 q), (g + 8, 2 q + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small terms a_lo b_hi and a_hi b_lo first, then
// a_hi b_hi, all into d.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                     unsigned bl0, unsigned bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The four words of x (f32 bits) times `mul`, split hi/lo.
__device__ __forceinline__ void split4(const unsigned (&x)[4], float mul, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(x[e]) * mul, hi[e], lo[e]);
}

// Four 8 x 4 f32 tiles from shared memory, as ldmatrix's 8 x 8 b16 tiles:
// lane 8 i + r gives the address of row r of tile i (16 bytes, 16-byte
// aligned), and every lane gets word (lane / 4, lane % 4) of each tile.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// A fragment (hi, lo) of rows row0 + [0, 16), columns k + [0, 8) of a
// row-major f32 tile [..][LD], times `mul`.
template <int LD>
__device__ __forceinline__ void frag_a(const float* tile, int row0, int k, float mul,
                                       unsigned (&hi)[4], unsigned (&lo)[4], int lane) {
  unsigned x[4];
  ldsm_x4(x, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + k + (lane >> 4) * 4);
  split4(x, mul, hi, lo);
}

// B fragments (hi, lo) of two 8-column tiles, B[k][n] = tile[n0 + n][k]
// (n < 16, k in k0 + [0, 8)): words 0, 1 of the first (n0 + [0, 8)), 2, 3
// of the second.
template <int LD>
__device__ __forceinline__ void frag_b_rows(const float* tile, int n0, int k0,
                                            unsigned (&hi)[4], unsigned (&lo)[4], int lane) {
  unsigned x[4];
  ldsm_x4(x, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 4);
  split4(x, 1.f, hi, lo);
}

// The tensor core truncates each sum it accumulates (round toward zero),
// so a long chain of mma.sync on one accumulator drifts: dV summed over 5
// heads x 1,024 queries in one accumulator measured 1.3x the 2e-5
// tolerance.  The two products below keep every chain to at most 8 k steps
// (24 mma.sync) from 0, and add its sum to the caller's accumulator in f32
// (round to nearest).

// acc[n] += A B^T (n < NN 8-column tiles), A = rows row0 + [0, 16) of the
// row-major tile a times `mul`, B^T[n][k] = tile b's rows 8 n + [0, 8), over
// the columns k < cols (<= DP) of both, in 3xTF32, 64 columns a chain.
// With 4 tiles or fewer the small terms take a chain of their own, so that
// a warp keeps at least 8 products in flight.
template <int LD, int DP, int NN>
__device__ __forceinline__ void mma_abt(float (&acc)[NN][4], const float* a, int row0, float mul,
                                        const float* b, int cols, int lane) {
  constexpr bool TWO = NN <= 4;
#pragma unroll
  for (int kg = 0; kg < DP / 8; kg += 8) {
    if (8 * kg >= cols) break;
    float t[NN][4], u[TWO ? NN : 1][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        t[n][e] = 0.f;
        if constexpr (TWO) u[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = kg; kk < kg + 8 && kk < DP / 8; ++kk) {
      if (8 * kk >= cols) break;        // zero-filled columns add nothing
      unsigned ah[4], al[4];
      frag_a<LD>(a, row0, 8 * kk, mul, ah, al, lane);
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        unsigned bhi[4], blo[4];
        frag_b_rows<LD>(b, 16 * np, 8 * kk, bhi, blo, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float (&small)[4] = TWO ? u[TWO ? 2 * np + i : 0] : t[2 * np + i];
          mma_tf32(small, al, bhi[2 * i], bhi[2 * i + 1]);
          mma_tf32(small, ah, blo[2 * i], blo[2 * i + 1]);
          mma_tf32(t[2 * np + i], ah, bhi[2 * i], bhi[2 * i + 1]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += TWO ? t[n][e] + u[TWO ? n : 0][e] : t[n][e];
  }
}

// acc[n] = acc[n] (mul0 for rows g, mul1 for rows g + 8) + C B for the
// 8-column tiles n < ND with 8 n < cols: C is the row block's 16 x 8 NJ f32
// accumulator c, its tile j the A fragment of k step j with the k index
// permuted (k index q is column 2 q, q + 4 is 2 q + 1: no shuffle), and
// B[k][n] = tile[k][8 n + g] read in the same order (rows 8 j + 2 q and
// 8 j + 2 q + 1).  Each column tile's NJ steps form one chain from 0, four
// column tiles at a time.
template <int LD, int ND, int NJ>
__device__ __forceinline__ void mma_cb(float (&acc)[ND][4], const float (&c)[NJ][4],
                                       const float* tile, int cols, float mul0, float mul1,
                                       int lane) {
  constexpr int NG = ND < 4 ? ND : 4;
  unsigned hi[NJ][4], lo[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split_tf32(c[j][0], hi[j][0], lo[j][0]);
    split_tf32(c[j][2], hi[j][1], lo[j][1]);
    split_tf32(c[j][1], hi[j][2], lo[j][2]);
    split_tf32(c[j][3], hi[j][3], lo[j][3]);
  }
  const float* b = tile + 2 * (lane & 3) * LD + (lane >> 2);
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += NG) {
    if (8 * n0 >= cols) break;          // zero-filled columns stay 0
    float t[NG][4];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(b[8 * j * LD + 8 * (n0 + i)], bh0, bl0);
        split_tf32(b[(8 * j + 1) * LD + 8 * (n0 + i)], bh1, bl1);
        mma3(t[i], hi[j], lo[j], bh0, bh1, bl0, bl1);
      }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      acc[n0 + i][0] = fmaf(acc[n0 + i][0], mul0, t[i][0]);
      acc[n0 + i][1] = fmaf(acc[n0 + i][1], mul0, t[i][1]);
      acc[n0 + i][2] = fmaf(acc[n0 + i][2], mul1, t[i][2]);
      acc[n0 + i][3] = fmaf(acc[n0 + i][3], mul1, t[i][3]);
    }
  }
}

// Stage `rows` (<= R) rows of a contiguous (rows, dh) f32 slab into
// tile[R][f32_ld(DP)] with NT threads, zero-filling rows past the slab and
// columns dh..DP.  `vec`: 16-byte cp.async copies (dh % 4 == 0, 16-byte
// aligned src), left in flight for the caller to commit and wait on; else
// plain loads.
template <int R, int DP, int NT>
__device__ __forceinline__ void stage_f32(float* __restrict__ tile,
                                          const float* __restrict__ src, int rows, int dh,
                                          bool vec) {
  constexpr int LD = f32_ld(DP);
  if (vec) {
    constexpr int CH = DP / 4;          // 16-byte chunks of a row
    for (int e = threadIdx.x; e < R * CH; e += NT) {
      const int r = e / CH, c = e - r * CH;
      const bool in = r < rows && c * 4 < dh;
      cp_async16(tile + r * LD + c * 4, in ? src + (size_t)r * dh + c * 4 : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * DP; e += NT) {
      const int r = e / DP, c = e - r * DP;
      tile[r * LD + c] = r < rows && c < dh ? src[(size_t)r * dh + c] : 0.f;
    }
  }
}

// The f32 kernels' padded head dim: Dh rounded up to 32, 64, 128 or 256.
inline int f32_dp(int dh) { return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }


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
