// Shared by the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): tile sizes, the f32 staging helper, and the
// bf16 tensor-core primitives (cp.async, ldmatrix, mma.sync m16n8k16, the
// hi/lo split of an f32 pair into two bf16 pairs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int TK = 64;                // keys per kv tile
constexpr float NEG_INF = -1e30f;

// -- f32: CUDA cores ---------------------------------------------------------

constexpr int TX = 16;                // threads along keys / head-dim columns
constexpr int TY = 16;                // threads along query rows
constexpr int TM = BQ / TY;           // rows per thread (4)
constexpr int TN = TK / TX;           // keys per thread (4)
constexpr int THREADS = TX * TY;      // 256
constexpr int PLD = TK + 1;           // row stride of the probability tile

// The first kv tile that a query tile starting at row q0 sees: 0 without a
// window, else the tile of key q0 - window + 1.
__device__ __forceinline__ int first_tile(int q0, int window) {
  return window > 0 ? max(0, q0 - window + 1) / TK : 0;
}

// Stage `rows` (<= 64) rows of a contiguous (rows, dh) slab into
// tile[64][ld] times `mul`, zero-filling rows past the slab.  Consecutive
// threads read consecutive elements, so the loads coalesce.
__device__ __forceinline__ void stage(float* __restrict__ tile,
                                      const float* __restrict__ src, int rows,
                                      int dh, int ld, float mul) {
  for (int e = threadIdx.x; e < 64 * dh; e += THREADS) {
    const int r = e / dh, c = e - r * dh;
    tile[r * ld + c] = r < rows ? src[(size_t)r * dh + c] * mul : 0.f;
  }
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
