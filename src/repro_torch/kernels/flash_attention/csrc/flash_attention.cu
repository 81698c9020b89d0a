// Causal GQA flash-attention forward on Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel
//    src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
//    (body _flash_kernel): q (BH, S, Dh); k, v (BKV, S, Dh) with BH = BKV * G,
//    f32 or bf16 -> out (BH, S, Dh) in q's dtype.  Query row b reads kv row
//    b / G, so repeated KV is never materialised.  The math is fp32 online
//    softmax (running max m, sum l, accumulator acc), masked scores are
//    -1e30, fully masked kv tiles are skipped, and the output is
//    acc / max(l, 1e-30), as in the TPU kernel.
//
// Bound on an H100 SXM: operations.  The causal function needs about
// 2 * BH * S^2 * Dh FLOPs (QK^T and PV, half of each under the mask); at the
// serving shape (BH = 56, S = 1,024, Dh = 64) that is ~7.5 GFLOP, 7.6 us at
// the 989 TFLOP/s bf16 tensor-core peak, against ~5 us to read q, k, v and
// write out once at 3.35 TB/s.  This first kernel computes on the CUDA cores
// in fp32, where the same FLOPs take 112 us at 67 TFLOP/s; wgmma, TMA and
// warp specialisation are later work.
//
// Design.  The TPU grid (BH, S/bq, S/bk) runs its kv axis in order on one
// core; Hopper's blocks run in no order, so the kv axis becomes a loop
// inside the block:
//  * one block of 256 threads per (q row, 64-query tile); the heaviest tiles
//    (the last ones, which see the most keys) are scheduled first;
//  * the block loops over 64-key tiles up to and including the diagonal tile
//    (the causal skip), staging each k and v tile in shared memory as f32;
//  * a 16 x 16 thread grid: thread (ty, tx) owns query rows ty + 16 i
//    (i < 4), the scores of keys tx + 16 j (j < 4) of the tile, and head-dim
//    columns tx + 16 j (j < DN) of the accumulator.  m, l and acc live in
//    registers; the 16 threads of a row (16 aligned lanes of one warp)
//    combine the row max and sum with shuffles, and the probabilities pass
//    through a shared tile to the PV product;
//  * nothing is padded: Dh is taken as it is (DN = 2, 4 or 8 columns per
//    thread covers Dh <= 128 with the rest masked), the scale is
//    1/sqrt(Dh), and a ragged S is masked in the kernel (zero-filled loads,
//    keys >= S scored -1e30, rows >= S not stored).
// Shared memory: (64 + 2 * 64) * (Dh + 1) + 64 * 65 floats, 66,560 B at
// Dh = 64 and 115,712 B at Dh = 128 (dynamic, above the 48 KB default).
// The +1 row pad keeps the column-wise reads free of bank conflicts.
//
// C interface (loaded with ctypes): fa_forward launches on the given stream
// of the given device, leaves the caller's current device as it found it,
// does not synchronise, and returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int TK = 64;                // keys per kv tile
constexpr int TX = 16;                // threads along keys / head-dim columns
constexpr int TY = 16;                // threads along query rows
constexpr int TM = BQ / TY;           // rows per thread (4)
constexpr int TN = TK / TX;           // keys per thread (4)
constexpr int THREADS = TX * TY;      // 256
constexpr int PLD = TK + 1;           // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Stage `rows` (<= 64) rows of a contiguous (rows, dh) slab into
// tile[64][ld] as f32 times `mul`, zero-filling rows past the slab.
// Consecutive threads read consecutive elements, so the loads coalesce.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ tile,
                                      const T* __restrict__ src, int rows,
                                      int dh, int ld, float mul) {
  for (int e = threadIdx.x; e < 64 * dh; e += THREADS) {
    const int r = e / dh, c = e - r * dh;
    tile[r * ld + c] = r < rows ? to_f32(src[(size_t)r * dh + c]) * mul : 0.f;
  }
}

template <typename T, int DN>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int dh, int group, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;                   // [BQ][ld], q * scale
  float* ks = qs + BQ * ld;           // [TK][ld]
  float* vs = ks + TK * ld;           // [TK][ld]
  float* ps = vs + TK * ld;           // [BQ][PLD], probabilities of one tile
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  const T* kb = k + (size_t)(bh / group) * S * dh;
  const T* vb = v + (size_t)(bh / group) * S * dh;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  stage(qs, q + ((size_t)bh * S + q0) * dh, S - q0, dh, ld, scale);

  float m[TM], l[TM], acc[TM][DN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  // kv tiles past the diagonal are fully masked for every row: skipped
  for (int t = 0; t <= qt; ++t) {
    const int k0 = t * TK;
    stage(ks, kb + (size_t)k0 * dh, S - k0, dh, ld, 1.f);
    stage(vs, vb + (size_t)k0 * dh, S - k0, dh, ld, 1.f);
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[(ty + TY * i) * ld + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ks[(tx + TX * j) * ld + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int key = k0 + tx + TX * j;
        if (key > row || key >= S) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + TY * i) * PLD + tx + TX * j] = p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // ps complete

    const int keys = min(TK, S - k0);   // zero-filled keys add nothing
    for (int c = 0; c < keys; ++c) {
      float p[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = ps[(ty + TY * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int col = tx + TX * j;
        const float vv = col < dh ? vs[c * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();   // the next tile overwrites ks, vs and ps
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * S + row) * dh;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = tx + TX * j;
      if (col < dh) store(orow + col, acc[i][j] / den);
    }
  }
}

size_t smem_bytes(int dh) {
  return ((size_t)(BQ + 2 * TK) * (dh + 1) + (size_t)BQ * PLD) * sizeof(float);
}

template <typename T, int DN>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int bkv, int S, int dh, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  auto kernel = flash_attention_kernel<T, DN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, dh, bh / bkv, 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int bh, int bkv, int S, int dh, cudaStream_t stream) {
  if (dh <= 32) return launch<T, 2>(q, k, v, out, bh, bkv, S, dh, stream);
  if (dh <= 64) return launch<T, 4>(q, k, v, out, bh, bkv, S, dh, stream);
  return launch<T, 8>(q, k, v, out, bh, bkv, S, dh, stream);
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

// Dynamic shared memory of one block at head dim dh, in bytes.
int fa_smem_bytes(int dh) { return (int)smem_bytes(dh); }

// q (bh, S, dh); k, v (bkv, S, dh); out (bh, S, dh); all contiguous, one
// dtype (0 = float32, 1 = bfloat16); bh % bkv == 0, 0 < dh <= 128.
int fa_forward(const void* q, const void* k, const void* v, void* out, int bh,
               int bkv, int S, int dh, int dtype, int device, void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv || S <= 0 || dh <= 0 || dh > 128 || bh > 65535)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, out, bh, bkv, S, dh, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, out, bh, bkv, S, dh, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
