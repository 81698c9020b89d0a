// Hopper (sm_90a) primitives of K3's backward (flash_attention_bwd.cu):
// mbarriers, TMA tile loads, wgmma on 128-byte-swizzled shared tiles, and
// the driver's tensor-map encoder reached through the runtime.
//
// Tiles: a 64-row bf16 tile of head dim up to 64 NP lives in shared memory
// as NP panels of 64 rows x 64 columns (8 KB each, 1024-byte aligned), row r
// at 128 r bytes, its 16-byte chunk j stored at chunk j ^ (r % 8): the layout
// that TMA's SWIZZLE_128B writes and that a wgmma descriptor of layout type
// B128 reads.  One descriptor form serves both uses here:
//  - K-major (rows are the operand's M or N, the head dim is the reduction):
//    start at the panel plus 32 bytes per 16-column step;
//  - MN-major (rows are the reduction, the head dim is N, wgmma's transpose
//    bit set): start at the panel plus 2 KB per 16-row step, one panel per
//    instruction (N 64).
// Both strides of 8-row groups are 1024 bytes; with one 64-wide MN chunk an
// instruction never steps the other offset, so both offset fields hold 1024.
// The wgmma wrappers take 32-bit shared addresses and build the descriptor
// (address / 16 in bits 0-13, FA_DESC_HI above) inside their asm.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fa_common.cuh"

namespace {

constexpr int PANEL = 64 * 64;                  // bf16 elements of one panel
constexpr int PANEL_BYTES = PANEL * 2;
constexpr unsigned long long WAIT_LIMIT_NS = 10'000'000'000ull;   // 10 s

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
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
// complete within WAIT_LIMIT_NS (a kernel here takes milliseconds) is a
// fault of the pipeline: trap, so that the launch fails instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  if (mbar_try(addr, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(addr, parity))
    if (globaltimer() - t0 > WAIT_LIMIT_NS) __trap();
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma) before the writer's barrier arrival.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- TMA ---------------------------------------------------------------------

// One box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-D tensor map at coordinates (c0 innermost, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// The element offset of (row r < 64, column c) in a tile of swizzled panels.
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return (c >> 6) * PANEL + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// -- wgmma -------------------------------------------------------------------

// Descriptor bits besides the start address: both 8-row-group strides
// 1024 bytes (in 16-byte units, bits 16-29 and 32-45) and layout B128 (bit
// 62).  The start address (bits 0-13) is the shared address / 16.
#define FA_DESC_HI "0x4000004000400000"

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes of `r` across an
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

#define FA_WGMMA_D32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_WGMMA_ACC(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])

#define FA_WGMMA_OUT(d)                                                                 \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),  \
  "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),            \
  "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),         \
  "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),         \
  "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),         \
  "=f"(d[31])

// The descriptor of the operand at shared address %A + %O (bytes), built
// inside the instruction's block: the compiler cannot then hoist one
// 64-bit descriptor per step into registers.
#define FA_DESC(D, A, O)                                                              \
  "add.u32 t32, " A ", " O ";\nshr.u32 t32, t32, 4;\nand.b32 t32, t32, 0x3FFF;\n"     \
  "cvt.u64.u32 " D ", t32;\nor.b64 " D ", " D ", " FA_DESC_HI ";\n"

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B K-major,
// 128-byte-swizzled in shared memory at addresses a + oa and b + ob (bytes).
// Thread t of the warpgroup holds d[4 j + e] at row
// 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
// `wgmma_ss_first` overwrites d (the first step of a product: d's old
// values are dead to the compiler, which otherwise keeps them live across
// the loop), `wgmma_ss` accumulates.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], unsigned a, unsigned oa,
                                               unsigned b, unsigned ob) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 t32;\n.reg .b64 da, db;\n"
      FA_DESC("da", "%32", "%33") FA_DESC("db", "%34", "%35")
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_WGMMA_D32
      ", da, db, p, 1, 1, 0, 0;\n}\n"
      : FA_WGMMA_OUT(d)
      : "r"(a), "r"(oa), "r"(b), "r"(ob), "r"(0));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], unsigned a, unsigned oa, unsigned b,
                                         unsigned ob) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 t32;\n.reg .b64 da, db;\n"
      FA_DESC("da", "%32", "%33") FA_DESC("db", "%34", "%35")
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_WGMMA_D32
      ", da, db, p, 1, 1, 0, 0;\n}\n"
      : FA_WGMMA_ACC(d)
      : "r"(a), "r"(oa), "r"(b), "r"(ob), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers: mma.sync's A fragment of
// each warp's 16 rows) B (16 x 64), B MN-major at shared address b + ob.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4], unsigned b,
                                         unsigned ob) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 t32;\n.reg .b64 db;\n"
      FA_DESC("db", "%36", "%37")
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_WGMMA_D32
      ", {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : FA_WGMMA_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(ob), "r"(1));
}

#undef FA_WGMMA_D32
#undef FA_WGMMA_ACC
#undef FA_WGMMA_OUT
#undef FA_DESC
#undef FA_DESC_HI

// -- warp specialisation ------------------------------------------------------

// The warpgroup index of the calling thread, broadcast from lane 0 so that
// ptxas knows it is the same across the warp: it serialises every wgmma on
// a path under a branch that it cannot prove warp-uniform (C7520), and a
// branch on threadIdx.x / 128 is not, to it.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// -- host: tensor maps -------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no -lcuda), or
// null if the driver does not give it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (n, S, dh) tensor as 64 x 64 boxes swizzled by 128 bytes, rows past
// S and columns past dh read as zeros.  dh % 8 == 0 and `base` 16-byte
// aligned (TMA's stride and address rules).
cudaError_t bf16_tile_map(EncodeTiled encode, CUtensorMap* map, const void* base, int n, int S,
                          int dh) {
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)S * dh * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
