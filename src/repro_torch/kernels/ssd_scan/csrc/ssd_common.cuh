// Helpers shared by K4's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu):
// the warp scan behind every decay, a chunk's decays from its dt, and the
// device guard of the C entry points.  Each source includes this once.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

}  // namespace
