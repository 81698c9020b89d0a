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
// NaN where either operand is NaN and fmaxf otherwise, as torch.maximum
// and jnp.maximum are (fmaxf alone drops a NaN operand, so a NaN in
// appends, floors or dt would give finite finishes where the plain loops
// give NaN).  Each seed's chain runs in order in one thread: no atomics,
// nothing reordered across steps, so the result is the plain PyTorch
// version's on the same card, NaNs included.
//
// Bound.  The work is a sequential chain per seed, a few operations a step,
// so the byte bound (z or dt read once, the finishes written once: 8 bytes a
// step and seed, 10 MB for 1,024 seeds x 1,251 steps, 3 us at 3.35 TB/s; the
// per-step inputs add 8 or 12 bytes a step) is far below what the chain's
// latency allows: each step waits for the previous one's max and add (and,
// in the grid scan, a round trip to its state in device memory, which stays
// in the L1 cache), so a call takes about steps x that latency whatever S
// is, until S fills the card (132 SMs x 64 warps).
//
// Design.  One thread per seed, 32 to a block (a block per warp spreads the
// seeds over the SMs; seeds are independent).  Thread s walks its own row of
// z or dt; the per-step inputs shared by all seeds (appends, means, or the
// trajectory) are read by every lane at one address.  The grid scan keeps
// its seed's part_last and cont_last in a scratch array in device memory
// from the caller, laid out [slot][seed] so a warp's 32 accesses to one slot
// fall in one 128-byte line; any n_parts + n_conts fits.  Loads of z and dt
// do not depend on the chain, so the unrolled loop issues them ahead of it.
// An index outside [0, n_parts) or [0, n_conts) makes that step's finish
// NaN and leaves the state as it was; a NaN input propagates through the
// state as in the plain loops.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int THREADS = 32;

// max(x, y) as torch.maximum takes it: the NaN operand where either is NaN,
// else fmaxf(x, y).
__device__ __forceinline__ float nan_max(float x, float y) {
  return x != x ? x : y != y ? y : fmaxf(x, y);
}

__global__ void __launch_bounds__(THREADS)
lockstep_chain_kernel(const float* __restrict__ appends, const float* __restrict__ means,
                      const float* __restrict__ z, float a, float b,
                      float* __restrict__ out, int S, int n) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= S) return;
  const float* zr = z + (size_t)s * n;
  float* o = out + (size_t)s * n;
  float finish = 0.0f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const float dt = __fmul_rn(means[i], expf(__fadd_rn(a, __fmul_rn(b, zr[i]))));
    finish = __fadd_rn(nan_max(appends[i], finish), dt);
    o[i] = finish;
  }
}

__global__ void __launch_bounds__(THREADS)
grid_lockstep_kernel(const float* __restrict__ floors, const int* __restrict__ parts,
                     const int* __restrict__ conts, const float* __restrict__ dt,
                     float* __restrict__ out, float* __restrict__ scratch, int S, int n,
                     int n_parts, int n_conts) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= S) return;
  float* state = scratch + s;   // this seed's slots, S apart
  const size_t stride = (size_t)S;
  const int slots = n_parts + n_conts;
  for (int k = 0; k < slots; ++k) state[k * stride] = 0.0f;
  float* part_last = state;
  float* cont_last = state + (size_t)n_parts * stride;
  const float* dr = dt + (size_t)s * n;
  float* o = out + (size_t)s * n;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const int p = parts[k], c = conts[k];
    const float d = dr[k];
    if ((unsigned)p >= (unsigned)n_parts || (unsigned)c >= (unsigned)n_conts) {
      o[k] = NAN;
      continue;
    }
    const float start =
        nan_max(floors[k], nan_max(part_last[p * stride], cont_last[c * stride]));
    const float fin = __fadd_rn(start, d);
    part_last[p * stride] = fin;
    cont_last[c * stride] = fin;
    o[k] = fin;
  }
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
  lockstep_chain_kernel<<<(S + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(appends), static_cast<const float*>(means),
      static_cast<const float*>(z), a, b, static_cast<float*>(out), S, n);
  return cudaGetLastError();
}

// floors (n,) float32, parts and conts (n,) int32, dt (S, n) and out (S, n)
// float32, all contiguous; scratch (n_parts + n_conts, S) float32, whose
// contents the kernel overwrites.
int grid_lockstep(const void* floors, const void* parts, const void* conts, const void* dt,
                  void* out, void* scratch, int S, int n, int n_parts, int n_conts,
                  int device, void* stream) {
  if (S <= 0 || n < 0 || n_parts <= 0 || n_conts <= 0 ||
      (long long)n_parts + n_conts > INT_MAX / 2 || scratch == nullptr)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  grid_lockstep_kernel<<<(S + THREADS - 1) / THREADS, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(floors), static_cast<const int*>(parts),
      static_cast<const int*>(conts), static_cast<const float*>(dt),
      static_cast<float*>(out), static_cast<float*>(scratch), S, n, n_parts, n_conts);
  return cudaGetLastError();
}

}  // extern "C"
