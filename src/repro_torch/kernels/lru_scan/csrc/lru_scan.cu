// lru_scan: the RG-LRU diagonal recurrence, written by hand for Hopper
// (sm_90a), built with nvcc into a shared library with a plain C interface
// and bound with ctypes (repro_torch/kernels/lru_scan/kernel.py).
//
// Replaces the TPU kernel src/repro/kernels/lru_scan/kernel.py
// (lru_scan_pallas, body _kernel).
//
// Computes, for a, b [B, S, W] (contiguous, float32 or bfloat16),
//   h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w],   h[b, -1, w] = 0,
// with the carry in float32 and each h rounded to the input type on store
// (round to nearest even for bfloat16).
//
// Design: one thread per (batch, channel), neighbouring threads on
// neighbouring channels so every load and store of a warp is one coalesced
// 128-byte line (float32), and a loop over S inside the thread.  The loop
// runs in chunks of kUnroll steps, double-buffered in registers: the loads of
// chunk k+1 are issued before the dependent multiply-adds of chunk k, so
// 2*kUnroll loads are in flight while the carry chain runs.  Each of a and b
// is read once and h written once.
//
// Bound: device-memory bytes, 3 * B*S*W * sizeof(T) at 3.35 TB/s on an H100
// SXM (the arithmetic is one multiply-add per element).  The design is
// latency-bound instead: B*W threads (2 560 at the recurrentgemma-2b shape,
// 80 warps for 132 SMs) cannot keep enough bytes in flight to approach the
// bandwidth.  A chunked two-pass scan (per-chunk carries, then a fix-up)
// that parallelises over S is the known remedy; it is left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ h, int64_t seq, int64_t width,
                int64_t lanes) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (lane >= lanes) return;
  const int64_t base = (lane / width) * seq * width + lane % width;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;

  float carry = 0.0f;
  const int64_t full = seq - seq % kUnroll;
  float a_cur[kUnroll], b_cur[kUnroll], a_nxt[kUnroll], b_nxt[kUnroll];
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a_nxt[u] = to_float(ap[u * width]);
      b_nxt[u] = to_float(bp[u * width]);
    }
  }
  for (int64_t t0 = 0; t0 < full; t0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a_cur[u] = a_nxt[u];
      b_cur[u] = b_nxt[u];
    }
    if (t0 + kUnroll < full) {
      const int64_t off = (t0 + kUnroll) * width;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a_nxt[u] = to_float(ap[off + u * width]);
        b_nxt[u] = to_float(bp[off + u * width]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = fmaf(a_cur[u], carry, b_cur[u]);
      hp[(t0 + u) * width] = from_float<T>(carry);
    }
  }
  for (int64_t t = full; t < seq; ++t) {
    carry = fmaf(to_float(ap[t * width]), carry, to_float(bp[t * width]));
    hp[t * width] = from_float<T>(carry);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int64_t batch,
                   int64_t seq, int64_t width, void* stream) {
  const int64_t lanes = batch * width;
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  lru_scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      seq, width, lanes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int lru_scan_float32(const void* a, const void* b, void* h, int64_t batch,
                     int64_t seq, int64_t width, void* stream) {
  return static_cast<int>(launch<float>(a, b, h, batch, seq, width, stream));
}

int lru_scan_bfloat16(const void* a, const void* b, void* h, int64_t batch,
                      int64_t seq, int64_t width, void* stream) {
  return static_cast<int>(
      launch<__nv_bfloat16>(a, b, h, batch, seq, width, stream));
}

}  // extern "C"
