// fct_count: the MR2 weighted token histogram, written by hand for Hopper
// (sm_90a), built with nvcc into a shared library with a plain C interface
// and bound with ctypes (repro_torch/kernels/fct_count/kernel.py).
//
// Replaces the TPU kernels of src/repro/kernels/fct_count/kernel.py:
//   fct_count_pallas_exact (integer weights: the int32 and int64
//   instantiations below) and fct_count_pallas (float32 weights).
//
// Computes, for every batch entry b (a candidate network of one engine
// dispatch),
//   out[b, v] += sum_row weights[b, row] * #{j : tokens[b, row, j] == v}
// PAD (0) is never counted, tokens outside [0, vocab) are dropped, and the
// integer instantiations are exact modulo 2^width of the weight type,
// wrap-around included (integer atomics are exact and order-independent).
// The TPU kernel's split-limb float32 matmul exists only because the TPU's
// matrix unit accumulates in float; none of it carries over.
//
// Design: grid (row_chunks, vocab_tiles, batch), 256 threads a block.  Each
// block holds the bins of one vocab tile in dynamic shared memory, counts its
// chunk of rows into them with shared-memory atomics, then merges every
// non-zero bin into `out` with one global atomic.  The caller zeroes `out`.
//
// Bound: device-memory bytes.  One launch reads B*R*L*4 token bytes plus
// B*R*w weight bytes once per vocab tile and writes B*V*w, against
// 3.35 TB/s on an H100 SXM; the arithmetic is one add per token.  The likely
// gap to that bound is contention of shared-memory atomics on the Zipf-hot
// bins of real text (a few ids take a large share of all tokens); that gap
// is measured and recorded, not yet worked on.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void atomic_add(int32_t* p, int32_t v) {
  atomicAdd(reinterpret_cast<int*>(p), static_cast<int>(v));
}

__device__ __forceinline__ void atomic_add(int64_t* p, int64_t v) {
  // two's-complement addition of the raw bits: exact modulo 2^64
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fct_count_kernel(const int32_t* __restrict__ tokens,
                 const T* __restrict__ weights, T* __restrict__ out,
                 int64_t rows, int text_len, int vocab, int tile,
                 int64_t rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bins = reinterpret_cast<T*>(smem_raw);

  const int64_t b = blockIdx.z;
  const int v0 = static_cast<int>(blockIdx.y) * tile;
  const int width = min(tile, vocab - v0);
  for (int i = threadIdx.x; i < width; i += kThreads) bins[i] = T(0);
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_chunk;
  const int64_t row1 = min(rows, row0 + rows_per_chunk);
  if (row0 < row1) {
    const int32_t* tok = tokens + (b * rows + row0) * text_len;
    const T* w = weights + b * rows + row0;
    // the wrapper keeps rows_per_chunk * text_len below 2^31
    const int n = static_cast<int>((row1 - row0) * text_len);
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int t = tok[e];
      // PAD, negative ids and ids outside this tile are not counted here
      if (t != 0 && t >= v0 && t < v0 + width) {
        const T wv = w[e / text_len];
        if (wv != T(0)) atomic_add(&bins[t - v0], wv);
      }
    }
  }
  __syncthreads();

  T* dst = out + b * vocab + v0;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const T c = bins[i];
    if (c != T(0)) atomic_add(&dst[i], c);
  }
}

template <typename T>
cudaError_t launch(const void* tokens, const void* weights, void* out,
                   int64_t batch, int64_t rows, int text_len, int vocab,
                   int tile, int64_t rows_per_chunk, void* stream) {
  const int64_t tiles = (vocab + tile - 1) / tile;
  const int64_t chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const int smem = static_cast<int>(sizeof(T)) * (vocab < tile ? vocab : tile);
  cudaError_t err = cudaFuncSetAttribute(
      fct_count_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(tiles),
                  static_cast<unsigned>(batch));
  fct_count_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tokens), static_cast<const T*>(weights),
      static_cast<T*>(out), rows, text_len, vocab, tile, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fct_count_int32(const void* tokens, const void* weights, void* out,
                    int64_t batch, int64_t rows, int text_len, int vocab,
                    int tile, int64_t rows_per_chunk, void* stream) {
  return static_cast<int>(launch<int32_t>(tokens, weights, out, batch, rows,
                                          text_len, vocab, tile,
                                          rows_per_chunk, stream));
}

int fct_count_int64(const void* tokens, const void* weights, void* out,
                    int64_t batch, int64_t rows, int text_len, int vocab,
                    int tile, int64_t rows_per_chunk, void* stream) {
  return static_cast<int>(launch<int64_t>(tokens, weights, out, batch, rows,
                                          text_len, vocab, tile,
                                          rows_per_chunk, stream));
}

int fct_count_float32(const void* tokens, const void* weights, void* out,
                      int64_t batch, int64_t rows, int text_len, int vocab,
                      int tile, int64_t rows_per_chunk, void* stream) {
  return static_cast<int>(launch<float>(tokens, weights, out, batch, rows,
                                        text_len, vocab, tile,
                                        rows_per_chunk, stream));
}

}  // extern "C"
