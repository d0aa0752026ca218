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
// Two layouts of the rows, one body:
//   - plain: tokens [B, R, L], row r of entry b at tokens[b, r];
//   - routed (MR2 by reference): entry b's rows are the P*P*C slots of its
//     routed relation, (dst, src, c) in that order, and slot (dst, src, c)
//     reads source row src*S + clamp(send[b, src, dst, c], 0, S-1) of the
//     CN's own store-resident text [P, S, L], whose base is texts[b] (a
//     device table of pointers).  That is the routing gather and the
//     all_to_all's transposition, read where they lie: no routed copy of
//     the text is made.  The one read it adds is the 4-byte send entry of
//     each row whose weight is not 0.
// PAD (0) is never counted, tokens outside [0, vocab) are dropped, and the
// integer instantiations are exact modulo 2^width of the weight type,
// wrap-around included (integer adds are exact and order-independent).
// The TPU kernel's split-limb float32 matmul exists only because the TPU's
// matrix unit accumulates in float; none of it carries over.
//
// Bound: device-memory bytes.  A row whose weight is 0 adds nothing, so its
// tokens need not be read: one launch must read the B*R weights, the tokens
// of the rows with a non-zero weight, and write B*V bins, against 3.35 TB/s
// on an H100 SXM; the arithmetic is one add per token.  On the FCT main path
// most rows weigh 0 (padding to a power of two, rows that join nothing).
// The routed layout reads 4 bytes more a non-zero row, its send entry, and
// its tokens lie scattered over the source text, one row (48-64 bytes) a
// run.
//
// Design: grid (row_chunks x vocab_tiles, batch), vocab tile fastest, so the
// blocks of one row chunk run side by side and the second read of a chunk
// (int64 bins need two 128 KB tiles at V = 32 768) hits L2.  1 024 threads a
// block, one block an SM: 32 warps share one vocab tile of bins in shared
// memory.
//   - Rows in groups of 32.  A warp loads the 32 weights of each of its
//     next 4 groups in one read each, all 4 in flight together, and skips a
//     group whose weights are all 0 without touching its tokens.  Otherwise its
//     lanes take the group's tokens in order, 16 bytes (int4) a load when
//     L % 4 == 0 and the tokens are 16-byte aligned, else 4 bytes, up to 4
//     loads in flight a lane; a lane skips the loads of rows whose weight
//     (shuffled from the lane that read it) is 0.  No division per token:
//     the (row, column) of a lane's next load is stepped by constants.
//   - Routed rows.  Beside its weight, each lane of a group reads the send
//     entry of its own row when the weight is not 0 (the 4 groups' entries
//     in flight together), and a token load takes its row's source row
//     from the lane that read it, by a shuffle as the weight.  Alignment is
//     decided per block, from the CN's text base.
//   - Bins.  int32 and float32 bins take the shared-memory atomics of
//     their width.  int64 bins are two 32-bit words: the low word's atomic
//     returns its old value, and the lane whose add wrapped it carries one
//     into the high word (64-bit shared atomics are compare-and-swap loops
//     that spin on the Zipf-hot bins of real text).  Integer adds are exact
//     modulo 2^width in any order.
//   - After the chunk, each non-zero bin is merged into `out` with one
//     global atomic.  The caller zeroes `out`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // token loads a lane keeps in flight
constexpr int kGroups = 4;  // 32-row groups whose weights a warp loads at once

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

// one vocab tile of bins in shared memory: `words` 4-byte words a bin
template <typename T>
struct Bins {
  static constexpr int words = 1;
  T* bin;
  __device__ explicit Bins(void* smem, int) : bin(static_cast<T*>(smem)) {}
  __device__ void zero(int i) { bin[i] = T(0); }
  __device__ void add(int i, T w) { atomic_add(&bin[i], w); }
  __device__ T get(int i) const { return bin[i]; }
};

// int64 bins as a low and a high 32-bit word: shared-memory atomics add 32
// bits natively and 64 bits only by a compare-and-swap loop, which spins on
// the hot bins.  The low word's add returns its old value, so the lane whose
// add wrapped it carries one into the high word: exact modulo 2^64.
template <>
struct Bins<int64_t> {
  static constexpr int words = 2;
  uint32_t* lo;
  uint32_t* hi;
  __device__ Bins(void* smem, int width)
      : lo(static_cast<uint32_t*>(smem)), hi(lo + width) {}
  __device__ void zero(int i) { lo[i] = hi[i] = 0u; }
  __device__ void add(int i, int64_t w) {
    const uint64_t u = static_cast<uint64_t>(w);
    const uint32_t wl = static_cast<uint32_t>(u);
    const uint32_t old = atomicAdd(&lo[i], wl);
    const uint32_t up = static_cast<uint32_t>(u >> 32) + (old + wl < old);
    if (up != 0u) atomicAdd(&hi[i], up);
  }
  __device__ int64_t get(int i) const {
    return static_cast<int64_t>((static_cast<uint64_t>(hi[i]) << 32) | lo[i]);
  }
};

// PAD, negative ids and ids outside this tile are not counted here
template <typename T>
__device__ __forceinline__ void count(int t, T w, Bins<T>& bins, int v0,
                                      int width) {
  if (t != 0 && t >= v0 && t < v0 + width) bins.add(t - v0, w);
}
template <typename T>
__device__ __forceinline__ void count_unit(int t, T w, Bins<T>& bins, int v0,
                                           int width) {
  count(t, w, bins, v0, width);
}
template <typename T>
__device__ __forceinline__ void count_unit(int4 t, T w, Bins<T>& bins,
                                           int v0, int width) {
  count(t.x, w, bins, v0, width);
  count(t.y, w, bins, v0, width);
  count(t.z, w, bins, v0, width);
  count(t.w, w, bins, v0, width);
}

// where a routed row's tokens lie: slot r of a batch entry is (dst, src, c)
// = (r / (P C), r / C % P, r % C), and reads source row
// src * S + clamp(send[src, dst, c], 0, S - 1) of the entry's text
struct Route {
  const int32_t* send;  // this batch entry's [P(src), P(dst), C] table
  int P, C, S;
  __device__ __forceinline__ int source_row(int64_t r) const {
    const int pc = P * C;
    const int slot = static_cast<int>(r);
    const int dst = slot / pc, j = slot - dst * pc;
    const int src = j / C, c = j - src * C;
    const int e = __ldg(send + (src * P + dst) * C + c);
    return src * S + min(max(e, 0), S - 1);
  }
};

// rows [row0, row1) of one batch entry; Unit is int4 (4 tokens) or int.
// Plain rows lie one after another from `units`; routed rows (kRouted)
// where `route` says, `units` being the entry's text
template <typename T, typename Unit, bool kRouted>
__device__ __forceinline__ void count_rows(const Unit* __restrict__ units,
                                           const T* __restrict__ w,
                                           const Route route, int64_t row0,
                                           int64_t row1, int q, Bins<T>& bins,
                                           int v0, int width) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // in a group of 32 rows of q units each, lane takes units lane + 32 i
  // (i < q): unit j is row j / q, column j % q; j += 32 steps the row by
  // 32 / q and the column by 32 % q
  const int dr = 32 / q, dc = 32 % q;
  const int rr0 = lane / q, cc0 = lane % q;
  constexpr int64_t kStride = 32 * kWarps;
  // a warp takes the groups at row0 + 32 warp + k kStride, kGroups of them
  // at a time: their weights are loaded together, so that a run of
  // zero-weight rows keeps kGroups loads in flight a lane
  for (int64_t g0 = row0 + 32 * warp; g0 < row1; g0 += kGroups * kStride) {
    T wg[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int64_t r = g0 + k * kStride + lane;
      wg[k] = r < row1 ? w[r] : T(0);
    }
    // routed: the source row of this lane's row in each group, read only
    // where the row weighs something
    int src_row[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      src_row[k] = 0;
      if constexpr (kRouted) {
        if (wg[k] != T(0))
          src_row[k] = route.source_row(g0 + k * kStride + lane);
      }
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const T wr = wg[k];
      if (__ballot_sync(0xffffffffu, wr != T(0)) == 0) continue;
      const Unit* ug = kRouted ? units : units + (g0 + k * kStride) * q;
      int rr = rr0, cc = cc0;
      for (int i = 0; i < q; i += kUnroll) {
        Unit val[kUnroll] = {};
        T wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const T x = __shfl_sync(0xffffffffu, wr, rr & 31);
          wv[u] = i + u < q ? x : T(0);
          int64_t at = rr * q + cc;
          if constexpr (kRouted)
            at = static_cast<int64_t>(
                     __shfl_sync(0xffffffffu, src_row[k], rr & 31)) * q + cc;
          if (wv[u] != T(0)) val[u] = __ldg(ug + at);
          cc += dc;
          rr += dr;
          if (cc >= q) {
            cc -= q;
            ++rr;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (wv[u] != T(0)) count_unit(val[u], wv[u], bins, v0, width);
      }
    }
  }
}

// one block: zero its vocab tile of bins, count its row chunk of batch
// entry blockIdx.y (16-byte loads when the rows allow them), merge the bins
// into out[b]
template <typename T, bool kRouted>
__device__ __forceinline__ void histogram_block(
    void* smem_raw, const int32_t* __restrict__ tok, const T* __restrict__ w,
    const Route route, T* __restrict__ out, int64_t rows, int text_len,
    int vocab, int tile, int tiles, int64_t rows_per_chunk) {
  const int64_t b = blockIdx.y;
  const int64_t chunk = blockIdx.x / tiles;
  const int v0 = static_cast<int>(blockIdx.x % tiles) * tile;
  const int width = min(tile, vocab - v0);
  Bins<T> bins(smem_raw, width);
  for (int i = threadIdx.x; i < width; i += kThreads) bins.zero(i);
  __syncthreads();

  const int64_t row0 = chunk * rows_per_chunk;
  const int64_t row1 = min(rows, row0 + rows_per_chunk);
  if (text_len % 4 == 0 && reinterpret_cast<uintptr_t>(tok) % 16 == 0)
    count_rows<T, int4, kRouted>(reinterpret_cast<const int4*>(tok), w,
                                 route, row0, row1, text_len / 4, bins, v0,
                                 width);
  else
    count_rows<T, int, kRouted>(tok, w, route, row0, row1, text_len, bins,
                                v0, width);
  __syncthreads();

  T* dst = out + b * vocab + v0;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const T c = bins.get(i);
    if (c != T(0)) atomic_add(&dst[i], c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fct_count_kernel(const int32_t* __restrict__ tokens,
                 const T* __restrict__ weights, T* __restrict__ out,
                 int64_t rows, int text_len, int vocab, int tile, int tiles,
                 int64_t rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t b = blockIdx.y;
  histogram_block<T, false>(smem_raw, tokens + b * rows * text_len,
                            weights + b * rows, Route{}, out, rows, text_len,
                            vocab, tile, tiles, rows_per_chunk);
}

// batch entry b reads its rows through send[b] from the text at texts[b]
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fct_count_routed_kernel(const int64_t* __restrict__ texts,
                        const int32_t* __restrict__ send,
                        const T* __restrict__ weights, T* __restrict__ out,
                        int P, int C, int S, int text_len, int vocab, int tile,
                        int tiles, int64_t rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t b = blockIdx.y;
  const int64_t rows = static_cast<int64_t>(P) * P * C;
  const Route route{send + b * rows, P, C, S};
  histogram_block<T, true>(smem_raw,
                           reinterpret_cast<const int32_t*>(texts[b]),
                           weights + b * rows, route, out, rows, text_len,
                           vocab, tile, tiles, rows_per_chunk);
}

// the grid and shared memory of one launch over `rows` rows a batch entry
template <typename T>
struct Grid {
  dim3 grid;
  int smem, tiles;
  Grid(int64_t batch, int64_t rows, int vocab, int tile,
       int64_t rows_per_chunk) {
    const int64_t t = (vocab + tile - 1) / tile;
    const int64_t chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
    tiles = static_cast<int>(t);
    smem = 4 * Bins<T>::words * (vocab < tile ? vocab : tile);
    grid = dim3(static_cast<unsigned>(chunks * t),
                static_cast<unsigned>(batch));
  }
};

template <typename T>
cudaError_t launch(const void* tokens, const void* weights, void* out,
                   int64_t batch, int64_t rows, int text_len, int vocab,
                   int tile, int64_t rows_per_chunk, void* stream) {
  const Grid<T> g(batch, rows, vocab, tile, rows_per_chunk);
  cudaError_t err = cudaFuncSetAttribute(
      fct_count_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.smem);
  if (err != cudaSuccess) return err;
  fct_count_kernel<T><<<g.grid, kThreads, g.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tokens), static_cast<const T*>(weights),
      static_cast<T*>(out), rows, text_len, vocab, tile, g.tiles,
      rows_per_chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_routed(const void* texts, const void* send,
                          const void* weights, void* out, int64_t batch,
                          int P, int C, int S, int text_len, int vocab,
                          int tile, int64_t rows_per_chunk, void* stream) {
  const Grid<T> g(batch, static_cast<int64_t>(P) * P * C, vocab, tile,
                  rows_per_chunk);
  cudaError_t err = cudaFuncSetAttribute(
      fct_count_routed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.smem);
  if (err != cudaSuccess) return err;
  fct_count_routed_kernel<T><<<g.grid, kThreads, g.smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(texts), static_cast<const int32_t*>(send),
      static_cast<const T*>(weights), static_cast<T*>(out), P, C, S, text_len,
      vocab, tile, g.tiles, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define FCT_ENTRY(NAME, T)                                                  \
  int NAME(const void* tokens, const void* weights, void* out,             \
           int64_t batch, int64_t rows, int text_len, int vocab, int tile, \
           int64_t rows_per_chunk, void* stream) {                         \
    return static_cast<int>(launch<T>(tokens, weights, out, batch, rows,   \
                                      text_len, vocab, tile,               \
                                      rows_per_chunk, stream));            \
  }

FCT_ENTRY(fct_count_int32, int32_t)
FCT_ENTRY(fct_count_int64, int64_t)
FCT_ENTRY(fct_count_float32, float)
#undef FCT_ENTRY

#define FCT_ROUTED_ENTRY(NAME, T)                                           \
  int NAME(const void* texts, const void* send, const void* weights,        \
           void* out, int64_t batch, int P, int C, int S, int text_len,     \
           int vocab, int tile, int64_t rows_per_chunk, void* stream) {     \
    return static_cast<int>(launch_routed<T>(texts, send, weights, out,     \
                                             batch, P, C, S, text_len,      \
                                             vocab, tile, rows_per_chunk,   \
                                             stream));                      \
  }

FCT_ROUTED_ENTRY(fct_count_routed_int32, int32_t)
FCT_ROUTED_ENTRY(fct_count_routed_int64, int64_t)
#undef FCT_ROUTED_ENTRY

}  // extern "C"
