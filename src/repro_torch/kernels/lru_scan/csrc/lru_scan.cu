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
// Design: a single-pass chunked scan, parallel over S as well as over
// channels and batch.
//   - Tiles.  A block of 256 threads covers kChunk = 128 timesteps x kTile
//     channels (64 float32 or 128 bfloat16: 16 groups of 16 bytes) of one
//     batch row.  Thread (group g, sub-chunk s) owns channels g and timesteps
//     s*8 .. s*8+7 of the tile: it copies its 8 x 16 bytes of a and of b into
//     shared memory with 16-byte cp.async (all 16 in flight; 64 KB a block,
//     three blocks an SM), and reads back only what it copied.  At the
//     prefill's shape (B 1, S 8 192, W 2 560, float32) that is 64 chunks x
//     40 tiles = 2 560 blocks.
//   - Chunk order without deadlock.  A block takes a ticket from a device
//     counter (atomicAdd) and maps it to (chunk, batch, tile), chunk-major,
//     so it only ever waits on chunks whose blocks already hold a ticket and
//     run; blockIdx order is not relied on.
//   - Aggregate.  Each thread runs the zero-carry loop over its piece,
//     giving (prod a, h_end) per channel; the 16 sub-chunks combine in a
//     fixed order into the tile's (A_c, H_c) per channel.
//   - Look-back, per channel (after Merrill & Garland, 2016, "Single-pass
//     Parallel Prefix Scan with Decoupled Look-back").  The channel's owner
//     thread publishes (A_c, H_c) as one 64-bit word, then reads the words of
//     its kLook = 4 predecessors at once and stops at the nearest one that
//     holds its inclusive carry P_k (before chunk 0: the zero carry), every
//     nearer one holding its aggregate; else it reads them again.  It folds
//     forward, P_j = fmaf(A_j, P_{j-1}, H_j) for j = k+1 .. c-1, and
//     publishes P_c = fmaf(A_c, P_{c-1}, H_c).  Every word starts all ones
//     ("not ready"; a value with those bits, one NaN, is written as another
//     NaN) and is written once with a single 32- or 64-bit store, so a
//     reader sees it whole or not at all: no fence or flag orders it.
//   - Recompute.  Each thread folds the tile's carry-in through the
//     sub-chunk aggregates before its own, in order, then re-runs
//     h = fmaf(a, h, b) over its 8 steps and stores h with 16-byte stores.
//   Misaligned pointers or W % (16 / sizeof(T)) != 0 take scalar loads and
//   stores in the same kernel; ragged S and W are masked (zeros past them).
//   The geometry is decided here alone: lru_scan_geometry reports it, and
//   the wrapper sizes the scratch from it.
//
// Deterministic: every carry is the serial chain P_c = fmaf(A_c, P_{c-1},
// H_c) over the same per-chunk aggregates, whichever predecessor the
// look-back happened to stop at, and every aggregate is combined in a fixed
// order; so the bits do not change from call to call.  They differ from the
// plain sequential loop by the rounding of the aggregates; the emulation in
// tests/test_torch_lru_scan.py holds that order to the port's 1e-5 rule.
//
// Bound: device-memory bytes, 3 * B*S*W * sizeof(T) at 3.35 TB/s on an H100
// SXM (each of a and b read once, h written once; the arithmetic is about
// three multiply-adds an element).  The scratch adds 12 bytes per (chunk,
// batch, channel), 1.97 MB at the prefill's shape (0.8% of its 252 MB,
// written once by the caller's fill and once here, read back mostly from
// L2).  What is left above the bound is the block's chain of latencies
// (ticket, copies, two barriers, the look-back's round trip to L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;            // 16-byte channel groups a tile
constexpr int kSubs = kThreads / kGroups;  // sub-chunks a chunk
constexpr int kSub = 8;                // timesteps a sub-chunk (a thread)
constexpr int kChunk = kSubs * kSub;   // timesteps a block
constexpr int kBlocksPerSM = 3;        // resident blocks an SM (float32)
// dynamic shared memory a block: 8 timesteps x 16 bytes of a and of b for
// each thread
constexpr int kTileBytes = 2 * kSub * kThreads * 16;
constexpr int kLook = 4;               // predecessors a look-back reads

// a published word is kNotReady (all ones) until its owner writes it; a
// value with those bits (one NaN) is written as another NaN
constexpr unsigned kNotReady = 0xffffffffu;

__device__ __forceinline__ unsigned ready(float x) {
  const unsigned u = __float_as_uint(x);
  return u == kNotReady ? 0x7fffffffu : u;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// element v of 16 packed bytes, as float
template <typename T>
__device__ __forceinline__ float unpack(const uint4& u, int v);
template <>
__device__ __forceinline__ float unpack<float>(const uint4& u, int v) {
  return __uint_as_float((&u.x)[v]);
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(const uint4& u,
                                                       int v) {
  const unsigned w = (&u.x)[v >> 1];
  return __uint_as_float((v & 1) ? (w & 0xffff0000u) : (w << 16));
}

// the bits of one element of type T, in the low bits of the result
template <typename T>
__device__ __forceinline__ unsigned bits_of(T x);
template <>
__device__ __forceinline__ unsigned bits_of<float>(float x) {
  return __float_as_uint(x);
}
template <>
__device__ __forceinline__ unsigned bits_of<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// element v of 16 packed bytes set to x (the slot is zero before)
template <typename T>
__device__ __forceinline__ void pack(unsigned (&w)[4], int v, T x) {
  constexpr int kBits = 8 * sizeof(T);
  w[v * kBits / 32] |= bits_of<T>(x) << (v * kBits % 32);
}

// n <= 16 / sizeof(T) elements at p, packed as one 16-byte load would, the
// rest zero
template <typename T>
__device__ __forceinline__ uint4 load_scalar(const T* p, int64_t n) {
  constexpr int V = 16 / sizeof(T);
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (v < n) pack<T>(w, v, p[v]);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ h, int64_t batch, int64_t seq, int64_t width,
                int tiles, int vec_ok, unsigned* __restrict__ ticket,
                unsigned long long* __restrict__ agg,
                unsigned* __restrict__ inclusive) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kTile = kGroups * V;
  static_assert(kTile <= kThreads, "a thread combines each channel");
  __shared__ unsigned s_ticket;
  __shared__ float sA[kSubs][kTile], sH[kSubs][kTile], s_carry[kTile];
  // this thread's 16 bytes of a (then b) at timestep i: [i * kThreads + tid]
  extern __shared__ uint4 s_tile[];
  uint4* const s_a = s_tile + threadIdx.x;
  uint4* const s_b = s_tile + kSub * kThreads + threadIdx.x;

  const int group = threadIdx.x % kGroups, sub = threadIdx.x / kGroups;
  // the counter starts at ~0u, so the first ticket is 0
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u) + 1u;
  __syncthreads();
  const int64_t rows = batch * tiles;  // (batch, tile) pairs a chunk
  const int64_t chunk = s_ticket / rows;
  const int64_t row = s_ticket % rows;
  const int64_t bi = row / tiles;
  const int64_t tile = row % tiles;

  // 1. this thread's 8 timesteps x V channels of a and b into shared
  // memory, 16 bytes a copy, all 16 in flight; each thread reads back only
  // what it copied, so waiting on its own copies is enough
  const int64_t c0 = tile * kTile + group * V;
  const int64_t t0 = chunk * kChunk + sub * kSub;
  const int64_t rowbase = bi * seq * width + c0;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int64_t off = rowbase + (t0 + i) * width;
    const bool in = t0 + i < seq && c0 < width;
    if (vec_ok) {  // past the edges: zeros
      cp_async16(smem_addr(s_a + i * kThreads), in ? a + off : a,
                 in ? 16 : 0);
      cp_async16(smem_addr(s_b + i * kThreads), in ? b + off : b,
                 in ? 16 : 0);
    } else {
      s_a[i * kThreads] = in ? load_scalar<T>(a + off, width - c0)
                             : make_uint4(0, 0, 0, 0);
      s_b[i * kThreads] = in ? load_scalar<T>(b + off, width - c0)
                             : make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_wait_all();

  // 2. zero-carry aggregate of each piece: (prod a, h_end)
  {
    float pa[V], ph[V];
#pragma unroll
    for (int v = 0; v < V; ++v) pa[v] = 1.0f, ph[v] = 0.0f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const uint4 ra = s_a[i * kThreads], rb = s_b[i * kThreads];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float av = unpack<T>(ra, v);
        pa[v] = pa[v] * av;
        ph[v] = fmaf(av, ph[v], unpack<T>(rb, v));
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sA[sub][group * V + v] = pa[v];
      sH[sub][group * V + v] = ph[v];
    }
  }
  __syncthreads();

  // 3-5. per channel of the tile, by its owner thread: the tile's aggregate
  // (sub-chunks in order), published; the look-back; the inclusive carry,
  // published.  Every published word carries its own readiness (kNotReady
  // until written), so no fence or flag orders it.
  const int ch = threadIdx.x;
  const int64_t gc = tile * kTile + ch;
  if (ch < kTile) {
    float carry = 0.0f;
    if (gc < width) {
      float tA = 1.0f, tH = 0.0f;
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        tA = tA * sA[s][ch];
        tH = fmaf(sA[s][ch], tH, sH[s][ch]);
      }
      const int64_t cstride = batch * width;  // between chunks
      const int64_t at = chunk * cstride + bi * width + gc;
      st_relaxed(agg + at, (static_cast<unsigned long long>(ready(tH)) << 32)
                               | ready(tA));
      // look-back: the nearest of the kLook predecessors that holds its
      // inclusive carry (before chunk 0: the zero carry), every nearer one
      // holding its aggregate; else read them again
      unsigned long long wa[kLook];
      unsigned wp[kLook];
      int k;
      for (;;) {
#pragma unroll
        for (int u = 0; u < kLook; ++u) {
          wa[u] = ~0ull;
          wp[u] = 0u;  // the zero carry before the sequence
          if (chunk - 1 - u >= 0) {
            wa[u] = ld_relaxed(agg + at - (u + 1) * cstride);
            wp[u] = ld_relaxed(inclusive + at - (u + 1) * cstride);
          }
        }
        k = kLook;
        bool nearer_ready = true, found = false;
#pragma unroll
        for (int u = 0; u < kLook; ++u) {
          if (!found && wp[u] != kNotReady) {
            k = u;
            found = true;
          }
          if (!found) nearer_ready = nearer_ready && wa[u] != ~0ull;
        }
        if (found && nearer_ready) break;
        __nanosleep(32);
      }
      // fold forward from P_{c-1-k}: P_j = fmaf(A_j, P_{j-1}, H_j)
#pragma unroll
      for (int u = kLook - 1; u >= 0; --u) {
        if (u == k) carry = __uint_as_float(wp[u]);
        if (u < k) {
          carry = fmaf(__uint_as_float(static_cast<unsigned>(wa[u])), carry,
                       __uint_as_float(static_cast<unsigned>(wa[u] >> 32)));
        }
      }
      st_relaxed(inclusive + at, ready(fmaf(tA, carry, tH)));
    }
    s_carry[ch] = carry;
  }
  __syncthreads();

  // 6. this piece's carry-in, then the plain loop again from it
  float p[V];
#pragma unroll
  for (int v = 0; v < V; ++v) p[v] = s_carry[group * V + v];
  for (int s = 0; s < sub; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p[v] = fmaf(sA[s][group * V + v], p[v], sH[s][group * V + v]);
    }
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const uint4 ra = s_a[i * kThreads], rb = s_b[i * kThreads];
    T out[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p[v] = fmaf(unpack<T>(ra, v), p[v], unpack<T>(rb, v));
      out[v] = from_float<T>(p[v]);
    }
    const int64_t off = rowbase + (t0 + i) * width;
    if (t0 + i < seq && c0 < width) {
      if (vec_ok) {
        unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int v = 0; v < V; ++v) pack<T>(w, v, out[v]);
        __stcs(reinterpret_cast<uint4*>(h + off),
               make_uint4(w[0], w[1], w[2], w[3]));
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (c0 + v < width) h[off + v] = out[v];
        }
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// what one launch at (batch, seq, width) takes: the scratch is 32-bit words
// filled with ~0 by the caller: the ticket counter, one word of padding, then
// per (chunk, batch, channel) the aggregate (A | H << 32, 64-bit words) and
// the inclusive carry P (32-bit words)
struct Geometry {
  int64_t tile, chunks, tiles, blocks, words;
};

template <typename T>
Geometry geometry(int64_t batch, int64_t seq, int64_t width) {
  constexpr int kTile = kGroups * 16 / sizeof(T);
  Geometry g;
  g.tile = kTile;
  g.chunks = (seq + kChunk - 1) / kChunk;
  g.tiles = (width + kTile - 1) / kTile;
  g.blocks = g.chunks * batch * g.tiles;
  g.words = 2 + 3 * g.chunks * batch * width;
  return g;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int64_t batch,
                   int64_t seq, int64_t width, void* scratch,
                   int64_t scratch_words, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const Geometry g = geometry<T>(batch, seq, width);
  const int64_t n = g.chunks * batch * width;
  if (g.blocks > INT32_MAX || scratch_words < g.words ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  unsigned* words = static_cast<unsigned*>(scratch);
  const int vec_ok = width % V == 0 && aligned16(a) && aligned16(b) &&
                     aligned16(h);
  // above 48 KB of shared memory a launch is refused unless the kernel opts
  // in (on the current device)
  cudaError_t err = cudaFuncSetAttribute(
      lru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTileBytes);
  // and the most shared memory an SM can give, so kBlocksPerSM blocks fit
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(lru_scan_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  lru_scan_kernel<T><<<static_cast<unsigned>(g.blocks), kThreads, kTileBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      batch, seq, width, static_cast<int>(g.tiles), vec_ok, words,
      reinterpret_cast<unsigned long long*>(words + 2), words + 2 + 2 * n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int lru_scan_float32(const void* a, const void* b, void* h, int64_t batch,
                     int64_t seq, int64_t width, void* scratch,
                     int64_t scratch_words, void* stream) {
  return static_cast<int>(launch<float>(a, b, h, batch, seq, width, scratch,
                                        scratch_words, stream));
}

int lru_scan_bfloat16(const void* a, const void* b, void* h, int64_t batch,
                      int64_t seq, int64_t width, void* scratch,
                      int64_t scratch_words, void* stream) {
  return static_cast<int>(launch<__nv_bfloat16>(
      a, b, h, batch, seq, width, scratch, scratch_words, stream));
}

// The geometry one launch takes for elements of elem_bytes (4: float32, 2:
// bfloat16) at (batch, seq, width), in out[0..4]: timesteps a sub-chunk (one
// thread's piece), timesteps a chunk (a block), channels a tile, blocks (one
// ticket each), and the int32 words of scratch the caller passes.  Launches
// nothing; returns cudaErrorInvalidValue for another elem_bytes.
int lru_scan_geometry(int64_t elem_bytes, int64_t batch, int64_t seq,
                      int64_t width, int64_t* out) {
  Geometry g;
  if (elem_bytes == 4) {
    g = geometry<float>(batch, seq, width);
  } else if (elem_bytes == 2) {
    g = geometry<__nv_bfloat16>(batch, seq, width);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = kSub;
  out[1] = kChunk;
  out[2] = g.tile;
  out[3] = g.blocks;
  out[4] = g.words;
  return 0;
}

}  // extern "C"
