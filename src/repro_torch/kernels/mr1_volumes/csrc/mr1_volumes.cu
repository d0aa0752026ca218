// mr1_volumes: MR1's statistics on routed relations (paper Algorithm 3,
// stage 2), written by hand for Hopper (sm_90a), built with nvcc into a
// shared library with a plain C interface and bound with ctypes
// (repro_torch/kernels/mr1_volumes/kernel.py).
//
// Replaces no TPU kernel: the reference computes MR1 with jnp scatter-adds
// and gathers (src/repro/core/fct.py::_mr1_volumes, :87), and the port's
// plain version (ref.py) with aten's scatter_add_ and gather.  It exists
// because those passes took most of a warm query's device time: four
// scatter/gather passes a dimension over every routed slot, int64 index
// copies, and atomics for the pad slots (all on one address, the key of
// local row 0) and for the many fact slots whose contribution is 0.
//
// Computes, for every plane (n, dst) of a CN batch's routed relations
// (slot s of a plane, dimension i of m):
//   num_i[k]       = #{dimension slots s : mask_i[s], key_i[s] = k}
//   probe_i(s)     = num_i[clamp(fkey_i[s])]
//   vol_fact[s]    = fmask[s] * prod_i probe_i(s)
//   contrib_i[k]   = sum over fact slots s with fkey_i[s] = k of
//                    fmask[s] * prod_{j != i} probe_j(s)
//   vol_i[s]       = mask_i[s] * contrib_i[clamp(key_i[s])]
// Index semantics are the reference's: a gather wraps a negative key once
// and clamps ("clamp" above), a scatter-add wraps once and drops what stays
// outside [0, domain).  Products and sums are exact modulo 2^width of the
// accumulator (int32 or int64): products are taken in the unsigned type of
// that width (no signed-overflow UB), and integer atomics add exactly in any
// order.  A masked slot adds nothing and a fact slot whose product is 0 adds
// nothing, so skipping both changes no sum.
//
// Bound: device-memory bytes.  A query reads each routed slot's mask, the m
// int32 keys of each valid fact slot and each dimension slot's key, and
// writes one volume a slot; the num and contribution planes (64 KB-16 MB a
// plane) mostly stay in the 50 MB L2.
//
// Design: three launches on the caller's stream, no host sync, every size
// fixed by the shapes (CUDA-graph capturable).  The caller zeroes num and
// contrib and allocates the volumes.
//   1. mr1_num_kernel: grid (slot chunks, planes, dimensions); a slot whose
//      mask is set adds 1 to its num bin; masked slots issue nothing.
//   2. mr1_probe_kernel<T, M>: one pass over the fact's slots, a block on
//      one chunk of one plane, a warp on 32 consecutive slots.  It reads a
//      slot's M keys once, gathers its M probes, writes its volume and adds
//      each non-zero prod_{j != i} to contrib_i.  A dimension whose
//      contribution plane fits the block's shared memory (decided by the
//      wrapper from the domain and the accumulator width) adds into a shared
//      copy of that plane, flushed after the chunk with one global atomic a
//      non-zero bin; int64 shared bins are two 32-bit words with a carry
//      (64-bit shared atomics are compare-and-swap loops).  The others add
//      to device memory with warp-aggregated atomics: the lanes adding to
//      one key (__match_any_sync; a warp stays in one plane) sum their
//      values by shuffles and one of them adds, so Zipf's hot keys cost one
//      atomic a warp, not one a slot.
//   3. mr1_dimvol_kernel<T>: grid as (1); a dimension slot's volume is its
//      contribution bin times its mask.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;        // num and dimvol blocks
constexpr int kSlotsPerThread = 16;  // num and dimvol: slots a thread takes
constexpr int kProbeThreads = 512;   // probe blocks

template <typename T>
struct Unsigned;
template <>
struct Unsigned<int32_t> {
  using type = unsigned int;
};
template <>
struct Unsigned<int64_t> {
  using type = unsigned long long;
};

// one routed dimension of a batch, every array [planes, ...] contiguous
struct Dim {
  const int32_t* keys;  // [planes, rows] routed keys
  const uint8_t* mask;  // [planes, rows] (torch.bool)
  int32_t* num;         // [planes, domain], zeroed by the caller
  void* contrib;        // [planes, domain] accumulator type, zeroed
  void* vol;            // [planes, rows] accumulator type, written here
  int64_t rows;
  int64_t domain;
  int64_t shared;  // offset of its plane among a probe block's shared bins,
                   // -1: kept in device memory
};

struct Args {
  Dim dim[kMaxDims];
  const int32_t* fact_keys;  // [planes, fact_rows, m]
  const uint8_t* fact_mask;  // [planes, fact_rows]
  void* fact_vol;            // [planes, fact_rows] accumulator type
  int64_t fact_rows;
  int64_t rows_per_chunk;  // fact slots a probe block takes
  int64_t chunks;          // probe blocks a plane
  int64_t shared_bins;     // bins of a probe block's shared planes
  int m, planes;
};

// the descriptor kernel.py packs: 9 int64 header words, then 8 a dimension
constexpr int kHeader = 9, kPerDim = 8;

bool unpack(const int64_t* d, Args* a) {
  a->m = static_cast<int>(d[0]);
  a->planes = static_cast<int>(d[1]);
  a->fact_keys = reinterpret_cast<const int32_t*>(d[2]);
  a->fact_mask = reinterpret_cast<const uint8_t*>(d[3]);
  a->fact_vol = reinterpret_cast<void*>(d[4]);
  a->fact_rows = d[5];
  a->rows_per_chunk = d[6];
  a->chunks = d[7];
  a->shared_bins = d[8];
  if (a->m < 0 || a->m > kMaxDims || a->planes < 1 || a->planes > 65535)
    return false;
  for (int i = 0; i < kMaxDims; ++i) {
    Dim& x = a->dim[i];
    if (i >= a->m) {
      x = Dim{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, -1};
      continue;
    }
    const int64_t* e = d + kHeader + kPerDim * i;
    x.keys = reinterpret_cast<const int32_t*>(e[0]);
    x.mask = reinterpret_cast<const uint8_t*>(e[1]);
    x.num = reinterpret_cast<int32_t*>(e[2]);
    x.contrib = reinterpret_cast<void*>(e[3]);
    x.vol = reinterpret_cast<void*>(e[4]);
    x.rows = e[5];
    x.domain = e[6];
    x.shared = e[7];
    if (x.domain < 1 || x.domain >= (int64_t{1} << 31)) return false;
  }
  return true;
}

// scatter-add index: a negative key counts from the end once; a key still
// outside [0, domain) adds nothing (-1)
__device__ __forceinline__ int64_t drop_index(int32_t key, int64_t domain) {
  const int64_t k = key < 0 ? key + domain : key;
  return k >= 0 && k < domain ? k : -1;
}

// gather index: a negative key counts from the end once, then clamps
__device__ __forceinline__ int64_t clamp_index(int32_t key, int64_t domain) {
  const int64_t k = key < 0 ? key + domain : key;
  return k < 0 ? 0 : (k >= domain ? domain - 1 : k);
}

// a probe block's shared contribution bins, 32-bit words
template <typename T>
struct SharedBins {
  unsigned int* bin;
  __device__ SharedBins(void* smem, int64_t) : bin(static_cast<unsigned int*>(smem)) {}
  __device__ void zero(int64_t i) { bin[i] = 0u; }
  __device__ void add(int64_t i, unsigned int v) { atomicAdd(&bin[i], v); }
  __device__ unsigned int get(int64_t i) const { return bin[i]; }
};

// int64 bins as a low and a high word: the low word's add returns its old
// value, and the lane whose add wrapped it carries one into the high word
template <>
struct SharedBins<int64_t> {
  unsigned int* lo;
  unsigned int* hi;
  __device__ SharedBins(void* smem, int64_t bins)
      : lo(static_cast<unsigned int*>(smem)), hi(lo + bins) {}
  __device__ void zero(int64_t i) { lo[i] = hi[i] = 0u; }
  __device__ void add(int64_t i, unsigned long long v) {
    const unsigned int vl = static_cast<unsigned int>(v);
    const unsigned int old = atomicAdd(&lo[i], vl);
    const unsigned int up = static_cast<unsigned int>(v >> 32) + (old + vl < old);
    if (up != 0u) atomicAdd(&hi[i], up);
  }
  __device__ unsigned long long get(int64_t i) const {
    return (static_cast<unsigned long long>(hi[i]) << 32) | lo[i];
  }
};

// adds v at plane[k] for every lane with k >= 0; every lane of the warp
// calls it.  Lanes with the same k sum their values first, and the lowest
// of them adds the sum: exact modulo 2^width, like the adds it replaces
template <typename U>
__device__ __forceinline__ void warp_add(U* plane, int64_t k, U v) {
  const unsigned int active = __ballot_sync(0xffffffffu, k >= 0);
  if (k < 0) return;
  const int lane = threadIdx.x & 31;
  const unsigned int peers = __match_any_sync(active, static_cast<int>(k));
  U sum = v;
  if (peers != (1u << lane)) {
    sum = 0;
    for (unsigned int r = peers; r != 0u; r &= r - 1u)
      sum += __shfl_sync(peers, v, __ffs(r) - 1);
  }
  if (lane == __ffs(peers) - 1) atomicAdd(plane + k, sum);
}

// (1) num-arrays: blockIdx.z a dimension, blockIdx.y a plane, blockIdx.x a
// chunk of kThreads * kSlotsPerThread slots
__global__ void __launch_bounds__(kThreads)
mr1_num_kernel(const __grid_constant__ Args a) {
  const Dim& d = a.dim[blockIdx.z];
  const int64_t per = int64_t{kThreads} * kSlotsPerThread;
  const int64_t r0 = blockIdx.x * per;
  if (r0 >= d.rows) return;
  const int64_t r1 = min(d.rows, r0 + per);
  const int64_t plane = blockIdx.y;
  const int32_t* __restrict__ keys = d.keys + plane * d.rows;
  const uint8_t* __restrict__ mask = d.mask + plane * d.rows;
  int32_t* num = d.num + plane * d.domain;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kThreads) {
    if (mask[r] == 0) continue;
    const int64_t k = drop_index(keys[r], d.domain);
    if (k >= 0) atomicAdd(num + k, 1);
  }
}

// (2) probe, volume and contributions: blockIdx.y a plane, blockIdx.x a
// chunk of rows_per_chunk fact slots; M dimensions
template <typename T, int M>
__global__ void __launch_bounds__(kProbeThreads)
mr1_probe_kernel(const __grid_constant__ Args a) {
  using U = typename Unsigned<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SharedBins<T> bins(smem_raw, a.shared_bins);
  for (int64_t i = threadIdx.x; i < a.shared_bins; i += kProbeThreads)
    bins.zero(i);
  __syncthreads();

  const int64_t plane = blockIdx.y;
  const int64_t row0 = blockIdx.x * a.rows_per_chunk;
  const int64_t row1 = min(a.fact_rows, row0 + a.rows_per_chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* __restrict__ fmask = a.fact_mask + plane * a.fact_rows;
  const int32_t* __restrict__ fkeys = a.fact_keys + plane * a.fact_rows * M;
  T* __restrict__ fvol = static_cast<T*>(a.fact_vol) + plane * a.fact_rows;
  // a warp takes 32 consecutive slots a step; the loop is warp-uniform, so
  // every lane reaches warp_add's ballot
  for (int64_t g = row0 + 32 * warp; g < row1;
       g += 32 * (kProbeThreads / 32)) {
    const int64_t s = g + lane;
    const bool in = s < row1;
    const bool valid = in && fmask[s] != 0;
    int32_t key[M > 0 ? M : 1];
    U probe[M > 0 ? M : 1];
#pragma unroll
    for (int i = 0; i < M; ++i) key[i] = valid ? fkeys[s * M + i] : 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const Dim& d = a.dim[i];
      probe[i] = 0;
      if (valid)  // int32 count, sign-extended to T as the reference casts
        probe[i] = static_cast<U>(static_cast<T>(
            __ldg(d.num + plane * d.domain + clamp_index(key[i], d.domain))));
    }
    U vol = valid ? U(1) : U(0);
#pragma unroll
    for (int i = 0; i < M; ++i) vol *= probe[i];
    if (in) fvol[s] = static_cast<T>(vol);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const Dim& d = a.dim[i];
      U other = valid ? U(1) : U(0);
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (j != i) other *= probe[j];
      const int64_t k = other != U(0) ? drop_index(key[i], d.domain) : -1;
      if (d.shared >= 0) {
        if (k >= 0) bins.add(d.shared + k, other);
      } else {
        warp_add(static_cast<U*>(d.contrib) + plane * d.domain, k, other);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const Dim& d = a.dim[i];
    if (d.shared < 0) continue;
    U* dst = static_cast<U*>(d.contrib) + plane * d.domain;
    for (int64_t b = threadIdx.x; b < d.domain; b += kProbeThreads) {
      const U c = bins.get(d.shared + b);
      if (c != U(0)) atomicAdd(dst + b, c);
    }
  }
}

// (3) dimension volumes: grid as the num kernel's
template <typename T>
__global__ void __launch_bounds__(kThreads)
mr1_dimvol_kernel(const __grid_constant__ Args a) {
  const Dim& d = a.dim[blockIdx.z];
  const int64_t per = int64_t{kThreads} * kSlotsPerThread;
  const int64_t r0 = blockIdx.x * per;
  if (r0 >= d.rows) return;
  const int64_t r1 = min(d.rows, r0 + per);
  const int64_t plane = blockIdx.y;
  const int32_t* __restrict__ keys = d.keys + plane * d.rows;
  const uint8_t* __restrict__ mask = d.mask + plane * d.rows;
  const T* __restrict__ contrib =
      static_cast<const T*>(d.contrib) + plane * d.domain;
  T* __restrict__ vol = static_cast<T*>(d.vol) + plane * d.rows;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kThreads)
    vol[r] = mask[r] != 0 ? contrib[clamp_index(keys[r], d.domain)] : T(0);
}

// the grid of the num and dimvol kernels: chunks of the longest dimension
dim3 dims_grid(const Args& a) {
  int64_t rows = 1;
  for (int i = 0; i < a.m; ++i) rows = a.dim[i].rows > rows ? a.dim[i].rows : rows;
  const int64_t per = int64_t{kThreads} * kSlotsPerThread;
  return dim3(static_cast<unsigned>((rows + per - 1) / per),
              static_cast<unsigned>(a.planes), static_cast<unsigned>(a.m));
}

cudaError_t launch_num(const int64_t* desc, void* stream) {
  Args a;
  if (!unpack(desc, &a) || a.m < 1) return cudaErrorInvalidValue;
  mr1_num_kernel<<<dims_grid(a), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dimvol(const int64_t* desc, void* stream) {
  Args a;
  if (!unpack(desc, &a) || a.m < 1) return cudaErrorInvalidValue;
  mr1_dimvol_kernel<T><<<dims_grid(a), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <typename T, int M>
cudaError_t launch_probe_m(const Args& a, void* stream) {
  const size_t smem = static_cast<size_t>(a.shared_bins) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      mr1_probe_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.chunks),
                  static_cast<unsigned>(a.planes));
  mr1_probe_kernel<T, M><<<grid, kProbeThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_probe(const int64_t* desc, void* stream) {
  Args a;
  if (!unpack(desc, &a) || a.chunks < 1 || a.rows_per_chunk < 1)
    return cudaErrorInvalidValue;
  switch (a.m) {
    case 0: return launch_probe_m<T, 0>(a, stream);
    case 1: return launch_probe_m<T, 1>(a, stream);
    case 2: return launch_probe_m<T, 2>(a, stream);
    case 3: return launch_probe_m<T, 3>(a, stream);
    case 4: return launch_probe_m<T, 4>(a, stream);
    case 5: return launch_probe_m<T, 5>(a, stream);
    case 6: return launch_probe_m<T, 6>(a, stream);
    case 7: return launch_probe_m<T, 7>(a, stream);
    case 8: return launch_probe_m<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int mr1_num(const int64_t* desc, void* stream) {
  return static_cast<int>(launch_num(desc, stream));
}

int mr1_probe_int32(const int64_t* desc, void* stream) {
  return static_cast<int>(launch_probe<int32_t>(desc, stream));
}

int mr1_probe_int64(const int64_t* desc, void* stream) {
  return static_cast<int>(launch_probe<int64_t>(desc, stream));
}

int mr1_dimvol_int32(const int64_t* desc, void* stream) {
  return static_cast<int>(launch_dimvol<int32_t>(desc, stream));
}

int mr1_dimvol_int64(const int64_t* desc, void* stream) {
  return static_cast<int>(launch_dimvol<int64_t>(desc, stream));
}

}  // extern "C"
