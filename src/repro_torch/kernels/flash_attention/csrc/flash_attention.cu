// flash_attention: blocked online-softmax attention, written by hand for
// Hopper (sm_90a), built with nvcc into a shared library with a plain C
// interface and bound with ctypes
// (repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _kernel).
//
// Computes, for q [B, Sq, H, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, Dv]
// (float32 or bfloat16, read through their batch/sequence/head strides; the
// last dimension contiguous), the output o [B, Sq, H, Dv] with
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / (H/Hkv)] / sqrt(D))
//                * v[b, j, h / (H/Hkv)]
// over the keys j with j < Skv and, when causal, 0 <= i - j (and
// i - j < window when a window is given; a window implies causal).
// Scores, softmax statistics and the accumulator are float32; the output is
// rounded to the input type on store (round to nearest even for bfloat16).
//
// Design: one block of 256 threads per (64-row q tile, batch*head), a loop
// over the 32-row kv tiles that hold at least one key of the tile's causal or
// local band (tiles outside it are never visited).  The q tile (pre-scaled),
// the k and v tiles, the 64x32 score tile and the running (m, l, corr) of each
// row live in shared memory in float32; each thread keeps its share of the
// 64xDv output accumulator in registers.  Per kv tile: every thread computes
// 8 scores (one key against 8 rows, float4 reads, conflict-free with the
// D+4 row stride); 4 threads per row then take the online-softmax step;
// then every thread adds its rows x columns of P.V.  Masked pairs get
// probability exactly 0 (the reference's finite NEG_INF = -2e38 marks them),
// so a row whose first visited tile lies wholly outside its window adds
// nothing, where the reference adds a term that its next tile multiplies by
// exp(NEG_INF - m) = 0: the two agree.  The denominator is clamped at 1e-30.
//
// Bound: at the recurrentgemma-2b prefill shape (Sq = Skv = 8192, H 10, Hkv 1,
// D = Dv = 256, window 2048, bf16) the band's 150 GFLOP at the H100's dense
// bf16 tensor-core peak (989 TFLOP/s), against about 92 MB of q, k, v and o
// at 3.35 TB/s: operations.  This kernel does its arithmetic on the CUDA
// cores in float32 (67 TFLOP/s peak) and waits on shared memory, so it is
// far from that bound by design; tensor cores (mma.sync / wgmma), TMA loads
// and a pipelined kv loop are the known next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 32;        // keys of a kv tile (one per lane in S = QK^T)
constexpr int kThreads = 256;  // 8 warps
constexpr float kNegInf = -2.0e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int heads, kv_heads, sq, skv, causal, window;
  float scale;
};

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

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 4) +
                          static_cast<size_t>(kBK) * (D + 4) +
                          static_cast<size_t>(kBK) * DV +
                          static_cast<size_t>(kBQ) * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  static_assert(D % 4 == 0, "float4 reads of q and k rows");
  constexpr int kRow = D + 4;                  // q/k row stride (floats)
  constexpr int kProw = kBK + 1;               // score row stride
  constexpr int kTx = DV < 32 ? DV : 32;       // P.V: threads along Dv
  constexpr int kTy = kThreads / kTx;          //       threads along rows
  constexpr int kRpt = kBQ / kTy;              //       rows per thread
  constexpr int kCpt = DV / kTx;               //       columns per thread
  static_assert(kBQ % kTy == 0 && DV % kTx == 0, "P.V thread layout");

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // [kBQ][kRow], pre-scaled
  float* sK = sQ + kBQ * kRow;         // [kBK][kRow]
  float* sV = sK + kBK * kRow;         // [kBK][DV]
  float* sP = sV + kBK * DV;           // [kBQ][kProw] scores, then probs
  float* sM = sP + kBQ * kProw;        // running max per row
  float* sL = sM + kBQ;                // running denominator per row
  float* sC = sL + kBQ;                // this tile's correction per row

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * kRow + c] =
        q0 + r < p.sq
            ? to_float(qg[static_cast<int64_t>(q0 + r) * p.q_ss + c]) * p.scale
            : 0.0f;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.0f;
  }

  // kv tiles that hold a key of the band of this q tile
  const bool causal = p.causal != 0 || p.window > 0;
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  const int k_end = causal ? min(p.skv, q_last + 1) : p.skv;
  const int k_begin =
      (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / kBK * kBK;

  const int kx = tid % 32, ry = tid / 32;  // scores: key kx, rows ry + 8i
  const int sr = tid / 4, sp = tid % 4;    // softmax: row sr, keys 8sp..8sp+7
  const int ox = tid % kTx, oy = tid / kTx;  // P.V: rows oy + kTy*i
  float acc[kRpt][kCpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
#pragma unroll
    for (int j = 0; j < kCpt; ++j) acc[i][j] = 0.0f;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the last tile's readers are done; q and stats ready
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      sK[r * kRow + c] =
          kt + r < p.skv
              ? to_float(kg[static_cast<int64_t>(kt + r) * p.k_ss + c])
              : 0.0f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      sV[r * DV + c] =
          kt + r < p.skv
              ? to_float(vg[static_cast<int64_t>(kt + r) * p.v_ss + c])
              : 0.0f;
    }
    __syncthreads();

    // S = (scale q) k^T for key kx against rows ry + 8i
    float s[kBQ / 8];
#pragma unroll
    for (int i = 0; i < kBQ / 8; ++i) s[i] = 0.0f;
    const float4* krow = reinterpret_cast<const float4*>(sK + kx * kRow);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kv = krow[d4];
#pragma unroll
      for (int i = 0; i < kBQ / 8; ++i) {
        const float4 qv =
            reinterpret_cast<const float4*>(sQ + (ry + 8 * i) * kRow)[d4];
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    const int kpos = kt + kx;
#pragma unroll
    for (int i = 0; i < kBQ / 8; ++i) {
      const int delta = q0 + ry + 8 * i - kpos;
      bool valid = kpos < p.skv;
      if (causal) valid = valid && delta >= 0;
      if (p.window > 0) valid = valid && delta < p.window;
      sP[(ry + 8 * i) * kProw + kx] = valid ? s[i] : kNegInf;
    }
    __syncthreads();

    // online softmax step of row sr: 4 lanes, 8 keys each
    {
      float* row = sP + sr * kProw + sp * 8;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, row[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[sr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = row[j];
        const float e = x == kNegInf ? 0.0f : expf(x - m_new);
        row[j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sp == 0) {
        const float corr = expf(m_old - m_new);
        sC[sr] = corr;
        sL[sr] = sL[sr] * corr + sum;
        sM[sr] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const float corr = sC[oy + kTy * i];
#pragma unroll
      for (int j = 0; j < kCpt; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kCpt];
#pragma unroll
      for (int j = 0; j < kCpt; ++j) vv[j] = sV[kk * DV + ox + kTx * j];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const float pr = sP[(oy + kTy * i) * kProw + kk];
#pragma unroll
        for (int j = 0; j < kCpt; ++j) acc[i][j] = fmaf(pr, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = oy + kTy * i;
    if (q0 + r >= p.sq) continue;
    const float inv = 1.0f / fmaxf(sL[r], 1e-30f);
    T* orow = og + static_cast<int64_t>(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < kCpt; ++j)
      orow[ox + kTx * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, DV>();
  auto kernel = flash_attention_kernel<T, D, DV>;
  if (bytes > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.heads);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, int d, int dv,
                     cudaStream_t s) {
#define FLASH_CASE(D_, DV_) \
  if (d == D_ && dv == DV_) return launch<T, D_, DV_>(p, batch, s);
  FLASH_CASE(16, 16)
  FLASH_CASE(32, 32)
  FLASH_CASE(32, 16)
  FLASH_CASE(64, 64)
  FLASH_CASE(64, 32)
  FLASH_CASE(128, 128)
  FLASH_CASE(128, 64)
  FLASH_CASE(256, 256)
  FLASH_CASE(256, 128)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
int entry(const void* q, const void* k, const void* v, void* o,
          int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
          int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
          int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int batch,
          int heads, int kv_heads, int sq, int skv, int d, int dv,
          int causal, int window, float scale, void* stream) {
  const Params p{q,    k,    v,    o,    q_sb,  q_ss,     q_sh,
                 k_sb, k_ss, k_sh, v_sb, v_ss,  v_sh,     o_sb,
                 o_ss, o_sh, heads, kv_heads, sq, skv, causal,
                 window, scale};
  return static_cast<int>(
      dispatch<T>(p, batch, d, dv, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

#define FLASH_ENTRY(NAME, T)                                                  \
  int NAME(const void* q, const void* k, const void* v, void* o,             \
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,           \
           int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,           \
           int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,           \
           int batch, int heads, int kv_heads, int sq, int skv, int d,       \
           int dv, int causal, int window, float scale, void* stream) {      \
    return entry<T>(q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,    \
                    v_ss, v_sh, o_sb, o_ss, o_sh, batch, heads, kv_heads,    \
                    sq, skv, d, dv, causal, window, scale, stream);          \
  }

FLASH_ENTRY(flash_attention_float32, float)
FLASH_ENTRY(flash_attention_bfloat16, __nv_bfloat16)
#undef FLASH_ENTRY

}  // extern "C"
