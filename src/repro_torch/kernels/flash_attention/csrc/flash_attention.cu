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
// Masked pairs get probability exactly 0 (the reference's finite NEG_INF =
// -2e38 marks them), so a row whose first visited tile lies wholly outside
// its window adds nothing, where the reference adds a term that its next
// tile multiplies by exp(NEG_INF - m) = 0: the two agree.  The denominator
// is clamped at 1e-30.  Both kernels visit only the kv tiles that hold a key
// of the q tile's causal or local band (k_begin .. k_end).
//
// Bound: at the recurrentgemma-2b prefill shape (Sq = Skv = 8192, H 10,
// Hkv 1, D = Dv = 256, window 2048, bf16) the band's 150 GFLOP at the H100's
// dense bf16 tensor-core peak (989 TFLOP/s), against about 92 MB of q, k, v
// and o at 3.35 TB/s: operations.
//
// bfloat16: flash_attention_mma_kernel, on the tensor cores.
//   - One block per (q tile, batch*head); each warp owns 16 q rows: 4 warps
//     (64 rows) at D <= 128, 8 warps (128 rows) at D = 256, where k and v
//     tiles take most of shared memory and 8 warps share them.
//   - S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with float32
//     accumulators, their fragments read from shared memory by ldmatrix
//     (.trans for V).  Q stays in registers as A fragments for the whole kv
//     loop where that fits beside O and S (Q D/4 + O Dv/2 + S 32 registers
//     <= 168 a thread); at D = Dv = 256 that would be 224 of 255 registers,
//     so Q is read again from shared memory at each k step instead.
//   - The scale 1/sqrt(D) multiplies S in float32 (exact for D 16, 64, 256).
//     The online-softmax step runs on the S fragments in registers: row max
//     and nothing else crosses the quad of lanes that holds a row (two
//     shuffles); the row sum l is kept per lane and summed at the end.
//   - P V as a split product: P_hi = bf16(P), P_lo = bf16(P - P_hi), and
//     O += P_hi V + P_lo V into one float32 accumulator.  P in one bf16 is
//     off by up to 2^-9 of each probability, which at the prefill's own
//     inputs breaks the check that holds the kernel to one bf16 rounding of
//     the output (tests/test_torch_flash_attention.py emulates both); the
//     split keeps P to about 2^-17 for 1.5x the tensor work of the plain
//     loop.
//   - k and v tiles of 64 keys in bf16 go through a two-stage ring in shared
//     memory, filled by cp.async (16 bytes a thread, zero-filled past Skv)
//     while the previous tile is computed.  Rows are padded by 8 elements
//     (16 bytes), so the 8 rows one ldmatrix phase reads fall in 8 distinct
//     16-byte bank groups: no bank conflicts.  Inputs that are not 16-byte
//     aligned (pointer or strides) are copied by plain loads in the same
//     kernel, with no overlap.
//   - A warp skips the products of a kv tile that holds no key of its own
//     16 rows' band (it still takes part in the loads and barriers), and
//     the mask of a tile whose keys all lie in the band of its 16 rows.
//   - Shared memory: (BQ (D+8) + 2 * 64 ((D+8) + (Dv+8))) * 2 bytes.  At
//     D = Dv = 256 that is 202 752 bytes with BQ 128, so one block of 8 warps
//     runs per SM; two blocks would need 2 x 135 168 bytes for the k/v rings
//     alone, more than the SM's 228 KB.  At D = Dv = 128: 87 040 bytes, two
//     blocks per SM.
//   - Bounded by the tensor cores' mma.sync rate and by shared memory: each
//     S step reads 512 bytes of K for 2 products.  wgmma, TMA and warp
//     specialisation are the known next steps.
//
// float32: flash_attention_kernel, on the CUDA cores (TF32 products would
//   break the float32 tolerance).  One block of 256 threads per (64-row q
//   tile, batch*head), a loop over 32-row kv tiles.  The q tile (pre-scaled),
//   the k and v tiles, the 64x32 score tile and the running (m, l, corr) of
//   each row live in shared memory in float32; each thread keeps its share of
//   the 64xDv output accumulator in registers.  Per kv tile: every thread
//   computes 8 scores (one key against 8 rows, float4 reads, conflict-free
//   with the D+4 row stride); 4 threads per row then take the online-softmax
//   step; then every thread adds its rows x columns of P.V.
//
// Log-sum-exp out (for the backward, below): given a
// non-null lse pointer, both kernels write lse[b, h, i] = m + log(l), the
// log of row i's softmax denominator over its scaled scores, in float32, once
// per row after the kv loop; a row with no key in its band (l = 0) gets
// +inf, so every probability the backward recomputes from it is 0.  With a
// null pointer nothing else changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] log-sum-exp of each row's scaled scores, or null
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int heads, kv_heads, sq, skv, causal, window;
  float scale;
  int aligned;  // q, k, v pointers and strides allow 16-byte copies
};

// --- float32: the CUDA-core kernel -------------------------------------------

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 32;        // keys of a kv tile (one per lane in S = QK^T)
constexpr int kThreads = 256;  // 8 warps

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 4) +
                          static_cast<size_t>(kBK) * (D + 4) +
                          static_cast<size_t>(kBK) * DV +
                          static_cast<size_t>(kBQ) * (kBK + 1) + 3 * kBQ);
}

template <int D, int DV>
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
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * kRow + c] =
        q0 + r < p.sq ? qg[static_cast<int64_t>(q0 + r) * p.q_ss + c] * p.scale
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
          kt + r < p.skv ? kg[static_cast<int64_t>(kt + r) * p.k_ss + c]
                         : 0.0f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      sV[r * DV + c] =
          kt + r < p.skv ? vg[static_cast<int64_t>(kt + r) * p.v_ss + c]
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

  if (p.lse != nullptr && tid < kBQ && q0 + tid < p.sq) {
    const float l = sL[tid];
    p.lse[(static_cast<int64_t>(blockIdx.y) * p.sq) + q0 + tid] =
        l > 0.0f ? sM[tid] + logf(l) : __int_as_float(0x7f800000);  // +inf
  }
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = oy + kTy * i;
    if (q0 + r >= p.sq) continue;
    const float inv = 1.0f / fmaxf(sL[r], 1e-30f);
    float* orow = og + static_cast<int64_t>(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < kCpt; ++j) orow[ox + kTx * j] = acc[i][j] * inv;
  }
}

// --- bfloat16: the tensor-core kernel ----------------------------------------

constexpr int kMmaBK = 64;                    // keys of a kv tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int DV>
struct MmaShape {
  static constexpr int kWarps = D == 256 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;     // q rows of a block
  static constexpr int kQS = D + 8;           // padded row strides (elements)
  static constexpr int kVS = DV + 8;
  static constexpr bool kQInRegs = D / 4 + DV / 2 + kMmaBK / 2 <= 168;
  static constexpr int kStage = kMmaBK * (kQS + kVS);  // one k and one v tile
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (static_cast<size_t>(kBQ) * kQS + 2 * kStage);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows [pos0, pos0 + ROWS) x COLS of one head of a [.., S, .., COLS] tensor
// into a shared tile of row stride LD, rows at or past `limit` zero-filled
template <int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int pos0, int limit,
                                          bool aligned) {
  constexpr int kChunks = COLS / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = pos0 + r < limit;
    const __nv_bfloat16* g = src + static_cast<int64_t>(pos0 + r) * stride + c;
    if (aligned) {
      cp_async16(smem_addr(dst + r * LD + c), in ? g : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[r * LD + c + e] = in ? g[e] : __float2bfloat16(0.0f);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(MmaShape<D, DV>::kThreads)
flash_attention_mma_kernel(const Params p) {
  using S = MmaShape<D, DV>;
  static_assert(D % 16 == 0 && DV % 16 == 0, "mma tiles of 16");
  constexpr int kQS = S::kQS, kVS = S::kVS, kBQ = S::kBQ;
  constexpr int kNS = kMmaBK / 8;  // n8 tiles of S across the kv tile
  constexpr int kNO = DV / 8;      // n8 tiles of O across Dv

  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  __nv_bfloat16* sQ = smem_bf16;                // [kBQ][kQS]
  __nv_bfloat16* sKV = sQ + kBQ * kQS;          // 2 x ([64][kQS] k, [64][kVS] v)

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;         // mma fragment row / column
  const int q0 = blockIdx.x * kBQ;
  const int r0 = q0 + warp * 16;                // this warp's first row
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  const auto* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                   h * p.q_sh;
  const auto* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                   hk * p.k_sh;
  const auto* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                   hk * p.v_sh;
  auto* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bool aligned = p.aligned != 0;

  // kv tiles that hold a key of the band of this q tile
  const bool causal = p.causal != 0 || p.window > 0;
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  const int k_end = causal ? min(p.skv, q_last + 1) : p.skv;
  const int k_begin =
      (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / kMmaBK * kMmaBK;

  auto load_kv = [&](int stage, int kt) {
    __nv_bfloat16* sk = sKV + stage * S::kStage;
    load_tile<kMmaBK, D, kQS, S::kThreads>(sk, kg, p.k_ss, kt, p.skv,
                                           aligned);
    load_tile<kMmaBK, DV, kVS, S::kThreads>(sk + kMmaBK * kQS, vg, p.v_ss, kt,
                                            p.skv, aligned);
  };
  load_tile<kBQ, D, kQS, S::kThreads>(sQ, qg, p.q_ss, q0, p.sq, aligned);
  if (k_begin < k_end) load_kv(0, k_begin);
  cp_async_commit();

  // ldmatrix lane addresses: A (Q) and V^T take rows lane % 16 and columns
  // 8 (lane / 16); K takes rows lane % 8 + 8 (lane / 16), columns
  // 8 ((lane / 8) % 2)
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int k_row = lane % 8 + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;
  const uint32_t q_addr = smem_addr(sQ + (warp * 16 + a_row) * kQS + a_col);

  uint32_t qf[S::kQInRegs ? D / 16 : 1][4];
  float o[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8
  float l[2] = {0.0f, 0.0f};        // this lane's share of their row sums

  for (int it = 0, kt = k_begin; kt < k_end; ++it, kt += kMmaBK) {
    const int stage = it % 2;
    if (kt + kMmaBK < k_end) {   // next tile into the other stage
      load_kv(stage ^ 1, kt + kMmaBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (S::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], q_addr + kk * 32);
      }
    }
    // does this kv tile hold a key of this warp's 16 rows' band?
    const bool skip = kt >= p.skv || (causal && kt > r0 + 15) ||
                      (p.window > 0 && r0 - (kt + kMmaBK - 1) >= p.window);
    if (!skip) {
      const __nv_bfloat16* sk = sKV + stage * S::kStage;
      const uint32_t k_addr = smem_addr(sk + k_row * kQS + k_col);
      const uint32_t v_addr = smem_addr(sk + kMmaBK * kQS + a_row * kVS +
                                        a_col);

      // S = Q K^T
      float s[kNS][4];
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        if constexpr (S::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, q_addr + kk * 32);
        }
#pragma unroll
        for (int np = 0; np < kNS / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_addr + (np * 16 * kQS + kk * 16) * 2);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // scale, mask, online softmax on the fragments: element e of tile n
      // is row r0 + g + 8 (e / 2), key kt + 8 n + 2 t + e % 2.  A tile
      // whose keys are all in the band of all 16 rows needs no mask.
      const bool inside =
          kt + kMmaBK <= p.skv && (!causal || kt + kMmaBK - 1 <= r0) &&
          (p.window <= 0 || r0 + 15 - kt < p.window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool valid = inside;
          if (!inside) {
            const int kpos = kt + 8 * n + 2 * t + (e % 2);
            const int delta = r0 + g + 8 * (e / 2) - kpos;
            valid = kpos < p.skv;
            if (causal) valid = valid && delta >= 0;
            if (p.window > 0) valid = valid && delta < p.window;
          }
          const float x = valid ? s[n][e] * p.scale : kNegInf;
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float corr[2], m_log2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        m_log2[r] = m_new * kLog2e;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          const float pr = x == kNegInf
                               ? 0.0f
                               : exp2f(fmaf(x, kLog2e, -m_log2[e / 2]));
          s[n][e] = pr;
          l[e / 2] += pr;
        }
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }

      // O += P_hi V + P_lo V, 16 keys a step; the S fragments of tiles
      // 2 kk and 2 kk + 1 are the A fragment of P
#pragma unroll
      for (int kk = 0; kk < kMmaBK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < kNO / 2; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_addr + (kk * 16 * kVS + np * 16) * 2);
          mma_bf16(o[2 * np], ph, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], ph, bv[2], bv[3]);
          mma_bf16(o[2 * np], pl, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pl, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  // row sums across the quad, then o / l rounded to bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row >= p.sq) continue;
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<int64_t>(blockIdx.y) * p.sq) + row] =
          l[r] > 0.0f ? m[r] + logf(l[r]) : __int_as_float(0x7f800000);  // +inf
    }
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + static_cast<int64_t>(row) * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// --- launch ------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, size_t bytes,
                          const Params& p, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  if constexpr (sizeof(T) == sizeof(float)) {
    const dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.heads);
    return launch_kernel(flash_attention_kernel<D, DV>, grid, kThreads,
                         smem_bytes<D, DV>(), p, stream);
  } else {
    using S = MmaShape<D, DV>;
    const dim3 grid((p.sq + S::kBQ - 1) / S::kBQ, batch * p.heads);
    return launch_kernel(flash_attention_mma_kernel<D, DV>, grid, S::kThreads,
                         S::kSmem, p, stream);
  }
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
int entry(const void* q, const void* k, const void* v, void* o, void* lse,
          int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
          int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
          int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int batch,
          int heads, int kv_heads, int sq, int skv, int d, int dv,
          int causal, int window, float scale, void* stream) {
  // 16-byte copies need 16-byte aligned rows: pointers and strides
  constexpr int64_t kPer16 = 16 / sizeof(T);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
      (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh) %
              kPer16 == 0;
  const Params p{q,    k,    v,    o,    static_cast<float*>(lse),
                 q_sb, q_ss, q_sh, k_sb,  k_ss,     k_sh,   v_sb,
                 v_ss, v_sh, o_sb, o_ss,  o_sh,     heads,  kv_heads,
                 sq,   skv,  causal, window, scale, static_cast<int>(aligned)};
  return static_cast<int>(
      dispatch<T>(p, batch, d, dv, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

#define FLASH_ENTRY(NAME, T)                                                  \
  int NAME(const void* q, const void* k, const void* v, void* o, void* lse,  \
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,           \
           int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,           \
           int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,           \
           int batch, int heads, int kv_heads, int sq, int skv, int d,       \
           int dv, int causal, int window, float scale, void* stream) {      \
    return entry<T>(q, k, v, o, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,    \
                    v_ss, v_sh, o_sb, o_ss, o_sh, batch, heads, kv_heads,    \
                    sq, skv, d, dv, causal, window, scale, stream);          \
  }

FLASH_ENTRY(flash_attention_float32, float)
FLASH_ENTRY(flash_attention_bfloat16, __nv_bfloat16)
#undef FLASH_ENTRY

}  // extern "C"

// === backward: flash_attention_bwd ==========================================
//
// The gradient of blocked attention, in the same library as the forward
// (repro_torch/kernels/flash_attention/kernel.py, flash_attention_bwd;
// counted as its own kernel, LAUNCHES["flash_attention_bwd"]).
//
// No TPU kernel to replace: the JAX package's flash_attention
// (src/repro/kernels/flash_attention/kernel.py, flash_attention_pallas) has
// no custom_vjp, and its training differentiates the jnp blocked version
// (flash_attention/ref.py).  This is the backward of the forward
// above, from what that forward keeps: its output o and the
// float32 log-sum-exp lse [B, H, Sq] of each row's scaled scores.
//
// For q [B, Sq, H, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, Dv] (float32 or
// bfloat16, read through their batch/sequence/head strides, the last
// dimension contiguous), o and dO [B, Sq, H, Dv], with s = scale q.k^T,
// P = exp(s - lse) inside the mask (0 outside), it computes
//   delta_i = sum_c dO_ic o_ic
//   dV_j   = sum over the heads of j's group and rows i of P_ij dO_i
//   dS_ij  = P_ij (dO_i . v_j - delta_i)
//   dK_j   = scale sum_i dS_ij q_i,       dQ_i = scale sum_j dS_ij k_j
// into new contiguous dq, dk, dv of the input type, from float32 arithmetic
// (the float32 instantiation never touches the tensor cores, so no TF32).
// The mask is the forward's: keys j < Skv and, when causal, 0 <= i - j (and
// i - j < window when a window is given; a window implies causal), positions
// aligned at 0, Sq and Skv ragged.
//
// Three launches, no atomics, so two calls give the same bits:
//   1. flash_bwd_delta_kernel: one warp per row, delta [B, H, Sq] float32.
//   2. flash_bwd_dkdv_kernel: one block per (32-key tile, b * Hkv).  It keeps
//      the tile's k and v in shared memory and its dK and dV accumulators in
//      registers (at D = Dv = 256 a 32-key tile's two accumulators are 64 KB:
//      64 floats a thread over 256 threads), and loops over the H / Hkv
//      query heads of the group and over the 32-row q tiles that hold a row
//      of the keys' band, recomputing P from lse; every element of dK and dV
//      is written once, by the thread that summed it.
//   3. flash_bwd_dq_kernel: one block per (32-row q tile, b * H), looping over
//      the key tiles of the band (the forward's k_begin .. k_end).
// A tile pair outside the band is never visited; inside it the mask decides
// each pair, so a skipped tile can hold no pair the forward read.
//
// Bound: operations.  At the recurrentgemma-2b training shape (S 4 096, H 10,
// Hkv 1, D = Dv = 256, window 2 048) the band's backward is 2.5x the forward's
// operations (S and dP recomputed, dV, dK, dQ: five products of the forward's
// two, halved where the forward shares), about 161 GFLOP: 0.163 ms at the
// dense bf16 tensor-core peak (989 TFLOP/s).  This first version runs on the
// CUDA cores in float32 for both input types, so it is bounded far above
// that, by the float32 rate (67 TFLOP/s) and by shared-memory reads: each
// score takes one float4 of k a thread against four broadcast float4 of q.
// The tensor-core (mma.sync / wgmma) backward is a later step.
//
// Shared memory a block: 32-row tiles of q, k (D + 4 floats a row), dO, v
// (Dv + 4), the 32 x 33 tiles of P and dS and 32 rows' lse and delta:
// 141 824 bytes at D = Dv = 256 (one block an SM), 76 288 at 128.
namespace {
namespace bwd {  // apart from the forward's names

constexpr int kThreads = 256;  // 8 warps
constexpr int kB = 32;         // rows of a q tile = keys of a kv tile
constexpr int kPS = kB + 1;    // row stride of the P and dS tiles

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Sq], from the forward
  float* delta;      // [B, H, Sq], written by the first launch
  void* dq;          // contiguous [B, Sq, H, D]
  void* dk;          // contiguous [B, Skv, Hkv, D]
  void* dv;          // contiguous [B, Skv, Hkv, Dv]
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int batch, heads, kv_heads, sq, skv, causal, window;
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// 1. delta_i = sum_c dO_ic o_ic, one warp per row (b, h, i), rows in the
// order of lse; lanes stride over Dv, then a fixed butterfly
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const BwdParams p, int dv) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  if (row >= static_cast<int64_t>(p.batch) * p.heads * p.sq) return;
  const int i = static_cast<int>(row % p.sq);
  const int64_t bh = row / p.sq;
  const int h = static_cast<int>(bh % p.heads);
  const int64_t b = bh / p.heads;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + i * p.o_ss +
               h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + i * p.do_ss +
               h * p.do_sh;
  float s = 0.0f;
  for (int c = lane; c < dv; c += 32) s = fmaf(to_f<T>(o[c]), to_f<T>(d[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) p.delta[row] = s;
}

// rows [pos0, pos0 + kB) x COLS of one head of a strided [.., S, .., COLS]
// tensor into float32 shared memory of row stride LD; rows at or past
// `limit` are zeros
template <typename T, int COLS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t stride, int pos0,
                                          int limit) {
  for (int i = threadIdx.x; i < kB * COLS; i += kThreads) {
    const int r = i / COLS, c = i % COLS;
    dst[r * LD + c] =
        pos0 + r < limit
            ? to_f<T>(src[static_cast<int64_t>(pos0 + r) * stride + c])
            : 0.0f;
  }
}

// is (query i, key j) inside the forward's mask?
__device__ __forceinline__ bool in_band(const BwdParams& p, int i, int j) {
  if (i >= p.sq || j >= p.skv) return false;
  const int delta = i - j;
  if ((p.causal != 0 || p.window > 0) && delta < 0) return false;
  return p.window <= 0 || delta < p.window;
}

// P and dS of the q tile at q0 against the kv tile at k0, from shared q, k,
// dO, v (row strides D + 4, Dv + 4), lse and delta, into sP and sS
// [kB][kPS].  Thread (key kx, rows ry + 8 i): one float4 of k (of v) against
// four broadcast float4 of q (of dO), as the float32 forward reads them.
template <int D, int DV>
__device__ __forceinline__ void probs_and_dscores(
    const BwdParams& p, const float* sQ, const float* sK, const float* sdO,
    const float* sV, const float* sLse, const float* sDelta, int q0, int k0,
    float* sP, float* sS) {
  constexpr int kQS = D + 4, kVS = DV + 4, kR = kB / 8;
  const int kx = threadIdx.x % 32, ry = threadIdx.x / 32;
  float s[kR], dp[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) s[i] = dp[i] = 0.0f;
  const float4* krow = reinterpret_cast<const float4*>(sK + kx * kQS);
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 kv = krow[d4];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float4 qv =
          reinterpret_cast<const float4*>(sQ + (ry + 8 * i) * kQS)[d4];
      s[i] = fmaf(qv.x, kv.x, s[i]);
      s[i] = fmaf(qv.y, kv.y, s[i]);
      s[i] = fmaf(qv.z, kv.z, s[i]);
      s[i] = fmaf(qv.w, kv.w, s[i]);
    }
  }
  const float4* vrow = reinterpret_cast<const float4*>(sV + kx * kVS);
#pragma unroll 4
  for (int d4 = 0; d4 < DV / 4; ++d4) {
    const float4 vv = vrow[d4];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float4 gv =
          reinterpret_cast<const float4*>(sdO + (ry + 8 * i) * kVS)[d4];
      dp[i] = fmaf(gv.x, vv.x, dp[i]);
      dp[i] = fmaf(gv.y, vv.y, dp[i]);
      dp[i] = fmaf(gv.z, vv.z, dp[i]);
      dp[i] = fmaf(gv.w, vv.w, dp[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ry + 8 * i;
    const float pr =
        in_band(p, q0 + r, k0 + kx) ? expf(s[i] * p.scale - sLse[r]) : 0.0f;
    sP[r * kPS + kx] = pr;
    sS[r * kPS + kx] = pr * (dp[i] - sDelta[r]);
  }
}

template <int D, int DV>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kB) * (D + 4) +
                          2 * static_cast<size_t>(kB) * (DV + 4) +
                          2 * static_cast<size_t>(kB) * kPS + 2 * kB);
}

// lse and delta of rows [q0, q0 + kB) of one (b, h); +inf and 0 past Sq
__device__ __forceinline__ void load_row_stats(const BwdParams& p,
                                               int64_t bh, int q0,
                                               float* sLse, float* sDelta) {
  if (threadIdx.x < kB) {
    const int r = q0 + threadIdx.x;
    const bool in = r < p.sq;
    sLse[threadIdx.x] =
        in ? p.lse[bh * p.sq + r] : __int_as_float(0x7f800000);  // +inf
    sDelta[threadIdx.x] = in ? p.delta[bh * p.sq + r] : 0.0f;
  }
}

// a (rows x cols) tile of accumulators split over the block: thread
// (x, y) = (tid % TX, tid / TX) owns rows y * R .. y * R + R - 1 and
// columns x + TX j
template <int COLS>
struct Split {
  static constexpr int TX = COLS < 32 ? COLS : 32;
  static constexpr int TY = kThreads / TX;
  static constexpr int R = kB / TY;
  static constexpr int C = COLS / TX;
  static_assert(COLS % TX == 0 && kB % TY == 0, "accumulator layout");
};

// 2. dK, dV of one 32-key tile of one (b, kv head)
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int kQS = D + 4, kVS = DV + 4;
  using SK = Split<D>;
  using SV = Split<DV>;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;               // [kB][kQS]
  float* sV = sK + kB * kQS;      // [kB][kVS]
  float* sQ = sV + kB * kVS;      // [kB][kQS]
  float* sdO = sQ + kB * kQS;     // [kB][kVS]
  float* sP = sdO + kB * kVS;     // [kB][kPS]
  float* sS = sP + kB * kPS;      // [kB][kPS]
  float* sLse = sS + kB * kPS;    // [kB]
  float* sDelta = sLse + kB;      // [kB]

  const int k0 = blockIdx.x * kB;
  const int64_t b = blockIdx.y / p.kv_heads;
  const int hk = blockIdx.y % p.kv_heads;
  const int group = p.heads / p.kv_heads;
  load_rows<T, D, kQS>(sK, static_cast<const T*>(p.k) + b * p.k_sb +
                               hk * p.k_sh, p.k_ss, k0, p.skv);
  load_rows<T, DV, kVS>(sV, static_cast<const T*>(p.v) + b * p.v_sb +
                                hk * p.v_sh, p.v_ss, k0, p.skv);

  const int kx = threadIdx.x % SK::TX, ky = threadIdx.x / SK::TX;
  const int vx = threadIdx.x % SV::TX, vy = threadIdx.x / SV::TX;
  float dk[SK::R][SK::C], dv[SV::R][SV::C];
#pragma unroll
  for (int r = 0; r < SK::R; ++r)
#pragma unroll
    for (int c = 0; c < SK::C; ++c) dk[r][c] = 0.0f;
#pragma unroll
  for (int r = 0; r < SV::R; ++r)
#pragma unroll
    for (int c = 0; c < SV::C; ++c) dv[r][c] = 0.0f;

  // the q rows whose band holds a key of this tile: from k0 when causal, to
  // the last key's window end
  const bool causal = p.causal != 0 || p.window > 0;
  const int q_begin = causal ? k0 : 0;
  const int q_end =
      p.window > 0 ? min(p.sq, k0 + kB - 1 + p.window) : p.sq;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const int64_t bh = b * p.heads + h;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = q_begin; q0 < q_end; q0 += kB) {
      __syncthreads();  // the last tile's readers are done; k, v are ready
      load_rows<T, D, kQS>(sQ, qg, p.q_ss, q0, p.sq);
      load_rows<T, DV, kVS>(sdO, dog, p.do_ss, q0, p.sq);
      load_row_stats(p, bh, q0, sLse, sDelta);
      __syncthreads();
      probs_and_dscores<D, DV>(p, sQ, sK, sdO, sV, sLse, sDelta, q0, k0, sP,
                               sS);
      __syncthreads();
      // dV += P^T dO, dK += dS^T q, row by row of the q tile
#pragma unroll 2
      for (int r = 0; r < kB; ++r) {
        float g[SV::C];
#pragma unroll
        for (int c = 0; c < SV::C; ++c) g[c] = sdO[r * kVS + vx + SV::TX * c];
#pragma unroll
        for (int j = 0; j < SV::R; ++j) {
          const float pr = sP[r * kPS + vy * SV::R + j];
#pragma unroll
          for (int c = 0; c < SV::C; ++c) dv[j][c] = fmaf(pr, g[c], dv[j][c]);
        }
        float qv[SK::C];
#pragma unroll
        for (int c = 0; c < SK::C; ++c) qv[c] = sQ[r * kQS + kx + SK::TX * c];
#pragma unroll
        for (int j = 0; j < SK::R; ++j) {
          const float ds = sS[r * kPS + ky * SK::R + j];
#pragma unroll
          for (int c = 0; c < SK::C; ++c) dk[j][c] = fmaf(ds, qv[c], dk[j][c]);
        }
      }
    }
  }

  // contiguous [B, Skv, Hkv, D] and [B, Skv, Hkv, Dv]
  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int j = 0; j < SK::R; ++j) {
    const int key = k0 + ky * SK::R + j;
    if (key >= p.skv) continue;
    const int64_t row = (b * p.skv + key) * p.kv_heads + hk;
#pragma unroll
    for (int c = 0; c < SK::C; ++c) {
      dkg[row * D + kx + SK::TX * c] = from_f<T>(dk[j][c] * p.scale);
    }
  }
#pragma unroll
  for (int j = 0; j < SV::R; ++j) {
    const int key = k0 + vy * SV::R + j;
    if (key >= p.skv) continue;
    const int64_t row = (b * p.skv + key) * p.kv_heads + hk;
#pragma unroll
    for (int c = 0; c < SV::C; ++c) {
      dvg[row * DV + vx + SV::TX * c] = from_f<T>(dv[j][c]);
    }
  }
}

// 3. dQ of one 32-row q tile of one (b, head)
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int kQS = D + 4, kVS = DV + 4;
  using SQ = Split<D>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // [kB][kQS]
  float* sdO = sQ + kB * kQS;     // [kB][kVS]
  float* sK = sdO + kB * kVS;     // [kB][kQS]
  float* sV = sK + kB * kQS;      // [kB][kVS]
  float* sP = sV + kB * kVS;      // [kB][kPS]
  float* sS = sP + kB * kPS;      // [kB][kPS]
  float* sLse = sS + kB * kPS;    // [kB]
  float* sDelta = sLse + kB;      // [kB]

  const int q0 = blockIdx.x * kB;
  const int64_t b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  const int64_t bh = b * p.heads + h;
  load_rows<T, D, kQS>(sQ, static_cast<const T*>(p.q) + b * p.q_sb +
                               h * p.q_sh, p.q_ss, q0, p.sq);
  load_rows<T, DV, kVS>(sdO, static_cast<const T*>(p.dout) + b * p.do_sb +
                                 h * p.do_sh, p.do_ss, q0, p.sq);
  load_row_stats(p, bh, q0, sLse, sDelta);
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int qx = threadIdx.x % SQ::TX, qy = threadIdx.x / SQ::TX;
  float acc[SQ::R][SQ::C];
#pragma unroll
  for (int r = 0; r < SQ::R; ++r)
#pragma unroll
    for (int c = 0; c < SQ::C; ++c) acc[r][c] = 0.0f;

  // the kv tiles that hold a key of this q tile's band (the forward's)
  const bool causal = p.causal != 0 || p.window > 0;
  const int q_last = min(q0 + kB, p.sq) - 1;
  const int k_end = causal ? min(p.skv, q_last + 1) : p.skv;
  const int k_begin =
      (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / kB * kB;

  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    __syncthreads();  // the last tile's readers are done; q, dO are ready
    load_rows<T, D, kQS>(sK, kg, p.k_ss, k0, p.skv);
    load_rows<T, DV, kVS>(sV, vg, p.v_ss, k0, p.skv);
    __syncthreads();
    probs_and_dscores<D, DV>(p, sQ, sK, sdO, sV, sLse, sDelta, q0, k0, sP,
                             sS);
    __syncthreads();
    // dQ += dS k, key by key of the kv tile
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float kv[SQ::C];
#pragma unroll
      for (int c = 0; c < SQ::C; ++c) kv[c] = sK[j * kQS + qx + SQ::TX * c];
#pragma unroll
      for (int r = 0; r < SQ::R; ++r) {
        const float ds = sS[(qy * SQ::R + r) * kPS + j];
#pragma unroll
        for (int c = 0; c < SQ::C; ++c) acc[r][c] = fmaf(ds, kv[c], acc[r][c]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq);  // contiguous [B, Sq, H, D]
#pragma unroll
  for (int r = 0; r < SQ::R; ++r) {
    const int row = q0 + qy * SQ::R + r;
    if (row >= p.sq) continue;
    const int64_t at = ((b * p.sq + row) * p.heads + h) * D;
#pragma unroll
    for (int c = 0; c < SQ::C; ++c) {
      dqg[at + qx + SQ::TX * c] = from_f<T>(acc[r][c] * p.scale);
    }
  }
}

// --- launch ------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  // above 48 KB a launch is refused unless the kernel opts in
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, int DV>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.batch) * p.heads * p.sq;
  const int64_t warps = kThreads / 32;
  if (rows > 0) {
    flash_bwd_delta_kernel<T>
        <<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0,
           stream>>>(p, DV);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t bytes = bwd_smem_bytes<D, DV>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, D, DV>, bytes);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<T, D, DV>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((p.skv + kB - 1) / kB, p.batch * p.kv_heads);
  flash_bwd_dkdv_kernel<T, D, DV><<<kv_grid, kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((p.sq + kB - 1) / kB, p.batch * p.heads);
  flash_bwd_dq_kernel<T, D, DV><<<q_grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const BwdParams& p, int d, int dv, cudaStream_t s) {
#define FLASH_BWD_CASE(D_, DV_) \
  if (d == D_ && dv == DV_) return launch<T, D_, DV_>(p, s);
  FLASH_BWD_CASE(16, 16)
  FLASH_BWD_CASE(32, 32)
  FLASH_BWD_CASE(32, 16)
  FLASH_BWD_CASE(64, 64)
  FLASH_BWD_CASE(64, 32)
  FLASH_BWD_CASE(128, 128)
  FLASH_BWD_CASE(128, 64)
  FLASH_BWD_CASE(256, 256)
  FLASH_BWD_CASE(256, 128)
#undef FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace bwd
}  // namespace

extern "C" {

// q, k, v, o, dout (strided, last dimension contiguous), lse [B, H, Sq] and
// the delta scratch [B, H, Sq] (float32), dq, dk, dv (contiguous, written),
// then the five tensors' batch / sequence / head strides in elements
#define FLASH_BWD_ENTRY(NAME, T)                                              \
  int NAME(const void* q, const void* k, const void* v, const void* o,       \
           const void* dout, const void* lse, void* delta, void* d_q,        \
           void* d_k, void* d_v, int64_t q_sb, int64_t q_ss, int64_t q_sh,   \
           int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,           \
           int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,           \
           int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,        \
           int batch, int heads, int kv_heads, int sq, int skv, int d,       \
           int dv, int causal, int window, float scale, void* stream) {      \
    const bwd::BwdParams p{q, k, v, o, dout, static_cast<const float*>(lse),  \
                      static_cast<float*>(delta), d_q, d_k, d_v,             \
                      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  \
                      o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, batch, heads,   \
                      kv_heads, sq, skv, causal, window, scale};             \
    return static_cast<int>(                                                  \
        bwd::dispatch<T>(p, d, dv, static_cast<cudaStream_t>(stream)));       \
  }

FLASH_BWD_ENTRY(flash_attention_bwd_float32, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bfloat16, __nv_bfloat16)
#undef FLASH_BWD_ENTRY

}  // extern "C"
