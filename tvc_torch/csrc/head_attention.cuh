// Per-(sequence, head) softmax attention for Hopper (sm_90a). Shared by
// attention_layer.cu (bf16 layer: P.V rounded to bf16), quantized_layer.cu
// (int8 layer: P.V kept in f32 until it is quantized) and mha.cu (the
// standalone multi-head attention on [B, T, H, D] q, k, v), each of which
// compiles its own copy.
//
// The kernel reads q, k and v through three base pointers and one row
// stride `ld` (elements): row t of sequence s, head h starts at
// base + (s * T + t) * ld + h * D. The layer kernels pass the packed
// [seqs * T, 3W] q | k | v activation (bases qkv, qkv + W, qkv + 2W,
// ld = 3W); mha.cu passes three [B, T, H, D] tensors (ld = H * D, or the
// row stride of q | k | v views of a packed projection). out is
// [seqs * T, H * D]. One block per (sequence, head): the T x D q, k and v
// slices go to dynamic shared memory sized by T (~104 KB at T = 257 in
// bf16, ~202 KB in f32, above the 48 KB static limit, so the launcher
// raises the block's limit first). Each warp takes a query row at a time:
// logits of the operands in f32, the causal mask, the f32 softmax with
// warp shuffles, the weights rounded to bf16 as the TPU kernels do (bf16
// operands only; f32 operands keep f32 weights), then P.V accumulated in
// f32. Head widths 32 and 64, T <= 257.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kMaxT = 257;  // ViT-L/14 at 224 px: 16 x 16 patches + class token
constexpr int kAttnWarps = 4;

// The operands are read as pairs of adjacent values: __nv_bfloat162 for
// bf16, float2 for f32.
template <typename InT> struct PairOf;
template <> struct PairOf<bf16> { using type = __nv_bfloat162; };
template <> struct PairOf<float> { using type = float2; };

__device__ __forceinline__ float2 to_float2(__nv_bfloat162 p) { return __bfloat1622float2(p); }
__device__ __forceinline__ float2 to_float2(float2 p) { return p; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// Dynamic shared memory for T rows of head width D in InT: q, k (rows of
// pairs padded by one pair, so that lane j reading row j hits bank
// (j + d) % 32 for bf16 and a half warp's 16 rows spread over all 32
// banks for f32), v, and one row of logits per warp; each part starts on
// a 16-byte boundary.
template <typename InT, int D>
struct AttnSmem {
  using Pair = typename PairOf<InT>::type;
  static constexpr int kKLd = D / 2 + 1;  // pairs of a padded k row
  __host__ __device__ static size_t q_bytes(int T) { return (size_t)T * D * sizeof(InT); }
  __host__ __device__ static size_t k_bytes(int T) { return ((size_t)T * kKLd * sizeof(Pair) + 15) / 16 * 16; }
  __host__ __device__ static size_t bytes(int T) {
    return 2 * q_bytes(T) + k_bytes(T) + (size_t)kAttnWarps * T * 4;
  }
};

__device__ __forceinline__ void store_out(bf16* o, int lane, float o0, float o1) {
  reinterpret_cast<__nv_bfloat162*>(o)[lane] = __floats2bfloat162_rn(o0, o1);
}
__device__ __forceinline__ void store_out(float* o, int lane, float o0, float o1) {
  reinterpret_cast<float2*>(o)[lane] = make_float2(o0, o1);
}

// Lane l computes logit columns l, l + 32, ... in ascending order, so its
// partial softmax sum is taken in the same order at every T.
template <typename InT, typename OutT, int D>
__global__ void __launch_bounds__(32 * kAttnWarps)
    head_attention_kernel(const InT* __restrict__ qg, const InT* __restrict__ kg,
                          const InT* __restrict__ vg, OutT* __restrict__ out, int ld,
                          int T, int H, int causal, float scale) {
  static_assert(D == 32 || D == 64, "head width 32 or 64");
  using S = AttnSmem<InT, D>;
  using Pair = typename S::Pair;
  constexpr int kVec = 16 / (int)sizeof(InT);   // elements of a 16-byte load
  constexpr int kChunks = D / kVec;             // 16-byte loads of a row
  constexpr int kChunkShift = kChunks == 8 ? 3 : kChunks == 4 ? 2 : 4;
  static_assert(1 << kChunkShift == kChunks, "16-byte loads of a row: 4, 8 or 16");
  constexpr bool kRoundP = sizeof(InT) == 2;    // bf16 operands: bf16 weights
  extern __shared__ __align__(16) unsigned char smem[];
  InT* qs = reinterpret_cast<InT*>(smem);
  Pair* ks = reinterpret_cast<Pair*>(smem + S::q_bytes(T));
  InT* vs = reinterpret_cast<InT*>(smem + S::q_bytes(T) + S::k_bytes(T));
  float* ps_all = reinterpret_cast<float*>(smem + 2 * S::q_bytes(T) + S::k_bytes(T));

  const int seq = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)seq * T;
  const int W = H * D;
  float* ps = ps_all + (size_t)warp * T;

  for (int c = tid; c < T * kChunks; c += blockDim.x) {
    const int t = c >> kChunkShift, part = (c & (kChunks - 1)) * kVec;
    const size_t off = (row0 + t) * (size_t)ld + (size_t)h * D + part;
    *reinterpret_cast<uint4*>(qs + t * D + part) = *reinterpret_cast<const uint4*>(qg + off);
    const uint4 kv = *reinterpret_cast<const uint4*>(kg + off);
    const Pair* k2 = reinterpret_cast<const Pair*>(&kv);
#pragma unroll
    for (int q = 0; q < (int)(16 / sizeof(Pair)); ++q) ks[t * S::kKLd + part / 2 + q] = k2[q];
    *reinterpret_cast<uint4*>(vs + t * D + part) = *reinterpret_cast<const uint4*>(vg + off);
  }
  __syncthreads();

  for (int i = warp; i < T; i += kAttnWarps) {
    const Pair* q2 = reinterpret_cast<const Pair*>(qs + i * D);
    const int jend = causal ? i + 1 : T;
    float mx = -INFINITY;
    for (int j = lane; j < jend; j += 32) {
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D / 2; ++d) {
        const float2 a = to_float2(q2[d]);
        const float2 b = to_float2(ks[j * S::kKLd + d]);
        acc += a.x * b.x + a.y * b.y;
      }
      const float s = acc * scale;
      ps[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < jend; j += 32) {
      const float e = expf(ps[j] - mx);
      ps[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < jend; j += 32) {
      // softmax weights rounded to bf16 before P.V, as the TPU kernels do
      ps[j] = kRoundP ? __bfloat162float(__float2bfloat16(ps[j] / sum)) : ps[j] / sum;
    }
    __syncwarp();
    if constexpr (D == 64) {
      float o0 = 0.f, o1 = 0.f;
      for (int j = 0; j < jend; ++j) {
        const float p = ps[j];
        const float2 v = to_float2(reinterpret_cast<const Pair*>(vs + j * D)[lane]);
        o0 += p * v.x;
        o1 += p * v.y;
      }
      // out's address is taken after the loop: taken before it, it holds
      // registers that the unrolled loop's loads in flight need
      OutT* o = out + (row0 + i) * W + (size_t)h * D;
      store_out(o, lane, o0, o1);
    } else {
      float o0 = 0.f;
      for (int j = 0; j < jend; ++j) o0 += ps[j] * to_f32(vs[j * D + lane]);
      OutT* o = out + (row0 + i) * W + (size_t)h * D;
      if constexpr (sizeof(OutT) == 2) {
        o[lane] = __float2bfloat16(o0);
      } else {
        o[lane] = o0;
      }
    }
    __syncwarp();
  }
}

// Launch on `stream` over `seqs` sequences of T rows and `heads` heads;
// returns cudaErrorInvalidValue for T > kMaxT, else cudaGetLastError().
template <typename InT, typename OutT, int D>
int launch_head_attention_strided(const void* q, const void* k, const void* v, void* out, int ld,
                                  int seqs, int T, int heads, int causal, float scale,
                                  cudaStream_t stream) {
  if (T > kMaxT) return (int)cudaErrorInvalidValue;
  if (seqs > 0 && T > 0) {
    const size_t smem = AttnSmem<InT, D>::bytes(T);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          head_attention_kernel<InT, OutT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    head_attention_kernel<InT, OutT, D><<<seqs * heads, 32 * kAttnWarps, smem, stream>>>(
        (const InT*)q, (const InT*)k, (const InT*)v, (OutT*)out, ld, T, heads, causal, scale);
  }
  return (int)cudaGetLastError();
}

// The layer kernels' call: the packed bf16 [seqs * T, 3W] q | k | v,
// head width 64; returns cudaErrorInvalidValue for another head width.
template <typename OutT>
int launch_head_attention(const void* qkv, void* out, int seqs, int T, int W,
                          int heads, int causal, cudaStream_t stream) {
  if (W != heads * 64) return (int)cudaErrorInvalidValue;
  const bf16* base = (const bf16*)qkv;
  return launch_head_attention_strided<bf16, OutT, 64>(
      base, base + W, base + 2 * W, out, 3 * W, seqs, T, heads, causal, 0.125f /* 1/sqrt(64) */, stream);
}

}  // namespace
