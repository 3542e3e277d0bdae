// Per-(sequence, head) softmax attention over a packed qkv activation, for
// Hopper (sm_90a). Shared by attention_layer.cu (bf16 layer: P.V rounded
// to bf16) and quantized_layer.cu (int8 layer: P.V kept in f32 until it is
// quantized), each of which compiles its own copy.
//
// qkv is [seqs * T, 3W] bf16 with q | k | v side by side, head h at columns
// h * 64 of each third; out is [seqs * T, W]. One block per (sequence,
// head): the T x 64 q, k and v slices go to dynamic shared memory sized by
// T (~104 KB at T = 257, above the 48 KB static limit, so the launcher
// raises the block's limit first). Each warp takes a query row at a time:
// logits of the bf16 operands in f32, the causal mask, the f32 softmax
// with warp shuffles, the weights rounded to bf16 as the TPU kernels do,
// then P.V accumulated in f32.

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

constexpr int kHeadDim = 64;
constexpr int kMaxT = 257;  // ViT-L/14 at 224 px: 16 x 16 patches + class token
constexpr int kAttnWarps = 4;
constexpr int kKsLd = kHeadDim / 2 + 1;  // k rows padded to 33 words

// Dynamic shared memory for T rows: q, k (padded rows: lane j reading row j
// hits bank (j + d) % 32), v, and one row of logits per warp; each part
// starts on a 16-byte boundary.
__host__ __device__ inline size_t attn_q_bytes(int T) { return (size_t)T * kHeadDim * 2; }
__host__ __device__ inline size_t attn_k_bytes(int T) { return ((size_t)T * kKsLd * 4 + 15) / 16 * 16; }
inline size_t attn_smem_bytes(int T) {
  return 2 * attn_q_bytes(T) + attn_k_bytes(T) + (size_t)kAttnWarps * T * 4;
}

// Lane l computes logit columns l, l + 32, ... in ascending order, so its
// partial softmax sum is taken in the same order at every T.
template <typename OutT>
__global__ void __launch_bounds__(32 * kAttnWarps)
    head_attention_kernel(const bf16* __restrict__ qkv, OutT* __restrict__ out,
                          int T, int W, int H, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  __nv_bfloat162* ks = reinterpret_cast<__nv_bfloat162*>(smem + attn_q_bytes(T));
  bf16* vs = reinterpret_cast<bf16*>(smem + attn_q_bytes(T) + attn_k_bytes(T));
  float* ps_all = reinterpret_cast<float*>(smem + 2 * attn_q_bytes(T) + attn_k_bytes(T));

  const int seq = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)seq * T;
  const size_t W3 = 3 * (size_t)W;
  float* ps = ps_all + (size_t)warp * T;

  for (int c = tid; c < T * (kHeadDim / 8); c += blockDim.x) {
    const int t = c >> 3, part = (c & 7) * 8;
    const bf16* base = qkv + (row0 + t) * W3 + (size_t)h * kHeadDim + part;
    *reinterpret_cast<uint4*>(qs + t * kHeadDim + part) = *reinterpret_cast<const uint4*>(base);
    const uint4 kv = *reinterpret_cast<const uint4*>(base + W);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
    for (int q = 0; q < 4; ++q) ks[t * kKsLd + part / 2 + q] = k2[q];
    *reinterpret_cast<uint4*>(vs + t * kHeadDim + part) = *reinterpret_cast<const uint4*>(base + 2 * W);
  }
  __syncthreads();

  for (int i = warp; i < T; i += kAttnWarps) {
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qs + i * kHeadDim);
    const int jend = causal ? i + 1 : T;
    float mx = -INFINITY;
    for (int j = lane; j < jend; j += 32) {
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < kHeadDim / 2; ++d) {
        const float2 a = __bfloat1622float2(q2[d]);
        const float2 b = __bfloat1622float2(ks[j * kKsLd + d]);
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
      ps[j] = __bfloat162float(__float2bfloat16(ps[j] / sum));
    }
    __syncwarp();
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < jend; ++j) {
      const float p = ps[j];
      const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(vs + j * kHeadDim)[lane]);
      o0 += p * v.x;
      o1 += p * v.y;
    }
    OutT* o = out + (row0 + i) * W + (size_t)h * kHeadDim;
    if constexpr (sizeof(OutT) == 2) {
      reinterpret_cast<__nv_bfloat162*>(o)[lane] = __floats2bfloat162_rn(o0, o1);
    } else {
      reinterpret_cast<float2*>(o)[lane] = make_float2(o0, o1);
    }
    __syncwarp();
  }
}

// Launch on `stream`; returns cudaErrorInvalidValue for T > kMaxT or a head
// width other than 64, else cudaGetLastError().
template <typename OutT>
int launch_head_attention(const void* qkv, void* out, int seqs, int T, int W,
                          int heads, int causal, cudaStream_t stream) {
  if (T > kMaxT || W != heads * kHeadDim) return (int)cudaErrorInvalidValue;
  if (seqs > 0 && T > 0) {
    const size_t smem = attn_smem_bytes(T);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          head_attention_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    head_attention_kernel<OutT><<<seqs * heads, 32 * kAttnWarps, smem, stream>>>(
        (const bf16*)qkv, (OutT*)out, T, W, heads, causal, 0.125f /* 1/sqrt(64) */);
  }
  return (int)cudaGetLastError();
}

}  // namespace
