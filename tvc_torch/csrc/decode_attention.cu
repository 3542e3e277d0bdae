// One-token grouped-query attention over a KV-major cache, for Hopper
// (sm_90a): the attention of every decode step of the Qwen2 paraphrase
// decode.
//
// Replaces the TPU kernels tvc/core/pallas/decode_attention_kernel.py
// decode_gqa_attention (body _decode_gqa_kernel) and
// decode_gqa_attention_stacked (_decode_gqa_stacked_kernel). The stacked
// TPU kernel picks layer l of the [L, B, KV, S, D] cache through scalar
// prefetch so that lax.scan copies no slab; in PyTorch k[l] of the
// contiguous stacked cache is already a zero-copy view, so the stacked
// wrapper hands this kernel that view. For each sequence b and KV head g,
// with R = query heads per KV head:
//   logits[r, s] = (q[b, g, r] . k[b, g, s]) * D^-1/2 + mask[b, s]   (f32)
//   w[r, :]      = softmax(logits[r, :]) rounded to q's dtype
//   out[b, g, r] = sum_s w[r, s] v[b, g, s]          (f32, then q's dtype)
// the TPU kernel's order: f32 logits of the compute-dtype operands, the
// additive f32 mask, the f32 softmax normalised by a division, the weights
// rounded before AV, AV accumulated in f32.
//
// Design. One block of 128 threads per (b, g). The (b, g) slab is S x D
// (128 KB of bf16 k at S = 512, D = 128), too large to stage whole next to
// the logits, so:
//  * pass 1 streams k through shared memory 32 keys at a time (converted
//    to f32, rows padded to D + 1 words so that the 32 lanes of a warp,
//    one key each, read 32 different banks) and keeps the R x S f32 logits
//    in shared memory (R = 7: 14 KB at S = 512);
//  * one warp per query row then takes the max, the exponentials and
//    their sum with warp shuffles and writes the normalised, rounded
//    weights back in place. No online-softmax rescale: its running weights
//    are never the normalised f32 values that the TPU kernel rounds;
//  * pass 2 streams v from device memory, each thread owning one column d
//    (and, at D = 64, every second query row), accumulating the rows in
//    ascending s.
//
// Bound. Per step the kernel must read each layer's k and v once: at the
// Qwen2-7B paraphrase batch (B = 576, KV = 4, D = 128, S ~ 64) that is
// 2 x 576 x 4 x 64 x 128 x 2 B = 75 MB against ~0.3 G operations, so it is
// bound by bytes (~22 us at 3.35 TB/s); chip_smoke.py computes the bound
// of each shape from its inputs. The design reads each k and v element
// once from device memory and writes nothing but the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // keys staged in shared memory per step of pass 1
constexpr int kMaxR = 8;    // query heads per KV head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

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

// Shared memory: q (R x D f32), one k chunk (kChunk x (D + 1) f32), the
// logits (R x S f32).
inline size_t decode_smem_bytes(int R, int S, int D) {
  return 4 * ((size_t)R * D + (size_t)kChunk * (D + 1) + (size_t)R * S);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ mask,
                      T* __restrict__ out, int KV, int R, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                              // [R][D]
  float* ks = qs + R * D;                        // [kChunk][D + 1]
  float* ps = ks + kChunk * (D + 1);             // [R][S]
  constexpr int kLd = D + 1;

  const int bg = blockIdx.x;  // b * KV + g
  const int b = bg / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + (size_t)bg * R * D;
  const T* kb = k + (size_t)bg * S * D;
  const T* vb = v + (size_t)bg * S * D;
  const float* mb = mask + (size_t)b * S;

  for (int i = tid; i < R * D; i += kThreads) qs[i] = to_f32(qb[i]);

  // pass 1: logits, kChunk keys at a time
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int n = min(kChunk, S - s0);
    __syncthreads();  // the previous chunk's readers are done (and qs is written)
    for (int i = tid; i < n * D; i += kThreads) {
      const int s = i / D, d = i - s * D;
      ks[s * kLd + d] = to_f32(kb[(size_t)(s0 + s) * D + d]);
    }
    __syncthreads();
    for (int p = tid; p < R * kChunk; p += kThreads) {
      const int r = p / kChunk, s = p - r * kChunk;
      if (s < n) {
        const float* qr = qs + r * D;
        const float* kr = ks + s * kLd;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        ps[r * S + s0 + s] = __fadd_rn(__fmul_rn(acc, scale), mb[s0 + s]);
      }
    }
  }
  __syncthreads();

  // softmax per query row, one warp a row: max, exp, sum, w = e / sum
  // rounded to T
  for (int r = warp; r < R; r += kWarps) {
    float* pr = ps + r * S;
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, pr[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(__fsub_rn(pr[s], mx));
      pr[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) pr[s] = to_f32(from_f32<T>(__fdiv_rn(pr[s], sum)));
  }
  __syncthreads();

  // pass 2: out[r, d] = sum_s w[r, s] v[s, d], ascending s
  constexpr int kGroups = kThreads / D;  // 1 at D = 128, 2 at D = 64, ... 8 at D = 16
  const int d = tid % D, g0 = tid / D;
  float acc[kMaxR];
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) acc[j] = 0.f;
  int s = 0;
  for (; s + 4 <= S; s += 4) {
    float vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = to_f32(vb[(size_t)(s + u) * D + d]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int r = g0 + j * kGroups;
        if (r < R) acc[j] = fmaf(ps[r * S + s + u], vv[u], acc[j]);
      }
  }
  for (; s < S; ++s) {
    const float vv = to_f32(vb[(size_t)s * D + d]);
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int r = g0 + j * kGroups;
      if (r < R) acc[j] = fmaf(ps[r * S + s], vv, acc[j]);
    }
  }
  T* ob = out + (size_t)bg * R * D;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) {
    const int r = g0 + j * kGroups;
    if (r < R) ob[r * D + d] = from_f32<T>(acc[j]);
  }
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v, const void* mask, void* out,
                  int B, int KV, int R, int S, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(R, S, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_gqa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = (float)(1.0 / sqrt((double)D));  // the TPU kernel's 1 / np.sqrt(D)
  decode_gqa_kernel<T, D><<<B * KV, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask, (T*)out, KV, R, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for (R, S, D), in bytes (the wrapper
// refuses shapes above the card's per-block limit).
extern "C" int tvc_decode_gqa_smem(int R, int S, int D) { return (int)decode_smem_bytes(R, S, D); }

// out [B, KV, R, D] = attention of q [B, KV, R, D] over k, v [B, KV, S, D]
// with the additive f32 mask [B, S]; is_bf16 != 0: q, k, v, out bf16, else f32.
// D is 16, 32, 64 or 128 (16: QwenConfig.tiny()), 1 <= R <= 8.
extern "C" int tvc_decode_gqa(const void* q, const void* k, const void* v, const void* mask,
                              void* out, int B, int KV, int R, int S, int D, int is_bf16,
                              void* stream) {
  if (R < 1 || R > kMaxR || S < 1) return (int)cudaErrorInvalidValue;
  if (B < 1 || KV < 1) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define TVC_DECODE_D(DD)                                                                     \
  if (D == DD)                                                                               \
    return is_bf16 ? launch_decode<bf16, DD>(q, k, v, mask, out, B, KV, R, S, st)            \
                   : launch_decode<float, DD>(q, k, v, mask, out, B, KV, R, S, st);
  TVC_DECODE_D(128)
  TVC_DECODE_D(64)
  TVC_DECODE_D(32)
  TVC_DECODE_D(16)
#undef TVC_DECODE_D
  return (int)cudaErrorInvalidValue;
}
