// Fused TVC consistency scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel tvc/core/pallas/consistency_kernel.py
// (fused_consistency_scores, body _consistency_kernel). Same formulas:
//   orig  = cos(img, txt)
//   vsims = cos(img, variants) * vmask -> masked mean and population std
//           via vvar = max(E[x^2] - mean^2, 0)
//   rsims = cos(img, refs) * rmask     -> masked mean
//   tv    = 1 - (0.7 (1 - |orig - vmean|) + 0.3 (1 - vstd)), 0 without variants
//   sd    = 1 - rmean, 0 without refs;  cons = 1 - orig
//   agg   = (tv wt + sd ws + cons wc) / max(wt + ws + wc, 1e-12), where wt/ws
//           are zero for the methods that did not run; flag = agg > threshold
// Norms use rsqrt(max(sum x^2, eps^2)), eps = 1e-8, as the TPU kernel does.
//
// Bound: bytes. Per query it reads (V + R + 2) D floats and does 2 flops per
// element, far below the card's 295 flop/byte ridge. Design: one warp per
// query; each lane streams float4s, so a warp reads 512 contiguous bytes per
// step. Norms and dots reduce in f32 registers with warp shuffles, and only
// the [B, 8] stats block goes back to device memory: no [B, V] or [B, R]
// array is written. Masked slots are skipped, so padding costs no reads.
// Weights and threshold come from a 4-float device tensor, so a calibration
// update rebuilds and relaunches nothing new.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kEps2 = 1e-16f;  // eps^2, eps = 1e-8

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum(a*a), sum(b*b), sum(a*b) over one D-row pair, reduced across the warp
__device__ __forceinline__ void row_stats(const float4* a, const float4* b,
                                          int d4, int lane, float& aa,
                                          float& bb, float& ab) {
  float s_aa = 0.f, s_bb = 0.f, s_ab = 0.f;
  for (int i = lane; i < d4; i += 32) {
    const float4 x = a[i];
    const float4 y = b[i];
    s_aa += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    s_bb += y.x * y.x + y.y * y.y + y.z * y.z + y.w * y.w;
    s_ab += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  aa = warp_sum(s_aa);
  bb = warp_sum(s_bb);
  ab = warp_sum(s_ab);
}

__global__ void consistency_kernel(const float* __restrict__ params,
                                   const float* __restrict__ img,
                                   const float* __restrict__ txt,
                                   const float* __restrict__ var,
                                   const uint8_t* __restrict__ vmask,
                                   const float* __restrict__ ref,
                                   const uint8_t* __restrict__ rmask,
                                   float* __restrict__ out, int B, int V,
                                   int R, int D) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;
  const int d4 = D >> 2;
  const float4* x = reinterpret_cast<const float4*>(img + (size_t)q * D);
  const float4* t = reinterpret_cast<const float4*>(txt + (size_t)q * D);

  float xx, tt, xt;
  row_stats(x, t, d4, lane, xx, tt, xt);
  const float ix = rsqrtf(fmaxf(xx, kEps2));
  const float orig = xt * ix * rsqrtf(fmaxf(tt, kEps2));

  float vsum = 0.f, vsq = 0.f, vcount = 0.f;
  for (int v = 0; v < V; ++v) {
    if (!vmask[(size_t)q * V + v]) continue;  // warp-uniform branch
    const float4* r = reinterpret_cast<const float4*>(var + ((size_t)q * V + v) * D);
    float unused, rr, xr;
    row_stats(x, r, d4, lane, unused, rr, xr);
    const float s = xr * ix * rsqrtf(fmaxf(rr, kEps2));
    vsum += s;
    vsq += s * s;
    vcount += 1.f;
  }
  float rsum = 0.f, rcount = 0.f;
  for (int k = 0; k < R; ++k) {
    if (!rmask[(size_t)q * R + k]) continue;
    const float4* r = reinterpret_cast<const float4*>(ref + ((size_t)q * R + k) * D);
    float unused, rr, xr;
    row_stats(x, r, d4, lane, unused, rr, xr);
    rsum += xr * ix * rsqrtf(fmaxf(rr, kEps2));
    rcount += 1.f;
  }
  if (lane != 0) return;

  const float w_tv = params[0], w_sd = params[1], w_cons = params[2];
  const float threshold = params[3];
  const float vsafe = fmaxf(vcount, 1.f);
  const float vmean = vsum / vsafe;
  // no FMA contraction here: with one valid variant E[x^2] and mean^2 must
  // round identically so that var is exactly 0 (sqrt would turn a 1e-8
  // contraction residue into a 1e-4 std)
  const float vvar = fmaxf(__fsub_rn(vsq / vsafe, __fmul_rn(vmean, vmean)), 0.f);
  const float vstd = sqrtf(vvar);
  const bool v_has = vcount > 0.f;
  const float rmean = rsum / fmaxf(rcount, 1.f);
  const bool r_has = rcount > 0.f;

  float tv = 1.f - (0.7f * (1.f - fabsf(orig - vmean)) + 0.3f * (1.f - vstd));
  tv = v_has ? tv : 0.f;
  const float sd = r_has ? 1.f - rmean : 0.f;
  const float cons = 1.f - orig;
  const float wt = v_has ? w_tv : 0.f;
  const float ws = r_has ? w_sd : 0.f;
  const float total_w = wt + ws + w_cons;
  const float agg = (tv * wt + sd * ws + cons * w_cons) / fmaxf(total_w, 1e-12f);

  float* o = out + (size_t)q * 8;
  o[0] = tv;
  o[1] = sd;
  o[2] = cons;
  o[3] = agg;
  o[4] = agg > threshold ? 1.f : 0.f;
  o[5] = orig;
  o[6] = v_has ? vmean : 0.f;
  o[7] = v_has ? vstd : 0.f;
}

}  // namespace

extern "C" int tvc_consistency_scores(const void* params, const void* img,
                                      const void* txt, const void* var,
                                      const void* vmask, const void* ref,
                                      const void* rmask, void* out, int B,
                                      int V, int R, int D, void* stream) {
  if (B > 0) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    consistency_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        (const float*)params, (const float*)img, (const float*)txt,
        (const float*)var, (const uint8_t*)vmask, (const float*)ref,
        (const uint8_t*)rmask, (float*)out, B, V, R, D);
  }
  return (int)cudaGetLastError();
}
