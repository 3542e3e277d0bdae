// Mamba-2 selective state-space layers for Hopper (sm_90a): the SSM
// blocks of Nemotron-H, around their GEMMs. Three kernels a block:
//
//  * ssm_prepare_kernel: the short causal depthwise convolution of the
//    x | B | C channels (kernel K, a window of the last K - 1 inputs kept
//    per row, a bias a channel), SiLU rounded to bf16 (the published
//    convolution's output), and the step Δ_h = softplus(dt_h + dt_bias_h)
//    in f32, over T >= 1 tokens a row with per-row valid lengths: a padded
//    token writes zeros and leaves the window as it was. A thread a
//    channel (or a head's Δ) of one row: the window lives in registers
//    while the thread walks the tokens.
//  * ssm_recurrent_kernel: per head the state S [P, N] (f32, updated in
//    place): S <- exp(Δ A) S + (Δ B) x^T, y = S C + D x, over a row's valid
//    tokens (y rounded to bf16, zeros past the row's length); B and C are
//    the head's group's (heads / groups heads share one). One block of 128
//    threads a (row, head): warp w holds rows 16 w .. 16 w + 15 of S, lane
//    l columns 4 l .. 4 l + 3, in registers, read and written once a call
//    by 16-byte vectors (a warp covers one 512-byte state row an access);
//    y's sum over N is a butterfly of shuffles inside the warp.
//  * ssm_gated_norm_kernel: o <- RMSNorm_group(y * SiLU(z)) * w over groups
//    of the channels (f32, rounded once); a warp a (token, group).
//
// Replaces no TPU kernel: the JAX package has no state-space layer. Bound:
// bytes. A decode step reads and writes each row's state once a block: at
// 640 rows and 64 heads of 64 x 128, 2 x 1.34 GB a block (~0.8 ms at 3.35
// TB/s), against ~5 operations a state value and token; the preparation
// and the norm move ~30 kB a row and token. The prefill runs the same
// recurrence token by token (a chunked form for long prompts is later
// work). No kernel reduces in an order that depends on the schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxConv = 8;  // the longest convolution the preparation takes
constexpr int kP = 64;       // the recurrence's head width (Nemotron-H's mamba_head_dim)
constexpr int kN = 128;      // its state size (ssm_state_size)
constexpr int kMaxGroup = 1024;  // the widest group the gated norm takes

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float siluf_(float x) { return __fdiv_rn(x, __fadd_rn(1.f, expf(-x))); }

// PyTorch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplusf_(float x) { return x > 20.f ? x : log1pf(expf(x)); }

__device__ __forceinline__ int row_len(const long long* lengths, int b, int T) {
  if (!lengths) return T;
  const long long n = lengths[b];
  return n < 0 ? 0 : (n > T ? T : (int)n);
}

// ---------------------------------------------------------------------------
// the preparation: conv, bias, SiLU; the step
// ---------------------------------------------------------------------------

__global__ void ssm_prepare_kernel(const bf16* __restrict__ y, int ldy, int xbc_col, int dt_col,
                                   const float* __restrict__ conv_w, const float* __restrict__ conv_b,
                                   const float* __restrict__ dt_bias, bf16* __restrict__ conv_state,
                                   const long long* __restrict__ lengths, bf16* __restrict__ xbc,
                                   float* __restrict__ dt, int T, int C, int nh, int K) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = row_len(lengths, b, T);
  const int W = K - 1;
  if (c < C) {
    float w[kMaxConv], win[kMaxConv];
    bf16* st = conv_state + (size_t)b * W * C;
#pragma unroll
    for (int j = 0; j < kMaxConv; ++j) {  // unrolled with guards: the taps stay in registers
      w[j] = j < K ? conv_w[(size_t)c * K + j] : 0.f;
      win[j] = j < W ? f32(st[(size_t)j * C + c]) : 0.f;
    }
    const float bias = conv_b[c];
    for (int t = 0; t < T; ++t) {
      bf16* o = xbc + ((size_t)b * T + t) * C + c;
      if (t >= n) {
        *o = __float2bfloat16_rn(0.f);
        continue;
      }
      const float x = f32(y[((size_t)b * T + t) * ldy + xbc_col + c]);
      float acc = 0.f, last = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxConv; ++j) {
        if (j < W) acc = __fadd_rn(acc, __fmul_rn(win[j], w[j]));
        if (j == W) last = w[j];
      }
      acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(x, last)), bias);
#pragma unroll
      for (int j = 0; j < kMaxConv; ++j) {
        if (j + 1 < W) win[j] = win[j + 1];
        else if (j + 1 == W) win[j] = x;
      }
      *o = __float2bfloat16_rn(siluf_(acc));
    }
#pragma unroll
    for (int j = 0; j < kMaxConv; ++j)
      if (j < W) st[(size_t)j * C + c] = __float2bfloat16_rn(win[j]);
  } else if (c < C + nh) {
    const int h = c - C;
    const float bias = dt_bias[h];
    for (int t = 0; t < T; ++t) {
      const float v = f32(y[((size_t)b * T + t) * ldy + dt_col + h]);
      dt[((size_t)b * T + t) * nh + h] = t < n ? softplusf_(__fadd_rn(v, bias)) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// the recurrence
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128) ssm_recurrent_kernel(const bf16* __restrict__ xbc,
                                                            const float* __restrict__ dt,
                                                            const float* __restrict__ a_log,
                                                            const float* __restrict__ dskip,
                                                            float* __restrict__ state,
                                                            const long long* __restrict__ lengths,
                                                            bf16* __restrict__ out, int T, int nh, int groups) {
  __shared__ float sx[kP], sb[kN], sc[kN];
  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = 16 * warp, n0 = 4 * lane;
  const int I = nh * kP, C = I + 2 * groups * kN;
  const int g = h / (nh / groups);
  const int n = row_len(lengths, b, T);
  const float A = -expf(a_log[h]), Dh = dskip[h];
  float* S = state + ((size_t)b * nh + h) * kP * kN;
  float s[16][4];
  if (n > 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float4 r = *reinterpret_cast<const float4*>(S + (size_t)(p0 + i) * kN + n0);
      s[i][0] = r.x, s[i][1] = r.y, s[i][2] = r.z, s[i][3] = r.w;
    }
  }
  for (int t = 0; t < n; ++t) {
    const bf16* row = xbc + ((size_t)b * T + t) * C;
    if (tid < kP) sx[tid] = f32(row[h * kP + tid]);
    sb[tid] = f32(row[I + g * kN + tid]);
    sc[tid] = f32(row[I + (groups + g) * kN + tid]);
    const float d = dt[((size_t)b * T + t) * nh + h];
    __syncthreads();
    const float dA = expf(__fmul_rn(d, A));
    float db[4], cc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) db[j] = __fmul_rn(d, sb[n0 + j]), cc[j] = sc[n0 + j];
    float yv = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float xv = sx[p0 + i];
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fadd_rn(__fmul_rn(s[i][j], dA), __fmul_rn(db[j], xv));
        part = __fadd_rn(part, __fmul_rn(s[i][j], cc[j]));
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) part = __fadd_rn(part, __shfl_xor_sync(kFull, part, off));
      if (lane == i) yv = part;
    }
    if (lane < 16) {
      const int p = p0 + lane;
      out[((size_t)b * T + t) * I + h * kP + p] = __float2bfloat16_rn(__fadd_rn(yv, __fmul_rn(sx[p], Dh)));
    }
    __syncthreads();  // the token's operands are reused
  }
  for (int t = n; t < T; ++t)
    if (tid < kP) out[((size_t)b * T + t) * I + h * kP + tid] = __float2bfloat16_rn(0.f);
  if (n > 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<float4*>(S + (size_t)(p0 + i) * kN + n0) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
  }
}

// ---------------------------------------------------------------------------
// the gated grouped norm
// ---------------------------------------------------------------------------

__global__ void ssm_gated_norm_kernel(const bf16* __restrict__ yv, const bf16* __restrict__ z, int ldz,
                                      const float* __restrict__ w, bf16* __restrict__ out, long long units,
                                      int groups, int gs, float eps) {
  const long long unit = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (unit >= units) return;
  const int lane = threadIdx.x & 31, per = gs >> 5;
  const long long r = unit / groups;
  const int g = (int)(unit % groups);
  const int I = groups * gs;
  const bf16* x = yv + r * I + (size_t)g * gs;
  const bf16* zr = z + r * ldz + (size_t)g * gs;
  bf16* o = out + r * I + (size_t)g * gs;
  float v[kMaxGroup / 32];
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxGroup / 32; ++q) {
    if (q < per) {
      v[q] = __fmul_rn(f32(x[lane + 32 * q]), siluf_(f32(zr[lane + 32 * q])));
      ss = __fadd_rn(ss, __fmul_rn(v[q], v[q]));
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, off));
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)gs), eps));
#pragma unroll
  for (int q = 0; q < kMaxGroup / 32; ++q) {
    if (q >= per) break;
    const int c = g * gs + lane + 32 * q;
    o[lane + 32 * q] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(v[q], rs), w[c]));
  }
}

}  // namespace

// y bf16 [B, T, ldy]: x | B | C (C channels) from column xbc_col, the nh
// step inputs from dt_col; conv_w f32 [C, K], conv_b f32 [C], dt_bias f32
// [nh], conv_state bf16 [B, K - 1, C] (read and written), lengths int64
// [B] or null (every token valid): xbc bf16 [B, T, C], dt f32 [B, T, nh].
// K <= 8.
extern "C" int tvc_ssm_prepare(const void* y, int ldy, int xbc_col, int dt_col, const void* conv_w, const void* conv_b,
                               const void* dt_bias, void* conv_state, const void* lengths, void* xbc, void* dt, int B,
                               int T, int C, int nh, int K, void* stream) {
  if (T < 1 || C < 1 || nh < 1 || K < 1 || K > kMaxConv || xbc_col < 0 || dt_col < 0 || ldy < xbc_col + C ||
      ldy < dt_col + nh)
    return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  const dim3 grid((C + nh + 255) / 256, B);
  ssm_prepare_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)y, ldy, xbc_col, dt_col, (const float*)conv_w, (const float*)conv_b, (const float*)dt_bias,
      (bf16*)conv_state, (const long long*)lengths, (bf16*)xbc, (float*)dt, T, C, nh, K);
  return (int)cudaGetLastError();
}

// xbc bf16 [B, T, nh 64 + 2 groups 128] (x | B | C), dt f32 [B, T, nh],
// a_log, d f32 [nh], state f32 [B, nh, 64, 128] (16 bytes aligned; updated
// in place), lengths int64 [B] or null: out bf16 [B, T, nh 64]. groups
// divides nh.
extern "C" int tvc_ssm_recurrent(const void* xbc, const void* dt, const void* a_log, const void* d, void* state,
                                 const void* lengths, void* out, int B, int T, int nh, int groups, void* stream) {
  if (T < 1 || nh < 1 || groups < 1 || nh % groups || reinterpret_cast<uintptr_t>(state) % 16)
    return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  ssm_recurrent_kernel<<<B * nh, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)xbc, (const float*)dt, (const float*)a_log, (const float*)d, (float*)state,
      (const long long*)lengths, (bf16*)out, T, nh, groups);
  return (int)cudaGetLastError();
}

// y bf16 [rows, groups gs], z bf16 [rows, ldz] (groups gs values from
// column 0), w f32 [groups gs]: out bf16 [rows, groups gs] =
// RMSNorm(y * SiLU(z)) * w over each group of gs channels. gs a multiple of
// 32 up to 1,024.
extern "C" int tvc_ssm_gated_norm(const void* y, const void* z, int ldz, const void* w, void* out, long long rows,
                                  int groups, int gs, float eps, void* stream) {
  if (groups < 1 || gs < 32 || gs % 32 || gs > kMaxGroup || ldz < groups * gs) return (int)cudaErrorInvalidValue;
  if (rows < 1) return (int)cudaGetLastError();
  const long long units = rows * groups;
  const int warps = 8;
  const long long blocks = (units + warps - 1) / warps;
  ssm_gated_norm_kernel<<<(unsigned)blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const bf16*)y, (const bf16*)z, ldz, (const float*)w, (bf16*)out, units, groups, gs, eps);
  return (int)cudaGetLastError();
}
