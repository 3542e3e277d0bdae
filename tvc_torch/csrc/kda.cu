// Kimi Delta Attention (KDA) for Hopper (sm_90a): the linear-attention
// layers of Kimi-Linear, around their GEMMs. Three kernels a layer:
//
//  * kda_prepare_kernel: the short causal depthwise convolution (kernel K,
//    a window of the last K - 1 inputs kept per row), SiLU rounded to the
//    model's dtype (the published convolution's output), the L2 norms of q
//    and k per head (rsqrt(sum x^2 + 1e-6), q also times d^-1/2), the
//    per-channel log-decay g = -exp(A_log[h]) softplus(f + dt_bias) and
//    beta = sigmoid(b), all f32, over T >= 1 tokens a row with per-row
//    valid lengths: a padded token writes zeros and leaves the window as it
//    was. One block a (row, head), a thread a channel of the head for q, k
//    and v: the window lives in registers while the block walks the tokens.
//  * kda_recurrent_kernel: per head the state S [d_k, d_v] (f32, updated
//    in place): S <- Diag(exp g) S, u = v - S^T k, S <- S + beta k u^T,
//    o = S^T q, over a row's valid tokens (o rounded to bf16, zeros past
//    the row's length). One block of 128 threads a (row, head):
//    thread t holds the 32 x 4 piece S[32 (t / 32) .., 4 (t % 32) ..] in
//    registers, read and written once a call by 16-byte vectors (a warp
//    covers 32 x 4 neighbouring columns of one state row); the two sums
//    over d_k go through shared memory, four warp partials summed in order.
//  * kda_gated_norm_kernel: o <- RMSNorm(o) * w * sigmoid(gate) per head
//    (f32, rounded once); a warp a (token, head).
//
// Replaces no TPU kernel: the JAX package has no linear attention. Bound:
// bytes. A decode step reads and writes each row's state once a layer: at
// 480 rows and 32 heads of 128 x 128, 2 x 1.0 GB a layer (~0.6 ms at 3.35
// TB/s), against 4 operations a state value and token; the preparation
// and the norm move ~2 kB a (row, head) and token. The prefill runs the
// same recurrence token by token (a chunked form for long prompts is later
// work). No kernel reduces in an order that depends on the schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxConv = 8;  // the longest convolution the preparation takes
constexpr int kD = 128;      // the recurrence's head width (Kimi-Linear's)

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoidf_(float x) { return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))); }

// PyTorch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplusf_(float x) { return x > 20.f ? x : log1pf(expf(x)); }

__device__ __forceinline__ int row_len(const long long* lengths, int b, int T) {
  if (!lengths) return T;
  const long long n = lengths[b];
  return n < 0 ? 0 : (n > T ? T : (int)n);
}

// ---------------------------------------------------------------------------
// the preparation: conv, SiLU, L2 norms, gate, beta
// ---------------------------------------------------------------------------

__global__ void kda_prepare_kernel(const bf16* __restrict__ y, int ldy, const bf16* __restrict__ f, int ldf,
                                   const float* __restrict__ conv_w, const float* __restrict__ a_log,
                                   const float* __restrict__ dt_bias, bf16* __restrict__ conv_state,
                                   const long long* __restrict__ lengths, float* __restrict__ out,
                                   float* __restrict__ beta, int T, int nh, int d, int K, int b_col, float q_scale) {
  __shared__ float2 red[32];
  const int b = blockIdx.x / nh, h = blockIdx.x % nh, c = threadIdx.x;
  const int HD = nh * d, C = 3 * HD, W = K - 1;
  const int n = row_len(lengths, b, T);
  const int warp = c >> 5, lane = c & 31, warps = d >> 5;
  int ch[3];
  float w[3][kMaxConv], win[3][kMaxConv];
  bf16* st = conv_state + (size_t)b * W * C;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    ch[m] = m * HD + h * d + c;
#pragma unroll
    for (int j = 0; j < kMaxConv; ++j) {  // unrolled with guards: the taps stay in registers
      w[m][j] = j < K ? conv_w[(size_t)ch[m] * K + j] : 0.f;
      win[m][j] = j < W ? f32(st[(size_t)j * C + ch[m]]) : 0.f;
    }
  }
  const float A = expf(a_log[h]);
  const float bias = dt_bias[h * d + c];
  for (int t = 0; t < T; ++t) {
    float* o = out + (((size_t)b * T + t) * nh + h) * 4 * d;
    if (t >= n) {  // block-uniform: a padded token
      for (int m = 0; m < 4; ++m) o[m * d + c] = 0.f;
      if (c == 0) beta[((size_t)b * T + t) * nh + h] = 0.f;
      continue;
    }
    const bf16* yr = y + ((size_t)b * T + t) * ldy;
    float a[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float x = f32(yr[ch[m]]);
      float acc = 0.f, last = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxConv; ++j) {
        if (j < W) acc = __fadd_rn(acc, __fmul_rn(win[m][j], w[m][j]));
        if (j == W) last = w[m][j];
      }
      acc = __fadd_rn(acc, __fmul_rn(x, last));
#pragma unroll
      for (int j = 0; j < kMaxConv; ++j) {
        if (j + 1 < W) win[m][j] = win[m][j + 1];
        else if (j + 1 == W) win[m][j] = x;
      }
      a[m] = f32(__float2bfloat16_rn(__fdiv_rn(acc, __fadd_rn(1.f, expf(-acc)))));  // SiLU, rounded
    }
    float2 s = make_float2(__fmul_rn(a[0], a[0]), __fmul_rn(a[1], a[1]));
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      s.x = __fadd_rn(s.x, __shfl_xor_sync(kFull, s.x, off));
      s.y = __fadd_rn(s.y, __shfl_xor_sync(kFull, s.y, off));
    }
    if (lane == 0) red[warp] = s;
    __syncthreads();
    float2 tot = red[0];
    for (int q = 1; q < warps; ++q) tot = make_float2(__fadd_rn(tot.x, red[q].x), __fadd_rn(tot.y, red[q].y));
    __syncthreads();  // red is reused by the next token
    const float fv = __fadd_rn(f32(f[((size_t)b * T + t) * ldf + h * d + c]), bias);
    o[c] = __fmul_rn(__fmul_rn(a[0], rsqrtf(__fadd_rn(tot.x, 1e-6f))), q_scale);
    o[d + c] = __fmul_rn(a[1], rsqrtf(__fadd_rn(tot.y, 1e-6f)));
    o[2 * d + c] = a[2];
    o[3 * d + c] = -__fmul_rn(A, softplusf_(fv));
    if (c == 0) beta[((size_t)b * T + t) * nh + h] = sigmoidf_(f32(yr[b_col + h]));
  }
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int j = 0; j < kMaxConv; ++j)
      if (j < W) st[(size_t)j * C + ch[m]] = __float2bfloat16_rn(win[m][j]);
}

// ---------------------------------------------------------------------------
// the recurrence
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128) kda_recurrent_kernel(const float* __restrict__ qkvg,
                                                            const float* __restrict__ beta,
                                                            float* __restrict__ state,
                                                            const long long* __restrict__ lengths,
                                                            bf16* __restrict__ out, int T, int nh) {
  __shared__ float sq[kD], sk[kD], sv[kD], se[kD];
  __shared__ float red[4][kD];
  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = 32 * warp, v0 = 4 * lane;
  const int n = row_len(lengths, b, T);
  float* S = state + ((size_t)b * nh + h) * kD * kD;
  float s[32][4];
  if (n > 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float4 r = *reinterpret_cast<const float4*>(S + (size_t)(k0 + i) * kD + v0);
      s[i][0] = r.x, s[i][1] = r.y, s[i][2] = r.z, s[i][3] = r.w;
    }
  }
  for (int t = 0; t < n; ++t) {
    const size_t row = ((size_t)b * T + t) * nh + h;
    const float* src = qkvg + row * 4 * kD;
    sq[tid] = src[tid];
    sk[tid] = src[kD + tid];
    sv[tid] = src[2 * kD + tid];
    se[tid] = expf(src[3 * kD + tid]);
    const float bt = beta[row];
    __syncthreads();
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = se[k0 + i], kk = sk[k0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fmul_rn(s[i][j], e);
        p[j] = __fadd_rn(p[j], __fmul_rn(s[i][j], kk));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][v0 + j] = p[j];
    __syncthreads();
    float u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + j;
      u[j] = __fsub_rn(sv[v], __fadd_rn(__fadd_rn(__fadd_rn(red[0][v], red[1][v]), red[2][v]), red[3][v]));
      p[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float bk = __fmul_rn(bt, sk[k0 + i]), qq = sq[k0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fadd_rn(s[i][j], __fmul_rn(bk, u[j]));
        p[j] = __fadd_rn(p[j], __fmul_rn(s[i][j], qq));
      }
    }
    __syncthreads();  // every warp has read red
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][v0 + j] = p[j];
    __syncthreads();
    if (warp == 0) {
      bf16* o = out + row * kD;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = v0 + j;
        o[v] = __float2bfloat16_rn(__fadd_rn(__fadd_rn(__fadd_rn(red[0][v], red[1][v]), red[2][v]), red[3][v]));
      }
    }
    __syncthreads();  // the token's operands and red are reused
  }
  for (int t = n; t < T; ++t) out[(((size_t)b * T + t) * nh + h) * kD + tid] = __float2bfloat16_rn(0.f);
  if (n > 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<float4*>(S + (size_t)(k0 + i) * kD + v0) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
  }
}

// ---------------------------------------------------------------------------
// the gated output norm
// ---------------------------------------------------------------------------

__global__ void kda_gated_norm_kernel(const bf16* __restrict__ o, const bf16* __restrict__ gate, int ldg,
                                      const float* __restrict__ w, bf16* __restrict__ out, long long units, int nh,
                                      int d, float eps) {
  const long long unit = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (unit >= units) return;
  const int lane = threadIdx.x & 31, per = d >> 5;
  const long long r = unit / nh;
  const int h = (int)(unit % nh);
  const bf16* x = o + unit * d;
  const bf16* g = gate + r * ldg + (size_t)h * d;
  bf16* y = out + unit * d;
  float v[8];
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    v[q] = q < per ? f32(x[lane + 32 * q]) : 0.f;
    ss = __fadd_rn(ss, __fmul_rn(v[q], v[q]));
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, off));
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q >= per) break;
    const int c = lane + 32 * q;
    const float nv = __fmul_rn(__fmul_rn(v[q], rs), w[c]);
    y[c] = __float2bfloat16_rn(__fmul_rn(nv, sigmoidf_(f32(g[c]))));
  }
}

}  // namespace

// y bf16 [B, T, ldy] (q | k | v, 3 nh d values, from column 0; beta's
// logits at columns b_col ..), f bf16 [B, T, ldf] (the log-decay's input,
// nh d values from column 0), conv_w f32 [3 nh d, K], a_log f32 [nh],
// dt_bias f32 [nh d], conv_state bf16 [B, K - 1, 3 nh d] (read and written),
// lengths int64 [B] or null (every token valid): out f32 [B, T, nh, 4, d]
// (q, k, v, g), beta f32 [B, T, nh]. d a multiple of 32 up to 1,024, K <=
// 8.
extern "C" int tvc_kda_prepare(const void* y, int ldy, const void* f, int ldf, const void* conv_w, const void* a_log,
                               const void* dt_bias, void* conv_state, const void* lengths, void* out, void* beta, int B,
                               int T, int nh, int d, int K, int b_col, float q_scale, void* stream) {
  if (T < 1 || nh < 1 || d < 32 || d % 32 || d > 1024 || K < 1 || K > kMaxConv || b_col < 3 * nh * d ||
      ldy < b_col + nh || ldf < nh * d)
    return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  kda_prepare_kernel<<<B * nh, d, 0, (cudaStream_t)stream>>>(
      (const bf16*)y, ldy, (const bf16*)f, ldf, (const float*)conv_w, (const float*)a_log, (const float*)dt_bias,
      (bf16*)conv_state, (const long long*)lengths, (float*)out, (float*)beta, T, nh, d, K, b_col, q_scale);
  return (int)cudaGetLastError();
}

// qkvg f32 [B, T, nh, 4, 128], beta f32 [B, T, nh], state f32 [B, nh, 128,
// 128] (16 bytes aligned; updated in place), lengths int64 [B] or null:
// out bf16 [B, T, nh, 128].
extern "C" int tvc_kda_recurrent(const void* qkvg, const void* beta, void* state, const void* lengths, void* out,
                                 int B, int T, int nh, void* stream) {
  if (T < 1 || nh < 1 || reinterpret_cast<uintptr_t>(state) % 16) return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  kda_recurrent_kernel<<<B * nh, 128, 0, (cudaStream_t)stream>>>(
      (const float*)qkvg, (const float*)beta, (float*)state, (const long long*)lengths, (bf16*)out, T, nh);
  return (int)cudaGetLastError();
}

// o bf16 [rows, nh, d] and gate bf16 [rows, ldg] (nh d values from column
// 0), w f32 [d]: out bf16 [rows, nh d] = RMSNorm(o) * w * sigmoid(gate) per
// head. d a multiple of 32 up to 256.
extern "C" int tvc_kda_gated_norm(const void* o, const void* gate, int ldg, const void* w, void* out, long long rows,
                                  int nh, int d, float eps, void* stream) {
  if (nh < 1 || d < 32 || d % 32 || d > 256 || ldg < nh * d) return (int)cudaErrorInvalidValue;
  if (rows < 1) return (int)cudaGetLastError();
  const long long units = rows * nh;
  const int warps = 8;
  const long long blocks = (units + warps - 1) / warps;
  kda_gated_norm_kernel<<<(unsigned)blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const bf16*)o, (const bf16*)gate, ldg, (const float*)w, (bf16*)out, units, nh, d, eps);
  return (int)cudaGetLastError();
}
