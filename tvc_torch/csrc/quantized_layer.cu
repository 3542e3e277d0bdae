// W8A8 pre-LN transformer sub-blocks for Hopper (sm_90a): the attention
// layer and the MLP layer of the int8 CLIP serving towers.
//
// Replaces the TPU kernels tvc/core/pallas/quantized_layer_kernel.py
// (fused_attention_layer_i8, body _attn_layer_i8_kernel; fused_mlp_layer_i8,
// body _mlp_layer_i8_kernel):
//   attention: out = x + deq(q(MHA(deq(q(LN(x)) . Wq_qkv))) . Wq_out)
//   mlp:       out = x + deq(q(quick_gelu(deq(q(LN(x)) . Wq_fc))) . Wq_proj)
// where Wq are int8 [in, out] weights with f32 per-output-channel scales
// (quantize_linear), q(.) is the dynamic symmetric per-row int8 quantizer
// (rs = max(max|h|, 1e-12) / 127, q = clip(rint(h / rs), -127, 127)) and
// deq(acc) = acc . row_scale . col_scale + bias, all in f32. The rounding
// points are the TPU kernel's: LN output quantized from f32; qkv rounded to
// bf16; softmax in f32, weights rounded to bf16, attention output kept in
// f32 and quantized from f32; GELU output kept in f32 and quantized from
// f32; residual added in f32, output rounded to bf16. Each f32 step is
// written with the round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fdiv_rn) so nvcc contracts nothing into an FMA the plain PyTorch
// version does not have, rintf rounds half to even as jnp.round does, and
// nothing is built with fast math.
//
// Kernels, launched in sequence by the Python wrappers
// (tvc_torch/core/kernels/quantized_layer_kernel.py):
//  * ln_quant_rows_kernel / quant_rows_kernel: one warp per row. The LN
//    form takes bf16 x and computes mean and variance (two passes, f32),
//    then the absmax of the normalized affine row, then writes the int8
//    row and its scale; the plain form does absmax and quantize for an
//    f32 row (attention output, GELU output). A per-row scale needs the
//    whole row before any element is quantized, so this pass runs once
//    per row here instead of once per column block inside the GEMM, and
//    the GEMM reads 1 byte per A element instead of 2 or 4.
//  * i8_gemm_kernel: C[M, N] = epilogue(A[M, K] . Wq[K, N]) on int8
//    operands with int32 accumulation: 128x128x64 tiles, 8 warps each
//    holding a 32x64 block of 16x16x16 signed-char WMMA fragments. Shared
//    tiles are stored as panels of 16 int8 columns so that every fragment
//    starts on a 256-byte boundary. Epilogue: dequantize + bias, then
//    bf16 out (qkv), quick_gelu f32 out (fc), or + residual bf16 out
//    (out-proj, proj); or dequantize alone, bf16 or f32 out (the W8A8
//    GEMM below).
//
// The same row-quantize and GEMM kernels also serve the Qwen2 decode's
// W8A8 GEMM, replacing tvc/core/pallas/w8_matmul_kernel.py w8a8_matmul
// (body _w8a8_matmul_kernel) and, on a layer's zero-copy view of the
// stacked [L, K, N] weights, w8a8_matmul_stacked (_w8a8_stacked_kernel):
//   y = ((x_q . Wq) . rs) . cs   in f32, rounded to x's dtype,
// with x_q, rs the per-row quantization of x (quant_rows_kernel, f32 or
// bf16 rows; bf16 -> f32 is exact, so the quanta are those of x.astype(f32))
// and no bias: the decode adds its q|k|v bias after the rounding. Two
// launches a call. Bound: at the Qwen2-7B decode batch (M = 576) the
// gate|up GEMM (K = 3584, N = 37888) does 2 M K N = 156 G operations on
// 136 MB of int8 weights, ~1,150 operations per byte, above the ridge:
// bound by operations (~79 us at 1,979 TOP/s).
//  * head_attention_tc_kernel<float> (head_attention.cuh): the bf16
//    layer's per-(sequence, head) tensor-core attention with an f32 output.
// An attention layer is 5 launches (LN-quantize, QKV GEMM, attention,
// quantize, out-proj GEMM) and an MLP layer 4 (LN-quantize, fc GEMM,
// quantize, proj GEMM).
//
// Bound. The H100's dense int8 tensor-core rate is 1,979 TOP/s, twice its
// bf16 rate, and its memory moves 3.35 TB/s: the ridge is ~590 int8
// operations per byte. A ViT-B/32 QKV GEMM (M = 64 x 50, K = 768,
// N = 2304) does 2 M K N = 11.3 G operations on M K + K N bytes of int8
// operands and 2 M N bytes of bf16 output (~19 MB): ~600 operations per
// byte, at the ridge, so the layer is bound by operations and bytes about
// equally; chip_smoke.py computes the bound for each shape from its
// inputs. This first version uses WMMA (mma.sync-level) fragments, whose
// peak is below wgmma's, and no TMA; the int8 row, the [M, 3W] qkv, the f32
// attention output and the f32 [M, 4W] GELU output go through device
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "head_attention.cuh"

namespace {

using namespace nvcuda;

constexpr int kRowWarps = 8;  // rows per block of the row-quantize kernels

enum QEpilogue {
  QEPI_BF16 = 0,
  QEPI_GELU_F32 = 1,
  QEPI_RESIDUAL = 2,
  QEPI_DEQUANT_BF16 = 3,  // (acc . rs) . cs, no bias, bf16 out
  QEPI_DEQUANT_F32 = 4,   // the same, f32 out
};

__device__ __forceinline__ float row_scale_of(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-12f), 127.f);
}

__device__ __forceinline__ int quant1(float h, float rs) {
  const float q = rintf(__fdiv_rn(h, rs));  // half to even, as jnp.round
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ float ln_affine(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

__device__ __forceinline__ uint2 pack8(const int* v) {
  uint2 p;
  p.x = (uint32_t)(v[0] & 0xff) | ((uint32_t)(v[1] & 0xff) << 8) |
        ((uint32_t)(v[2] & 0xff) << 16) | ((uint32_t)(v[3] & 0xff) << 24);
  p.y = (uint32_t)(v[4] & 0xff) | ((uint32_t)(v[5] & 0xff) << 8) |
        ((uint32_t)(v[6] & 0xff) << 16) | ((uint32_t)(v[7] & 0xff) << 24);
  return p;
}

// LN(x) row -> int8 row + scale. x bf16 [M, K], K % 8 == 0.
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                         const float* __restrict__ ln_b, int8_t* __restrict__ q,
                         float* __restrict__ scale, int M, int K, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(xr);
  // two-pass f32 statistics, as the TPU kernel: mean((x - mean)^2)
  float s = 0.f;
  for (int i = lane; i < K / 2; i += 32) {
    const float2 f = __bfloat1622float2(x2[i]);
    s += f.x + f.y;
  }
  const float mean = warp_sum(s) / K;
  float s2 = 0.f;
  for (int i = lane; i < K / 2; i += 32) {
    const float2 f = __bfloat1622float2(x2[i]);
    const float a = f.x - mean, b = f.y - mean;
    s2 += a * a + b * b;
  }
  const float rstd = rsqrtf(warp_sum(s2) / K + eps);
  float amax = 0.f;
  for (int c = lane; c < K / 8; c += 32) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      amax = fmaxf(amax, fabsf(ln_affine(__bfloat162float(e[t]), mean, rstd, ln_g[c * 8 + t], ln_b[c * 8 + t])));
  }
  const float rs = row_scale_of(warp_max(amax));
  for (int c = lane; c < K / 8; c += 32) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    int v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = quant1(ln_affine(__bfloat162float(e[t]), mean, rstd, ln_g[c * 8 + t], ln_b[c * 8 + t]), rs);
    *reinterpret_cast<uint2*>(q + (size_t)row * K + c * 8) = pack8(v);
  }
  if (lane == 0) scale[row] = rs;
}

// Eight consecutive elements of a row as f32 (16 bytes of bf16, 32 of f32).
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w; f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int t = 0; t < 8; ++t) f[t] = __bfloat162float(e[t]);
}

// f32 or bf16 row -> int8 row + scale. h [M, K], K % 8 == 0.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    quant_rows_kernel(const T* __restrict__ h, int8_t* __restrict__ q,
                      float* __restrict__ scale, int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= M) return;
  const T* hr = h + (size_t)row * K;
  float amax = 0.f;
  for (int c = lane; c < K / 8; c += 32) {
    float f[8];
    load8(hr + c * 8, f);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(f[t]));
  }
  const float rs = row_scale_of(warp_max(amax));
  for (int c = lane; c < K / 8; c += 32) {
    float f[8];
    load8(hr + c * 8, f);
    int v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = quant1(f[t], rs);
    *reinterpret_cast<uint2*>(q + (size_t)row * K + c * 8) = pack8(v);
  }
  if (lane == 0) scale[row] = rs;
}

constexpr int QBM = 128, QBN = 128, QBK = 64;
constexpr int kPanel = 16;  // int8 columns per shared panel (one WMMA k or n extent)
constexpr int kQGemmThreads = 256;

template <int EPI>
__global__ void __launch_bounds__(kQGemmThreads)
    i8_gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ row_scale,
                   const int8_t* __restrict__ Wq, const float* __restrict__ col_scale,
                   const float* __restrict__ bias, const bf16* __restrict__ res,
                   void* __restrict__ out, int M, int N, int K) {
  // As[p][m][:] holds A[m, k0 + 16p .. +16); Bs[p][k][:] holds Wq[k0 + k, n0 + 16p .. +16)
  __shared__ __align__(256) int8_t As[QBK / kPanel][QBM][kPanel];
  __shared__ __align__(256) int8_t Bs[QBN / kPanel][QBK][kPanel];
  __shared__ __align__(256) int scratch[kQGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * QBM, n0 = blockIdx.x * QBN;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 ra[2], rb[2];
  // A tile: 128 rows x 4 chunks of 16 bytes; W tile: 64 rows x 8 chunks
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kQGemmThreads;
      const int r = c >> 2, kc = c & 3;
      const int gm = m0 + r, gk = k0 + kc * kPanel;
      ra[i] = (gm < M && gk < K) ? *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk) : zero;
      const int kr = c >> 3, nc = c & 7;
      const int gk2 = k0 + kr, gn = n0 + nc * kPanel;
      rb[i] = (gk2 < K && gn < N) ? *reinterpret_cast<const uint4*>(Wq + (size_t)gk2 * N + gn) : zero;
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kQGemmThreads;
      *reinterpret_cast<uint4*>(&As[c & 3][c >> 2][0]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[c & 7][c >> 3][0]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int wm = warp >> 1;  // rows wm*32 .. +32
  const int wn = warp & 1;   // cols wn*64 .. +64
  const int nk = (K + QBK - 1) / QBK;
  load_tiles(0);
  for (int kt = 0; kt < nk; ++kt) {
    store_tiles();
    __syncthreads();
    if (kt + 1 < nk) load_tiles((kt + 1) * QBK);
#pragma unroll
    for (int p = 0; p < QBK / kPanel; ++p) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], reinterpret_cast<const signed char*>(&As[p][wm * 32 + i * 16][0]), kPanel);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], reinterpret_cast<const signed char*>(&Bs[wn * 4 + j][p * kPanel][0]), kPanel);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, one 16x16 fragment at a time through the warp's scratch tile:
  // f32 dequant (acc . row_scale) . col_scale (+ bias), in the TPU kernel's order
  constexpr bool kBias = EPI == QEPI_BF16 || EPI == QEPI_GELU_F32 || EPI == QEPI_RESIDUAL;
  constexpr bool kF32Out = EPI == QEPI_GELU_F32 || EPI == QEPI_DEQUANT_F32;
  int* sc = scratch[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 32 + i * 16 + r;
      const int gn = n0 + wn * 64 + j * 16 + c0;
      if (gm < M && gn < N) {
        const float rs = row_scale[gm];
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          v[q] = __fmul_rn(__fmul_rn((float)sc[r * 16 + c0 + q], rs), col_scale[gn + q]);
          if (kBias) v[q] = __fadd_rn(v[q], bias[gn + q]);
        }
        if (EPI == QEPI_GELU_F32) {
          // quick_gelu in f32: h * sigmoid(1.702 h), sigmoid as 1 / (1 + exp(-t))
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, v[q]))));
            v[q] = __fmul_rn(v[q], sg);
          }
        }
        if (kF32Out) {
          float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)gm * N + gn);
          o[0] = make_float4(v[0], v[1], v[2], v[3]);
          o[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          if (EPI == QEPI_RESIDUAL) {
            const uint4 rv = *reinterpret_cast<const uint4*>(res + (size_t)gm * N + gn);
            const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] = __fadd_rn(__bfloat162float(re[q]), v[q]);
          }
          uint4 o;
          bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
          for (int q = 0; q < 8; ++q) oe[q] = __float2bfloat16(v[q]);
          *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + (size_t)gm * N + gn) = o;
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI>
void launch_i8_gemm(const void* a, const void* rs, const void* w, const void* cs,
                    const void* bias, const void* res, void* out, int M, int N,
                    int K, cudaStream_t stream) {
  const dim3 grid((N + QBN - 1) / QBN, (M + QBM - 1) / QBM);
  i8_gemm_kernel<EPI><<<grid, kQGemmThreads, 0, stream>>>(
      (const int8_t*)a, (const float*)rs, (const int8_t*)w, (const float*)cs,
      (const float*)bias, (const bf16*)res, out, M, N, K);
}

}  // namespace

// has_ln: h is bf16 and LayerNorm(ln_scale, ln_bias, eps) comes first;
// else h is f32. Writes q int8 [M, K] and scale f32 [M].
extern "C" int tvc_quant_rows(const void* h, const void* ln_scale, const void* ln_bias,
                              void* q, void* scale, int M, int K, float eps,
                              int has_ln, void* stream) {
  if (K % 8 != 0) return (int)cudaErrorInvalidValue;
  if (M > 0 && K > 0) {
    const int blocks = (M + kRowWarps - 1) / kRowWarps;
    cudaStream_t s = (cudaStream_t)stream;
    if (has_ln)
      ln_quant_rows_kernel<<<blocks, 32 * kRowWarps, 0, s>>>(
          (const bf16*)h, (const float*)ln_scale, (const float*)ln_bias, (int8_t*)q,
          (float*)scale, M, K, eps);
    else
      quant_rows_kernel<float><<<blocks, 32 * kRowWarps, 0, s>>>(
          (const float*)h, (int8_t*)q, (float*)scale, M, K);
  }
  return (int)cudaGetLastError();
}

// bf16 rows -> q int8 [M, K] and scale f32 [M] (no LayerNorm).
extern "C" int tvc_quant_rows_bf16(const void* h, void* q, void* scale, int M, int K, void* stream) {
  if (K % 8 != 0) return (int)cudaErrorInvalidValue;
  if (M > 0 && K > 0)
    quant_rows_kernel<bf16><<<(M + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, (cudaStream_t)stream>>>(
        (const bf16*)h, (int8_t*)q, (float*)scale, M, K);
  return (int)cudaGetLastError();
}

// out = epilogue(deq(a . w)): a int8 [M, K] with row_scale [M]; w int8
// [K, N] with col_scale [N]; bias f32 [N] (unused by QEPI_DEQUANT_*);
// residual bf16 [M, N] for QEPI_RESIDUAL. K and N multiples of 16.
extern "C" int tvc_i8_gemm(const void* a, const void* row_scale, const void* w,
                           const void* col_scale, const void* bias, const void* residual,
                           void* out, int M, int N, int K, int epilogue, void* stream) {
  if (K % kPanel != 0 || N % kPanel != 0) return (int)cudaErrorInvalidValue;
  if (M > 0 && N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (epilogue == QEPI_BF16)
      launch_i8_gemm<QEPI_BF16>(a, row_scale, w, col_scale, bias, residual, out, M, N, K, s);
    else if (epilogue == QEPI_GELU_F32)
      launch_i8_gemm<QEPI_GELU_F32>(a, row_scale, w, col_scale, bias, residual, out, M, N, K, s);
    else if (epilogue == QEPI_RESIDUAL)
      launch_i8_gemm<QEPI_RESIDUAL>(a, row_scale, w, col_scale, bias, residual, out, M, N, K, s);
    else if (epilogue == QEPI_DEQUANT_BF16)
      launch_i8_gemm<QEPI_DEQUANT_BF16>(a, row_scale, w, col_scale, bias, residual, out, M, N, K, s);
    else if (epilogue == QEPI_DEQUANT_F32)
      launch_i8_gemm<QEPI_DEQUANT_F32>(a, row_scale, w, col_scale, bias, residual, out, M, N, K, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Per-(sequence, head) attention with an f32 output [seqs * T, W].
extern "C" int tvc_head_attention_f32(const void* qkv, void* out, int seqs, int T,
                                      int W, int heads, int causal, void* stream) {
  return launch_head_attention<float>(qkv, out, seqs, T, W, heads, causal, (cudaStream_t)stream);
}
