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
//    form takes bf16 or f32 x and computes mean and variance (two passes, f32),
//    then the absmax of the normalized affine row, then writes the int8
//    row and its scale; the plain form does absmax and quantize for an
//    f32 row (attention output, GELU output). A per-row scale needs the
//    whole row before any element is quantized, so this pass runs once
//    per row here instead of once per column block inside the GEMM, and
//    the GEMM reads 1 byte per A element instead of 2 or 4. Widths that
//    are not a multiple of 8 take quant_rows_any_kernel (an element a
//    lane; the wrapper then pads the int8 rows for the GEMM).
//  * i8_gemm_kernel: C[M, N] = epilogue(A[M, K] . Wq[K, N]) on int8
//    operands with int32 sums, on Hopper's int8 tensor cores:
//     - Mainloop: 128-deep k-tiles; the int8 A box (128-byte swizzled: a
//       row of 128 int8 is wgmma's K-major layout) in a ring of SA stages
//       and the int8 weight box as it lies in device memory ([k][n], one
//       byte a weight) in a ring of SW stages, both filled by TMA ahead of
//       use, one mbarrier a stage counting its bytes. Rows past M, columns
//       past N and depth past K arrive as zeros.
//     - Weight transpose: s8 wgmma takes no transpose flag, so both
//       operands must be K-major. The threads rewrite each [128 x BN]
//       weight box into a K-major, 128-byte-swizzled [BN x 128] tile: four
//       32-bit words (4 depth rows x 4 columns) in, a 4 x 4 byte transpose
//       by __byte_perm, four words (4 depth values of one column) out, with
//       the lanes placed so that reads and writes hit 32 distinct banks.
//       It fills one of two tiles while the tensor cores read the other, so
//       each weight byte is transposed once per block row of outputs and
//       tall blocks (192 rows) divide that cost.
//     - Product: wgmma m64n{128,256}k32 s8 x s8 -> s32, both operands from
//       shared memory; a warpgroup takes 64 rows (BM = 64 x warpgroups);
//       tile t's wgmmas run while tile t + 1 is transposed (wait_group 1,
//       then a block barrier before a tile or stage is reused).
//     - Epilogue: dequantize + bias, then bf16 out (qkv), quick_gelu f32
//       out (fc), or + residual bf16 out (out-proj, proj); with f32 x
//       (the tiny configurations) f32 qkv and + f32 residual, f32 out; or
//       dequantize alone, bf16 or f32 out (the W8A8 GEMM below). M and N
//       edges guarded.
//     - Filling the card: the tile (192 x 256, 128 x 256, 192 x 128,
//       128 x 128 or 64 x 128) and a split of K come from i8_plan(M, N, K)
//       in tvc_torch/core/kernels/w8_matmul_kernel.py. With a split, each
//       block stores its int32 sums of one K range into a workspace and
//       i8_splitk_reduce_kernel adds them (exact in any order) and applies
//       the epilogue, so a split changes no bit. The block rows of one
//       column tile are neighbours in the grid, so each weight tile crosses
//       device memory once.
//
// The same row-quantize and GEMM kernels also serve the Qwen2 decode's
// W8A8 GEMM, replacing tvc/core/pallas/w8_matmul_kernel.py w8a8_matmul
// (body _w8a8_matmul_kernel) and, on a layer's zero-copy view of the
// stacked [L, K, N] weights, w8a8_matmul_stacked (_w8a8_stacked_kernel):
//   y = ((x_q . Wq) . rs) . cs   in f32, rounded to x's dtype,
// with x_q, rs the per-row quantization of x (quant_rows_kernel, f32 or
// bf16 rows; bf16 -> f32 is exact, so the quanta are those of x.astype(f32))
// and no bias: the decode adds its q|k|v bias after the rounding. Two
// launches a call, three when K is split. Bound: at the Qwen2-7B decode batch (M = 576) the
// gate|up GEMM (K = 3584, N = 37888) does 2 M K N = 156 G operations on
// 136 MB of int8 weights, ~1,150 operations per byte, above the ridge:
// bound by operations (~79 us at 1,979 TOP/s).
//  * head_attention_tc_kernel<float> (head_attention.cuh): the bf16
//    layer's per-(sequence, head) tensor-core attention with an f32 output
//    (head_attention_kernel, on the CUDA cores, for f32 qkv); head width 32
//    or 64.
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
// inputs. Shared memory caps what the design reaches: every 64-row wgmma
// reads its B tile, and TMA, the transpose and wgmma's A reads add
// BM / 64 x BN + BM + (BM + BN) + 2 BN 128-byte rows a k-tile, against the
// SM's 128 bytes a clock; at 192 x 256 that is ~80 % of the int8 rate. The
// int8 row, the [M, 3W] qkv, the f32 attention output and the f32 [M, 4W]
// GELU output go through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_attention.cuh"

namespace {

using namespace hopper;

constexpr int kRowWarps = 8;  // rows per block of the row-quantize kernels

enum QEpilogue {
  QEPI_BF16 = 0,
  QEPI_GELU_F32 = 1,
  QEPI_RESIDUAL = 2,
  QEPI_DEQUANT_BF16 = 3,  // (acc . rs) . cs, no bias, bf16 out
  QEPI_DEQUANT_F32 = 4,   // the same, f32 out
  QEPI_BIAS_F32 = 5,      // + bias, f32 out (f32 qkv)
  QEPI_RESIDUAL_F32 = 6,  // + bias + f32 residual, f32 out
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

// Elements 2 i and 2 i + 1 of a row as f32.
__device__ __forceinline__ float2 load2(const bf16* row, int i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[i]);
}
__device__ __forceinline__ float2 load2(const float* row, int i) { return reinterpret_cast<const float2*>(row)[i]; }

// LN(x) row -> int8 row + scale. x bf16 or f32 [M, K], K % 8 == 0.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                         const float* __restrict__ ln_b, int8_t* __restrict__ q,
                         float* __restrict__ scale, int M, int K, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  // two-pass f32 statistics, as the TPU kernel: mean((x - mean)^2)
  float s = 0.f;
  for (int i = lane; i < K / 2; i += 32) {
    const float2 f = load2(xr, i);
    s += f.x + f.y;
  }
  const float mean = warp_sum(s) / K;
  float s2 = 0.f;
  for (int i = lane; i < K / 2; i += 32) {
    const float2 f = load2(xr, i);
    const float a = f.x - mean, b = f.y - mean;
    s2 += a * a + b * b;
  }
  const float rstd = rsqrtf(warp_sum(s2) / K + eps);
  float amax = 0.f;
  for (int c = lane; c < K / 8; c += 32) {
    float f[8];
    load8(xr + c * 8, f);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      amax = fmaxf(amax, fabsf(ln_affine(f[t], mean, rstd, ln_g[c * 8 + t], ln_b[c * 8 + t])));
  }
  const float rs = row_scale_of(warp_max(amax));
  for (int c = lane; c < K / 8; c += 32) {
    float f[8];
    load8(xr + c * 8, f);
    int v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = quant1(ln_affine(f[t], mean, rstd, ln_g[c * 8 + t], ln_b[c * 8 + t]), rs);
    *reinterpret_cast<uint2*>(q + (size_t)row * K + c * 8) = pack8(v);
  }
  if (lane == 0) scale[row] = rs;
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

// The same two functions for K % 8 != 0 (rows not 16-byte aligned), an
// element a lane at a time: the tail path for widths no configured model
// has. has_ln: LN(x) first, as ln_quant_rows_kernel.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    quant_rows_any_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                          const float* __restrict__ ln_b, int8_t* __restrict__ q,
                          float* __restrict__ scale, int M, int K, float eps, int has_ln) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float mean = 0.f, rstd = 0.f;
  if (has_ln) {
    float s = 0.f;
    for (int i = lane; i < K; i += 32) s += to_f32(xr[i]);
    mean = warp_sum(s) / K;
    float s2 = 0.f;
    for (int i = lane; i < K; i += 32) {
      const float a = to_f32(xr[i]) - mean;
      s2 += a * a;
    }
    rstd = rsqrtf(warp_sum(s2) / K + eps);
  }
  auto value = [&](int i) {
    const float f = to_f32(xr[i]);
    return has_ln ? ln_affine(f, mean, rstd, ln_g[i], ln_b[i]) : f;
  };
  float amax = 0.f;
  for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(value(i)));
  const float rs = row_scale_of(warp_max(amax));
  for (int i = lane; i < K; i += 32) q[(size_t)row * K + i] = (int8_t)quant1(value(i), rs);
  if (lane == 0) scale[row] = rs;
}

constexpr int QBK = 128;  // depth of a k-tile: one 128-byte swizzled row of int8

// What the GEMM's epilogue needs: row and column scales, bias, residual,
// output, and which of the QEpilogue variants to apply.
struct QEpi {
  const float* rs;
  const float* cs;
  const float* bias;
  const void* res;  // bf16 (QEPI_RESIDUAL) or f32 (QEPI_RESIDUAL_F32)
  void* out;
  int M, N, epi;
};

// quick_gelu in f32: h * sigmoid(1.702 h), sigmoid as 1 / (1 + exp(-t))
__device__ __forceinline__ float quick_gelu(float h) {
  return __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h)))));
}

// Columns col .. col + 3 of row `row` from their int32 sums: f32 dequant
// (acc . rs) . cs (+ bias), then the variant's tail, in the TPU kernel's
// order.
__device__ __forceinline__ void epilogue4(const QEpi& e, int row, int col, int4 a) {
  const float rs = e.rs[row];
  float v[4] = {__int2float_rn(a.x), __int2float_rn(a.y), __int2float_rn(a.z), __int2float_rn(a.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __fmul_rn(__fmul_rn(v[i], rs), e.cs[col + i]);
    if (e.epi != QEPI_DEQUANT_BF16 && e.epi != QEPI_DEQUANT_F32) v[i] = __fadd_rn(v[i], e.bias[col + i]);
  }
  const size_t o = (size_t)row * e.N + col;
  if (e.epi == QEPI_GELU_F32 || e.epi == QEPI_DEQUANT_F32 || e.epi == QEPI_BIAS_F32 || e.epi == QEPI_RESIDUAL_F32) {
    if (e.epi == QEPI_GELU_F32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = quick_gelu(v[i]);
    }
    if (e.epi == QEPI_RESIDUAL_F32) {
      const float4 r = *reinterpret_cast<const float4*>(static_cast<const float*>(e.res) + o);
      v[0] = __fadd_rn(r.x, v[0]);
      v[1] = __fadd_rn(r.y, v[1]);
      v[2] = __fadd_rn(r.z, v[2]);
      v[3] = __fadd_rn(r.w, v[3]);
    }
    *reinterpret_cast<float4*>(static_cast<float*>(e.out) + o) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  if (e.epi == QEPI_RESIDUAL) {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(e.res) + o);
    const float2 r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = __fadd_rn(r0.x, v[0]);
    v[1] = __fadd_rn(r0.y, v[1]);
    v[2] = __fadd_rn(r1.x, v[2]);
    v[3] = __fadd_rn(r1.y, v[3]);
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(static_cast<bf16*>(e.out) + o) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

template <int WGS, int BN, int SA, int SW>
struct I8Cfg {
  static constexpr int BM = 64 * WGS, kThreads = 128 * WGS;
  static constexpr int kA = BM * QBK;  // bytes of an activation stage
  static constexpr int kW = QBK * BN;  // bytes of a weight stage, and of its K-major tile
  static constexpr int kAcc = BN / 2;  // s32 accumulators a thread
  // two blocks an SM where their shared memory and registers allow
  static constexpr int kMinBlocks = (BN == 128 && WGS <= 2) ? 2 : 1;
  static constexpr size_t kPool = (size_t)SA * kA + (size_t)(SW + 2) * kW;  // the rings, then the epilogue's stage
  static constexpr size_t kSmem = kPool + 8 * (SA + SW) + 1024;
  static_assert((size_t)BM * (BN + 8) * 4 <= kPool, "the epilogue's int32 stage must fit the rings");
};

// One block: BM x BN outputs over local k-tiles [kt0, kt0 + n) of 128,
// kt0 = blockIdx.z * per; warpgroup w takes rows [64 w, 64 w + 64).
// ws == nullptr: the epilogue to e.out; else the int32 sums to
// ws[blockIdx.z] (split K). tma: A [M, K] int8, 128 x BM boxes, 128-byte
// swizzle; tmw: W [K, N] int8, BN x 128 boxes as they lie. Rows, columns
// and depth past the tensors arrive as zeros.
template <int WGS, int BN, int SA, int SW>
__global__ void __launch_bounds__(128 * WGS, (I8Cfg<WGS, BN, SA, SW>::kMinBlocks))
    i8_gemm_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmw, const QEpi e,
                   int32_t* __restrict__ ws, int K, int per) {
  using C = I8Cfg<WGS, BN, SA, SW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_s = (raw + 1023) & ~1023u;
  // SA activation stages, two K-major weight tiles, SW weight stages as
  // they lie, then the barriers: SA activation, SW weight
  const uint32_t t_s = a_s + SA * C::kA, w_s = t_s + 2 * C::kW, bar_s = w_s + SW * C::kW;
  unsigned char* t_g = smem_raw + (t_s - raw);
  const unsigned char* w_g = smem_raw + (w_s - raw);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * per;
  const int n = min(per, (K + QBK - 1) / QBK - kt0);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < SA + SW; ++i) mbar_init(bar_s + 8 * i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto issue_a = [&](int t) {  // one thread: tile t's activation box into slot t % SA
    const uint32_t bar = bar_s + 8 * (t % SA);
    mbar_expect_tx(bar, C::kA);
    tma_load_2d(a_s + (t % SA) * C::kA, &tma, (kt0 + t) * QBK, m0, bar);
  };
  auto issue_w = [&](int t) {  // one thread: tile t's weight box into slot t % SW
    const uint32_t bar = bar_s + 8 * (SA + t % SW);
    mbar_expect_tx(bar, C::kW);
    tma_load_2d(w_s + (t % SW) * C::kW, &tmw, n0, (kt0 + t) * QBK, bar);
  };
  // Weight tile t, [128 k][BN n] as it lies, -> K-major swizzled tile
  // t % 2, [BN n][128 k]. A warp's unit is 128 columns x one round: lane l
  // takes columns 4g..4g+3 (g = 32 block + l) and depth 4q..4q+3, q = the
  // lane's group ^ round, reading four 32-bit words (one a depth row) and
  // writing four (one a column) after a 4 x 4 byte transpose. A weight row
  // is a multiple of 128 bytes, so the reads fall in bank l whatever the
  // row; the lanes' groups make the 32 writes of each column j land on
  // 32 distinct banks of the swizzled tile. 32 rounds cover the depth.
  auto transpose = [&](int t) {
    mbar_wait(bar_s + 8 * (SA + t % SW), (t / SW) & 1);
    const unsigned char* src = w_g + (t % SW) * C::kW;
    unsigned char* dst = t_g + (t & 1) * C::kW;
    const int lane_q = (((lane >> 3) & 3) << 2) | ((lane >> 1) & 3);
#pragma unroll 2
    for (int u = tid >> 5; u < BN / 4; u += C::kThreads / 32) {
      const int q = lane_q ^ (u & 31), g = (u >> 5) * 32 + lane;
      const unsigned char* s = src + 4 * q * BN + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(s);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(s + BN);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(s + 2 * BN);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(s + 3 * BN);
      const uint32_t x0 = __byte_perm(w0, w1, 0x5140), x1 = __byte_perm(w0, w1, 0x7362);
      const uint32_t x2 = __byte_perm(w2, w3, 0x5140), x3 = __byte_perm(w2, w3, 0x7362);
      const uint32_t o[4] = {__byte_perm(x0, x2, 0x5410), __byte_perm(x0, x2, 0x7632), __byte_perm(x1, x3, 0x5410),
                             __byte_perm(x1, x3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * g + j;
        *reinterpret_cast<uint32_t*>(dst + col * 128 + ((((q >> 2) ^ (col & 7)) << 4) | ((q & 3) << 2))) = o[j];
      }
    }
  };

  int32_t acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0;

  if (tid == 0) {
    for (int t = 0; t < SA && t < n; ++t) issue_a(t);
    for (int t = 0; t < SW && t < n; ++t) issue_w(t);
  }
  transpose(0);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0 && SW < n) issue_w(SW);
  for (int t = 0; t < n; ++t) {
    // tile t: activations in slot t % SA, the K-major weights in tile t % 2
    mbar_wait(bar_s + 8 * (t % SA), (t / SA) & 1);
    const uint32_t a_t = a_s + (t % SA) * C::kA + wg * 8192, b_t = t_s + (t & 1) * C::kW;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QBK / 32; ++kk) {
      const uint64_t da = desc_sw128(a_t + kk * 32, 16, kSbo), db = desc_sw128(b_t + kk * 32, 16, kSbo);
      if constexpr (BN == 256) {
        wgmma_m64n256k32_s8(acc, da, db, 1);
      } else {
        wgmma_m64n128k32_s8(acc, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    // every warpgroup's wgmmas of tile t - 1 are done: its activation slot
    // and K-major tile are free
    __syncthreads();
    if (tid == 0 && t >= 1 && t - 1 + SA < n) issue_a(t - 1 + SA);
    if (t + 1 < n) {
      transpose(t + 1);  // while the tensor cores work on tile t
      fence_proxy_async();
    }
    __syncthreads();  // tile t + 1 is written and its weight slot is free
    if (tid == 0 && t + 1 + SW < n) issue_w(t + 1 + SW);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue. The int32 sums go through shared memory (the rings are
  // idle now): thread (warp, lane) holds rows 16 warp + lane / 4 and + 8,
  // columns 8 j + 2 (lane % 4) and + 1; rows are padded by 8 words so
  // that each half-warp's 8-byte stores fall on 32 distinct banks. Then
  // each thread takes 4 consecutive columns of a row, so a warp reads 512
  // contiguous bytes and writes a contiguous run of the output (or of the
  // split's workspace).
  int32_t* stage = reinterpret_cast<int32_t*>(smem_raw + (a_s - raw));
  constexpr int kLd = BN + 8;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  __syncthreads();  // every warpgroup's wgmmas are done with the tiles
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<int2*>(stage + r0 * kLd + c) = make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(stage + (r0 + 8) * kLd + c) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  int32_t* wsz = ws ? ws + (size_t)blockIdx.z * e.M * e.N : nullptr;
  for (int i = tid; i < C::BM * (BN / 4); i += C::kThreads) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4)), row = m0 + r, col = n0 + c;
    if (row >= e.M || col >= e.N) continue;
    const int4 a = *reinterpret_cast<const int4*>(stage + r * kLd + c);
    if (wsz)
      *reinterpret_cast<int4*>(wsz + (size_t)row * e.N + col) = a;
    else
      epilogue4(e, row, col, a);
  }
}

// The split ranges' int32 sums added (exact in any order), then the
// epilogue: one thread 4 columns.
__global__ void __launch_bounds__(256) i8_splitk_reduce_kernel(const int32_t* __restrict__ ws, const QEpi e, int splits) {
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  const size_t MN = (size_t)e.M * e.N;
  if (i >= MN) return;
  int4 s = *reinterpret_cast<const int4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const int4 p = *reinterpret_cast<const int4*>(ws + z * MN + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  epilogue4(e, (int)(i / e.N), (int)(i % e.N), s);
}

template <int WGS, int BN, int SA, int SW>
int launch_i8(const void* a, const void* w, const QEpi& e, void* ws, int K, int splits, int per,
              cudaStream_t stream) {
  using C = I8Cfg<WGS, BN, SA, SW>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(i8_gemm_kernel<WGS, BN, SA, SW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap tma, tmw;
  if (!make_map_2d(&tma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, e.M, K, QBK, C::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, e.N, BN, QBK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  // the block rows of one column tile run side by side, so each weight
  // tile crosses device memory once
  const dim3 grid((e.M + C::BM - 1) / C::BM, (e.N + BN - 1) / BN, splits);
  i8_gemm_kernel<WGS, BN, SA, SW><<<grid, C::kThreads, C::kSmem, stream>>>(
      tma, tmw, e, splits > 1 ? (int32_t*)ws : nullptr, K, per);
  if (splits > 1) {
    const size_t quads = (size_t)e.M * e.N / 4;
    i8_splitk_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>((const int32_t*)ws, e, splits);
  }
  return (int)cudaGetLastError();
}

template <typename T>
void launch_quant_rows(const void* h, const void* ln_scale, const void* ln_bias, void* q, void* scale, int M,
                       int K, float eps, int has_ln, cudaStream_t s) {
  const int blocks = (M + kRowWarps - 1) / kRowWarps;
  if (K % 8)
    quant_rows_any_kernel<T><<<blocks, 32 * kRowWarps, 0, s>>>(
        (const T*)h, (const float*)ln_scale, (const float*)ln_bias, (int8_t*)q, (float*)scale, M, K, eps, has_ln);
  else if (has_ln)
    ln_quant_rows_kernel<T><<<blocks, 32 * kRowWarps, 0, s>>>(
        (const T*)h, (const float*)ln_scale, (const float*)ln_bias, (int8_t*)q, (float*)scale, M, K, eps);
  else
    quant_rows_kernel<T><<<blocks, 32 * kRowWarps, 0, s>>>((const T*)h, (int8_t*)q, (float*)scale, M, K);
}

}  // namespace

// h [M, K] bf16 (is_f32 = 0) or f32 rows -> q int8 [M, K] and scale f32
// [M]; has_ln: LayerNorm(ln_scale, ln_bias, eps) first. K % 8 != 0 on the
// element-a-lane kernel.
extern "C" int tvc_quant_rows(const void* h, const void* ln_scale, const void* ln_bias,
                              void* q, void* scale, int M, int K, float eps,
                              int has_ln, int is_f32, void* stream) {
  if (M > 0 && K > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (is_f32)
      launch_quant_rows<float>(h, ln_scale, ln_bias, q, scale, M, K, eps, has_ln, s);
    else
      launch_quant_rows<bf16>(h, ln_scale, ln_bias, q, scale, M, K, eps, has_ln, s);
  }
  return (int)cudaGetLastError();
}

// out = epilogue(deq(a . w)): a int8 [M, K] with row_scale [M]; w int8
// [K, N] with col_scale [N]; bias f32 [N] (unused by QEPI_DEQUANT_*);
// residual [M, N] bf16 for QEPI_RESIDUAL, f32 for QEPI_RESIDUAL_F32. bm x bn tiles (192 x 256,
// 128 x 256, 192 x 128, 128 x 128 or 64 x 128) over `splits` ranges of
// `per` 128-deep k-tiles; ws: int32 [splits, M, N] when splits > 1. K and N
// multiples of 16; a and w 16-byte aligned.
extern "C" int tvc_i8_gemm(const void* a, const void* row_scale, const void* w, const void* col_scale,
                           const void* bias, const void* residual, void* out, void* ws, int M, int N, int K,
                           int epilogue, int bm, int bn, int splits, int per, void* stream) {
  const int nk = (K + QBK - 1) / QBK;
  if (K % 16 != 0 || N % 16 != 0 || epilogue < QEPI_BF16 || epilogue > QEPI_RESIDUAL_F32 || splits < 1 ||
      per < 1 || (splits - 1) * per >= nk || splits * per < nk || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const QEpi e{(const float*)row_scale, (const float*)col_scale, (const float*)bias, residual,
               out, M, N, epilogue};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 192 && bn == 256) return launch_i8<3, 256, 3, 2>(a, w, e, ws, K, splits, per, s);
  if (bm == 128 && bn == 256) return launch_i8<2, 256, 4, 2>(a, w, e, ws, K, splits, per, s);
  if (bm == 192 && bn == 128) return launch_i8<3, 128, 4, 2>(a, w, e, ws, K, splits, per, s);
  if (bm == 128 && bn == 128) return launch_i8<2, 128, 2, 2>(a, w, e, ws, K, splits, per, s);
  if (bm == 64 && bn == 128) return launch_i8<1, 128, 4, 2>(a, w, e, ws, K, splits, per, s);
  return (int)cudaErrorInvalidValue;
}

// Per-(sequence, head) attention on the packed [seqs * T, 3W] q | k | v,
// bf16 (in_f32 = 0) or f32, with an f32 output [seqs * T, W]; head width
// W / heads (32 or 64 tiled, any other on the tail path).
extern "C" int tvc_head_attention_f32(const void* qkv, void* out, int seqs, int T,
                                      int W, int heads, int causal, int in_f32, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (in_f32) return launch_head_attention<float, float>(qkv, out, seqs, T, W, heads, causal, s);
  return launch_head_attention<bf16, float>(qkv, out, seqs, T, W, heads, causal, s);
}
