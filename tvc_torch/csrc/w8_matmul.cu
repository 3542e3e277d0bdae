// Weight-only int8 GEMM for Hopper (sm_90a): the Qwen2 decode's "w8" GEMM.
//
// Replaces the TPU kernels tvc/core/pallas/w8_matmul_kernel.py w8_matmul
// (body _w8_matmul_kernel) and, on a layer's zero-copy view of the stacked
// [L, K, N] weights, w8_matmul_stacked (_w8_stacked_kernel):
//   y[M, N] = ( (x . Wq) summed in f32 ) * scale[n], rounded to x's dtype
// with x [M, K] bf16 or f32, Wq int8 [K, N] (per-output-channel symmetric,
// from quantize_linear) and scale f32 [N]. The int8 weights convert to x's
// type exactly (|v| <= 128 fits bf16's 8-bit significand), the products
// are summed in f32, and the epilogue is the TPU kernel's
// (acc * s).astype(x.dtype): __fmul_rn, then round to nearest even — no
// FMA contraction, no fast math. Every output element is a sum in a fixed
// order (no atomics), so two calls return the same bits.
//
// bf16 activations: w8_gemm_kernel, on the tensor cores.
//  * Mainloop: a ring of S shared-memory stages of 64-deep k-tiles, filled
//    by TMA S - 1 tiles ahead (one thread issues both boxes of a tile
//    and an mbarrier counts their bytes): the bf16 x box (128-byte
//    swizzled, wgmma's K-major layout) and the int8 weight box as it lies
//    in device memory, so weights cross device memory and L2 at one byte
//    each. TMA fills rows, columns and depth past the tensors with zeros.
//  * Conversion: every thread converts its share of the int8 tile, four
//    values a 32-bit word: the bytes, offset by 128, are permuted into the
//    f32 2^23 + u, 2^23 + 128 is subtracted (exact for -128..127), and
//    cvt.rn.bf16x2.f32 packs two values. The bf16 tile goes once into one
//    of two swizzled tiles, in the MN-major layout wgmma reads with its
//    transpose flag, while the tensor cores multiply the other. Each
//    weight element is converted once per block row of outputs, so wide
//    blocks (256 rows) halve the conversions.
//  * Product: wgmma m64n{64,128,192}k16, bf16 in, f32 accumulators in
//    registers; a warpgroup takes 64 or 128 rows (1 or 2 wgmmas a k16
//    step); each tile's wgmmas run while the next tile converts
//    (wait_group 1, then a block barrier before a tile is reused).
//  * Epilogue: from the accumulator registers: each thread's two columns'
//    scales loaded once, bf16 pairs stored straight to device memory.
//  * Filling the card: the tile (256 x 192, 256 x 128 or 64 x 64) and a
//    split of K are chosen from (M, N, K) by w8_plan in
//    tvc_torch/core/kernels/w8_matmul_kernel.py. With a split, each block
//    stores its f32 sum of one K range into a workspace, and
//    w8_splitk_reduce_kernel adds the ranges in order, scales and rounds.
// f32 activations: w8_gemm_f32_kernel, on the CUDA cores (the tiny and
//   f32 configurations): 64 x 64 output tiles, 16-deep k-tiles, 4 x 4
//   outputs a thread, each summed in k order in f32 (no TF32, which would
//   not be the f32 product), then __fmul_rn by the scale.
//
// Bound. At the Qwen2-1.5B decode batch (M = 960) a layer's GEMMs do
// 2 M K N = 90 G flops on 47 MB of int8 weights, ~1,900 flops per weight
// byte, far above the H100's bf16 ridge (~295 flop/byte): bound by
// operations (~91 us a layer at 989 TF/s). At the prefix prefill (M = 15)
// the same weights carry 30 flops per byte: bound by the weight bytes
// (~14 us a layer at 3.35 TB/s), which the split of K spreads over every
// SM. Rows past M and columns past N load zeros and store nothing; K and
// N are multiples of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

template <int WGS, int MT, int BN, int S>
struct W8Cfg {
  static constexpr int BM = 64 * WGS * MT, kThreads = 128 * WGS;
  static constexpr int kA = BM * 128;       // bytes of an x stage: BM rows of 64 bf16
  static constexpr int kB8 = 64 * BN;       // bytes of an int8 weight stage
  static constexpr int kBbf = 64 * BN * 2;  // bytes of a bf16 weight tile (BN / 64 atoms)
  static constexpr size_t kSmem = (size_t)S * (kA + kB8) + 2 * (size_t)kBbf + 8 * S + 1024;
};

// 16 int8 -> 16 bf16, exactly
__device__ __forceinline__ void int8x16_to_bf16(const uint4& raw, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) f[b] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + b)) - 8388736.f;
    o[2 * i] = pack_bf16(f[0], f[1]);
    o[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// One block: BM x BN outputs over local k-tiles [kt0, kt0 + n) of 64,
// kt0 = blockIdx.z * per; warpgroup w takes rows [w MT 64, (w + 1) MT 64).
// ws == nullptr: scaled bf16 to out; else the raw f32 sums to
// ws[blockIdx.z] (split K). tmx: x [M, K] bf16, 64 x BM boxes, 128-byte
// swizzle; tmw: w [K, N] int8, BN x 64 boxes. Rows, columns and depth past
// the tensors arrive as zeros.
template <int WGS, int MT, int BN, int S>
__global__ void __launch_bounds__(128 * WGS, 1)
    w8_gemm_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                   const float* __restrict__ scale, bf16* __restrict__ out, float* __restrict__ ws, int M, int N,
                   int K, int per) {
  using C = W8Cfg<WGS, MT, BN, S>;
  constexpr int PD = S - 1;     // tiles in flight ahead of the one multiplied
  constexpr int kWc = BN / 16;  // 16-byte int8 chunks of a weight row
  constexpr int kAcc = BN / 2;  // accumulator floats a thread, per 64-row sub-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_s = (raw + 1023) & ~1023u;
  const uint32_t bbf_s = a_s + S * C::kA, b8_s = bbf_s + 2 * C::kBbf, bar_s = b8_s + S * C::kB8;
  unsigned char* bbf_g = smem_raw + (bbf_s - raw);
  const unsigned char* b8_g = smem_raw + (b8_s - raw);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * per;
  const int n = min(per, (K + 63) / 64 - kt0);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) mbar_init(bar_s + 8 * i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int t) {  // one thread: tile t's x and weight boxes into slot t % S
    const int slot = t % S, k0 = (kt0 + t) * 64;
    const uint32_t bar = bar_s + 8 * slot;
    mbar_expect_tx(bar, C::kA + C::kB8);
    tma_load_2d(a_s + slot * C::kA, &tmx, k0, m0, bar);
    tma_load_2d(b8_s + slot * C::kB8, &tmw, n0, k0, bar);
  };
  auto convert = [&](int t) {
    const unsigned char* src = b8_g + (t % S) * C::kB8;
    unsigned char* dst = bbf_g + (t & 1) * C::kBbf;
#pragma unroll
    for (int c = tid; c < 64 * kWc; c += C::kThreads) {
      const int r = c / kWc, col = (c % kWc) * 16, atom = col >> 6, cc = (col & 63) >> 3;
      uint4 lo, hi;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(src + c * 16), lo, hi);
      *reinterpret_cast<uint4*>(dst + atom * 8192 + sw128(r, cc)) = lo;
      *reinterpret_cast<uint4*>(dst + atom * 8192 + sw128(r, cc + 1)) = hi;
    }
  };

  float acc[MT][kAcc];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[m][i] = 0.f;

  if (tid == 0) {
    for (int t = 0; t < PD && t < n; ++t) issue(t);
  }
  mbar_wait(bar_s, 0);
  convert(0);
  fence_proxy_async();
  __syncthreads();
  for (int t = 0; t < n; ++t) {
    // tile t: x in slot t % S, bf16 weights in tile t % 2, both in place
    const uint32_t b_t = bbf_s + (t & 1) * C::kBbf;
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(b_t + kk * 2048, 8192, kSbo);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint64_t da = desc_sw128(a_s + (t % S) * C::kA + (wg * MT + m) * 8192 + kk * 32, 16, kSbo);
        if constexpr (BN == 192) {
          wgmma_m64n192_ss<1>(acc[m], da, db, 1);
        } else if constexpr (BN == 128) {
          wgmma_m64n128_ss<1>(acc[m], da, db, 1);
        } else {
          wgmma_m64n64_ss<1>(acc[m], da, db, 1);
        }
      }
    }
    wgmma_commit();
    if (t + 1 < n) mbar_wait(bar_s + 8 * ((t + 1) % S), ((t + 1) / S) & 1);  // tile t + 1 has landed
    wgmma_wait<1>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    // every warpgroup's wgmmas of tile t - 1 are done: its x slot and bf16
    // tile are free
    __syncthreads();
    if (tid == 0 && t + PD < n) issue(t + PD);
    if (t + 1 < n) {
      convert(t + 1);  // while the tensor cores work on tile t
      fence_proxy_async();
    }
    __syncthreads();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs(acc[m]);

  float* wsz = ws ? ws + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int rA = m0 + (wg * MT + m) * 64 + warp * 16 + (lane >> 2), rB = rA + 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= N) continue;
      const float* d = acc[m] + 4 * j;
      if (wsz) {
        if (rA < M) *reinterpret_cast<float2*>(wsz + (size_t)rA * N + col) = make_float2(d[0], d[1]);
        if (rB < M) *reinterpret_cast<float2*>(wsz + (size_t)rB * N + col) = make_float2(d[2], d[3]);
      } else {
        const float2 sc = *reinterpret_cast<const float2*>(scale + col);
        if (rA < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rA * N + col) =
              __floats2bfloat162_rn(__fmul_rn(d[0], sc.x), __fmul_rn(d[1], sc.y));
        if (rB < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rB * N + col) =
              __floats2bfloat162_rn(__fmul_rn(d[2], sc.x), __fmul_rn(d[3], sc.y));
      }
    }
  }
}

// out = bf16((ws[0] + ws[1] + ... + ws[splits - 1]) * scale), in that order
__global__ void __launch_bounds__(256)
    w8_splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale, bf16* __restrict__ out,
                            int M, int N, int splits) {
  const size_t e = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  const size_t MN = (size_t)M * N;
  if (e >= MN) return;
  float2 s = *reinterpret_cast<const float2*>(ws + e);
  for (int z = 1; z < splits; ++z) {
    const float2 p = *reinterpret_cast<const float2*>(ws + z * MN + e);
    s.x = __fadd_rn(s.x, p.x);
    s.y = __fadd_rn(s.y, p.y);
  }
  const float2 sc = *reinterpret_cast<const float2*>(scale + e % N);
  *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(__fmul_rn(s.x, sc.x), __fmul_rn(s.y, sc.y));
}

__global__ void __launch_bounds__(256)
    w8_gemm_f32_kernel(const float* __restrict__ X, const int8_t* __restrict__ Wq, const float* __restrict__ scale,
                       float* __restrict__ out, int M, int N, int K) {
  __shared__ float As[16][64];  // [k][m]
  __shared__ float Bs[16][64];  // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int i = tid; i < 16 * 64; i += 256) {
      const int r = i >> 4, kk = i & 15;
      As[kk][r] = (m0 + r < M && k0 + kk < K) ? X[(size_t)(m0 + r) * K + k0 + kk] : 0.f;
      const int kb = i >> 6, c = i & 63;
      Bs[kb][c] = (k0 + kb < K && n0 + c < N) ? (float)Wq[(size_t)(k0 + kb) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (r < M && c < N) out[(size_t)r * N + c] = __fmul_rn(acc[i][j], scale[c]);
    }
  }
}

template <int WGS, int MT, int BN, int S>
int launch_w8(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K,
              int splits, int per, cudaStream_t stream) {
  using C = W8Cfg<WGS, MT, BN, S>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(w8_gemm_kernel<WGS, MT, BN, S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap tmx, tmw;
  if (!make_map_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 64, C::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, BN, 64, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + C::BM - 1) / C::BM, splits);
  w8_gemm_kernel<WGS, MT, BN, S><<<grid, C::kThreads, C::kSmem, stream>>>(
      tmx, tmw, (const float*)scale, (bf16*)out, splits > 1 ? (float*)ws : nullptr, M, N, K, per);
  if (splits > 1) {
    const size_t pairs = (size_t)M * N / 2;
    w8_splitk_reduce_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
        (const float*)ws, (const float*)scale, (bf16*)out, M, N, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out bf16 [M, N] = (x bf16 [M, K] . bf16(w int8 [K, N])) * scale f32 [N]
// on bm x bn tiles (256 x 192, 256 x 128 or 64 x 64) over
// `splits` ranges of `per` 64-deep k-tiles; ws: f32 [splits, M, N] when
// splits > 1. K and N multiples of 16; x and w 16-byte aligned.
extern "C" int tvc_w8_matmul(const void* x, const void* w, const void* scale, void* out, void* ws,
                             int M, int N, int K, int bm, int bn, int splits, int per, void* stream) {
  if (K % 16 != 0 || N % 16 != 0 || splits < 1 || per < 1 || (splits - 1) * per >= (K + 63) / 64)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 256 && bn == 192) return launch_w8<2, 2, 192, 4>(x, w, scale, out, ws, M, N, K, splits, per, s);
  if (bm == 256 && bn == 128) return launch_w8<2, 2, 128, 4>(x, w, scale, out, ws, M, N, K, splits, per, s);
  if (bm == 64 && bn == 64) return launch_w8<1, 1, 64, 6>(x, w, scale, out, ws, M, N, K, splits, per, s);
  return (int)cudaErrorInvalidValue;
}

// out f32 [M, N] = (x f32 [M, K] . f32(w int8 [K, N])) * scale f32 [N]
extern "C" int tvc_w8_matmul_f32(const void* x, const void* w, const void* scale, void* out,
                                 int M, int N, int K, void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    w8_gemm_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int8_t*)w, (const float*)scale, (float*)out, M, N, K);
  }
  return (int)cudaGetLastError();
}
