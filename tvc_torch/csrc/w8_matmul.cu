// Weight-only int8 GEMM for Hopper (sm_90a): the Qwen2 decode's "w8" GEMM.
//
// Replaces the TPU kernels tvc/core/pallas/w8_matmul_kernel.py w8_matmul
// (body _w8_matmul_kernel) and, on a layer's zero-copy view of the stacked
// [L, K, N] weights, w8_matmul_stacked (_w8_stacked_kernel):
//   y[M, N] = bf16( (x . bf16(Wq)) * scale[n] )
// with x bf16 [M, K], Wq int8 [K, N] (per-output-channel symmetric, from
// quantize_linear) and scale f32 [N]. The int8 weights are converted to
// bf16 exactly (|v| <= 128 fits bf16's 8-bit significand), the products
// are summed in f32 on the tensor cores, and the epilogue is the TPU
// kernel's (acc * s).astype(x.dtype): __fmul_rn, then round to nearest
// even bf16 — no FMA contraction, no fast math.
//
// Tiling: 128x128x32 block tiles, 8 warps each holding a 32x64 block of
// 16x16x16 bf16 WMMA fragments with f32 accumulators. Each k-tile stages
// the x tile (bf16, two 16-byte loads a thread) and the weight tile (int8,
// one 16-byte load a thread, converted to 16 bf16 on the way into shared
// memory); the next k-tile is loaded into registers while the tensor cores
// work on the current one. The M edge is guarded (rows past M load zeros
// and store nothing: the slice runs M = 15 and M = 960); K and N are
// multiples of 16. No split-K and no atomics: each output element is one
// block's sum in a fixed order, so results repeat bit for bit run to run.
//
// Bound. At the Qwen2-1.5B decode batch (M = 960) a layer's GEMMs do
// 2 M K N = 90 G flops on 47 MB of int8 weights, ~1,900 flops per weight
// byte, far above the H100's bf16 ridge (~295 flop/byte): bound by
// operations (~91 us a layer at 989 TF/s). At the prefix prefill (M = 15)
// the same weights carry 30 flops per byte: bound by the weight bytes
// (~14 us a layer at 3.35 TB/s). What the design does about the first:
// tensor-core fragments on a 128x128 tile reuse every staged weight
// element 128 times; about the second: int8 weights are read once, one
// byte each, and never written back as bf16. This first version uses WMMA
// (mma.sync-level) fragments, whose peak is below wgmma's, and no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;
constexpr int kLdA = BK + 8;  // padded leading dimensions (multiples of 8)
constexpr int kLdB = BN + 8;

// 16 int8 -> 16 bf16 (exact), as two 16-byte vectors
__device__ __forceinline__ void int8x16_to_bf16(const uint4& raw, uint4& lo, uint4& hi) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  bf16* l = reinterpret_cast<bf16*>(&lo);
  bf16* h = reinterpret_cast<bf16*>(&hi);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    l[q] = __float2bfloat16_rn(static_cast<float>(e[q]));
    h[q] = __float2bfloat16_rn(static_cast<float>(e[q + 8]));
  }
}

__global__ void __launch_bounds__(kThreads)
    w8_gemm_kernel(const bf16* __restrict__ X, const int8_t* __restrict__ Wq,
                   const float* __restrict__ scale, bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[BM][kLdA];
  __shared__ __align__(128) bf16 Bs[BK][kLdB];
  __shared__ __align__(128) float scratch[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 ra[2], rb;
  // x tile: 128 rows x 32 cols = 512 chunks of 8 bf16; weight tile: 32 rows
  // x 128 int8 = 256 chunks of 16 bytes
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      const int gm = m0 + r, gk = k0 + col;
      ra[i] = (gm < M && gk < K) ? *reinterpret_cast<const uint4*>(X + (size_t)gm * K + gk) : zero;
    }
    const int kr = tid >> 3, nc = (tid & 7) * 16;
    const int gk = k0 + kr, gn = n0 + nc;
    rb = (gk < K && gn < N) ? *reinterpret_cast<const uint4*>(Wq + (size_t)gk * N + gn) : zero;
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[c >> 2][(c & 3) * 8]) = ra[i];
    }
    uint4 lo, hi;
    int8x16_to_bf16(rb, lo, hi);
    const int kr = tid >> 3, nc = (tid & 7) * 16;
    *reinterpret_cast<uint4*>(&Bs[kr][nc]) = lo;
    *reinterpret_cast<uint4*>(&Bs[kr][nc + 8]) = hi;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int wm = warp >> 1;  // rows wm*32 .. +32
  const int wn = warp & 1;   // cols wn*64 .. +64
  const int nk = (K + BK - 1) / BK;
  load_tiles(0);
  for (int kt = 0; kt < nk; ++kt) {
    store_tiles();
    __syncthreads();
    if (kt + 1 < nk) load_tiles((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &Bs[kk][wn * 64 + j * 16], kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, one 16x16 fragment at a time through the warp's scratch tile:
  // (acc * scale[n]) rounded to bf16
  float* sc = scratch[warp];
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
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int q = 0; q < 8; ++q) oe[q] = __float2bfloat16_rn(__fmul_rn(sc[r * 16 + c0 + q], scale[gn + q]));
        *reinterpret_cast<uint4*>(out + (size_t)gm * N + gn) = o;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// out bf16 [M, N] = (x bf16 [M, K] . bf16(w int8 [K, N])) * scale f32 [N].
// K and N multiples of 16; x and w 16-byte aligned.
extern "C" int tvc_w8_matmul(const void* x, const void* w, const void* scale, void* out,
                             int M, int N, int K, void* stream) {
  if (K % 16 != 0 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  if (M > 0 && N > 0) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    w8_gemm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const int8_t*)w, (const float*)scale, (bf16*)out, M, N, K);
  }
  return (int)cudaGetLastError();
}
