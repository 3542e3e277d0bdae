// Pre-LN transformer sub-blocks for Hopper (sm_90a): the attention layer
// and the MLP layer of the CLIP towers.
//
// Replaces the TPU kernels tvc/core/pallas/attention_layer_kernel.py
// (fused_attention_layer, body _attn_layer_kernel; fused_mlp_layer, body
// _mlp_layer_kernel):
//   attention: out = x + W_out . MHA(split(W_qkv . LN(x) + b_qkv)) + b_out
//   mlp:       out = x + W_proj . quick_gelu(W_fc . LN(x) + b_fc) + b_proj
// with the TPU kernel's numerics: LayerNorm (eps 1e-5) and softmax in f32,
// every GEMM on bf16 operands with f32 accumulation, the GEMM outputs
// rounded to bf16 where the TPU kernel rounds them (qkv, attention output,
// GELU output), bias and residual added in f32, output rounded to bf16.
//
// Two kernels, launched in sequence by the Python wrappers:
//  * ln_gemm_kernel: C[M, N] = epilogue(prologue(A)[M, K] . W[K, N]) with
//    W in the JAX layout [in, out]. Prologue: optional LayerNorm of the A
//    rows in f32 (row statistics computed by the block first). Epilogue:
//    + bias, then nothing, quick_gelu, or + residual. 128x128x32 tiles,
//    8 warps each holding a 32x64 block of 16x16x16 bf16 WMMA accumulators
//    in f32; the next k-tile is loaded into registers while the tensor
//    cores work on the current one.
//  * head_attention_tc_kernel<bf16> (head_attention.cuh): 64 query rows
//    of one (sequence, head) a block, any T, Q.K^T and P.V by wgmma on the
//    tensor cores; f32 softmax, weights rounded to bf16, P.V accumulated in
//    f32 and rounded to bf16.
//
// Bound: operations. A layer's GEMMs do 2 M K N flops on 2 (M K + K N + M N)
// bytes: at ViT-B/32 (M = 64 x 50, K = 768) that is ~600 flops per byte,
// above the H100's 295 flop/byte bf16 ridge. Why not one kernel as on the
// TPU: the TPU kernel keeps the whole [W, 3W] weight and a block of
// sequences resident in its many-MB VMEM. A Hopper block has at most
// 227 KB of shared memory, and one ViT-B/32 sequence's bf16 qkv alone is
// 50 x 2304 x 2 = 230 KB. So an attention layer is three launches
// (LN+QKV GEMM -> per-head attention -> out-proj+bias+residual GEMM) and an
// MLP layer two (LN+fc+GELU GEMM -> proj+bias+residual GEMM); the [M, 3W]
// qkv, the [M, W] attention output and the [M, 4W] hidden go through
// device memory. Fusing them back (a persistent kernel with wgmma and TMA)
// is later work. This first version uses mma.sync-level WMMA fragments,
// whose peak is below wgmma's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "head_attention.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kGemmThreads = 256;
constexpr int kLdA = BK + 8;  // padded leading dimensions (multiples of 8)
constexpr int kLdB = BN + 8;

enum Epilogue { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

template <bool HAS_LN, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    ln_gemm_kernel(const bf16* __restrict__ A, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, const bf16* __restrict__ Wt,
                   const float* __restrict__ bias, const bf16* __restrict__ res,
                   bf16* __restrict__ out, int M, int N, int K, float eps) {
  __shared__ __align__(128) bf16 As[BM][kLdA];
  __shared__ __align__(128) bf16 Bs[BK][kLdB];
  __shared__ __align__(128) float scratch[kGemmThreads / 32][16 * 16];
  __shared__ float row_mean[BM];
  __shared__ float row_rstd[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (HAS_LN) {
    // two-pass f32 row statistics, as the TPU kernel: mean((x - mean)^2)
    for (int r = warp; r < BM; r += kGemmThreads / 32) {
      const int gm = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (gm < M) {
        const __nv_bfloat162* row = reinterpret_cast<const __nv_bfloat162*>(A + (size_t)gm * K);
        float s = 0.f;
        for (int i = lane; i < K / 2; i += 32) {
          const float2 f = __bfloat1622float2(row[i]);
          s += f.x + f.y;
        }
        mean = warp_sum(s) / K;
        float s2 = 0.f;
        for (int i = lane; i < K / 2; i += 32) {
          const float2 f = __bfloat1622float2(row[i]);
          const float a = f.x - mean, b = f.y - mean;
          s2 += a * a + b * b;
        }
        rstd = rsqrtf(warp_sum(s2) / K + eps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 ra[2], rb[2];
  // A tile: 128 rows x 32 cols = 512 chunks of 8 bf16; W tile: 32 x 128
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      const int gm = m0 + r, gk = k0 + col;
      ra[i] = (gm < M && gk < K) ? *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk) : zero;
      const int kr = c >> 4, coln = (c & 15) * 8;
      const int gk2 = k0 + kr, gn = n0 + coln;
      rb[i] = (gk2 < K && gn < N) ? *reinterpret_cast<const uint4*>(Wt + (size_t)gk2 * N + gn) : zero;
    }
  };
  auto store_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      uint4 v = ra[i];
      if (HAS_LN) {
        const int gk = k0 + col;
        if (gk < K) {
          bf16* e = reinterpret_cast<bf16*>(&v);
          const float mu = row_mean[r], rs = row_rstd[r];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float x = __bfloat162float(e[q]);
            e[q] = __float2bfloat16((x - mu) * rs * ln_g[gk + q] + ln_b[gk + q]);
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[r][col]) = v;
      const int kr = c >> 4, coln = (c & 15) * 8;
      *reinterpret_cast<uint4*>(&Bs[kr][coln]) = rb[i];
    }
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
    store_tiles(kt * BK);
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

  // epilogue, one 16x16 fragment at a time through the warp's scratch tile
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
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = sc[r * 16 + c0 + q] + bias[gn + q];
        if (EPI == EPI_GELU) {
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = v[q] / (1.f + expf(-1.702f * v[q]));
        }
        if (EPI == EPI_RESIDUAL) {
          const uint4 rv = *reinterpret_cast<const uint4*>(res + (size_t)gm * N + gn);
          const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(re[q]) + v[q];
        }
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int q = 0; q < 8; ++q) oe[q] = __float2bfloat16(v[q]);
        *reinterpret_cast<uint4*>(out + (size_t)gm * N + gn) = o;
      }
      __syncwarp();
    }
  }
}

template <bool HAS_LN, int EPI>
void launch_gemm(const void* a, const void* g, const void* b, const void* w,
                 const void* bias, const void* res, void* out, int M, int N,
                 int K, float eps, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ln_gemm_kernel<HAS_LN, EPI><<<grid, kGemmThreads, 0, stream>>>(
      (const bf16*)a, (const float*)g, (const float*)b, (const bf16*)w,
      (const float*)bias, (const bf16*)res, (bf16*)out, M, N, K, eps);
}

}  // namespace

extern "C" int tvc_ln_gemm(const void* a, const void* ln_scale,
                           const void* ln_bias, const void* w,
                           const void* bias, const void* residual, void* out,
                           int M, int N, int K, float eps, int has_ln,
                           int epilogue, void* stream) {
  if (M > 0 && N > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (has_ln && epilogue == EPI_BIAS)
      launch_gemm<true, EPI_BIAS>(a, ln_scale, ln_bias, w, bias, residual, out, M, N, K, eps, s);
    else if (has_ln && epilogue == EPI_GELU)
      launch_gemm<true, EPI_GELU>(a, ln_scale, ln_bias, w, bias, residual, out, M, N, K, eps, s);
    else if (!has_ln && epilogue == EPI_RESIDUAL)
      launch_gemm<false, EPI_RESIDUAL>(a, ln_scale, ln_bias, w, bias, residual, out, M, N, K, eps, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int tvc_head_attention(const void* qkv, void* out, int seqs, int T,
                                  int W, int heads, int causal, void* stream) {
  return launch_head_attention<bf16>(qkv, out, seqs, T, W, heads, causal, (cudaStream_t)stream);
}
