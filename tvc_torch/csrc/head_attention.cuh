// Per-(sequence, head) softmax attention for Hopper (sm_90a). Shared by
// attention_layer.cu (bf16 layer: P.V rounded to bf16), quantized_layer.cu
// (int8 layer: P.V kept in f32 until it is quantized) and mha.cu (the
// standalone multi-head attention on [B, T, H, D] q, k, v), each of which
// compiles its own copy; decode_attention.cu takes its tail path.
//
// The kernels read q, k and v through three base pointers and one row
// stride `ld` (elements): row t of sequence s, head h starts at
// base + (s * T + t) * ld + h * D. The layer kernels pass the packed
// [seqs * T, 3W] q | k | v activation (bases qkv, qkv + W, qkv + 2W,
// ld = 3W); mha.cu passes three [B, T, H, D] tensors (ld = H * D, or the
// row stride of q | k | v views of a packed projection). out is
// [seqs * T, H * D]. Head widths 32 and 64 on the two kernels below, any
// other on the tail path (attention_rows_kernel, which decode_attention.cu
// launches too).
//
// What every path computes (the TPU kernels' function and rounding
// points): logits = (q . k summed in f32) * scale, the scale applied after
// the dot; the optional causal mask (key <= query); an f32 softmax whose
// normalizer is the row's sum of exp(s - m) with m the row's max; the
// normalized weights rounded to bf16 for bf16 operands (f32 operands keep
// f32 weights); P.V summed in f32, rounded once to the output type.
//
// bf16 operands: head_attention_tc_kernel, on the tensor cores, any T.
//   A block (one warpgroup) takes 64 query rows of one (sequence, head),
//   with the q tile in shared memory, and walks the 64-row key tiles twice
//   through a 2-stage ring that one thread fills by TMA. Sweep 1: S = Q.K^T by wgmma
//   (m64n64k16, f32 accumulators in registers), scaled and masked; the
//   row max and the normalizer kept by online rescaling (l = l e^(m - m')
//   + sum e^(s - m')), so sweep 1 reads only k. Sweep 2: S recomputed tile
//   by tile, P = bf16(e^(s - m) * (1 / l)) formed in the accumulator
//   registers, which are already wgmma's A-operand layout, and O += P.V by
//   wgmma with A from registers and v read MN-major from shared memory.
//   Flash attention's unnormalized rescaled accumulator is not used: the
//   TPU kernels round the normalized weights to bf16, and so does this.
//   Against a softmax with the exact max and an exact division, the online
//   normalizer and the reciprocal differ by a few f32 ulps, which moves a
//   weight across a bf16 rounding boundary now and then (an output moves
//   by at most 2^-8 |w v|): the tolerance of the bf16 outputs, 1e-2 of
//   max(1, |y|), holds it. Work: 6 T^2 D flops per (b, h) (Q.K^T twice).
//   e^x is taken as 2^(x log2 e) on the special-function unit, with the
//   subtraction of the max folded into the multiply (one FFMA), and it is
//   skipped for warps that hold no query row and for key columns past T
//   (it would be 0). What holds it back: the tile loads (the `noload`
//   ablation of scripts/compare_head_attention.py runs ~25 % faster at
//   ViT-L/14) and the second Q.K^T.
// f32 operands: head_attention_kernel, on the CUDA cores (tensor cores
//   would mean TF32, which the f32 function excludes), any T: 64 query rows
//   a block of 256 threads, 4 x 4 logits a thread, 64-row key tiles in
//   ~66 KB of shared memory at D = 64 whatever T is, and the same two
//   sweeps as the bf16 kernel (online max and sum, then the logits again,
//   the f32 weights e^(s - m) / l by a division, P.V in f32). e^x is expf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// The f32 kernel: 64 query rows of one (sequence, head) a block of 256
// threads (16 x 16, each a 4 x 4 tile of logits: rows 4 ty + a, keys
// 4 tx + b), 64-row key tiles in shared memory whose size does not depend
// on T: q and k transposed ([d][row], so that a thread's four rows or keys
// at one d are one 16-byte read), v as it lies ([key][d]), and the weights
// P ([row][key], rows padded by 4 floats).
constexpr int kF32Rows = 64;
constexpr int kF32Threads = 256;
constexpr int kF32PLd = kF32Rows + 4;

template <int D>
struct F32AttnSmem {
  static constexpr size_t kBytes = (size_t)(3 * D * kF32Rows + kF32Rows * kF32PLd) * sizeof(float);
};

__device__ __forceinline__ void store_pair(bf16* o, float o0, float o1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(o0, o1);
}
__device__ __forceinline__ void store_pair(float* o, float o0, float o1) {
  *reinterpret_cast<float2*>(o) = make_float2(o0, o1);
}

// Rows t0.. of head h of one sequence (row stride ld) into [D][64]
// (transposed) or [64][D]; rows at or past T are zeros.
template <int D, bool kTransposed>
__device__ __forceinline__ void f32_tile(float* dst, const float* __restrict__ src, size_t row0, int t0, int T,
                                         int ld, int h) {
  constexpr int kParts = D / 4;  // 16-byte pieces of a row
  for (int c = threadIdx.x; c < kF32Rows * kParts; c += kF32Threads) {
    // transposed: neighbouring threads take neighbouring rows (the
    // scattered stores then hit 32 banks); else neighbouring pieces
    const int t = kTransposed ? c % kF32Rows : c / kParts;
    const int part = kTransposed ? c / kF32Rows : c % kParts;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + t < T) x = *reinterpret_cast<const float4*>(src + (row0 + t0 + t) * (size_t)ld + (size_t)h * D + 4 * part);
    if constexpr (kTransposed) {
      dst[(4 * part + 0) * kF32Rows + t] = x.x;
      dst[(4 * part + 1) * kF32Rows + t] = x.y;
      dst[(4 * part + 2) * kF32Rows + t] = x.z;
      dst[(4 * part + 3) * kF32Rows + t] = x.w;
    } else {
      *reinterpret_cast<float4*>(dst + t * D + 4 * part) = x;
    }
  }
}

// Sweep 1: the row max and the sum of exp(s - m), by online rescaling
// (l = l e^(m - m') + sum e^(s - m')); sweep 2: the logits again, the f32
// weights e^(s - m) / l (not rounded: f32 operands keep f32 weights) and
// O += P.V in f32. Each thread sums its keys and dot products in
// ascending order and the 16 threads of a row combine by a fixed shuffle
// tree, so two calls give the same bits.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    head_attention_kernel(const float* __restrict__ qg, const float* __restrict__ kg,
                          const float* __restrict__ vg, float* __restrict__ out, int ld,
                          int T, int H, int causal, float scale) {
  static_assert(D == 32 || D == 64, "head width 32 or 64");
  constexpr int kCB = D / 16;  // output columns a thread
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                       // [D][64]
  float* ks = qs + D * kF32Rows;         // [D][64]
  float* vs = ks + D * kF32Rows;         // [64][D]
  float* ps = vs + kF32Rows * D;         // [64][kF32PLd]

  const int qt = blockIdx.y, seq = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = qt * kF32Rows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t row0 = (size_t)seq * T;
  const int nkt = causal ? qt + 1 : (T + kF32Rows - 1) / kF32Rows;

  f32_tile<D, true>(qs, qg, row0, q0, T, ld, h);

  float m[4], l[4], o[4][kCB];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < kCB; ++j) o[a][j] = 0.f;
  }

  // s = the logits of this thread's 4 x 4 tile of key tile kt: masked keys
  // (past T; causal: after the row) -inf
  auto logits = [&](int kt, float (&s)[4][4]) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 x = *reinterpret_cast<const float4*>(qs + d * kF32Rows + 4 * ty);
      const float4 y = *reinterpret_cast<const float4*>(ks + d * kF32Rows + 4 * tx);
      const float xa[4] = {x.x, x.y, x.z, x.w}, yb[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(xa[a], yb[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int row = q0 + 4 * ty + a, col = kt * kF32Rows + 4 * tx + b;
        s[a][b] = (col < T && (!causal || col <= row)) ? __fmul_rn(s[a][b], scale) : -INFINITY;
      }
  };

  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // the previous tile's readers are done (and q is written)
    f32_tile<D, true>(ks, kg, row0, kt * kF32Rows, T, ld, h);
    __syncthreads();
    float s[4][4];
    logits(kt, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float x = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      const float mn = fmaxf(m[a], x);  // finite: every key tile holds a key of every row
      float e = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) e += expf(s[a][b] - mn);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
      l[a] = l[a] * expf(m[a] - mn) + e;
      m[a] = mn;
    }
  }

  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    f32_tile<D, true>(ks, kg, row0, kt * kF32Rows, T, ld, h);
    f32_tile<D, false>(vs, vg, row0, kt * kF32Rows, T, ld, h);
    __syncthreads();
    float s[4][4];
    logits(kt, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float4 p;
      p.x = __fdiv_rn(expf(s[a][0] - m[a]), l[a]);
      p.y = __fdiv_rn(expf(s[a][1] - m[a]), l[a]);
      p.z = __fdiv_rn(expf(s[a][2] - m[a]), l[a]);
      p.w = __fdiv_rn(expf(s[a][3] - m[a]), l[a]);
      *reinterpret_cast<float4*>(ps + (4 * ty + a) * kF32PLd + 4 * tx) = p;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kF32Rows; j += 4) {
      float p[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 x = *reinterpret_cast<const float4*>(ps + (4 * ty + a) * kF32PLd + j);
        p[a][0] = x.x, p[a][1] = x.y, p[a][2] = x.z, p[a][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kCB];
        if constexpr (kCB == 4) {
          const float4 y = *reinterpret_cast<const float4*>(vs + (j + jj) * D + 4 * tx);
          vv[0] = y.x, vv[1] = y.y, vv[2] = y.z, vv[3] = y.w;
        } else {
          const float2 y = *reinterpret_cast<const float2*>(vs + (j + jj) * D + 2 * tx);
          vv[0] = y.x, vv[1] = y.y;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cb = 0; cb < kCB; ++cb) o[a][cb] = fmaf(p[a][jj], vv[cb], o[a][cb]);
      }
    }
  }

  const int W = H * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ty + a;
    if (row < T) {
#pragma unroll
      for (int cb = 0; cb < kCB; cb += 2)
        store_pair(out + (row0 + row) * W + (size_t)h * D + kCB * tx + cb, o[a][cb], o[a][cb + 1]);
    }
  }
}

// The tensor-core kernel: 64 query rows a block, 64-row key tiles.
constexpr int kTcRows = 64;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (what __expf runs after its multiply)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kTcTile = kTcRows * 128;                        // bytes of one swizzled tile
constexpr size_t kTcSmem = 5 * (size_t)kTcTile + 1024 + 3 * 8;  // q, k x 2, v x 2, alignment, barriers

// q, k and v arrive through 3-d tensor maps (columns of a row, rows of a
// sequence, sequences) in 64 x 64 x 1 boxes with the 128-byte swizzle: the
// box at (h D, t0, seq) is the tile of rows t0.. of head h, rows past T
// arriving as zeros. At D = 32 its right half holds the next head's
// columns (zeros past the last head), which no wgmma reads.
template <typename OutT, int D>
__global__ void __launch_bounds__(128)
    head_attention_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv, OutT* __restrict__ out, int T, int H,
                             int causal, float scale) {
  static_assert(D == 32 || D == 64, "head width 32 or 64");
  using namespace hopper;
  constexpr int kO = D / 2;  // accumulator floats of P.V a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // 128-byte swizzle needs 1024-byte tiles
  const uint32_t bar_s = q_s + 5 * kTcTile;     // mbarriers: q, then ring slots 0 and 1
  auto k_slot = [&](int i) { return q_s + (uint32_t)kTcTile * (1 + (i & 1)); };
  auto v_slot = [&](int i) { return q_s + (uint32_t)kTcTile * (3 + (i & 1)); };

  const int ntiles = (T + kTcRows - 1) / kTcRows;
  const int qt = blockIdx.y, seq = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = qt * kTcRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)seq * T;
  const int nkt = causal ? qt + 1 : ntiles;  // key tiles this block needs
  const int nsteps = 2 * nkt;                // sweep 1, then sweep 2
  // warp-uniform: the warp holds a query row (else its softmax is skipped
  // and its P rows are zeros), and the 8-column groups of a key tile that
  // hold a key (exp(-inf) = 0 is not computed)
  const bool live = q0 + warp * 16 < T;

  // one thread: step i's k tile (and in sweep 2 its v tile) into slot i % 2
  auto load_step = [&](int i) {
    const int kt = i < nkt ? i : i - nkt;
    const uint32_t bar = bar_s + 8 * (1 + (i & 1));
    mbar_expect_tx(bar, i < nkt ? kTcTile : 2 * kTcTile);
    tma_load_3d(k_slot(i), &mk, h * D, kt * kTcRows, seq, bar);
    if (i >= nkt) tma_load_3d(v_slot(i), &mv, h * D, kt * kTcRows, seq, bar);
  };
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < 3; ++b) mbar_init(bar_s + 8 * b, 1);
    fence_mbar_init();
    mbar_expect_tx(bar_s, kTcTile);
    tma_load_3d(q_s, &mq, h * D, q0, seq, bar_s);
    load_step(0);
  }
  __syncthreads();  // the barriers are initialized before anyone waits on them

  const int rA = q0 + warp * 16 + (lane >> 2), rB = rA + 8;  // this thread's two query rows
  const int cq = 2 * (lane & 3);
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f, invA = 0.f, invB = 0.f;
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;

  mbar_wait(bar_s, 0);
  for (int i = 0; i < nsteps; ++i) {
    // slot (i + 1) % 2 was freed by step i - 1's closing barrier
    if (tid == 0 && i + 1 < nsteps) load_step(i + 1);
    mbar_wait(bar_s + 8 * (1 + (i & 1)), (i >> 1) & 1);

    const int kt = i < nkt ? i : i - nkt;
    const int groups = min(8, (T - kt * kTcRows + 7) / 8);
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_m64n64_ss<0>(s, desc_sw128(q_s + kk * 32, 16, kSbo), desc_sw128(k_slot(i) + kk * 32, 16, kSbo),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // logits: the f32 dot times the scale; masked keys -inf (only the last
    // key tile and, causal, the diagonal tile hold masked keys)
    if (live) {
      if ((kt + 1) * kTcRows > T || (causal && kt == qt)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kt * kTcRows + 8 * j + cq + e;
            const bool in = col < T;
            s[4 * j + e] = (in && (!causal || col <= rA)) ? s[4 * j + e] * scale : -INFINITY;
            s[4 * j + 2 + e] = (in && (!causal || col <= rB)) ? s[4 * j + 2 + e] * scale : -INFINITY;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] *= scale;
      }
    }

    if (i < nkt) {
      if (live) {
        // sweep 1: the row max and the normalizer, by online rescaling
        float xA = -INFINITY, xB = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xA = fmaxf(xA, fmaxf(s[4 * j], s[4 * j + 1]));
          xB = fmaxf(xB, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int o2 = 1; o2 <= 2; o2 <<= 1) {
          xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, o2));
          xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, o2));
        }
        const float nA = fmaxf(mA, xA), nB = fmaxf(mB, xB);  // finite: key 0 is in every row's first tile
        const float cA = -nA * kLog2e, cB = -nB * kLog2e;
        float sA = 0.f, sB = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < groups) {
            sA += exp2_approx(fmaf(s[4 * j], kLog2e, cA)) + exp2_approx(fmaf(s[4 * j + 1], kLog2e, cA));
            sB += exp2_approx(fmaf(s[4 * j + 2], kLog2e, cB)) + exp2_approx(fmaf(s[4 * j + 3], kLog2e, cB));
          }
        }
#pragma unroll
        for (int o2 = 1; o2 <= 2; o2 <<= 1) {
          sA += __shfl_xor_sync(0xffffffffu, sA, o2);
          sB += __shfl_xor_sync(0xffffffffu, sB, o2);
        }
        lA = lA * exp2_approx((mA - nA) * kLog2e) + sA;
        lB = lB * exp2_approx((mB - nB) * kLog2e) + sB;
        mA = nA;
        mB = nB;
        if (i + 1 == nkt) {
          invA = 1.f / lA;
          invB = 1.f / lB;
          mA = -mA * kLog2e;  // sweep 2 takes e^(s - m) as 2^(s log2(e) - m log2(e))
          mB = -mB * kLog2e;
        }
      }
    } else {
      // sweep 2: normalized weights rounded to bf16, straight into wgmma's
      // A registers, then O += P.V
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = 8 * kk + 2 * q;
          const float c = (q & 1) ? mB : mA, inv = (q & 1) ? invB : invA;
          a[kk][q] = live && 2 * kk + (q >> 1) < groups
                         ? pack_bf16(exp2_approx(fmaf(s[x], kLog2e, c)) * inv,
                                     exp2_approx(fmaf(s[x + 1], kLog2e, c)) * inv)
                         : 0u;
        }
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_sw128(v_slot(i) + kk * 2048, 8 * kTcTile, kSbo);
        if constexpr (D == 64) {
          wgmma_m64n64_rs<1>(o, a[kk], db);
        } else {
          wgmma_m64n32_rs<1>(o, a[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncthreads();  // every warp is done with slot i before step i + 1 refills it
  }

  const size_t W = (size_t)H * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const size_t col = (size_t)h * D + 8 * j + cq;
    if (rA < T) store_pair(out + (row0 + rA) * W + col, o[4 * j], o[4 * j + 1]);
    if (rB < T) store_pair(out + (row0 + rB) * W + col, o[4 * j + 2], o[4 * j + 3]);
  }
}

// Any other shape: attention_rows_kernel, on the CUDA cores, the tail
// path of this header's kernels (head widths other than 32 / 64) and of
// decode_attention.cu (head widths off the tiled kernel's, more than 8
// query heads a KV head); no model the repo configures reaches it, and the
// TPU kernels take any width. One warp a query row, four rows a block;
// the row's q in shared memory as f32, lanes on keys for the logits (each
// lane a key's whole dot product, in d order) and on output columns for
// P.V (256 columns a pass over the keys). Three sweeps of the logits: the
// exact row max, the sum of e^(s - m), then the weights e^(s - m) / l,
// rounded to the operands' type for bf16 as the TPU kernels round them,
// and P.V summed in f32, rounded once to OutT. Any D, rows and keys.
//
// Where the rows lie: a block column g (blockIdx.x) is a group of `rows`
// query rows over one slab of `keys` keys, g = outer * inner + in (outer a
// sequence, in a head, or outer a batch row, in a KV head); query row i of
// it starts at q + outer * q.o + in * q.i + i * q.r, key j at
// k (and v) + outer * kv.o + in * kv.i + j * kv.r, its output at
// out + outer * o.o + in * o.i + i * o.r. `mask`, when not null, is an
// additive f32 [outer, keys] mask added to the scaled logits.
constexpr int kAnyWarps = 4;
constexpr int kAnyCols = 8;  // output columns a lane holds in one pass

struct RowStrides {
  long long o, i, r;  // elements per outer index, inner index and row
};

struct RowLayout {
  int inner;  // groups per outer index
  RowStrides q, kv, o;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_one(float* o, float x) { *o = x; }
__device__ __forceinline__ void store_one(bf16* o, float x) { *o = __float2bfloat16(x); }
__device__ __forceinline__ float weight_in(float p, const float*) { return p; }
__device__ __forceinline__ float weight_in(float p, const bf16*) { return __bfloat162float(__float2bfloat16(p)); }

template <typename InT, typename OutT>
__global__ void __launch_bounds__(32 * kAnyWarps)
    attention_rows_kernel(const InT* __restrict__ qg, const InT* __restrict__ kg, const InT* __restrict__ vg,
                          const float* __restrict__ mask, OutT* __restrict__ out, RowLayout L, int rows, int keys,
                          int D, int causal, float scale) {
  extern __shared__ float any_sm[];  // [kAnyWarps][D] query rows, then [kAnyWarps][32] weights
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int outer = blockIdx.x / L.inner, in = blockIdx.x % L.inner;
  const int row = blockIdx.y * kAnyWarps + warp;
  if (row >= rows) return;  // whole warps: nothing below syncs wider than a warp
  float* qs = any_sm + warp * D;
  float* ps = any_sm + kAnyWarps * D + warp * 32;
  const InT* qr = qg + outer * L.q.o + in * L.q.i + row * L.q.r;
  const InT* kb = kg + outer * L.kv.o + in * L.kv.i;
  const InT* vb = vg + outer * L.kv.o + in * L.kv.i;
  const float* mr = mask ? mask + (size_t)outer * keys : nullptr;
  for (int d = lane; d < D; d += 32) qs[d] = to_f32(qr[d]);
  __syncwarp();
  const int nk = causal ? row + 1 : keys;
  auto logit = [&](int j) {
    const InT* kr = kb + j * L.kv.r;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qs[d], to_f32(kr[d]), s);
    s = __fmul_rn(s, scale);
    return mr ? __fadd_rn(s, mr[j]) : s;
  };
  float m = -INFINITY;
  for (int j = lane; j < nk; j += 32) m = fmaxf(m, logit(j));
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < nk; j += 32) l += expf(logit(j) - m);
  l = warp_sum(l);
  OutT* orow = out + outer * L.o.o + in * L.o.i + row * L.o.r;
  for (int c0 = 0; c0 < D; c0 += 32 * kAnyCols) {
    float o[kAnyCols];
#pragma unroll
    for (int c = 0; c < kAnyCols; ++c) o[c] = 0.f;
    for (int j0 = 0; j0 < nk; j0 += 32) {
      const int j = j0 + lane;
      ps[lane] = j < nk ? weight_in(__fdiv_rn(expf(logit(j) - m), l), qg) : 0.f;
      __syncwarp();
      const int n = min(32, nk - j0);
      for (int jj = 0; jj < n; ++jj) {
        const InT* vr = vb + (j0 + jj) * L.kv.r;
        const float p = ps[jj];
#pragma unroll
        for (int c = 0; c < kAnyCols; ++c) {
          const int col = c0 + lane + 32 * c;
          if (col < D) o[c] = fmaf(p, to_f32(vr[col]), o[c]);
        }
      }
      __syncwarp();  // every lane has read ps before the next keys' weights
    }
#pragma unroll
    for (int c = 0; c < kAnyCols; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < D) store_one(orow + col, o[c]);
    }
  }
}

// The tail path's launch: `groups` groups of `rows` query rows laid out as
// L says, each over `keys` keys; any D >= 1.
template <typename InT, typename OutT>
int launch_attention_rows(const void* q, const void* k, const void* v, const float* mask, void* out,
                          const RowLayout& L, int groups, int rows, int keys, int D, int causal, float scale,
                          cudaStream_t stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  if (groups <= 0 || rows <= 0 || keys <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)kAnyWarps * (D + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(attention_rows_kernel<InT, OutT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(groups, (rows + kAnyWarps - 1) / kAnyWarps);
  attention_rows_kernel<InT, OutT><<<grid, 32 * kAnyWarps, smem, stream>>>(
      (const InT*)q, (const InT*)k, (const InT*)v, mask, (OutT*)out, L, rows, keys, D, causal, scale);
  return (int)cudaGetLastError();
}

// The tail path over `seqs` sequences of T rows and `heads` heads: q, k, v
// with row stride ld, out [seqs * T, heads * D].
template <typename InT, typename OutT>
int launch_head_attention_any(const void* q, const void* k, const void* v, void* out, int ld, int seqs, int T,
                              int heads, int D, int causal, float scale, cudaStream_t stream) {
  const long long seq = (long long)T * ld, W = (long long)heads * D;
  const RowLayout L{heads, {seq, D, ld}, {seq, D, ld}, {T * W, D, W}};
  return launch_attention_rows<InT, OutT>(q, k, v, nullptr, out, L, seqs * heads, T, T, D, causal, scale, stream);
}

// Launch on `stream` over `seqs` sequences of T rows and `heads` heads;
// returns cudaGetLastError() (cudaErrorInvalidValue if a tensor map cannot
// be made).
template <typename InT, typename OutT, int D>
int launch_head_attention_strided(const void* q, const void* k, const void* v, void* out, int ld,
                                  int seqs, int T, int heads, int causal, float scale,
                                  cudaStream_t stream) {
  if (seqs <= 0 || T <= 0) return (int)cudaGetLastError();
  if constexpr (sizeof(InT) == 2) {
    // [seqs, T, heads * D] views with row stride ld; ld * 2 bytes and the
    // bases 16-byte aligned, as the maps need
    const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)T, (cuuint64_t)seqs};
    const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)T * ld * 2};
    const cuuint32_t box[3] = {64, kTcRows, 1};
    CUtensorMap maps[3];
    const void* bases[3] = {q, k, v};
    for (int i = 0; i < 3; ++i)
      if (!hopper::make_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, bases[i], dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(seqs * heads, (T + kTcRows - 1) / kTcRows);
    head_attention_tc_kernel<OutT, D><<<grid, 128, kTcSmem, stream>>>(maps[0], maps[1], maps[2], (OutT*)out, T,
                                                                       heads, causal, scale);
  } else {
    static_assert(sizeof(OutT) == 4, "f32 operands give an f32 output");
    constexpr size_t smem = F32AttnSmem<D>::kBytes;
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(head_attention_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    const dim3 grid(seqs * heads, (T + kF32Rows - 1) / kF32Rows);
    head_attention_kernel<D><<<grid, kF32Threads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, ld, T, heads, causal, scale);
  }
  return (int)cudaGetLastError();
}

// The layer kernels' call: the packed [seqs * T, 3W] q | k | v of InT
// (bf16, or f32 with an f32 output), head width D = W / heads (32 and 64
// on the kernels above, any other width on the tail path), logits scaled
// by 1 / sqrt(D) rounded to f32 (as the plain version's f32 product with
// the Python float).
template <typename InT, typename OutT>
int launch_head_attention(const void* qkv, void* out, int seqs, int T, int W,
                          int heads, int causal, cudaStream_t stream) {
  if (heads <= 0 || W % heads != 0) return (int)cudaErrorInvalidValue;
  const int D = W / heads;
  const float scale = (float)(1.0 / sqrt((double)D));
  const InT* base = (const InT*)qkv;
  if (D == 64)
    return launch_head_attention_strided<InT, OutT, 64>(base, base + W, base + 2 * W, out, 3 * W, seqs, T, heads,
                                                        causal, scale, stream);
  if (D == 32)
    return launch_head_attention_strided<InT, OutT, 32>(base, base + W, base + 2 * W, out, 3 * W, seqs, T, heads,
                                                        causal, scale, stream);
  return launch_head_attention_any<InT, OutT>(base, base + W, base + 2 * W, out, 3 * W, seqs, T, heads, D, causal,
                                              scale, stream);
}

}  // namespace
