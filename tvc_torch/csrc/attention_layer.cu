// Pre-LN transformer sub-blocks for Hopper (sm_90a): the attention layer
// and the MLP layer of the CLIP towers.
//
// Replaces the TPU kernels tvc/core/pallas/attention_layer_kernel.py
// (fused_attention_layer, body _attn_layer_kernel; fused_mlp_layer, body
// _mlp_layer_kernel):
//   attention: out = x + W_out . MHA(split(W_qkv . LN(x) + b_qkv)) + b_out
//   mlp:       out = x + W_proj . quick_gelu(W_fc . LN(x) + b_fc) + b_proj
// with the TPU kernel's numerics in its compute dtype (x's: bf16 on the
// serving towers, f32 on the tiny configurations): LayerNorm (eps 1e-5,
// two-pass variance) and softmax in f32; GEMMs on compute-dtype operands
// with f32 sums; LN(x), qkv, the attention output and the GELU output
// rounded to the compute dtype where the TPU kernel rounds them; bias and
// residual added in f32; the output rounded to the compute dtype.
//
// Kernels, launched in sequence by the Python wrappers
// (tvc_torch/core/kernels/attention_layer_kernel.py): an attention layer
// is 4 launches (LayerNorm rows, QKV GEMM, per-head attention, out-proj
// GEMM), an MLP layer 3 (LayerNorm rows, fc GEMM, proj GEMM), one more
// for each GEMM whose K the plan splits.
//  * layernorm_rows_kernel<T>: one warp a row: mean, then the mean square
//    of x - mean (f32), then LN(x) rounded to T. The TPU kernel rounds
//    LN(x) to the compute dtype before its product too, so the GEMM reads
//    the same bits it would have formed itself; done once per row here
//    instead of once per column block inside the GEMM (which would read
//    the A rows 3 x N / BN times), and the GEMM's A operand is a plain
//    TMA box.
//  * bf16_gemm_kernel (bf16): C[M, N] = epilogue(A[M, K] . W[K, N]), W in
//    the JAX layout [in, out], on the tensor cores:
//     - Mainloop: a ring of S shared-memory stages of 64-deep k-tiles,
//       filled by TMA (one thread issues the boxes of a tile, an mbarrier
//       a stage counts their bytes) up to S tiles ahead: A as a 64 x BM
//       box under the 128-byte swizzle (wgmma's K-major layout), W read
//       as it lies in BN / 64 boxes of 64 columns x 64 k-rows under the
//       128-byte swizzle, which is wgmma's MN-major layout, read with the
//       transpose flag: weights go from TMA to the tensor cores with no
//       pass through registers. Rows, columns and depth past the tensors
//       arrive as zeros.
//     - Product: wgmma m64n{128,192,256}k16, bf16 in, f32 accumulators in
//       registers; a warpgroup takes 64 rows (BM = 64 x warpgroups). Tile
//       t's wgmmas run while tile t + 1's are issued (wait_group 1); a
//       block barrier then frees tile t - 1's stage for the TMA of tile
//       t - 1 + S.
//     - Epilogue: the f32 sums go through shared memory (the ring is idle
//       then), so that each thread takes 4 consecutive columns of a row
//       and a warp stores a contiguous run: + bias, then nothing,
//       quick_gelu, or + the bf16 residual, all in f32, rounded once to
//       bf16. Or, with a split of K, the raw f32 sums to a workspace,
//       which bf16_splitk_reduce_kernel adds in split order before the
//       same epilogue.
//     - Tiles (128 x 256, 128 x 192, and 128 x 128 and 64 x 128 two an
//       SM, where each block's epilogue overlaps the other's mainloop) and
//       the split of K come from bf16_plan(M, N, K) in
//       attention_layer_kernel.py, costed in waves over the 132 SMs. The
//       block rows of one column tile are neighbours in the grid, so each
//       weight tile crosses device memory once.
//     - What holds it (scripts/sweep_bf16_gemm.py's ablations): the loads
//       alone (no wgmma, no epilogue) take about cuBLAS's whole time at
//       the larger shapes, and the epilogue, which follows the mainloop
//       in each block, adds up to a third; 1.25-1.73x cuBLAS at the layer
//       shapes.
//  * f32_gemm_kernel (f32): the same function on the CUDA cores (tensor
//    cores would mean TF32, which is not the f32 product): 64 x 64 output
//    tiles, 16-deep k-tiles, 4 x 4 outputs a thread, each summed in k order
//    in f32, then the f32 epilogue.
//  * head_attention_tc_kernel<bf16> / head_attention_kernel (f32)
//    (head_attention.cuh): the per-(sequence, head) softmax attention on
//    the packed qkv, head width 32 or 64, any T; other head widths on the
//    header's tail path (attention_rows_kernel).
// Every output element is a sum in a fixed order (no atomics; split
// partials added in split order), so two calls return the same bits.
//
// Bound: operations. A layer's GEMMs do 2 M K N flops on 2 (M K + K N + M N)
// bytes: at ViT-B/32 (M = 64 x 50, K = 768) that is ~600 flops per byte,
// above the H100's ~295 flop/byte bf16 ridge. Why not one kernel as on the
// TPU: the TPU kernel keeps the whole [W, 3W] weight and a block of
// sequences resident in its many-MB VMEM. A Hopper block has at most
// 227 KB of shared memory, and one ViT-B/32 sequence's bf16 qkv alone is
// 50 x 2304 x 2 = 230 KB, so LN(x), the [M, 3W] qkv, the [M, W] attention
// output and the [M, 4W] hidden go through device memory (L2 at these
// sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_attention.cuh"

namespace {

using namespace hopper;

enum Epilogue { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

constexpr int kRowWarps = 8;  // rows per block of the LayerNorm kernel

__device__ __forceinline__ float2 pair_at(const bf16* row, int i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[i]);
}
__device__ __forceinline__ float2 pair_at(const float* row, int i) { return reinterpret_cast<const float2*>(row)[i]; }

// y = LN(x) rounded to T, one warp a row, two elements a lane at a time
// (neighbouring lanes on neighbouring pairs of x, ln_g and ln_b; a form
// with 16-byte chunks a lane measured slower, its ln_g / ln_b reads
// scattered); K even.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    layernorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                          T* __restrict__ y, int M, int K, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  // two-pass f32 statistics, as the TPU kernel: mean((x - mean)^2)
  float s = 0.f;
  for (int i = lane; i < K / 2; i += 32) {
    const float2 f = pair_at(xr, i);
    s += f.x + f.y;
  }
  const float mean = warp_sum(s) / K;
  float s2 = 0.f;
  for (int i = lane; i < K / 2; i += 32) {
    const float2 f = pair_at(xr, i);
    const float a = f.x - mean, b = f.y - mean;
    s2 += a * a + b * b;
  }
  const float rstd = rsqrtf(warp_sum(s2) / K + eps);
  T* yr = y + (size_t)row * K;
  for (int i = lane; i < K / 2; i += 32) {
    const float2 f = pair_at(xr, i);
    store_pair(yr + 2 * i, (f.x - mean) * rstd * ln_g[2 * i] + ln_b[2 * i],
               (f.y - mean) * rstd * ln_g[2 * i + 1] + ln_b[2 * i + 1]);
  }
}

// The same function for odd K (rows not 4-byte aligned), an element a lane
// at a time: the tail path for widths no configured model has.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    layernorm_rows_odd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                              const float* __restrict__ ln_b, T* __restrict__ y, int M, int K, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int i = lane; i < K; i += 32) s += to_f32(xr[i]);
  const float mean = warp_sum(s) / K;
  float s2 = 0.f;
  for (int i = lane; i < K; i += 32) {
    const float a = to_f32(xr[i]) - mean;
    s2 += a * a;
  }
  const float rstd = rsqrtf(warp_sum(s2) / K + eps);
  T* yr = y + (size_t)row * K;
  for (int i = lane; i < K; i += 32) store_one(yr + i, (to_f32(xr[i]) - mean) * rstd * ln_g[i] + ln_b[i]);
}

// quick_gelu in f32: h * sigmoid(1.702 h), sigmoid as 1 / (1 + exp(-t))
__device__ __forceinline__ float quick_gelu(float h) {
  return __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h)))));
}

// The same for an output rounded to bf16 (8 significant bits): e^x on the
// special-function unit and an approximate division (a few f32 ulps, far
// below the bf16 rounding that follows). The IEEE division made the text
// T=32 fc GEMM 0.1097 ms against 0.0864 with this form (NVIDIA H100 80GB
// HBM3, 700 W, scripts/sweep_bf16_gemm.py). e^-t past f32's range gives a
// quotient of 0: h * 0 for large negative h, as the exact form.
__device__ __forceinline__ float quick_gelu_bf16(float h) {
  return h * __fdividef(1.f, 1.f + __expf(-1.702f * h));
}

// What a GEMM's epilogue needs.
struct Epi {
  const float* bias;
  const void* res;  // the residual, in the output's type (EPI_RESIDUAL)
  void* out;
  int M, N, epi;
};

// The bf16 residual of columns col .. col + 3 of row `row` (EPI_RESIDUAL).
__device__ __forceinline__ uint2 residual4(const Epi& e, int row, int col) {
  return e.epi == EPI_RESIDUAL ? *reinterpret_cast<const uint2*>(static_cast<const bf16*>(e.res) + (size_t)row * e.N + col)
                               : make_uint2(0u, 0u);
}

// Columns col .. col + 3 of row `row` from their f32 sums: + bias, then
// nothing, quick_gelu or + the residual `raw` (residual4), rounded once to
// bf16.
__device__ __forceinline__ void epilogue4(const Epi& e, int row, int col, float4 a, uint2 raw) {
  float v[4] = {a.x + e.bias[col], a.y + e.bias[col + 1], a.z + e.bias[col + 2], a.w + e.bias[col + 3]};
  if (e.epi == EPI_GELU) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = quick_gelu_bf16(v[i]);
  }
  const size_t o = (size_t)row * e.N + col;
  if (e.epi == EPI_RESIDUAL) {
    const float2 r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = r0.x + v[0];
    v[1] = r0.y + v[1];
    v[2] = r1.x + v[2];
    v[3] = r1.y + v[3];
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(static_cast<bf16*>(e.out) + o) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

template <int WGS, int BN, int S>
struct GemmCfg {
  static constexpr int BM = 64 * WGS, kThreads = 128 * WGS;
  static constexpr int kA = BM * 128;  // bytes of an A stage: BM rows of 64 bf16
  static constexpr int kB = BN * 128;  // bytes of a W stage: BN / 64 boxes of 64 k-rows x 128 bytes
  static constexpr int kAcc = BN / 2;  // f32 accumulators a thread
  static constexpr int kLd = BN + 8;   // f32 words a row of the epilogue's stage
  static constexpr int kMinBlocks = BN <= 128 ? 2 : 1;  // two blocks an SM where they fit
  static constexpr size_t kPool = (size_t)S * (kA + kB);
  static constexpr size_t kSmem = kPool + 8 * S + 1024;
  static_assert((size_t)BM * kLd * 4 <= kPool, "the epilogue's f32 stage must fit the ring");
};

// One block: BM x BN outputs over local k-tiles [kt0, kt0 + n) of 64,
// kt0 = blockIdx.z * per; warpgroup w takes rows [64 w, 64 w + 64).
// ws == nullptr: the epilogue to e.out; else the f32 sums to
// ws[blockIdx.z] (split K). tma: A [M, K] bf16, 64 x BM boxes; tmw:
// W [K, N] bf16, 64 x 64 boxes; both under the 128-byte swizzle.
template <int WGS, int BN, int S>
__global__ void __launch_bounds__(128 * WGS, (GemmCfg<WGS, BN, S>::kMinBlocks))
    bf16_gemm_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmw, const Epi e,
                     float* __restrict__ ws, int K, int per) {
  using C = GemmCfg<WGS, BN, S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_s = (raw + 1023) & ~1023u;  // 128-byte swizzle needs 1024-byte tiles
  const uint32_t b_s = a_s + S * C::kA, bar_s = b_s + S * C::kB;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * per;
  const int n = min(per, (K + 63) / 64 - kt0);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) mbar_init(bar_s + 8 * i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int t) {  // one thread: tile t's A box and W boxes into slot t % S
    const int slot = t % S, k0 = (kt0 + t) * 64;
    const uint32_t bar = bar_s + 8 * slot;
    mbar_expect_tx(bar, C::kA + C::kB);
    tma_load_2d(a_s + slot * C::kA, &tma, k0, m0, bar);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) tma_load_2d(b_s + slot * C::kB + j * 8192, &tmw, n0 + 64 * j, k0, bar);
  };

  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;

  if (tid == 0) {
    for (int t = 0; t < S && t < n; ++t) issue(t);
  }
  for (int t = 0; t < n; ++t) {
    const int slot = t % S;
    mbar_wait(bar_s + 8 * slot, (t / S) & 1);
    const uint32_t a_t = a_s + slot * C::kA + wg * 8192, b_t = b_s + slot * C::kB;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_sw128(a_t + kk * 32, 16, kSbo);
      const uint64_t db = desc_sw128(b_t + kk * 2048, 8192, kSbo);
      if constexpr (BN == 256) {
        wgmma_m64n256_ss<1>(acc, da, db, 1);
      } else if constexpr (BN == 192) {
        wgmma_m64n192_ss<1>(acc, da, db, 1);
      } else {
        wgmma_m64n128_ss<1>(acc, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    // every warpgroup's wgmmas of tile t - 1 are done: its stage is free
    __syncthreads();
    if (tid == 0 && t >= 1 && t - 1 + S < n) issue(t - 1 + S);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue through shared memory: thread (warp, lane) holds rows
  // 16 warp + lane / 4 and + 8 of its warpgroup's 64, columns 8 j +
  // 2 (lane % 4) and + 1; rows padded by 8 words so that each half-warp's
  // 8-byte stores fall on 32 distinct banks. Then each thread takes 4
  // consecutive columns of a row: a warp reads 512 contiguous bytes and
  // writes a contiguous run of the output (or of the split's workspace).
  // The residuals of a thread's kIters quads are loaded first, all in
  // flight while the sums are staged, instead of one device-memory latency
  // a quad.
  constexpr int kQuads = C::BM * (BN / 4), kIters = (kQuads + C::kThreads - 1) / C::kThreads;
  float* wsz = ws ? ws + (size_t)blockIdx.z * e.M * e.N : nullptr;
  uint2 res[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int i = tid + k * C::kThreads, row = m0 + i / (BN / 4), col = n0 + 4 * (i % (BN / 4));
    res[k] = !wsz && i < kQuads && row < e.M && col < e.N ? residual4(e, row, col) : make_uint2(0u, 0u);
  }
  float* stage = reinterpret_cast<float*>(smem_raw + (a_s - raw));
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  __syncthreads();  // every warpgroup's wgmmas are done with the ring
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(stage + r0 * C::kLd + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stage + (r0 + 8) * C::kLd + c) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int i = tid + k * C::kThreads, r = i / (BN / 4), c = 4 * (i % (BN / 4)), row = m0 + r, col = n0 + c;
    if (i >= kQuads) break;
    if (row >= e.M || col >= e.N) continue;
    const float4 a = *reinterpret_cast<const float4*>(stage + r * C::kLd + c);
    if (wsz)
      *reinterpret_cast<float4*>(wsz + (size_t)row * e.N + col) = a;
    else
      epilogue4(e, row, col, a, res[k]);
  }
}

// out = epilogue(ws[0] + ws[1] + ... + ws[splits - 1]), in that order; one
// thread 4 columns.
__global__ void __launch_bounds__(256) bf16_splitk_reduce_kernel(const float* __restrict__ ws, const Epi e, int splits) {
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  const size_t MN = (size_t)e.M * e.N;
  if (i >= MN) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(ws + z * MN + i);
    s.x = __fadd_rn(s.x, p.x);
    s.y = __fadd_rn(s.y, p.y);
    s.z = __fadd_rn(s.z, p.z);
    s.w = __fadd_rn(s.w, p.w);
  }
  const int row = (int)(i / e.N), col = (int)(i % e.N);
  epilogue4(e, row, col, s, residual4(e, row, col));
}

// f32 operands on the CUDA cores: out = epilogue(A . W) with the sums in
// k order, then + bias, quick_gelu or + residual in f32, f32 out.
__global__ void __launch_bounds__(256)
    f32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ Wt, const float* __restrict__ bias,
                    const float* __restrict__ res, float* __restrict__ out, int M, int N, int K, int epi) {
  __shared__ float As[16][64];  // [k][m]
  __shared__ float Bs[16][64];  // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int i = tid; i < 16 * 64; i += 256) {
      const int r = i >> 4, kk = i & 15;
      As[kk][r] = (m0 + r < M && k0 + kk < K) ? A[(size_t)(m0 + r) * K + k0 + kk] : 0.f;
      const int kb = i >> 6, c = i & 63;
      Bs[kb][c] = (k0 + kb < K && n0 + c < N) ? Wt[(size_t)(k0 + kb) * N + n0 + c] : 0.f;
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
      if (r >= M || c >= N) continue;
      float v = __fadd_rn(acc[i][j], bias[c]);
      if (epi == EPI_GELU) v = quick_gelu(v);
      if (epi == EPI_RESIDUAL) v = __fadd_rn(res[(size_t)r * N + c], v);
      out[(size_t)r * N + c] = v;
    }
  }
}

template <int WGS, int BN, int S>
int launch_bf16(const void* a, const void* w, const Epi& e, void* ws, int K, int splits, int per,
                cudaStream_t stream) {
  using C = GemmCfg<WGS, BN, S>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(bf16_gemm_kernel<WGS, BN, S>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap tma, tmw;
  if (!make_map_2d(&tma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, e.M, K, 64, C::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K, e.N, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  // the block rows of one column tile run side by side, so each weight
  // tile crosses device memory once
  const dim3 grid((e.M + C::BM - 1) / C::BM, (e.N + BN - 1) / BN, splits);
  bf16_gemm_kernel<WGS, BN, S><<<grid, C::kThreads, C::kSmem, stream>>>(
      tma, tmw, e, splits > 1 ? (float*)ws : nullptr, K, per);
  if (splits > 1) {
    const size_t quads = (size_t)e.M * e.N / 4;
    bf16_splitk_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>((const float*)ws, e, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y = LN(x) (f32 statistics, eps), rounded to x's type: x, y [M, K] bf16
// (is_f32 = 0) or f32; odd K on the element-a-lane kernel.
extern "C" int tvc_layernorm_rows(const void* x, const void* ln_scale, const void* ln_bias, void* y, int M, int K,
                                  float eps, int is_f32, void* stream) {
  if (M > 0 && K > 0) {
    const int blocks = (M + kRowWarps - 1) / kRowWarps;
    const cudaStream_t s = (cudaStream_t)stream;
    if (K % 2 && is_f32)
      layernorm_rows_odd_kernel<float><<<blocks, 32 * kRowWarps, 0, s>>>(
          (const float*)x, (const float*)ln_scale, (const float*)ln_bias, (float*)y, M, K, eps);
    else if (K % 2)
      layernorm_rows_odd_kernel<bf16><<<blocks, 32 * kRowWarps, 0, s>>>(
          (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (bf16*)y, M, K, eps);
    else if (is_f32)
      layernorm_rows_kernel<float><<<blocks, 32 * kRowWarps, 0, s>>>(
          (const float*)x, (const float*)ln_scale, (const float*)ln_bias, (float*)y, M, K, eps);
    else
      layernorm_rows_kernel<bf16><<<blocks, 32 * kRowWarps, 0, s>>>(
          (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (bf16*)y, M, K, eps);
  }
  return (int)cudaGetLastError();
}

// out bf16 [M, N] = epilogue(a bf16 [M, K] . w bf16 [K, N]): + bias f32 [N],
// then nothing (EPI_BIAS), quick_gelu (EPI_GELU) or + residual bf16 [M, N]
// (EPI_RESIDUAL). bm x bn tiles (128 x 256, 128 x 192, 128 x 128 or
// 64 x 128) over `splits` ranges of `per` 64-deep k-tiles; ws: f32
// [splits, M, N] when splits > 1. K and N multiples of 8; a and w 16-byte
// aligned.
extern "C" int tvc_bf16_gemm(const void* a, const void* w, const void* bias, const void* residual, void* out,
                             void* ws, int M, int N, int K, int epilogue, int bm, int bn, int splits, int per,
                             void* stream) {
  const int nk = (K + 63) / 64;
  if (K % 8 != 0 || N % 8 != 0 || epilogue < EPI_BIAS || epilogue > EPI_RESIDUAL || splits < 1 || per < 1 ||
      (splits - 1) * per >= nk || splits * per < nk || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const Epi e{(const float*)bias, residual, out, M, N, epilogue};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 128 && bn == 256) return launch_bf16<2, 256, 4>(a, w, e, ws, K, splits, per, s);
  if (bm == 128 && bn == 192) return launch_bf16<2, 192, 4>(a, w, e, ws, K, splits, per, s);
  if (bm == 128 && bn == 128) return launch_bf16<2, 128, 3>(a, w, e, ws, K, splits, per, s);
  if (bm == 64 && bn == 128) return launch_bf16<1, 128, 4>(a, w, e, ws, K, splits, per, s);
  return (int)cudaErrorInvalidValue;
}

// out f32 [M, N] = epilogue(a f32 [M, K] . w f32 [K, N]), the epilogues of
// tvc_bf16_gemm in f32 (the residual f32 [M, N]).
extern "C" int tvc_f32_gemm(const void* a, const void* w, const void* bias, const void* residual, void* out, int M,
                            int N, int K, int epilogue, void* stream) {
  if (epilogue < EPI_BIAS || epilogue > EPI_RESIDUAL) return (int)cudaErrorInvalidValue;
  if (M > 0 && N > 0) {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    f32_gemm_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const float*)a, (const float*)w, (const float*)bias,
                                                             (const float*)residual, (float*)out, M, N, K, epilogue);
  }
  return (int)cudaGetLastError();
}

// Per-(sequence, head) attention on the packed [seqs * T, 3W] q | k | v:
// bf16 in and out (is_f32 = 0) or f32 in and out; head width W / heads
// (32 or 64 tiled, any other on the tail path).
extern "C" int tvc_head_attention(const void* qkv, void* out, int seqs, int T, int W, int heads, int causal,
                                  int is_f32, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) return launch_head_attention<float, float>(qkv, out, seqs, T, W, heads, causal, s);
  return launch_head_attention<bf16, bf16>(qkv, out, seqs, T, W, heads, causal, s);
}
