// Grouped weight-only int8 GEMM for Hopper (sm_90a): the routed experts of
// a mixture-of-experts layer, all of a layer's experts in one launch.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. It
// was added for DeepSeek-V2-Lite's routed experts (64 a layer, 6 a token):
// one w8_matmul launch per expert would be 64 launches a projection on a
// decode step that is already bound by the host's launches. For the rows
// of x sorted by expert, with expert e's rows offsets[e] .. offsets[e+1]:
//   y[r, n] = ( (x[r] . Wq[e][:, n]) summed in f32 ) * scale[e, n]
// rounded to bf16, with x bf16 [M, K], Wq int8 [E, K, N] (per expert and
// output channel symmetric) and scale f32 [E, N]: w8_matmul's function on
// each expert's rows (the int8 weights convert exactly to bf16; the
// epilogue is __fmul_rn, then round to nearest even). Every output element
// is a sum in a fixed order, so two calls return the same bits.
//
// Bound. At the DeepSeek-V2-Lite decode batch (960 rows, 5,760 row-expert
// assignments, ~90 rows an expert) a layer's gate|up product moves 369 MB
// of int8 weights for 66 G operations and its down product 185 MB for
// 33 G: ~180 operations a weight byte, below the bf16 ridge (~295), so the
// weights' bytes bound it (~165 us a layer at 3.35 TB/s). At the prefill
// (~430 rows an expert) it is bound by operations.
//
// Design. The grid is sized on the host from M alone: ceil(M / 64) + E row
// tiles (every expert's partial last tile included, whatever the split of
// the rows) by N / 128 column tiles. A block reads the offsets from device
// memory, finds its expert and its 64 rows, and exits when it lies past
// every expert's tiles: the host never reads the routing. The row tile is
// the grid's fast dimension, so the blocks that share an expert's weight
// tile run side by side and the second reads it from L2.
//  * Mainloop: a 3-stage ring of 64-deep k-tiles filled by 16-byte
//    cp.async (rows past the expert's zero-filled): the bf16 x tile
//    (rows padded by 16 bytes) and the int8 weight tile as it lies in
//    device memory, so weights cross device memory at one byte each.
//  * Conversion: each k-tile's int8 weights are converted once to a bf16
//    [64][128] tile (rows padded by 16 bytes), exactly.
//  * Product: mma.sync.m16n8k16 (bf16 in, f32 accumulators), 8 warps each
//    a 32 x 32 sub-tile; A by ldmatrix, B by ldmatrix.trans from the
//    [k][n] tile. mma.sync and not wgmma: a first kernel, right and simple;
//    wgmma with TMA, as w8_matmul.cu does, is later work.
//  * Epilogue: straight from the accumulators, the expert's scales loaded
//    per column pair, bf16 pairs stored for the rows the expert has.
// K is a multiple of 64 and N of 16 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int kStages = 3, kThreads = 256;
constexpr int kAStride = BK + 8;   // bf16 a shared x row holds (144 bytes: ldmatrix rows in 8 bank groups)
constexpr int kBStride = BN + 8;   // bf16 a converted weight row holds (272 bytes)
constexpr int kAStage = BM * kAStride * 2;  // bytes of an x stage
constexpr int kB8Stage = BK * BN;           // bytes of an int8 weight stage
constexpr int kSmem = kStages * (kAStage + kB8Stage) + BK * kBStride * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
// d (16 x 8, f32) += a (16 x 16 bf16, row-major) . b (16 x 8 bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the four signed bytes of a word, lowest address first, as exact bf16 pairs
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const int v = static_cast<int>(w);
  lo = pack_bf16x2(static_cast<float>((v << 24) >> 24), static_cast<float>((v << 16) >> 24));
  hi = pack_bf16x2(static_cast<float>((v << 8) >> 24), static_cast<float>(v >> 24));
}

__global__ void __launch_bounds__(kThreads) moe_w8_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                                                          const float* __restrict__ scale,
                                                          const int* __restrict__ offsets, bf16* __restrict__ out,
                                                          int E, int N, int K) {
  // this block's expert and rows: the row tiles of the experts in order
  const int t = blockIdx.x;
  int e = -1, m0 = 0, rows = 0;
  {
    int before = 0;
    for (int i = 0; i < E; ++i) {
      const int lo = __ldg(offsets + i), hi = __ldg(offsets + i + 1);
      const int tiles = (hi - lo + BM - 1) / BM;
      if (t < before + tiles) {
        e = i;
        m0 = lo + (t - before) * BM;
        rows = min(BM, hi - m0);
        break;
      }
      before += tiles;
    }
  }
  if (e < 0) return;  // past every expert's row tiles
  const int n0 = blockIdx.y * BN;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* a_ring = smem;                              // [kStages][BM][kAStride] bf16
  unsigned char* b_ring = smem + kStages * kAStage;          // [kStages][BK][BN] int8
  bf16* bt = reinterpret_cast<bf16*>(smem + kStages * (kAStage + kB8Stage));  // [BK][kBStride] bf16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 32 x 32 sub-tile
  const int8_t* we = w + (size_t)e * K * N;
  const int KT = K / BK;

  auto load = [&](int kt, int stage) {
    const int k0 = kt * BK;
    bf16* as = reinterpret_cast<bf16*>(a_ring + stage * kAStage);
    for (int c = tid; c < BM * (BK / 8); c += kThreads) {
      const int r = c / (BK / 8), ch = c % (BK / 8);
      const bool ok = r < rows;
      const bf16* src = x + (size_t)(m0 + (ok ? r : 0)) * K + k0 + ch * 8;
      cp_async16(smem_u32(as + r * kAStride + ch * 8), src, ok);
    }
    int8_t* bs = reinterpret_cast<int8_t*>(b_ring + stage * kB8Stage);
    for (int c = tid; c < BK * (BN / 16); c += kThreads) {
      const int r = c / (BN / 16), ch = c % (BN / 16);
      const int col = n0 + ch * 16;
      const bool ok = col < N;
      const int8_t* src = we + (size_t)(k0 + r) * N + (ok ? col : 0);
      cp_async16(smem_u32(bs + r * BN + ch * 16), src, ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + kStages - 1 < KT) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    const int stage = kt % kStages;
    const int8_t* bs = reinterpret_cast<const int8_t*>(b_ring + stage * kB8Stage);
    for (int c = tid; c < BK * (BN / 16); c += kThreads) {
      const int r = c / (BN / 16), ch = c % (BN / 16);
      const uint4 raw = *reinterpret_cast<const uint4*>(bs + r * BN + ch * 16);
      uint4 lo, hi;
      int8x4_to_bf16(raw.x, lo.x, lo.y);
      int8x4_to_bf16(raw.y, lo.z, lo.w);
      int8x4_to_bf16(raw.z, hi.x, hi.y);
      int8x4_to_bf16(raw.w, hi.z, hi.w);
      uint4* dst = reinterpret_cast<uint4*>(bt + r * kBStride + ch * 16);
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncthreads();
    const bf16* as = reinterpret_cast<const bf16*>(a_ring + stage * kAStage);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], smem_u32(as + (wm * 32 + mi * 16 + (lane & 15)) * kAStride + kk + (lane >> 4) * 8));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(b[nj], smem_u32(bt + (kk + (lane & 15)) * kBStride + wn * 32 + nj * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_16816(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }

  const float* se = scale + (size_t)e * N;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
    if (col >= N) continue;
    const float s0 = __ldg(se + col), s1 = __ldg(se + col + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + (lane >> 2);
      if (r < rows)
        *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + r) * N + col) =
            pack_bf16x2(__fmul_rn(acc[mi][ni][0], s0), __fmul_rn(acc[mi][ni][1], s1));
      if (r + 8 < rows)
        *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + r + 8) * N + col) =
            pack_bf16x2(__fmul_rn(acc[mi][ni][2], s0), __fmul_rn(acc[mi][ni][3], s1));
    }
  }
}

}  // namespace

// out bf16 [M, N] = the rows of x bf16 [M, K] times their expert's int8
// weights w [E, K, N], scaled by scale f32 [E, N]; expert e's rows are
// offsets[e] .. offsets[e + 1] (int32 [E + 1] in device memory,
// non-decreasing, offsets[0] = 0, offsets[E] <= M; rows past offsets[E]
// are not written). K % 64 == 0, N % 16 == 0.
extern "C" int tvc_moe_w8_grouped(const void* x, const void* w, const void* scale, const void* offsets, void* out,
                                  int M, int E, int N, int K, void* stream) {
  if (K % BK != 0 || N % 16 != 0 || E < 1 || K < BK) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(moe_w8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((M + BM - 1) / BM + E, (N + BN - 1) / BN);
  moe_w8_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int8_t*)w, (const float*)scale, (const int*)offsets, (bf16*)out, E, N, K);
  return (int)cudaGetLastError();
}
