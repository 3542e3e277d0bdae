// Grouped weight-only int8 GEMM for Hopper (sm_90a): the routed experts of
// a mixture-of-experts layer, all of a layer's experts in one launch.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. It
// was added for DeepSeek-V2-Lite's routed experts (64 a layer, 6 a token)
// and serves Kimi-Linear's too (256 a layer, 8 a token): one w8_matmul
// launch per expert would be 64 or 256 launches a projection. For the rows
// of x sorted by expert, with expert e's rows offsets[e] .. offsets[e+1]:
//   y[r, n] = ( (x[r] . Wq[e][:, n]) summed in f32 ) * scale[e, n]
// rounded to bf16, with x bf16 [M, K], Wq int8 [E, K, N] (per expert and
// output channel symmetric) and scale f32 [E, N]: w8_matmul's function on
// each expert's rows (the int8 weights convert exactly to bf16; the
// epilogue is __fmul_rn, then round to nearest even). Every output element
// is one block's sum over K in a fixed order (no split of K, no atomics),
// so two calls return the same bits.
//
// Bound. A decode step reads every busy expert's weights once, at one byte
// a weight: Kimi-Linear at 480 decode rows (3,840 assignments over 256
// experts, ~15 rows an expert) moves 1.21 GB of gate|up weights for 36 G
// operations, 30 operations a byte; DeepSeek-V2-Lite at 960 rows (5,760
// over 64 experts, ~90 an expert) 369 MB for 66 G, ~180 a byte. Both lie
// below the bf16 ridge (~295 a byte): the weights' bytes bound them (0.36
// and 0.11 ms a gate|up call at 3.35 TB/s). DeepSeek's prefill (~290 rows
// an expert) is bound by operations, Kimi's (~72) still by bytes.
//
// Design: a persistent, warp-specialised block on each SM.
//  * Work list. An item is (expert, row tile of R rows, 256 output
//    channels). Each block derives the list from the offsets in device
//    memory (a prefix over the experts' items in shared memory; the host
//    never reads the routing) and takes items blockIdx.x, + gridDim.x, ...
//    An expert's row tiles lie next to each other, so blocks that run at
//    the same time share its weight tiles through L2; an expert with no
//    rows has no item and reads nothing.
//  * Producer: one thread keeps a ring of S stages in flight across items,
//    each a 64-deep k-tile: two TMA boxes of 128 channels x 64 int8
//    weights from a 3-d map over [E, K, N] (read as they lie, one byte a
//    weight, 128-byte swizzled) and the item's rows in 16-row bf16 boxes of
//    a 2-d map over x (rows past M arrive as zeros; rows past the expert's
//    end are computed and not stored). Completion on mbarriers; each
//    consumer warp hands a stage back on another once its products of it
//    are done.
//  * Products with the weights as wgmma's A and the rows as its N, so an
//    expert's 15 rows cost an n32 product, not a 64-row tile, and a wide N
//    serves a busy expert. Two consumer warpgroups of two m-tiles (64
//    channels each) issue m64nRk16 with A from registers and B, K-major,
//    from the x boxes. A warp reads its 16 channels x 32 depth of int8 by
//    one ldmatrix.x4.trans (a byte pair is one b16; the swizzle keeps the
//    eight rows of each matrix on separate banks): a thread receives a
//    2 x 2 block of (depth, channel) bytes, which converts exactly (the
//    byte offset into the f32 2^23 + u, less 2^23 + 128, cvt.rn.bf16x2)
//    into the A fragments of two channels, so an A row is channel 2m or
//    2m + 1 of the warp's 16 and the epilogue stores channel pairs. The
//    conversion of one half k-tile runs while the tensor cores multiply the
//    previous one (two register sets, wgmma.wait_group 1); nothing of it
//    goes back to shared memory, and no barrier is taken per k-tile beyond
//    the ring's mbarriers. N is fixed per launch: a branch around wgmma
//    would serialise it.
//  * Registers: R accumulators a consumer thread. At R = 128 the producer
//    is a whole warpgroup that gives the consumers its registers
//    (setmaxnreg 40 / 232); below, one producer warp.
//  * Plan: moe_plan (tvc_torch/core/kernels/moe_kernel.py) picks R, the
//    smallest of 16, 32, 128 that holds twice the mean rows an expert
//    (M / E), and S, the stages the shared memory then holds. Kimi-Linear's
//    decode (~15 rows an expert) runs R = 32, DeepSeek-V2-Lite's decode
//    (~90) and both suffix prefills R = 128, the shared prefix's prefill
//    (under two rows an expert) R = 16. On an H100 (700 W;
//    scripts/sweep_moe_gemm.py over chip_smoke.MOE_CASES) each pick was
//    the fastest of the three row tiles at all eight shapes: 80 / 71 % of
//    the bytes bound at Kimi's decode gate|up / down, 65 / 55 % at
//    DeepSeek's, 65 % (Kimi) of the bytes and 48 % (DeepSeek) of the
//    operations bound at the suffix prefill, 75–77 % at the prefix's,
//    where R = 32 came within 1 %.
//  * Epilogue: straight from the accumulators, each thread's two channels'
//    scales loaded once, bf16 pairs stored for the rows the expert has.
// K is a multiple of 64, N of 16, E at most 256 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                           // depth of a k-tile
constexpr int kWBox = 128 * kBK;                  // bytes of a weight box: 128 channels x 64 deep, int8
constexpr int kXBox = 16 * 128;                   // bytes of an x box: 16 rows x 64 bf16
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kMaxExperts = 256;
constexpr int kSmemLimit = 232448 - 128;          // dynamic shared memory a block may use (the rest: warp sums)

constexpr int kBN = 256;                          // output channels an item: two weight boxes
constexpr int kWStage = 2 * kWBox;                // weight bytes a stage

// Threads of a block whose items have R rows: two consumer warpgroups and
// one producer warp, or, where a consumer thread's accumulators (R of
// them) leave too few of the 168 registers that a block of three
// warpgroups gives each thread, a whole producer warpgroup that hands most
// of its registers to the consumers (setmaxnreg: 40 and 232).
template <int R>
struct Shape {
  static constexpr bool kWide = R >= 128;
  static constexpr int kThreads = 128 * kConsumers + (kWide ? 128 : 32);
};

// one item of the work list: expert e's rows m0 .. m0 + rows, channels n0 .. n0 + kBN
struct Item {
  int e, m0, rows, n0;
};

// Item i of the list: pre[e] .. pre[e + 1] are expert e's items (column tile
// outer, row tile inner), off the offsets, both in shared memory.
__device__ __forceinline__ Item item_at(int i, const int* pre, const int* off, int E, int R) {
  int lo = 0, hi = E;  // the last expert whose items start at or before i
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= i) lo = mid; else hi = mid;
  }
  const int tiles = (off[lo + 1] - off[lo] + R - 1) / R, local = i - pre[lo];
  const int c = local / tiles;
  Item it;
  it.e = lo;
  it.m0 = off[lo] + (local - c * tiles) * R;
  it.rows = min(R, off[lo + 1] - it.m0);
  it.n0 = c * kBN;
  return it;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&v)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
}

// The bytes b0..b3 of v, lowest first, as exact bf16 pairs: lo = (b0, b2),
// hi = (b1, b3).
__device__ __forceinline__ void int8x4_to_pairs(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.f;
  lo = pack_bf16(f[0], f[2]);
  hi = pack_bf16(f[1], f[3]);
}

#define TVC_F8(i)                                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// D[64 x NN] += A[64 x 16] (registers) . B[16 x NN] (shared, K-major)
template <int NN>
__device__ __forceinline__ void wgmma_rs(float (&d)[NN / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NN == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : TVC_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  } else if constexpr (NN == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : TVC_F8(0), TVC_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  } else {
    static_assert(NN == 128, "wgmma_rs takes N of 16, 32 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : TVC_F8(0), TVC_F8(8), TVC_F8(16), TVC_F8(24), TVC_F8(32), TVC_F8(40), TVC_F8(48), TVC_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
}

#undef TVC_F8

size_t smem_bytes(int R, int S, int E) {
  return 1024 + (size_t)S * (kWStage + R * 128 + 16) + 8 * (size_t)(E + 1);
}

// R: rows an item and wgmma's N. tmx: x [M, K] bf16, 64 x 16 boxes,
// 128-byte swizzle; tmw: w [E, K, N] int8, 128 x 64 x 1 boxes, 128-byte
// swizzle.
template <int R>
__global__ void __launch_bounds__(Shape<R>::kThreads, 1)
    moe_w8_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                  const float* __restrict__ scale, const int* __restrict__ offsets, bf16* __restrict__ out, int E,
                  int N, int K, int S) {
  constexpr int kXStage = R * 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_sums[Shape<R>::kThreads / 32];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t w_s = (raw + 1023) & ~1023u;  // S weight stages
  const uint32_t x_s = w_s + S * kWStage;      // S x stages
  const uint32_t full_s = x_s + S * kXStage, empty_s = full_s + 8 * S;
  int* pre = reinterpret_cast<int*>(smem_raw + (empty_s + 8 * S - raw));  // [E + 1]
  int* off = pre + E + 1;                                                // [E + 1]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NT = (N + kBN - 1) / kBN, KT = K / kBK;

  // the offsets, and each expert's items (row tiles x column tiles) summed
  // in expert order: pre[e] is the first item of expert e, pre[E] the count
  if (tid <= E) off[tid] = __ldg(offsets + tid);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full_s + 8 * i, 1);
      mbar_init(empty_s + 8 * i, 4 * kConsumers);  // each consumer warp hands a stage back
    }
    fence_mbar_init();
  }
  __syncthreads();
  int v = 0;
  if (tid < E) {
    const int n = off[tid + 1] - off[tid];
    v = n > 0 ? (n + R - 1) / R * NT : 0;
  }
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  for (int q = 0; q < warp; ++q) incl += warp_sums[q];
  if (tid < E) pre[tid] = incl - v;
  if (tid == E - 1) pre[E] = incl;
  __syncthreads();
  const int total = pre[E];
  if constexpr (Shape<R>::kWide) {
    if (warp >= 4 * kConsumers) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    else asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  }

  if (warp >= 4 * kConsumers) {  // the producer: one thread
    if (warp == 4 * kConsumers && lane == 0) {
      int slot = 0, round = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const Item it = item_at(i, pre, off, E, R);
        const int nb = (it.rows + 15) >> 4;  // x boxes: the item's rows, in 16s
        for (int kt = 0; kt < KT; ++kt) {
          if (round > 0) mbar_wait(empty_s + 8 * slot, (round - 1) & 1);
          const uint32_t bar = full_s + 8 * slot, k0 = kt * kBK;
          mbar_expect_tx(bar, kWStage + nb * kXBox);
          tma_load_3d(w_s + slot * kWStage, &tmw, it.n0, k0, it.e, bar);
          tma_load_3d(w_s + slot * kWStage + kWBox, &tmw, it.n0 + 128, k0, it.e, bar);
          for (int b = 0; b < nb; ++b) tma_load_2d(x_s + slot * kXStage + b * kXBox, &tmx, k0, it.m0 + 16 * b, bar);
          if (++slot == S) {
            slot = 0;
            ++round;
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: channels n0 + 128 g .. + 128 (weight box g) as
  // two m-tiles of 64; warp w of it takes channels 16 w .. 16 w + 16 of
  // each. The x stage's rows past the item's (left from an earlier stage)
  // only reach accumulator columns that are not stored.
  const int g = warp >> 2, w = warp & 3;
  float acc[2][R / 2];
  uint32_t a[2][2][2][4];  // [half k-tile][m-tile][k16 step][fragment]
  int slot = 0, phase = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const Item it = item_at(i, pre, off, E, R);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < R / 2; ++j) acc[m][j] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(full_s + 8 * slot, phase);
      const uint32_t wb = w_s + slot * kWStage + g * kWBox, xb = x_s + slot * kXStage;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // depth 32 h .. 32 h + 32 of this warp's channels: lane l addresses
        // row 32 h + l (matrix l / 8) of the box, its 16-byte chunk swizzled
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t raw4[4];
          ldmatrix_x4_trans(raw4, wb + (32 * h + lane) * 128 + (((4 * m + w) ^ (lane & 7)) << 4));
#pragma unroll
          for (int r = 0; r < 4; ++r)
            int8x4_to_pairs(raw4[r], a[h][m][r >> 1][(r & 1) * 2], a[h][m][r >> 1][(r & 1) * 2 + 1]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint64_t db = desc_sw128(xb + (2 * h + j) * 32, 16, kSbo);
#pragma unroll
          for (int m = 0; m < 2; ++m) wgmma_rs<R>(acc[m], a[h][m][j], db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous half k-tile's products are done
#pragma unroll
        for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
        if (h == 0 && prev >= 0 && lane == 0) mbar_arrive(empty_s + 8 * prev);  // this warp is done with k-tile kt - 1
      }
      prev = slot;
      if (++slot == S) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
    if (lane == 0) mbar_arrive(empty_s + 8 * prev);

    // accumulator row 16 w + l / 4 (+ 8) is channel 16 w + 2 (l / 4) (+ 1)
    // of the m-tile; column 8 j + 2 (l % 4) (+ 1) is the item's row
    const float* se = scale + (size_t)it.e * N;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int ch = it.n0 + 128 * g + 64 * m + 16 * w + 2 * (lane >> 2);
      if (ch >= N) continue;
      const float2 sc = *reinterpret_cast<const float2*>(se + ch);
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        const int r = 8 * j + 2 * (lane & 3);
        const float* d = acc[m] + 4 * j;
        if (r < it.rows)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(it.m0 + r) * N + ch) =
              __floats2bfloat162_rn(__fmul_rn(d[0], sc.x), __fmul_rn(d[2], sc.y));
        if (r + 1 < it.rows)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(it.m0 + r + 1) * N + ch) =
              __floats2bfloat162_rn(__fmul_rn(d[1], sc.x), __fmul_rn(d[3], sc.y));
      }
    }
  }
}

template <int R>
int launch_moe(const void* x, const void* w, const void* scale, const void* offsets, void* out, int M, int E, int N,
               int K, int S, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(moe_w8_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap tmx, tmw;
  const cuuint64_t wdims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  const cuuint32_t wbox[3] = {128, (cuuint32_t)kBK, 1};
  if (!make_map_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, kBK, 16, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // no more blocks than items can be: every expert's partial tile, M / R full ones
  const long long most = ((long long)(M + R - 1) / R + E) * ((N + kBN - 1) / kBN);
  const int grid = (int)(most < sms ? most : sms);
  moe_w8_kernel<R><<<grid, Shape<R>::kThreads, smem_bytes(R, S, E), stream>>>(
      tmx, tmw, (const float*)scale, (const int*)offsets, (bf16*)out, E, N, K, S);
  return (int)cudaGetLastError();
}

}  // namespace

// out bf16 [M, N] = the rows of x bf16 [M, K] times their expert's int8
// weights w [E, K, N], scaled by scale f32 [E, N]; expert e's rows are
// offsets[e] .. offsets[e + 1] (int32 [E + 1] in device memory,
// non-decreasing, offsets[0] = 0, offsets[E] <= M; rows past offsets[E]
// are not written). Items of R rows (16, 32 or 128) and 256 channels,
// S ring stages (moe_plan). K % 64 == 0, N % 16 == 0, 1 <= E <= 256; x, w
// 16-byte aligned.
extern "C" int tvc_moe_w8_grouped(const void* x, const void* w, const void* scale, const void* offsets, void* out,
                                  int M, int E, int N, int K, int R, int S, void* stream) {
  if (K % kBK != 0 || N % 16 != 0 || E < 1 || E > kMaxExperts || K < kBK || S < 2 ||
      smem_bytes(R, S, E) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (R == 16) return launch_moe<16>(x, w, scale, offsets, out, M, E, N, K, S, s);
  if (R == 32) return launch_moe<32>(x, w, scale, offsets, out, M, E, N, K, S, s);
  if (R == 128) return launch_moe<128>(x, w, scale, offsets, out, M, E, N, K, S, s);
  return (int)cudaErrorInvalidValue;
}
