// One-token latent attention (MLA) over a latent cache, for Hopper
// (sm_90a): the attention of every decode step of the DeepSeek-V2-Lite
// paraphrase decode, in the absorbed form.
//
// Replaces no TPU kernel: the JAX package has no latent attention. Every
// position keeps one cache row of 576 values: the normed 512-wide latent
// c_s and the 64-wide roped key k_pe_s, shared by all 16 query heads (32 in
// Kimi-Linear's latent layers, whose k_pe is unroped). With
// the up-projections absorbed into the query (q_lat_h = W_UK,h^T q_nope_h,
// outside this kernel) and into the output (W_UV,h, outside), for each
// sequence b and head h:
//   logits[h, s] = (q_lat[h] . c_s + q_pe[h] . k_pe_s) * scale + mask[b, s]
//   p[h, :]      = softmax(logits[h, :])                         (f32)
//   out[b, h]    = sum_s p[h, s] c_s                  (f32, then bf16)
//
// Bound. Per step the kernel must read each sequence's S cache rows once
// (1,152 bytes each) against 16 x 2 x 1,088 operations a row: ~30
// operations a byte, so bytes bound it (960 rows, S = 64: 71 MB a layer,
// ~21 us at 3.35 TB/s).
//
// Design. A block of 4 warps a group of 16 heads (4 at 16 heads, 8 at 32)
// takes one sequence and reads each latent row once for all its heads:
//  * the cache rows stream through a 2-stage shared-memory ring of 32-row
//    tiles by 16-byte cp.async (rows padded by 16 bytes for ldmatrix; rows
//    past S zero-filled), the next tile in flight while this one is used;
//    the 16 query rows [q_lat | q_pe] come with the first tile.
//  * logits on the tensor cores, mma.sync.m16n8k16: a group's 16 heads are
//    M, 8 cache rows a warp are N, the 576-wide row is K (36 steps); scaled
//    with __fmul_rn, the mask added with __fadd_rn.
//  * an online softmax in f32 (one warp a head row, a lane a slot): the
//    running max and sum per head, each tile's weights exp(s - m) rounded
//    to bf16, the sum taken of the rounded weights, and the accumulators
//    rescaled by exp(m_old - m_new).
//  * P.C on the tensor cores: a group's weights [16 x 32] are A, the
//    tile's first 512 columns are B (ldmatrix.trans), each warp of the
//    group 128 of the 512 output columns in 64 f32 registers a thread;
//    divided by the sum and rounded to bf16 at the end.
// Each head's arithmetic is the same at 16 and at 32 heads.
// mma.sync and not wgmma: the products have 16 rows, a quarter of
// wgmma's 64. S is at most the cache length the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLat = 512, kRope = 64, kRowW = kLat + kRope;  // 576
constexpr int kTile = 32, kStages = 2;
constexpr int kRow = kRowW + 8;       // bf16 a padded shared row holds (1,168 bytes)
constexpr int kPStride = kTile + 8;   // bf16 a weight row holds
constexpr int kTileBytes = kTile * kRow * 2;

// the block's layout at kHeads heads: 4 warps a group of 16
template <int kHeads>
struct Mla {
  static constexpr int kThreads = 128 * (kHeads / 16);
  static constexpr int kQBytes = kHeads * kRow * 2;
  static constexpr int kLogitBytes = kHeads * kTile * 4;
  static constexpr int kPBytes = kHeads * kPStride * 2;
  static constexpr int kSmem = kQBytes + kStages * kTileBytes + kLogitBytes + kPBytes + 3 * kHeads * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&a)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(a[0]), "=r"(a[1]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int kHeads>
__global__ void __launch_bounds__(Mla<kHeads>::kThreads) mla_decode_kernel(const bf16* __restrict__ q_lat,
                                                                           const bf16* __restrict__ q_pe,
                                                                           const bf16* __restrict__ cache,
                                                                           const float* __restrict__ mask,
                                                                           bf16* __restrict__ out, int S, int q_sb,
                                                                           int q_sh, float scale) {
  constexpr int kThreads = Mla<kHeads>::kThreads, kQBytes = Mla<kHeads>::kQBytes;
  constexpr int kLogitBytes = Mla<kHeads>::kLogitBytes, kPBytes = Mla<kHeads>::kPBytes;
  constexpr int kWarps = kThreads / 32;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's group of 16 heads (its rows of every product) and its place in the group
  const int grp = (tid >> 5) >> 2, warp = (tid >> 5) & 3, hg = 16 * grp;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q = reinterpret_cast<bf16*>(smem);                                 // [16][kRow]
  bf16* ring = reinterpret_cast<bf16*>(smem + kQBytes);                    // [kStages][kTile][kRow]
  float* logits = reinterpret_cast<float*>(smem + kQBytes + kStages * kTileBytes);  // [16][kTile]
  bf16* p = reinterpret_cast<bf16*>(smem + kQBytes + kStages * kTileBytes + kLogitBytes);  // [16][kPStride]
  float* run_max = reinterpret_cast<float*>(smem + kQBytes + kStages * kTileBytes + kLogitBytes + kPBytes);
  float* run_sum = run_max + kHeads;
  float* rescale = run_sum + kHeads;

  const bf16* rows = cache + (size_t)b * S * kRowW;
  constexpr int kChunks = kRowW / 8;  // 16-byte pieces of a row
  for (int c = tid; c < kHeads * kChunks; c += kThreads) {
    const int h = c / kChunks, ch = c % kChunks;
    const bf16* src = ch < kLat / 8 ? q_lat + (size_t)b * q_sb + (size_t)h * q_sh + ch * 8
                                    : q_pe + ((size_t)b * kHeads + h) * kRope + (ch - kLat / 8) * 8;
    cp_async16(smem_u32(q + h * kRow + ch * 8), src, true);
  }
  auto load = [&](int t, int stage) {
    const int s0 = t * kTile;
    bf16* dst = ring + stage * kTile * kRow;
    for (int c = tid; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, ch = c % kChunks;
      const bool ok = s0 + r < S;
      cp_async16(smem_u32(dst + r * kRow + ch * 8), rows + (size_t)(ok ? s0 + r : 0) * kRowW + ch * 8, ok);
    }
  };
  load(0, 0);
  cp_async_commit();
  if (tid < kHeads) {
    run_max[tid] = -INFINITY;
    run_sum[tid] = 0.f;
  }

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  const int g = lane >> 2;  // the accumulator rows this thread holds: heads g and g + 8
  const int n_tiles = (S + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load(t + 1, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t (and q) landed
    const bf16* tile = ring + (t % kStages) * kTile * kRow;

    // logits of this warp's 8 rows of the tile for its group's 16 heads
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int kk = 0; kk < kRowW; kk += 16) {
      uint32_t a[4], bb[2];
      ldmatrix_x4(a, smem_u32(q + (hg + (lane & 15)) * kRow + kk + (lane >> 4) * 8));
      ldmatrix_x2(bb, smem_u32(tile + (warp * 8 + (lane & 7)) * kRow + kk + ((lane >> 3) & 1) * 8));
      mma_16816(d, a, bb[0], bb[1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = hg + g + (j >> 1) * 8, col = warp * 8 + (lane & 3) * 2 + (j & 1);
      const int s = t * kTile + col;
      logits[h * kTile + col] = s < S ? __fadd_rn(__fmul_rn(d[j], scale), __ldg(mask + (size_t)b * S + s)) : -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp a head row, a lane a slot of the tile
#pragma unroll
    for (int rr = 0; rr < kHeads / kWarps; ++rr) {
      const int h = (tid >> 5) * (kHeads / kWarps) + rr;
      const float v = logits[h * kTile + lane];
      const float m_old = run_max[h];
      const float m_new = fmaxf(m_old, warp_max(v));
      const bf16 pv = __float2bfloat16(m_new == -INFINITY ? 0.f : expf(v - m_new));
      p[h * kPStride + lane] = pv;
      const float sum = warp_sum(__bfloat162float(pv));
      if (lane == 0) {
        const float r = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        run_sum[h] = run_sum[h] * r + sum;
        run_max[h] = m_new;
        rescale[h] = r;
      }
    }
    __syncthreads();

    // acc = acc * rescale + P . C[:, :512], this warp's 128 columns
    const float r0 = rescale[hg + g], r1 = rescale[hg + g + 8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[j][0] *= r0;
      acc[j][1] *= r0;
      acc[j][2] *= r1;
      acc[j][3] *= r1;
    }
#pragma unroll
    for (int ks = 0; ks < kTile; ks += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(p + (hg + (lane & 15)) * kPStride + ks + (lane >> 4) * 8));
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, smem_u32(tile + (ks + (lane & 15)) * kRow + warp * 128 + jj * 16 + (lane >> 4) * 8));
        mma_16816(acc[2 * jj], a, bb[0], bb[1]);
        mma_16816(acc[2 * jj + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the ring slot and the logits are reused
  }

  const float inv0 = 1.f / run_sum[hg + g], inv1 = 1.f / run_sum[hg + g + 8];
  bf16* o0 = out + ((size_t)b * kHeads + hg + g) * kLat;
  bf16* o1 = out + ((size_t)b * kHeads + hg + g + 8) * kLat;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = warp * 128 + j * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16x2(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16x2(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int kHeads>
int launch(const void* q_lat, const void* q_pe, const void* cache, const void* mask, void* out, int B, int S, int q_sb,
           int q_sh, float scale, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(mla_decode_kernel<kHeads>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Mla<kHeads>::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  mla_decode_kernel<kHeads><<<B, Mla<kHeads>::kThreads, Mla<kHeads>::kSmem, stream>>>(
      (const bf16*)q_lat, (const bf16*)q_pe, (const bf16*)cache, (const float*)mask, (bf16*)out, S, q_sb, q_sh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// out bf16 [B, H, 512] = latent attention of q_lat bf16 [B, H, 512] (its
// rows q_sb and its heads q_sh values apart, multiples of 8, the latents
// unit-stride) and q_pe bf16 [B, H, 64] over cache bf16 [B, S, 576] (one
// layer's rows: c then k_pe) with the additive f32 mask [B, S] and the
// logit scale; H 16 or 32.
extern "C" int tvc_mla_decode(const void* q_lat, const void* q_pe, const void* cache, const void* mask, void* out,
                              int B, int H, int S, int q_sb, int q_sh, float scale, void* stream) {
  if (S < 1 || q_sb % 8 || q_sh % 8 || (H != 16 && H != 32)) return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  return H == 16 ? launch<16>(q_lat, q_pe, cache, mask, out, B, S, q_sb, q_sh, scale, (cudaStream_t)stream)
                 : launch<32>(q_lat, q_pe, cache, mask, out, B, S, q_sb, q_sh, scale, (cudaStream_t)stream);
}
