// One-token grouped-query attention over a KV-major cache, for Hopper
// (sm_90a): the attention of every decode step of the Qwen2 paraphrase
// decode.
//
// Replaces the TPU kernels tvc/core/pallas/decode_attention_kernel.py
// decode_gqa_attention (body _decode_gqa_kernel) and
// decode_gqa_attention_stacked (_decode_gqa_stacked_kernel). The stacked
// TPU kernel picks layer l of the [L, B, KV, S, D] cache through scalar
// prefetch so that lax.scan copies no slab; in PyTorch k[l] of the
// contiguous stacked cache is already a zero-copy view, so the stacked
// wrapper hands this kernel that view. For each sequence b and KV head g,
// with R = query heads per KV head:
//   logits[r, s] = (q[b, g, r] . k[b, g, s]) * D^-1/2 + mask[b, s]   (f32)
//   w[r, :]      = softmax(logits[r, :]) rounded to q's dtype
//   out[b, g, r] = sum_s w[r, s] v[b, g, s]          (f32, then q's dtype)
// the TPU kernel's order: f32 logits of the compute-dtype operands, the
// additive f32 mask, the f32 softmax with the row's true max normalised by
// a division, the normalised weights rounded before AV, AV accumulated in
// f32 and rounded once. Flash-decoding's unnormalised rescaled accumulator
// is another function (it rounds other weights) and is not used.
//
// Bound. Per step the kernel must read each layer's k and v once: 2 S D
// elements per (b, g) against ~4 R S D operations, so it is bound by bytes
// (Qwen2-7B's batch, B = 576, KV = 4, D = 128, S = 64: 75 MB, ~22 us at
// 3.35 TB/s); chip_smoke.py computes the bound of each shape.
//
// Design. A block of 4 warps takes one (b, g) and one contiguous range
// ("split") of at most kMaxChunk cache slots:
//  * k and then v stream through a 3-stage shared-memory ring of 64-slot
//    tiles filled by 16-byte cp.async (rows padded by 16 bytes, so that
//    ldmatrix's eight 16-byte rows hit eight bank groups; a split of one
//    tile has two slots); every (b, g) slab is one contiguous [S, D]
//    range. Two tiles are always in flight,
//    so the first v tiles arrive while the softmax runs, and at S = 64 k
//    and v are both requested before anything else happens; the split's
//    mask slots come with the first tile (4-byte cp.async), so no logit
//    waits on a device-memory read. Slots past the split read as zeros
//    (cp.async with a zero source size).
//  * bf16: Q.K^T on the tensor cores with mma.sync.m16n8k16 (16 slots are
//    M, the group's R <= 8 query heads are N = 8, rows past R zeros),
//    each warp 16 slots of a tile; the f32 accumulator is scaled with
//    __fmul_rn and the mask added with __fadd_rn into an R x chunk f32
//    logit array in shared memory. One warp a row then takes the max,
//    the sum of exp(s - m) and w = exp(s - m) / sum, rounded to bf16 and
//    written in place over the row's logits (zeros past the split and in
//    rows past R). P.V as out^T[d, r] = sum_s V^T[d, s] P^T[s, r]:
//    A = V^T by ldmatrix.trans from the v tile, B = the bf16 weights, the
//    warps splitting D (no cross-warp sum). mma.sync and not wgmma: the
//    products are 16 x 8 tiles of a byte-bound kernel, and wgmma's 64-row
//    M would be 7/8 padding on either product.
//  * f32 (QwenConfig.tiny(), D = 16): the same loads; exact f32 FMA on the
//    CUDA cores (no TF32), f32 weights.
//  * Splits. When B * KV gives fewer blocks than two a SM and S is long
//    enough to give each split 256 slots or more, or S exceeds kMaxChunk,
//    the wrapper splits S across blocks: the kernel
//    runs once in the stats mode (each split's row max and sum of
//    exp(s - m)), once in the partial mode (each split recomputes its
//    logits, combines the splits' max and sum in split order into the
//    row's own, forms the normalised weights against them, rounds them and
//    writes an f32 P.V partial), and a last kernel adds the partials in
//    split order and rounds once. Every sum runs in a fixed order, so two
//    calls give the same bits.
// A row whose every slot is masked gives what the plain version gives
// (NaN: exp(-inf - -inf)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_attention.cuh"  // bf16, warp_sum / warp_max, to_f32 and the tail path

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // cache slots a ring tile holds (16 a warp)
constexpr int kStages = 3;      // ring slots: two tiles in flight (a fourth costs blocks an SM)
constexpr int kMaxR = 8;        // query heads per KV head: mma's N
constexpr int kMaxChunk = 1024;  // slots a block takes (its logits live in shared memory)

enum Mode { kFused = 0, kStats = 1, kPartial = 2 };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
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

// Shared memory: the ring (kStages tiles of kTile padded rows), q (kMaxR
// padded rows, zeros past R), the logits (kMaxR rows of chunk + 4 f32; the
// weights overwrite them in place, as T), the split's mask slots. Offsets
// in bytes.
template <typename T, int D>
struct Smem {
  static constexpr int kRow = D * (int)sizeof(T) + 16;  // a padded k / v / q row
  static constexpr int kTileBytes = kTile * kRow;
  // ring slots: a split of one tile streams two (k, v), both in flight at
  // once, and needs no third
  __host__ __device__ static int slots(int chunk) {
    const int nt = 2 * ((chunk + kTile - 1) / kTile);
    return nt < kStages ? nt : kStages;
  }
  __host__ __device__ static int q_at(int chunk) { return slots(chunk) * kTileBytes; }
  __host__ __device__ static int logits_at(int chunk) { return q_at(chunk) + kMaxR * kRow; }
  // f32 logits a row: the split's slots rounded up to whole tiles, plus 4
  // (rows 16 bytes apart in the banks: the weight reads are conflict-free)
  __host__ __device__ static int ld(int chunk) { return (chunk + kTile - 1) / kTile * kTile + 4; }
  __host__ __device__ static int mask_at(int chunk) { return logits_at(chunk) + kMaxR * ld(chunk) * 4; }
  __host__ __device__ static size_t bytes(int chunk) { return mask_at(chunk) + (size_t)ld(chunk) * 4; }
};

// The row's max and sum of exp(s - m) over n logits, lane-strided
// ascending then a fixed shuffle tree (every lane gets both). Every slot
// masked: (-inf, 0), so that such a split adds nothing to the combined
// sum, and a row masked everywhere still gives exp(-inf - -inf) / 0 = NaN.
__device__ __forceinline__ float2 row_stats(const float* pr, int n, int lane) {
  float mx = -INFINITY;
  for (int s = lane; s < n; s += 32) mx = fmaxf(mx, pr[s]);
  mx = warp_max(mx);
  const float m0 = mx == -INFINITY ? 0.f : mx;
  float sum = 0.f;
  for (int s = lane; s < n; s += 32) sum += expf(__fsub_rn(pr[s], m0));
  return make_float2(mx, warp_sum(sum));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ mask, T* __restrict__ out, float2* __restrict__ stats,
                      float* __restrict__ part, int KV, int R, int S, int chunk, int splits, int mode,
                      float scale) {
  using L = Smem<T, D>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kCpr = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  unsigned char* qs = smem + L::q_at(chunk);
  float* ps = reinterpret_cast<float*>(smem + L::logits_at(chunk));
  const int ldp = L::ld(chunk);

  const int split = blockIdx.x % splits, bg = blockIdx.x / splits;
  const int b = bg / KV;
  const int BKV = gridDim.x / splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // mma fragment row / column pair
  const int s_begin = split * chunk;
  const int n = min(S, s_begin + chunk) - s_begin;  // slots of this split (>= 1)
  const int nk = (n + kTile - 1) / kTile;
  const int nt = mode == kStats ? nk : 2 * nk;  // ring tiles: k, then v
  const T* kb = k + ((size_t)bg * S + s_begin) * D;
  const T* vb = v + ((size_t)bg * S + s_begin) * D;
  // the split's mask slots arrive with the first tile (its commit group)
  float* mb = reinterpret_cast<float*>(smem + L::mask_at(chunk));
  for (int i = tid; i < n; i += kThreads) cp_async4(smem_u32(mb + i), mask + (size_t)b * S + s_begin + i);

  // tile t of the stream into ring slot t % kStages (one commit group
  // each, empty past the stream's end)
  auto issue = [&](int t) {
    if (t < nt) {
      const T* src = t < nk ? kb : vb;
      const int s0 = (t < nk ? t : t - nk) * kTile;
      const uint32_t dst = ring + (uint32_t)((t % kStages) * L::kTileBytes);
      for (int i = tid; i < kTile * kCpr; i += kThreads) {
        const int row = i / kCpr, part16 = i % kCpr;
        const bool ok = s0 + row < n;
        cp_async16(dst + row * L::kRow + part16 * 16, ok ? (const void*)(src + (size_t)(s0 + row) * D + part16 * (16 / sizeof(T))) : (const void*)src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // q rows, zeros past R; bf16: every warp's Q.K^T B fragments in registers
  const T* qb = q + (size_t)bg * R * D;
  for (int i = tid; i < kMaxR * D; i += kThreads) {
    const int r = i / D, d = i % D;
    reinterpret_cast<T*>(qs + r * L::kRow)[d] = r < R ? qb[r * D + d] : from_f32<T>(0.f);
  }
  __syncthreads();
  uint32_t qf[kBf16 ? D / 16 : 1][2];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const unsigned char* qr = qs + g * L::kRow + (kk * 16 + 2 * c) * 2;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 16);
    }
  }

  // combined max and sum of the splits (the partial mode), per row
  auto combined = [&](int r) {
    const float2* st = stats + (size_t)bg * R + r;
    float m = -INFINITY;
    for (int i = 0; i < splits; ++i) m = fmaxf(m, st[(size_t)i * BKV * R].x);
    float l = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float2 x = st[(size_t)i * BKV * R];
      l += x.y * expf(__fsub_rn(x.x, m));
    }
    return make_float2(m, l);
  };

  constexpr int kMT = (D / 16 + kWarps - 1) / kWarps;  // P.V m-tiles (16 of D) a warp, bf16
  float acc[kMT][4];   // bf16: out^T fragments
  float accf[kMaxR];   // f32: out[r, d] of this thread's column
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) accf[j] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; slot (t - 1) % kStages is free
    issue(t + kStages - 1);
    const uint32_t slot = ring + (uint32_t)((t % kStages) * L::kTileBytes);
    const unsigned char* slot_p = smem + (t % kStages) * L::kTileBytes;

    if (t == nk) {
      // softmax, one warp a row: normalised weights over the logits, as T
      for (int r = warp; r < kMaxR; r += kWarps) {
        float* pr = ps + r * ldp;
        T* wr = reinterpret_cast<T*>(pr);
        if (r < R) {
          const float2 ml = mode == kPartial ? combined(r) : row_stats(pr, n, lane);
          for (int s0 = 0; s0 < nk * kTile; s0 += 32) {
            const int s = s0 + lane;
            const float w = s < n ? __fdiv_rn(expf(__fsub_rn(pr[s], ml.x)), ml.y) : 0.f;
            __syncwarp();  // bf16 in place: every lane has read before any lane writes
            wr[s] = from_f32<T>(w);
          }
        } else {
          for (int s = lane; s < nk * kTile; s += 32) wr[s] = from_f32<T>(0.f);
        }
      }
      __syncthreads();
    }

    if (t < nk) {
      // logits of this tile's slots
      const int w0 = t * kTile + warp * 16;  // this warp's first slot (split-relative)
      if (w0 < n) {
        if constexpr (kBf16) {
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
          const int mi = lane >> 3, i = lane & 7;
          const uint32_t a_addr = slot + (uint32_t)((warp * 16 + i + (mi & 1) * 8) * L::kRow + (mi >> 1) * 16);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, a_addr + kk * 32);
            mma_16816(d4, a, qf[kk][0], qf[kk][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = w0 + g + (e >> 1) * 8, r = 2 * c + (e & 1);
            if (s < n && r < R) ps[r * ldp + s] = __fadd_rn(__fmul_rn(d4[e], scale), mb[s]);
          }
        } else {
          const int s = w0 + (lane & 15);
          const float* kr = reinterpret_cast<const float*>(slot_p + (warp * 16 + (lane & 15)) * L::kRow);
          for (int r = lane >> 4; r < R; r += 2) {
            const float* qr = reinterpret_cast<const float*>(qs + r * L::kRow);
            float dot = 0.f;
#pragma unroll 16
            for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
            if (s < n) ps[r * ldp + s] = __fadd_rn(__fmul_rn(dot, scale), mb[s]);
          }
        }
      }
    } else {
      // P.V over this v tile
      const int j0 = (t - nk) * kTile;  // split-relative slot of the tile's row 0
      if constexpr (kBf16) {
        const unsigned char* pw = reinterpret_cast<const unsigned char*>(ps) + g * ldp * 4;
        const int mi = lane >> 3, i = lane & 7;
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          if (j0 + kk * 16 >= n) break;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pw + (j0 + kk * 16 + 2 * c) * 2);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pw + (j0 + kk * 16 + 8 + 2 * c) * 2);
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            const int mt = warp + m * kWarps;
            if (mt < D / 16) {
              uint32_t a[4];
              ldmatrix_x4_trans(a, slot + (uint32_t)((kk * 16 + i + (mi >> 1) * 8) * L::kRow +
                                                     (mt * 16 + (mi & 1) * 8) * 2));
              mma_16816(acc[m], a, b0, b1);
            }
          }
        }
      } else {
        constexpr int kGroups = kThreads / D > kMaxR ? kMaxR : kThreads / D;  // row groups
        const int d = tid % D, rg = tid / D;
        const int m = min(kTile, n - j0);
        if (rg < kGroups) {
          for (int s = 0; s < m; ++s) {
            const float vv = reinterpret_cast<const float*>(slot_p + s * L::kRow)[d];
#pragma unroll
            for (int j = 0; j < kMaxR; ++j) {
              const int r = rg + j * kGroups;
              if (j * kGroups < kMaxR && r < R) accf[j] = fmaf(ps[r * ldp + j0 + s], vv, accf[j]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (mode == kStats) {
    __syncthreads();  // the last tile's logits
    for (int r = warp; r < R; r += kWarps) {
      const float2 ml = row_stats(ps + r * ldp, n, lane);
      if (lane == 0) stats[((size_t)split * BKV + bg) * R + r] = ml;
    }
    return;
  }
  // out (fused) or the split's f32 partial, [R, D] of this (b, g)
  auto put = [&](int r, int d, float x) {
    if (mode == kFused) {
      out[((size_t)bg * R + r) * D + d] = from_f32<T>(x);
    } else {
      part[(((size_t)split * BKV + bg) * R + r) * D + d] = x;
    }
  };
  if constexpr (kBf16) {
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int mt = warp + m * kWarps;
      if (mt < D / 16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = mt * 16 + g + (e >> 1) * 8, r = 2 * c + (e & 1);
          if (r < R) put(r, d, acc[m][e]);
        }
      }
    }
  } else {
    constexpr int kGroups = kThreads / D > kMaxR ? kMaxR : kThreads / D;
    const int d = tid % D, rg = tid / D;
    if (rg < kGroups) {
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int r = rg + j * kGroups;
        if (j * kGroups < kMaxR && r < R) put(r, d, accf[j]);
      }
    }
  }
}

// out = the splits' partials added in split order, rounded once
template <typename T>
__global__ void decode_reduce_kernel(const float* __restrict__ part, T* __restrict__ out, int total, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * total + i];
  out[i] = from_f32<T>(s);
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v, const void* mask, void* out, void* ws, int B,
                  int KV, int R, int S, int splits, int chunk, cudaStream_t stream) {
  const size_t smem = Smem<T, D>::bytes(chunk);
  static bool attr_set = false;  // once: the largest chunk's shared memory
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(decode_gqa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Smem<T, D>::bytes(kMaxChunk));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));  // the TPU kernel's 1 / np.sqrt(D)
  const int BKV = B * KV;
  float2* stats = (float2*)ws;
  float* part = (float*)ws + (size_t)2 * splits * BKV * R;
  const dim3 grid(BKV * splits);
  if (splits == 1) {
    decode_gqa_kernel<T, D><<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                               (const float*)mask, (T*)out, nullptr, nullptr, KV, R,
                                                               S, chunk, 1, kFused, scale);
    return (int)cudaGetLastError();
  }
  for (int mode = kStats; mode <= kPartial; ++mode) {
    decode_gqa_kernel<T, D><<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                               (const float*)mask, (T*)out, stats, part, KV, R, S,
                                                               chunk, splits, mode, scale);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return (int)le;
  }
  const int total = BKV * R * D;
  decode_reduce_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(part, (T*)out, total, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 words of workspace the split path needs: per split, the (max, sum)
// pairs and the [B, KV, R, D] partial.
extern "C" int tvc_decode_gqa_workspace(int B, int KV, int R, int D, int splits) {
  return splits > 1 ? splits * B * KV * R * (2 + D) : 0;
}

// out [B, KV, R, D] = attention of q [B, KV, R, D] over k, v [B, KV, S, D]
// with the additive f32 mask [B, S]; is_bf16 != 0: q, k, v, out bf16, else
// f32. S is cut into `splits` ranges of `chunk` slots (a multiple of 16,
// at most 1024; splits * chunk >= S > (splits - 1) * chunk); ws holds
// tvc_decode_gqa_workspace() f32 words when splits > 1. D is 16, 32, 64 or
// 128 (16: QwenConfig.tiny()), 1 <= R <= 8.
extern "C" int tvc_decode_gqa(const void* q, const void* k, const void* v, const void* mask, void* out, void* ws,
                              int B, int KV, int R, int S, int D, int is_bf16, int splits, int chunk,
                              void* stream) {
  if (R < 1 || R > kMaxR || S < 1 || splits < 1 || chunk < 16 || chunk % 16 || chunk > kMaxChunk ||
      (long long)splits * chunk < S || (long long)(splits - 1) * chunk >= S || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || KV < 1) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define TVC_DECODE_D(DD)                                                                                \
  if (D == DD)                                                                                          \
    return is_bf16 ? launch_decode<bf16, DD>(q, k, v, mask, out, ws, B, KV, R, S, splits, chunk, st)    \
                   : launch_decode<float, DD>(q, k, v, mask, out, ws, B, KV, R, S, splits, chunk, st);
  TVC_DECODE_D(128)
  TVC_DECODE_D(64)
  TVC_DECODE_D(32)
  TVC_DECODE_D(16)
#undef TVC_DECODE_D
  return (int)cudaErrorInvalidValue;
}

// The tail path: any R, S and D (the wrapper takes it for head widths off
// the tiled kernel's and for R > 8), the same operands and function as
// tvc_decode_gqa, one launch of the header's attention_rows_kernel, no
// workspace.
extern "C" int tvc_decode_gqa_any(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                                  int KV, int R, int S, int D, int is_bf16, void* stream) {
  if (R < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (B < 1 || KV < 1) return (int)cudaGetLastError();
  const float scale = (float)(1.0 / sqrt((double)D));
  const long long head = (long long)R * D, cache = (long long)S * D;
  const RowLayout L{KV, {KV * head, head, D}, {KV * cache, cache, D}, {KV * head, head, D}};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_attention_rows<bf16, bf16>(q, k, v, (const float*)mask, out, L, B * KV, R, S, D, 0, scale, st);
  return launch_attention_rows<float, float>(q, k, v, (const float*)mask, out, L, B * KV, R, S, D, 0, scale, st);
}
