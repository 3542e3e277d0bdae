// Exact streaming top-k of query-bank inner products for Hopper (sm_90a):
// the port of the TPU kernel tvc/core/pallas/topk_kernel.py (_topk_kernel,
// bank_topk). The [B, N] score matrix never exists in device memory.
//
// What it computes: for each query b, the k bank rows of largest
// score q_b . bank_r among the valid rows, ordered by (score descending,
// row index ascending) -- the TPU kernel's order, whose running list merges
// each tile by first-argmax with the running entries (lower indices) first.
// Scores are f32 sums of f32 products; bf16 operands are converted to f32
// exactly first (no TF32: it would change which rows win).
//
// Two launches:
//  * bank_topk_partial_kernel: a block takes 64 queries and one contiguous
//    range ("split") of bank rows, streams the range through shared memory
//    in 64-row x 32-column tiles (register-prefetched, the two operand tiles
//    stored transposed with an XOR swizzle of 4-row groups so that both the
//    transposing stores and the 16-byte reads of the product loop are free
//    of bank conflicts), computes the 64 x 64 score tile with 4 x 4 outputs
//    a thread, then each warp folds the tile into the sorted candidate lists
//    of its 8 queries (shared memory, k <= 128 entries each; a row enters
//    only if it beats the k-th entry, and rows arrive in ascending index
//    order, so equal scores keep the lower index first). Each block writes
//    its lists to [B, splits, k] (unfilled slots (-inf, INT_MAX)).
//  * bank_topk_merge_kernel: a warp per query merges the split lists by
//    their heads in the same order and writes [B, k]; when fewer than k rows
//    are valid, the surplus slots hold (-inf, s) with s the TPU kernel's
//    leftover index: the best valid row below `cutoff` (the first row of the
//    TPU kernel's last tile), else 0.
//
// What bounds it: 2 B N D flops of f32 FMA against 4 N D bytes of bank, ~2
// flops a byte at B = 1 and 128 at B = 256, so at serving batch sizes the
// card's f32 rate (67 TF/s, no tensor cores) bounds it. The product loop
// keeps 16 accumulators a thread and reads 2 x 16 bytes of shared memory
// per 16 FMAs; the top-k bookkeeping runs once per 64 x 64 tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQB = 64;        // queries a block
constexpr int kNB = 64;        // bank rows a tile
constexpr int kDK = 32;        // columns a stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kSLd = kNB + 1;  // score tile row
constexpr int kMaxK = 128;
constexpr int kNoIdx = 0x7fffffff;
constexpr int kMergeWarps = 4;

__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Offset of (column d, row r) in a [kDK][64] transposed tile: 4-row groups
// XOR-swizzled by column so that the transposing stores hit 32 banks.
__device__ __forceinline__ int swz(int d, int r) {
  return d * 64 + ((((r >> 2) ^ ((d >> 2) & 7)) << 2) | (r & 3));
}

// 16-byte loads of one row chunk as f32 (bf16 converted exactly).
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// A 64-row x kDK-column tile of the row-major [rows, D] matrix `src` from
// (row0, d0) into 8 registers a thread; rows at or past `limit` and columns
// past D read as 0.
template <typename T>
__device__ __forceinline__ void fetch_tile(const T* __restrict__ src, int limit, int D, int row0, int d0,
                                           float* reg) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPer = 64 * kDK / kVec / kThreads;  // 16-byte loads a thread
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int v = threadIdx.x + p * kThreads;
    const int row = v / (kDK / kVec), d = d0 + (v % (kDK / kVec)) * kVec;
    if (row0 + row < limit && d < D) {
      load16(src + (size_t)(row0 + row) * D + d, reg + p * kVec);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) reg[p * kVec + e] = 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(float* tile, const float* reg) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPer = 64 * kDK / kVec / kThreads;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int v = threadIdx.x + p * kThreads;
    const int row = v / (kDK / kVec), d = (v % (kDK / kVec)) * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) tile[swz(d + e, row)] = reg[p * kVec + e];
  }
}

__host__ __device__ inline size_t partial_smem_bytes(int k) {
  return (size_t)(2 * kDK * 64 + kQB * kSLd + kQB * k) * 4 + (size_t)kQB * k * 4 + kQB * 4;
}

// Fold one 64 x 64 score tile into the sorted lists of this warp's queries.
__device__ void fold_tile(const float* ss, float* lv, int* li, int* cnt, int q0, int B, int k, int tile_row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int qq = warp; qq < kQB; qq += kThreads / 32) {
    if (q0 + qq >= B) break;
    float* v = lv + qq * k;
    int* ix = li + qq * k;
    int c = cnt[qq];
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const float s = ss[qq * kSLd + half * 32 + lane];
      const float kth = c == k ? v[k - 1] : -INFINITY;
      unsigned m = __ballot_sync(0xffffffffu, s > -INFINITY && (c < k || s > kth));
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float cs = __shfl_sync(0xffffffffu, s, src);
        const int cidx = tile_row0 + half * 32 + src;
        if (c == k && !(cs > v[k - 1])) continue;
        // entries with score >= cs come first: their rows are lower
        int p = 0;
        for (int j0 = 0; j0 < c; j0 += 32) {
          const int j = j0 + lane;
          p += __popc(__ballot_sync(0xffffffffu, j < c && v[j] >= cs));
        }
        const int nc = c < k ? c + 1 : k;
        // shift [p, nc - 2] up to [p + 1, nc - 1]
        float sv[kMaxK / 32];
        int si[kMaxK / 32];
#pragma unroll
        for (int t = 0; t < kMaxK / 32; ++t) {
          const int j = p + 1 + lane + 32 * t;
          if (j < nc) {
            sv[t] = v[j - 1];
            si[t] = ix[j - 1];
          }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < kMaxK / 32; ++t) {
          const int j = p + 1 + lane + 32 * t;
          if (j < nc) {
            v[j] = sv[t];
            ix[j] = si[t];
          }
        }
        __syncwarp();
        if (lane == 0) {
          v[p] = cs;
          ix[p] = cidx;
        }
        __syncwarp();
        c = nc;
      }
    }
    if (lane == 0) cnt[qq] = c;
    __syncwarp();
  }
}

template <typename QT, typename BT>
__global__ void __launch_bounds__(kThreads)
    bank_topk_partial_kernel(const QT* __restrict__ q, const BT* __restrict__ bank,
                             const uint8_t* __restrict__ valid, float* __restrict__ part_vals,
                             int* __restrict__ part_idx, int B, int N, int D, int k, int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kDK][64] swizzled
  float* bs = qs + kDK * 64;                   // [kDK][64] swizzled
  float* ss = bs + kDK * 64;                   // [64][kSLd] scores
  float* lv = ss + kQB * kSLd;                 // [64][k] sorted list scores
  int* li = reinterpret_cast<int*>(lv + kQB * k);  // [64][k] their rows
  int* cnt = li + kQB * k;                     // [64] entries held

  const int split = blockIdx.x, splits = gridDim.x;
  const int q0 = blockIdx.y * kQB;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int i = tid; i < kQB; i += kThreads) cnt[i] = 0;

  const int stages = (D + kDK - 1) / kDK;
  const int tiles = r_end > r_begin ? (r_end - r_begin + kNB - 1) / kNB : 0;
  const int steps = tiles * stages;
  float qreg[8], breg[8];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (steps > 0) {
    fetch_tile(q, B, D, q0, 0, qreg);
    fetch_tile(bank, r_end, D, r_begin, 0, breg);
  }
  for (int step = 0; step < steps; ++step) {
    const int t = step / stages, st = step % stages;
    store_tile<QT>(qs, qreg);
    store_tile<BT>(bs, breg);
    __syncthreads();
    if (step + 1 < steps) {
      const int nt = (step + 1) / stages, nst = (step + 1) % stages;
      fetch_tile(q, B, D, q0, nst * kDK, qreg);
      fetch_tile(bank, r_end, D, r_begin + nt * kNB, nst * kDK, breg);
    }
#pragma unroll
    for (int d = 0; d < kDK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + swz(d, ty * 4));
      const float4 b = *reinterpret_cast<const float4*>(bs + swz(d, tx * 4));
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (st == stages - 1) {
      const int tile_row0 = r_begin + t * kNB;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = tile_row0 + tx * 4 + j;
        const bool ok = row < r_end && (valid == nullptr || valid[row]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ss[(ty * 4 + i) * kSLd + tx * 4 + j] = ok ? acc[i][j] : -INFINITY;
          acc[i][j] = 0.f;
        }
      }
      __syncthreads();
      fold_tile(ss, lv, li, cnt, q0, B, k, tile_row0);
    }
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int qq = warp; qq < kQB; qq += kThreads / 32) {
    if (q0 + qq >= B) break;
    const int c = cnt[qq];
    const size_t base = ((size_t)(q0 + qq) * splits + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_vals[base + j] = j < c ? lv[qq * k + j] : -INFINITY;
      part_idx[base + j] = j < c ? li[qq * k + j] : kNoIdx;
    }
  }
}

__global__ void __launch_bounds__(32 * kMergeWarps)
    bank_topk_merge_kernel(const float* __restrict__ part_vals, const int* __restrict__ part_idx,
                           float* __restrict__ vals, int* __restrict__ idx, int B, int splits, int k,
                           int cutoff) {
  extern __shared__ int heads_all[];  // [kMergeWarps][splits]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMergeWarps + warp;
  if (b >= B) return;  // whole warps only: the kernel syncs nothing wider
  int* heads = heads_all + warp * splits;
  for (int l = lane; l < splits; l += 32) heads[l] = 0;
  __syncwarp();
  const float* pv = part_vals + (size_t)b * splits * k;
  const int* pi = part_idx + (size_t)b * splits * k;
  int n = 0, leftover = 0;
  bool have_leftover = false;
  for (; n < k; ++n) {
    float bsc = -INFINITY;
    int bi = kNoIdx, bl = -1;
    for (int l = lane; l < splits; l += 32) {
      const int h = heads[l];
      if (h < k && better(pv[l * k + h], pi[l * k + h], bsc, bi)) {
        bsc = pv[l * k + h];
        bi = pi[l * k + h];
        bl = l;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bsc, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
      if (better(os, oi, bsc, bi)) {
        bsc = os;
        bi = oi;
        bl = ol;
      }
    }
    if (!(bsc > -INFINITY)) break;  // every list is spent: fewer than k valid rows
    if (lane == 0) {
      vals[(size_t)b * k + n] = bsc;
      idx[(size_t)b * k + n] = bi;
    }
    if (lane == (bl & 31)) heads[bl] += 1;
    __syncwarp();
    if (!have_leftover && bi < cutoff) {
      have_leftover = true;
      leftover = bi;
    }
  }
  for (int j = n + lane; j < k; j += 32) {
    vals[(size_t)b * k + j] = -INFINITY;
    idx[(size_t)b * k + j] = leftover;
  }
}

template <typename QT, typename BT>
int launch_partial(const void* q, const void* bank, const uint8_t* valid, float* pv, int* pi, int B, int N,
                   int D, int k, int rows_per_split, int splits, cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(bank_topk_partial_kernel<QT, BT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(splits, (B + kQB - 1) / kQB);
  bank_topk_partial_kernel<QT, BT><<<grid, kThreads, smem, stream>>>(
      (const QT*)q, (const BT*)bank, valid, pv, pi, B, N, D, k, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, D] and bank [N, D] row-major (f32 or bf16 each), valid [N] u8 or
// null (every row valid); part_vals / part_idx [B, splits, k]. Split s
// takes rows [s * rows_per_split, (s + 1) * rows_per_split). Returns
// cudaErrorInvalidValue unless 1 <= k <= 128, D % 8 == 0 and the splits
// cover N.
extern "C" int tvc_bank_topk_partial(const void* q, const void* bank, const void* valid, void* part_vals,
                                     void* part_idx, int B, int N, int D, int k, int rows_per_split, int splits,
                                     int bank_is_bf16, int q_is_bf16, void* stream) {
  if (k < 1 || k > kMaxK || D < 8 || D % 8 || rows_per_split < 1 || splits < 1 ||
      (long long)rows_per_split * splits < N || B < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* v = (const uint8_t*)valid;
  float* pv = (float*)part_vals;
  int* pi = (int*)part_idx;
  if (q_is_bf16) {
    return bank_is_bf16 ? launch_partial<bf16, bf16>(q, bank, v, pv, pi, B, N, D, k, rows_per_split, splits, s)
                        : launch_partial<bf16, float>(q, bank, v, pv, pi, B, N, D, k, rows_per_split, splits, s);
  }
  return bank_is_bf16 ? launch_partial<float, bf16>(q, bank, v, pv, pi, B, N, D, k, rows_per_split, splits, s)
                      : launch_partial<float, float>(q, bank, v, pv, pi, B, N, D, k, rows_per_split, splits, s);
}

// part_vals / part_idx [B, splits, k] -> vals [B, k] f32, idx [B, k] i32.
extern "C" int tvc_bank_topk_merge(const void* part_vals, const void* part_idx, void* vals, void* idx, int B,
                                   int splits, int k, int cutoff, void* stream) {
  if (k < 1 || k > kMaxK || splits < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMergeWarps * splits * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(bank_topk_merge_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bank_topk_merge_kernel<<<(B + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, smem, (cudaStream_t)stream>>>(
      (const float*)part_vals, (const int*)part_idx, (float*)vals, (int*)idx, B, splits, k, cutoff);
  return (int)cudaGetLastError();
}

// Bytes of shared memory a partial block needs for lists of k entries.
extern "C" int tvc_bank_topk_smem(int k) { return (int)partial_smem_bytes(k); }
