// Exact streaming top-k of query-bank inner products for Hopper (sm_90a):
// the port of the TPU kernel tvc/core/pallas/topk_kernel.py (_topk_kernel,
// bank_topk). The [B, N] score matrix never exists in device memory.
//
// What it computes: for each query b, the k bank rows of largest
// score q_b . bank_r among the valid rows, ordered by (score descending,
// row index ascending) -- the TPU kernel's order, whose running list merges
// each tile by first-argmax with the running entries (lower indices) first.
// Scores are f32 sums of f32 products; bf16 operands are converted to f32
// exactly first (no TF32 or split-TF32: another rounding, and it would
// change which rows win). With `normalize`, the kernel divides each score
// by the bank row's norm, max(sqrt(sum of its squares), eps), which it sums
// in f32 from the tiles it streams: (q^ . b) / |b| rather than the plain
// version's q^ . (b / |b|), a few f32 ulps apart.
//
// What bounds it: 2 B N D flops of f32 FMA against 4 N D bytes of bank, ~2
// flops a byte at B = 1 and 128 at B = 256, so at serving batch sizes the
// card's f32 rate (67 TF/s, no tensor cores) bounds it -- and, right behind
// it, shared memory: an SM issues 128 FMA a clock and its shared memory
// delivers 128 bytes a clock (4 bytes a lane), so a thread must take at
// least 4 FMA from every float it loads.
//
// Two launches:
//  * bank_topk_partial_kernel: a block of 256 threads (one an SM: ~255
//    registers) takes 128 queries and one contiguous range ("split") of
//    bank rows and streams the range in 256-row tiles, 16 columns a stage
//    (8 when k is so large that the sorted lists leave too little shared
//    memory for three 16-column stages), through a 3-stage shared-memory
//    ring filled by 16-byte cp.async (one barrier a stage). Both operand
//    tiles lie as in device memory, each row stride an odd number of
//    16-byte words (80 bytes at 16 f32 columns, 48 at 16 bf16 or 8 f32, 16
//    at 8 bf16): a thread's 8 queries are rows ty + 16a and its 16 bank
//    rows tx + 16b, so at each 4-column step it reads 8 + 16 four-value
//    words (the 8 bank rows of a warp's lanes hit 8 distinct bank groups,
//    its 4 query rows 4; the rest are broadcasts) for 512 FMAs: 0.75 bytes
//    of shared memory a FMA. At the tile's end each thread holds its 8 x 16
//    scores in registers. A query's candidates must beat two filters: its
//    k-th score as the tile started (it only rises, so a stale copy is
//    safe; strictly greater, since the rows of a split arrive in ascending
//    order and an equal score loses to the lower index already held), and,
//    while its list is not full and k <= 16, the k-th largest of the 16
//    maxima its 16 threads hold in this tile (k of the tile's scores are at
//    least that, so a lower score cannot be in the top k; an equal one may,
//    and passes) -- so the first tile of a split sends ~k candidates a
//    query to the lists, not 256. Only when some score passes (a block
//    vote) do the passing (score, row) pairs go to per-query buckets in
//    shared memory, and one warp a query merges them into its sorted list
//    (k <= 128 entries) by rank: every entry's and candidate's new place is
//    the count of those before it in the full (score, row) order, so the
//    order in which candidates arrive does not matter. Each block writes
//    its lists to [B, splits, k] (unfilled slots (-inf, INT_MAX)).
//  * bank_topk_merge_kernel: a warp per query merges the split lists by
//    their heads in the same order and writes [B, k]; when fewer than k rows
//    are valid, the surplus slots hold (-inf, s) with s the TPU kernel's
//    leftover index: the best valid row below `cutoff` (the first row of the
//    TPU kernel's last tile), else 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQB = 128;       // queries a block (8 a thread)
constexpr int kNB = 256;       // bank rows a tile (16 a thread)
constexpr int kStages = 3;     // ring stages
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 16 scores each
constexpr int kBucket = 32;    // candidates a query per fold round (a warp's lanes)
constexpr int kMaxK = 128;
constexpr int kNoIdx = 0x7fffffff;
constexpr int kMergeWarps = 4;
constexpr float kEps = 1e-8f;  // tvc_torch.core.similarity.EPS

__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

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

// four consecutive values of a shared-memory row as f32 (bf16 exactly)
__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 lds4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One operand's tile of a stage: `Rows` rows of DK columns, the row
// stride an odd number of 16-byte words (conflict-free 16-byte reads of 8
// consecutive rows).
template <typename T, int Rows, int DK>
struct OpTile {
  static constexpr int kData = DK * (int)sizeof(T);
  static constexpr int kRow = (kData / 16) % 2 ? kData : kData + 16;
  static constexpr int kBytes = Rows * kRow;
  static constexpr int kChunks = kData / 16;  // 16-byte pieces a row
};

// Shared memory: the ring (kStages x (q tile, bank tile)), the sorted
// lists [kQB][k] (scores, rows), the buckets [kQB][kBucket] (scores,
// rows), per query its list length, k-th score (-inf until full), bucket
// fill and the tile's seed threshold, per query and thread column its
// tile maximum, and per tile row its norm.
template <typename QT, typename BT, int DK>
struct Layout {
  static constexpr int kStage = OpTile<QT, kQB, DK>::kBytes + OpTile<BT, kNB, DK>::kBytes;
  static constexpr int kLists = kStages * kStage;
  __host__ __device__ static size_t bytes(int k) {
    return kLists + (size_t)kQB * k * 8 + (size_t)kQB * kBucket * 8 + (size_t)kQB * 16 + kQB * 16 * 4 + kNB * 4;
  }
};

template <typename QT, typename BT, int DK>
__global__ void __launch_bounds__(kThreads, 1)
    bank_topk_partial_kernel(const QT* __restrict__ q, const BT* __restrict__ bank,
                             const uint8_t* __restrict__ valid, const float* __restrict__ floor_vals,
                             const int* __restrict__ floor_idx, float* __restrict__ part_vals,
                             int* __restrict__ part_idx, int B, int N, int D, int k, int rows_per_split,
                             int normalize) {
  using L = Layout<QT, BT, DK>;
  using QTile = OpTile<QT, kQB, DK>;
  using BTile = OpTile<BT, kNB, DK>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lv = reinterpret_cast<float*>(smem + L::kLists);  // [kQB][k]
  int* li = reinterpret_cast<int*>(lv + kQB * k);           // [kQB][k]
  float* bval = reinterpret_cast<float*>(li + kQB * k);     // [kQB][kBucket]
  int* bidx = reinterpret_cast<int*>(bval + kQB * kBucket); // [kQB][kBucket]
  int* cnt = bidx + kQB * kBucket;                          // [kQB]
  float* thr = reinterpret_cast<float*>(cnt + kQB);         // [kQB]
  int* bcnt = reinterpret_cast<int*>(thr + kQB);            // [kQB]
  float* seed = reinterpret_cast<float*>(bcnt + kQB);       // [kQB]
  float* tmax = seed + kQB;                                 // [kQB][16]
  float* rnorm = tmax + kQB * 16;                           // [kNB] 1 / the tile rows' norms

  const int split = blockIdx.x, splits = gridDim.x;
  const int q0 = blockIdx.y * kQB;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // a warp: 8 bank-row columns x 4 query rows
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  for (int i = tid; i < kQB; i += kThreads) {
    cnt[i] = 0;
    thr[i] = -INFINITY;
    bcnt[i] = 0;
  }

  const int nst = (D + DK - 1) / DK;  // stages a tile
  const int tiles = r_end > r_begin ? (r_end - r_begin + kNB - 1) / kNB : 0;
  const int steps = tiles * nst;
  const uint32_t ring = smem_u32(smem);

  // stage `step` into ring slot step % kStages (one commit group each,
  // empty past the last); rows past B / r_end and columns past D are zeros
  auto issue = [&](int step) {
    if (step < steps) {
      const int t = step / nst, d0 = (step % nst) * DK;
      const uint32_t qdst = ring + (uint32_t)((step % kStages) * L::kStage);
      const uint32_t bdst = qdst + QTile::kBytes;
      for (int i = tid; i < kQB * QTile::kChunks; i += kThreads) {
        const int row = i / QTile::kChunks, piece = i % QTile::kChunks;
        const int d = d0 + piece * (16 / (int)sizeof(QT));
        const bool ok = q0 + row < B && d < D;
        cp_async16(qdst + row * QTile::kRow + piece * 16, ok ? (const void*)(q + (size_t)(q0 + row) * D + d) : q, ok);
      }
      const int rb = r_begin + t * kNB;
      for (int i = tid; i < kNB * BTile::kChunks; i += kThreads) {
        const int row = i / BTile::kChunks, piece = i % BTile::kChunks;
        const int d = d0 + piece * (16 / (int)sizeof(BT));
        const bool ok = rb + row < r_end && d < D;
        cp_async16(bdst + row * BTile::kRow + piece * 16,
                   ok ? (const void*)(bank + (size_t)(rb + row) * D + d) : bank, ok);
      }
    }
    cp_async_commit();
  };

  // merge the buckets' candidates into the lists, one warp a query: each
  // entry's new place is its old place plus the candidates before it, each
  // candidate's the list entries and the other candidates before it (the
  // (score, row) order is strict: rows are distinct), so the result is the
  // top k of the union whatever order the candidates came in
  auto fold = [&]() {
    for (int qq = warp; qq < kQB; qq += kThreads / 32) {
      const int n = min(bcnt[qq], kBucket);
      if (n == 0) continue;
      float* v = lv + qq * k;
      int* ix = li + qq * k;
      const int c = cnt[qq];
      const float cs = lane < n ? bval[qq * kBucket + lane] : -INFINITY;
      const int ci = lane < n ? bidx[qq * kBucket + lane] : kNoIdx;
      float ev[kMaxK / 32];
      int ei[kMaxK / 32], ep[kMaxK / 32];
#pragma unroll
      for (int t = 0; t < kMaxK / 32; ++t) {
        const int j = lane + 32 * t;
        ev[t] = j < c ? v[j] : -INFINITY;
        ei[t] = j < c ? ix[j] : kNoIdx;
        ep[t] = j;
      }
      int pos = 0;
      for (int j = 0; j < n; ++j) {
        const float s2 = __shfl_sync(0xffffffffu, cs, j);
        const int i2 = __shfl_sync(0xffffffffu, ci, j);
        pos += better(s2, i2, cs, ci);
#pragma unroll
        for (int t = 0; t < kMaxK / 32; ++t) ep[t] += better(s2, i2, ev[t], ei[t]);
      }
      for (int j = 0; j < c; ++j) pos += better(v[j], ix[j], cs, ci);
      __syncwarp();  // every lane has read the old list
#pragma unroll
      for (int t = 0; t < kMaxK / 32; ++t) {
        if (lane + 32 * t < c && ep[t] < k) {
          v[ep[t]] = ev[t];
          ix[ep[t]] = ei[t];
        }
      }
      if (lane < n && pos < k) {
        v[pos] = cs;
        ix[pos] = ci;
      }
      __syncwarp();
      if (lane == 0) {
        const int nc = min(k, c + n);
        cnt[qq] = nc;
        thr[qq] = nc == k ? v[k - 1] : -INFINITY;
        bcnt[qq] = 0;
      }
      __syncwarp();
    }
  };

  float acc[8][16];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 16; ++b) acc[a][b] = 0.f;
  float ss = 0.f;  // normalize: tile row tid's sum of squares

#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) issue(i);
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` landed for every thread; slot (step - 1) % kStages is free
    issue(step + kStages - 1);
    const unsigned char* qsl = smem + (step % kStages) * L::kStage;
    const unsigned char* bsl = qsl + QTile::kBytes;
#pragma unroll
    for (int d4 = 0; d4 < DK; d4 += 4) {
      float4 qa[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) qa[a] = lds4(reinterpret_cast<const QT*>(qsl + (ty + 16 * a) * QTile::kRow) + d4);
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const float4 x = lds4(reinterpret_cast<const BT*>(bsl + (tx + 16 * b) * BTile::kRow) + d4);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          acc[a][b] = fmaf(qa[a].x, x.x, acc[a][b]);
          acc[a][b] = fmaf(qa[a].y, x.y, acc[a][b]);
          acc[a][b] = fmaf(qa[a].z, x.z, acc[a][b]);
          acc[a][b] = fmaf(qa[a].w, x.w, acc[a][b]);
        }
      }
    }
    if (normalize) {
      const BT* p = reinterpret_cast<const BT*>(bsl + tid * BTile::kRow);
#pragma unroll
      for (int d = 0; d < DK; d += 4) {
        const float4 x = lds4(p + d);
        ss = fmaf(x.x, x.x, ss), ss = fmaf(x.y, x.y, ss), ss = fmaf(x.z, x.z, ss), ss = fmaf(x.w, x.w, ss);
      }
    }
    if (step % nst != nst - 1) continue;

    // the tile's end: scores, each query's tile maximum of this thread
    const int tile_row0 = r_begin + (step / nst) * kNB;
    if (normalize) {
      rnorm[tid] = __frcp_rn(fmaxf(sqrtf(ss), kEps));
      ss = 0.f;
    }
    __syncthreads();  // rnorm written; thr stable since the last fold
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int row = tile_row0 + tx + 16 * b;
        const bool ok = row < r_end && (valid == nullptr || valid[row]) && q0 + ty + 16 * a < B;
        float s = ok ? (normalize ? __fmul_rn(acc[a][b], rnorm[tx + 16 * b]) : acc[a][b]) : -INFINITY;
        // a later pass of k > 128: only rows after the query's floor entry
        // in the (score, row) order (before the tile maxima, so the seed
        // filter sees the eligible rows only)
        if (floor_vals != nullptr && ok) {
          const int qg = q0 + ty + 16 * a;
          if (!better(floor_vals[qg], floor_idx[qg], s, row)) s = -INFINITY;
        }
        acc[a][b] = s;
        mx = fmaxf(mx, s);
      }
      tmax[(ty + 16 * a) * 16 + tx] = mx;
    }
    __syncthreads();
    // a query's seed while its list is not full: the k-th largest of its 16
    // thread maxima (k <= 16), at most the k-th largest score of the tile
    if (tid < kQB) {
      float sd = -INFINITY;
      if (k <= 16 && cnt[tid] < k) {
        const float* m = tmax + tid * 16;
#pragma unroll 1
        for (int i = 0; i < 16; ++i) {
          int above = 0;
#pragma unroll
          for (int j = 0; j < 16; ++j) above += m[j] > m[i] || (m[j] == m[i] && j < i);
          if (above == k - 1) sd = m[i];
        }
      }
      seed[tid] = sd;
    }
    __syncthreads();
    uint64_t pass[2] = {0, 0};
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float th = thr[ty + 16 * a], sd = seed[ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (acc[a][b] > th && acc[a][b] >= sd) pass[a >> 2] |= 1ull << ((a & 3) * 16 + b);
    }
    while (__syncthreads_or((pass[0] | pass[1]) != 0)) {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const uint64_t bit = 1ull << ((a & 3) * 16 + b);
          if (pass[a >> 2] & bit) {
            const int qq = ty + 16 * a;
            // a fold of this tile may have raised the query's k-th score
            const int slot = acc[a][b] > thr[qq] ? atomicAdd(&bcnt[qq], 1) : -1;
            if (slot < 0) pass[a >> 2] &= ~bit;
            if (slot >= 0 && slot < kBucket) {
              bval[qq * kBucket + slot] = acc[a][b];
              bidx[qq * kBucket + slot] = tile_row0 + tx + 16 * b;
              pass[a >> 2] &= ~bit;
            }
          }
        }
      __syncthreads();
      fold();
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 16; ++b) acc[a][b] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
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

template <typename QT, typename BT, int DK>
int launch_partial_dk(const void* q, const void* bank, const uint8_t* valid, const float* fv, const int* fi,
                      float* pv, int* pi, int B, int N, int D, int k, int rows_per_split, int splits, int normalize,
                      cudaStream_t stream) {
  const size_t smem = Layout<QT, BT, DK>::bytes(k);
  static size_t allowed = 0;  // the kernel's shared-memory limit, raised as larger k come
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(bank_topk_partial_kernel<QT, BT, DK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid(splits, (B + kQB - 1) / kQB);
  bank_topk_partial_kernel<QT, BT, DK><<<grid, kThreads, smem, stream>>>(
      (const QT*)q, (const BT*)bank, valid, fv, fi, pv, pi, B, N, D, k, rows_per_split, normalize);
  return (int)cudaGetLastError();
}

// 16 columns a stage where the ring and the lists of k entries fit a
// block's shared memory, else 8
template <typename QT, typename BT>
int launch_partial(const void* q, const void* bank, const uint8_t* valid, const float* fv, const int* fi,
                   float* pv, int* pi, int B, int N, int D, int k, int rows_per_split, int splits, int normalize,
                   cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (Layout<QT, BT, 16>::bytes(k) <= (size_t)optin)
    return launch_partial_dk<QT, BT, 16>(q, bank, valid, fv, fi, pv, pi, B, N, D, k, rows_per_split, splits,
                                         normalize, stream);
  return launch_partial_dk<QT, BT, 8>(q, bank, valid, fv, fi, pv, pi, B, N, D, k, rows_per_split, splits,
                                      normalize, stream);
}

}  // namespace

// q [B, D] and bank [N, D] row-major (f32 or bf16 each, 16-byte aligned),
// valid [N] u8 or null (every row valid); floor_vals f32 / floor_idx i32
// [B] or both null: when given, query b takes only rows that come after
// (floor_vals[b], floor_idx[b]) in the (score descending, row ascending)
// order -- the next pass of a k above 128, whose floor is the previous
// pass's last entry; part_vals / part_idx [B, splits, k]. Split s takes
// rows [s * rows_per_split, (s + 1) * rows_per_split). normalize != 0:
// each score divided by its bank row's norm. Returns
// cudaErrorInvalidValue unless 1 <= k <= 128, D % 8 == 0 and the splits
// cover N.
extern "C" int tvc_bank_topk_partial(const void* q, const void* bank, const void* valid, const void* floor_vals,
                                     const void* floor_idx, void* part_vals, void* part_idx, int B, int N, int D,
                                     int k, int rows_per_split, int splits, int bank_is_bf16, int q_is_bf16,
                                     int normalize, void* stream) {
  if (k < 1 || k > kMaxK || D < 8 || D % 8 || rows_per_split < 1 || splits < 1 ||
      (long long)rows_per_split * splits < N || B < 1 || ((uintptr_t)q | (uintptr_t)bank) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((floor_vals == nullptr) != (floor_idx == nullptr)) return (int)cudaErrorInvalidValue;
  const uint8_t* v = (const uint8_t*)valid;
  const float* fv = (const float*)floor_vals;
  const int* fi = (const int*)floor_idx;
  float* pv = (float*)part_vals;
  int* pi = (int*)part_idx;
  if (q_is_bf16) {
    return bank_is_bf16
               ? launch_partial<bf16, bf16>(q, bank, v, fv, fi, pv, pi, B, N, D, k, rows_per_split, splits, normalize, s)
               : launch_partial<bf16, float>(q, bank, v, fv, fi, pv, pi, B, N, D, k, rows_per_split, splits, normalize, s);
  }
  return bank_is_bf16
             ? launch_partial<float, bf16>(q, bank, v, fv, fi, pv, pi, B, N, D, k, rows_per_split, splits, normalize, s)
             : launch_partial<float, float>(q, bank, v, fv, fi, pv, pi, B, N, D, k, rows_per_split, splits, normalize, s);
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
