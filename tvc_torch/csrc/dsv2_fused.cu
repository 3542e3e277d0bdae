// DeepSeek-V2's decode-layer glue, fused, for Hopper (sm_90a): the latent
// attention's rope, latent norm, cache write and absorbed scales around the
// two absorbed products, and the MoE block's routing, sort, gather and
// combine around the two grouped expert GEMMs.
//
// Replaces no TPU kernel: the JAX package has no DeepSeek-V2 and would leave
// these steps to XLA. Run as PyTorch operators they were ~60 launches a
// layer of a decode step (the rope alone 18, the routing ~20), and the
// host's launch loop, not the card, set the decode's pace. The kernels here
// take 5 launches a layer, each returning the bits of the PyTorch
// expressions they replace (read off torch 2.11 on the card). Qwen2's
// elementwise kernels (decode_fused.cu) are a separate path: its half-split
// GQA epilogue shares nothing with the interleaved rope and latent norm.
//
// Bound: bytes, and at the decode's sizes the launch itself. At 960 rows,
// DeepSeek-V2-Lite: the rope / norm / cache pass reads the q|kv_a row and
// writes as much (14 MB, 4.2 us at 3.35 TB/s); the output scale 7.9 MB
// (2.3 us); the routing's gather reads 3.9 MB and writes the 23.6 MB of
// expert rows (8.2 us); the combine reads the 23.6 MB of expert outputs and
// the shared experts' 3.9 MB (9.4 us).
//
//  * mla_rope_cache_kernel: one block a row of the q|kv_a GEMM's output
//    [B, nh (nope + rope) + r + rope]. q_nope times the W_UK scales (f32,
//    rounded once to bf16) into [B, nh, nope]; q_pe and k_pe roped
//    (interleaved pairs (2i, 2i + 1) are the halves of rotate-half, each
//    product and sum rounded on its own, no contraction into an FMA: the bits
//    of apply_rope); the latent's RMSNorm with the row's sum of squares in
//    the order of PyTorch's reduction kernel for x.float().square().mean(-1)
//    (bw lanes, the wrapper's _torch_lanes), x * rsqrt(mean + eps) * scale in
//    f32; the normed latent and k_pe into slot `slot` of the layer's cache.
//  * mla_out_kernel: o [nh, B, v] (the second absorbed product) times the
//    W_UV scales [nh, v] in f32, rounded to bf16, written as [B, nh v].
//  * moe_route_kernel: a warp a row of the router's f32 logits [N, E]
//    (E <= 256), scored by a softmax or (Kimi-Linear, DeepSeek-V3) by
//    sigmoid(logit) + a correction bias, the weights then the unbiased
//    sigmoids, renormalised over the k (their sum in slot order, + 1e-20)
//    where asked. The softmax of PyTorch's softmax_warp_forward (the row's max
//    and sum by xor butterflies over min(np2(E), 32) lanes, lane l holding
//    elements l, l + 32; expf, IEEE division); the top k as torch.topk
//    returns them: the elements of rank < k (rank: the values above, then
//    the equal ones at lower index) gathered in radix select's order (every
//    value above the k-th in index order, then the k-th's ties), then
//    PyTorch's 32-slot bitonic sort of (value, index) pairs run step for step
//    on 16 lanes (ties come out in its order). Each block (16 rows) then
//    ranks its row-expert pairs within their expert and counts them; the
//    last block to finish (a ticket in device memory, reset by that block)
//    turns the counts into every block's start within each expert, the
//    experts' starts (the stable sort's order: by expert, then by row) and
//    the offsets, and adds the counts into the call's counters.
//  * moe_scatter_kernel: a block a row: its k positions in that order,
//    and the row copied to each (the expert GEMM's sorted rows).
//  * moe_combine_kernel: a block a row: sum_j yd[pos_j] * (w_j * scale)
//    in f32 with PyTorch's sum over the k slots (four accumulators, slot j
//    into j mod 4, combined in order), + the shared experts' row in f32,
//    rounded once to bf16; yd is read at the rows' positions, not unsorted.
// No kernel reduces in an order that depends on the schedule: two calls
// return the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRouteRows = 16;  // rows a block of the routing pass: a warp a row
constexpr int kMaxExperts = 256, kMaxTopK = 32, kSortSlots = 32;
constexpr int kLaneExperts = kMaxExperts / 32;  // experts a lane holds

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }

// 8 bf16 values (16 bytes, aligned) from / to memory
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const bf16* v = reinterpret_cast<const bf16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = f32(v[i]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 r;
  bf16* v = reinterpret_cast<bf16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = to_bf16(f[i]);
  *reinterpret_cast<uint4*>(p) = r;
}

// ---------------------------------------------------------------------------
// the latent attention's rope, latent norm, cache write and q_nope scales
// ---------------------------------------------------------------------------

__device__ __forceinline__ float add_sq(float acc, float a) { return __fadd_rn(acc, __fmul_rn(a, a)); }

// x1 cos - x2 sin | x2 cos + x1 sin, each product and sum rounded
__device__ __forceinline__ void rope_pair(float x1, float x2, float c, float s, bf16* lo, bf16* hi) {
  *lo = to_bf16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  *hi = to_bf16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

__global__ void __launch_bounds__(512)
    mla_rope_cache_kernel(const bf16* __restrict__ qa, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, const float* __restrict__ suk,
                          const float* __restrict__ kv_norm, bf16* __restrict__ cache, bf16* __restrict__ qn,
                          bf16* __restrict__ qpe, int nh, int dn, int dr, int r, int S, int slot, float eps,
                          float factor, int bw) {
  __shared__ float red[512];
  __shared__ float total;
  const int b = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int qd = dn + dr, half = dr / 2, nq = nh * qd, W = nq + r + dr;
  const bf16* row = qa + (size_t)b * W;
  const bf16* lat = row + nq;
  const float* cr = cos_t + (size_t)b * half;
  const float* sr = sin_t + (size_t)b * half;
  bf16* crow = cache + ((size_t)b * S + slot) * (r + dr);

  // the latent's sum of squares, as rmsnorm_rows_kernel (decode_fused.cu)
  // and PyTorch's reduction: from 128 values four accumulators, one a
  // position of the 4-wide vectors i = lane, lane + bw, ..., the tail into
  // the first; below 128 four accumulators over elements lane + m bw, m mod
  // 4; summed in order; then a halving tree across the bw lanes
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (t < bw) {
    if (r >= 128) {
      for (int i = t; 4 * i + 3 < r; i += bw) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = add_sq(acc[j], f32(lat[4 * i + j]));
      }
      if (t < r % 4) acc[0] = add_sq(acc[0], f32(lat[r - r % 4 + t]));
    } else {
      for (int c = t, m = 0; c < r; c += bw, ++m) acc[m % 4] = add_sq(acc[m % 4], f32(lat[c]));
    }
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  if (bw > 32) {
    if (t < bw) red[t] = s;
    for (int off = bw / 2; off >= 32; off >>= 1) {
      __syncthreads();
      if (t < off) {
        s = __fadd_rn(s, red[t + off]);
        red[t] = s;
      }
    }
  }
  __syncthreads();
  if (t < 32) {
    for (int off = (bw < 32 ? bw : 32) / 2; off; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
    if (t == 0) total = s;
  }

  // q_nope * suk -> qn [B, nh, nope], pairs
  for (int p = t; p < nh * dn / 2; p += nt) {
    const int h = 2 * p / dn, j = 2 * p % dn;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + h * qd + j);
    __nv_bfloat162 o;
    o.x = to_bf16(__fmul_rn(f32(v.x), suk[h * dn + j]));
    o.y = to_bf16(__fmul_rn(f32(v.y), suk[h * dn + j + 1]));
    *reinterpret_cast<__nv_bfloat162*>(qn + (size_t)b * nh * dn + 2 * p) = o;
  }
  // q_pe -> qpe [B, nh, rope] and k_pe -> the cache, roped
  for (int p = t; p < (nh + 1) * half; p += nt) {
    const int h = p / half, i = p % half;
    const bf16* src = h < nh ? row + h * qd + dn + 2 * i : lat + r + 2 * i;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src);
    bf16* dst = h < nh ? qpe + ((size_t)b * nh + h) * dr : crow + r;
    rope_pair(f32(v.x), f32(v.y), cr[i], sr[i], dst + i, dst + half + i);
  }

  __syncthreads();  // the row's total
  const float rs = rsqrtf(__fadd_rn(__fmul_rn(total, factor), eps));
  for (int c = t; c < r; c += nt) crow[c] = to_bf16(__fmul_rn(__fmul_rn(f32(lat[c]), rs), kv_norm[c]));
}

// ---------------------------------------------------------------------------
// the second absorbed product's scales
// ---------------------------------------------------------------------------

__global__ void mla_out_kernel(const bf16* __restrict__ o, const float* __restrict__ suv, bf16* __restrict__ out,
                               int B, int nh, int dv) {
  const int per_row = nh * dv / 8;  // 8-value vectors of an output row
  const long long n = (long long)B * per_row;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / per_row), c = (int)(i % per_row) * 8;
    const int h = c / dv, j = c % dv;
    float v[8];
    load8(o + ((size_t)h * B + b) * dv + j, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = __fmul_rn(v[q], suv[h * dv + j + q]);
    store8(out + (size_t)b * nh * dv + c, v);
  }
}

// ---------------------------------------------------------------------------
// the routing: softmax, top k, counts, the sort's positions
// ---------------------------------------------------------------------------

// PyTorch's GTOp<float, true>: NaN above everything
__device__ __forceinline__ bool gt_nan(float a, float b) { return (isnan(a) && !isnan(b)) || a > b; }

// the workspace's int32 words: ids, in-expert ranks, positions [N k]; the
// offsets [E + 1]; the experts' starts [E]; the blocks' counts and starts
// [blocks, E]
__host__ __device__ inline long long route_words(int N, int E, int k) {
  const long long blocks = (N + kRouteRows - 1) / kRouteRows;
  return 3LL * N * k + (E + 1) + E + 2 * blocks * E;
}

// torch.sigmoid's float arithmetic: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_f(float x) { return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))); }

__global__ void __launch_bounds__(kRouteRows * 32)
    moe_route_kernel(const float* __restrict__ logits, const float* __restrict__ bias, int N, int E, int k,
                     int sigmoid, int renorm, int* __restrict__ ids, int* __restrict__ rank, int* __restrict__ offsets,
                     int* __restrict__ starts, int* __restrict__ hist, int* __restrict__ base,
                     int* __restrict__ counts, unsigned int* __restrict__ ticket, float* __restrict__ topv) {
  __shared__ float s_p[kRouteRows][kMaxExperts];
  __shared__ float s_w[kRouteRows][kMaxTopK];
  __shared__ float s_rkey[kRouteRows][kMaxTopK];
  __shared__ int s_rval[kRouteRows][kMaxTopK];
  __shared__ float s_key[kRouteRows][kSortSlots];
  __shared__ int s_val[kRouteRows][kSortSlots];
  __shared__ int s_ok[kRouteRows][kSortSlots];
  __shared__ int s_ids[kRouteRows * kMaxTopK];
  __shared__ int s_part[kRouteRows * 32 / kMaxExperts][kMaxExperts];
  __shared__ int s_total[kMaxExperts];
  __shared__ int s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRouteRows, row = row0 + warp;
  const int rows_here = N - row0 < kRouteRows ? N - row0 : kRouteRows;

  if (row < N) {  // warp-uniform
    int np2 = 1;
    while (np2 < E) np2 <<= 1;
    const int width = np2 < 32 ? np2 : 32, iters = np2 / width;
    const float* lr = logits + (size_t)row * E;
    if (sigmoid) {  // the choice: sigmoid(logit) + the correction bias
      for (int e = lane; e < E; e += 32) {
        const float sc = sigmoid_f(lr[e]);
        s_p[warp][e] = bias ? __fadd_rn(sc, bias[e]) : sc;
      }
    } else {
      float el[kLaneExperts];
#pragma unroll
      for (int it = 0; it < kLaneExperts; ++it) {
        const int e = lane + it * width;
        el[it] = it < iters && lane < width && e < E ? lr[e] : -INFINITY;
      }
      float mx = el[0];
#pragma unroll
      for (int it = 0; it < kLaneExperts; ++it)
        if (it < iters) mx = mx < el[it] ? el[it] : mx;
      for (int off = width / 2; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(kFull, mx, off);
        mx = mx < o ? o : mx;
      }
      float sum = 0.f;
#pragma unroll
      for (int it = 0; it < kLaneExperts; ++it) {
        if (it < iters) {
          el[it] = expf(__fsub_rn(el[it], mx));
          sum = __fadd_rn(sum, el[it]);
        }
      }
      for (int off = width / 2; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
#pragma unroll
      for (int it = 0; it < kLaneExperts; ++it) {
        const int e = lane + it * width;
        if (it < iters && lane < width && e < E) s_p[warp][e] = __fdiv_rn(el[it], sum);
      }
    }
    __syncwarp();

    // the top k in rank order
    for (int e = lane; e < E; e += 32) {
      const float v = s_p[warp][e];
      int rk = 0;
      for (int j = 0; j < E; ++j) {
        const float u = s_p[warp][j];
        rk += (u > v) || (u == v && j < e);
      }
      if (rk < k) {
        s_rkey[warp][rk] = v;
        s_rval[warp][rk] = e;
      }
    }
    s_key[warp][lane] = 0.f;
    s_val[warp][lane] = 0;
    s_ok[warp][lane] = 0;
    __syncwarp();
    // radix select's gather order: the values above the k-th by index, then the k-th's ties by index
    if (lane < k) {
      const float kth = s_rkey[warp][k - 1], v = s_rkey[warp][lane];
      const int e = s_rval[warp][lane];
      int above = 0, before = 0;
      for (int q = 0; q < k; ++q) {
        const float u = s_rkey[warp][q];
        const int f = s_rval[warp][q];
        above += u > kth;
        before += (v > kth ? u > kth : u == kth) && f < e;
      }
      const int g = v > kth ? before : above + before;
      s_key[warp][g] = v;
      s_val[warp][g] = e;
      s_ok[warp][g] = 1;
    }
    // PyTorch's bitonicSort<32> with GTOp (descending), lanes 0..15 its threads
    float* K = s_key[warp];
    int* Vv = s_val[warp];
    int* ok = s_ok[warp];
    auto swap_step = [&](unsigned stride, bool dir) {
      __syncwarp();
      if (lane < 16) {
        const unsigned a = 2 * lane - (lane & (stride - 1)), c = a + stride;
        const bool sw = (gt_nan(K[a], K[c]) && ok[a]) || !ok[c];
        if (sw == dir) {
          const float tk = K[a];
          K[a] = K[c];
          K[c] = tk;
          const int tv = Vv[a];
          Vv[a] = Vv[c];
          Vv[c] = tv;
          const int to = ok[a];
          ok[a] = ok[c];
          ok[c] = to;
        }
      }
    };
#pragma unroll
    for (unsigned size = 2; size < kSortSlots; size *= 2) {
      const bool flag = (lane & (size / 2)) != 0;
#pragma unroll
      for (unsigned stride = size / 2; stride > 0; stride /= 2) swap_step(stride, flag);
    }
#pragma unroll
    for (unsigned stride = kSortSlots / 2; stride > 0; stride /= 2) swap_step(stride, false);
    __syncwarp();
    if (lane < k) {
      // the weight: the chosen value itself, or (sigmoid) the expert's
      // unbiased score
      s_w[warp][lane] = sigmoid ? sigmoid_f(lr[Vv[lane]]) : K[lane];
      ids[(size_t)row * k + lane] = Vv[lane];
      s_ids[warp * k + lane] = Vv[lane];
    }
    __syncwarp();
    if (lane < k) {
      float w = s_w[warp][lane];
      if (renorm) {  // over the k weights summed in slot order, + 1e-20
        float den = s_w[warp][0];
        for (int j = 1; j < k; ++j) den = __fadd_rn(den, s_w[warp][j]);
        w = __fdiv_rn(w, __fadd_rn(den, 1e-20f));
      }
      topv[(size_t)row * k + lane] = w;
    }
  }
  __syncthreads();

  // each pair's rank within its expert among the block's pairs (flat order:
  // row, then slot), and the block's count of each expert
  const int pairs = rows_here * k;
  for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
    const int e = s_ids[q];
    int rk = 0;
    for (int q2 = 0; q2 < q; ++q2) rk += s_ids[q2] == e;
    rank[(size_t)row0 * k + q] = rk;
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int c = 0;
    for (int q = 0; q < pairs; ++q) c += s_ids[q] == e;
    hist[(size_t)blockIdx.x * E + e] = c;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: every block's start within each expert (2 groups of
  // blocks, 256 experts), the experts' totals
  constexpr int kGroups = kRouteRows * 32 / kMaxExperts;
  const int nb = gridDim.x, e = threadIdx.x % kMaxExperts, grp = threadIdx.x / kMaxExperts;
  const int chunk = (nb + kGroups - 1) / kGroups;
  const int b0 = grp * chunk < nb ? grp * chunk : nb, b1 = b0 + chunk < nb ? b0 + chunk : nb;
  int part = 0;
  if (e < E)
    for (int bb = b0; bb < b1; ++bb) part += __ldcg(hist + (size_t)bb * E + e);
  s_part[grp][e] = part;
  __syncthreads();
  if (threadIdx.x < kMaxExperts) {
    int run = 0;
    for (int g = 0; g < kGroups; ++g) {
      const int v = s_part[g][e];
      s_part[g][e] = run;
      run += v;
    }
    s_total[e] = run;
  }
  __syncthreads();
  if (e < E) {
    int run = s_part[grp][e];
    for (int bb = b0; bb < b1; ++bb) {
      base[(size_t)bb * E + e] = run;
      run += __ldcg(hist + (size_t)bb * E + e);
    }
  }
  // the experts' starts (this call's pairs), the counters and the offsets
  // (their cumulative sum, as F.pad(cumsum(counts)) forms it): warp 0,
  // kLaneExperts neighbouring experts a lane
  if (warp == 0) {
    int tl[kLaneExperts], cl[kLaneExperts], st = 0, sc = 0;
#pragma unroll
    for (int q = 0; q < kLaneExperts; ++q) {
      const int e = kLaneExperts * lane + q;
      tl[q] = cl[q] = 0;
      if (e < E) {
        tl[q] = s_total[e];
        cl[q] = counts ? counts[e] + tl[q] : tl[q];
        if (counts) counts[e] = cl[q];
      }
      st += tl[q];
      sc += cl[q];
    }
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(kFull, st, off), c = __shfl_up_sync(kFull, sc, off);
      if (lane >= off) st += a, sc += c;
    }
    int xt = st, xc = sc;
#pragma unroll
    for (int q = 0; q < kLaneExperts; ++q) xt -= tl[q], xc -= cl[q];
#pragma unroll
    for (int q = 0; q < kLaneExperts; ++q) {
      const int e = kLaneExperts * lane + q;
      if (e < E) starts[e] = xt, offsets[e] = xc;
      xt += tl[q];
      xc += cl[q];
    }
    if (lane == 31) offsets[E] = sc;
    if (lane == 0) *ticket = 0u;
  }
}

// ---------------------------------------------------------------------------
// the gather into expert order, and the combine
// ---------------------------------------------------------------------------

__global__ void moe_scatter_kernel(const bf16* __restrict__ x, int ldx, const int* __restrict__ ids,
                                   const int* __restrict__ rank, const int* __restrict__ starts,
                                   const int* __restrict__ base, int* __restrict__ pos, bf16* __restrict__ xs, int E,
                                   int k, int H) {
  __shared__ int s_pos[kMaxTopK];
  const int n = blockIdx.x;
  if (threadIdx.x < k) {
    const int q = n * k + threadIdx.x, e = ids[q];
    const int p = starts[e] + base[(size_t)(n / kRouteRows) * E + e] + rank[q];
    pos[q] = p;
    s_pos[threadIdx.x] = p;
  }
  __syncthreads();
  const bf16* xr = x + (size_t)n * ldx;
  for (int c = threadIdx.x * 8; c < H; c += blockDim.x * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    for (int j = 0; j < k; ++j) *reinterpret_cast<uint4*>(xs + (size_t)s_pos[j] * H + c) = v;
  }
}

__global__ void moe_combine_kernel(const bf16* __restrict__ yd, const int* __restrict__ pos,
                                   const float* __restrict__ topv, const bf16* __restrict__ shared,
                                   bf16* __restrict__ out, int k, int H, float scale) {
  __shared__ int s_pos[kMaxTopK];
  __shared__ float s_w[kMaxTopK];
  const int n = blockIdx.x;
  if (threadIdx.x < k) {
    s_pos[threadIdx.x] = pos[n * k + threadIdx.x];
    s_w[threadIdx.x] = __fmul_rn(topv[n * k + threadIdx.x], scale);
  }
  __syncthreads();
  for (int c = threadIdx.x * 8; c < H; c += blockDim.x * 8) {
    float acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[a][i] = 0.f;
    for (int j0 = 0; j0 < k; j0 += 4) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (j0 + a < k) {
          float y[8];
          load8(yd + (size_t)s_pos[j0 + a] * H + c, y);
          const float w = s_w[j0 + a];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[a][i] = __fadd_rn(acc[a][i], __fmul_rn(y[i], w));
        }
      }
    }
    float sh[8];
    load8(shared + (size_t)n * H + c, sh);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sh[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc[0][i], acc[1][i]), acc[2][i]), acc[3][i]), sh[i]);
    store8(out + (size_t)n * H + c, sh);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// threads of a block that moves one row of H values, 8 a thread
int row_threads(int H) {
  const int t = (H / 8 + 31) / 32 * 32;
  return t > 256 ? 256 : t;
}

}  // namespace

// qa bf16 [B, nh (dn + dr) + r + dr] (the q|kv_a GEMM's rows): qn bf16 [B,
// nh, dn] = q_nope * suk (f32 [nh, dn]); qpe bf16 [B, nh, dr] = q_pe roped;
// slot `slot` of cache (one layer's bf16 [B, S, r + dr]) = RMSNorm(latent) *
// kv_norm (f32 [r]) | k_pe roped. cos, sin f32 [B, dr / 2]. bw: the lanes of
// the norm's row (a power of two up to 512); factor: 1 / r as the plain mean
// forms it.
extern "C" int tvc_mla_rope_cache(const void* qa, const void* cos_t, const void* sin_t, const void* suk,
                                  const void* kv_norm, void* cache, void* qn, void* qpe, int B, int nh, int dn, int dr,
                                  int r, int S, int slot, float eps, float factor, int bw, void* stream) {
  if (nh < 1 || dn < 2 || dn % 2 || dr < 2 || dr % 4 || r < 2 || r % 2 || slot < 0 || slot >= S || bw < 1 ||
      bw > 512 || (bw & (bw - 1)))
    return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  mla_rope_cache_kernel<<<B, bw > 256 ? 512 : 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)qa, (const float*)cos_t, (const float*)sin_t, (const float*)suk, (const float*)kv_norm,
      (bf16*)cache, (bf16*)qn, (bf16*)qpe, nh, dn, dr, r, S, slot, eps, factor, bw);
  return (int)cudaGetLastError();
}

// out bf16 [B, nh dv] = o (bf16 [nh, B, dv]) * suv (f32 [nh, dv]), rounded;
// dv a multiple of 8, o and out 16 bytes aligned
extern "C" int tvc_mla_out(const void* o, const void* suv, void* out, int B, int nh, int dv, void* stream) {
  if (nh < 1 || dv < 8 || dv % 8 || !aligned16(o) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  const long long n = (long long)B * nh * dv / 8;
  const long long blocks = (n + 255) / 256 > 8192 ? 8192 : (n + 255) / 256;
  mla_out_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>((const bf16*)o, (const float*)suv, (bf16*)out, B,
                                                                  nh, dv);
  return (int)cudaGetLastError();
}

// logits f32 [N, E] (E <= 256), x bf16 [N, H] (row stride ldx; H and ldx
// multiples of 8, x and xs 16 bytes aligned): topv f32 [N,
// k] and, in ws (int32, ws_words of them, route_words' layout), the ids [N,
// k] in torch.topk's order, the positions [N, k] of each pair in the
// expert-sorted rows, the offsets [E + 1]; xs bf16 [N k, H] the rows in that
// order. The experts are chosen by softmax(logits) (sigmoid 0) or by
// sigmoid(logits) + bias (bias f32 [E] or null; the weights then the
// unbiased sigmoids); renorm: the k weights divided by their sum + 1e-20.
// counts (int32 [E] or null) += this call's count of each expert, the
// offsets then its cumulative sum. ticket: an unsigned int in device memory,
// 0 between calls. Two launches.
extern "C" int tvc_moe_route(const void* logits, const void* x, int ldx, void* counts, void* ticket, void* ws,
                             void* topv, void* xs, const void* bias, int N, int E, int k, int H, int sigmoid,
                             int renorm, long long ws_words, void* stream) {
  if (E < 1 || E > kMaxExperts || k < 1 || k > kMaxTopK || k > E || H < 8 || H % 8 || ldx < H || ldx % 8 ||
      !aligned16(x) || !aligned16(xs))
    return (int)cudaErrorInvalidValue;
  if (N < 1) return (int)cudaGetLastError();
  if (ws_words < route_words(N, E, k)) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kRouteRows - 1) / kRouteRows;
  int* w = (int*)ws;
  int *ids = w, *rank = w + (size_t)N * k, *pos = w + 2 * (size_t)N * k, *offsets = w + 3 * (size_t)N * k;
  int *starts = offsets + E + 1, *hist = starts + E, *base = hist + (size_t)blocks * E;
  cudaStream_t s = (cudaStream_t)stream;
  moe_route_kernel<<<blocks, kRouteRows * 32, 0, s>>>((const float*)logits, (const float*)bias, N, E, k, sigmoid,
                                                      renorm, ids, rank, offsets, starts, hist, base, (int*)counts,
                                                      (unsigned int*)ticket, (float*)topv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_scatter_kernel<<<N, row_threads(H), 0, s>>>((const bf16*)x, ldx, ids, rank, starts, base, pos, (bf16*)xs, E, k,
                                                  H);
  return (int)cudaGetLastError();
}

// out bf16 [N, H] = sum_j yd[pos[n, j]] * (topv[n, j] * scale) + shared[n]
// (yd, shared bf16 [*, H], H a multiple of 8, 16 bytes aligned; pos int32,
// topv f32 [N, k])
extern "C" int tvc_moe_combine(const void* yd, const void* pos, const void* topv, const void* shared, void* out, int N,
                               int k, int H, float scale, void* stream) {
  if (k < 1 || k > kMaxTopK || H < 8 || H % 8 || !aligned16(yd) || !aligned16(shared) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (N < 1) return (int)cudaGetLastError();
  moe_combine_kernel<<<N, row_threads(H), 0, (cudaStream_t)stream>>>((const bf16*)yd, (const int*)pos,
                                                                       (const float*)topv, (const bf16*)shared,
                                                                       (bf16*)out, k, H, scale);
  return (int)cudaGetLastError();
}
