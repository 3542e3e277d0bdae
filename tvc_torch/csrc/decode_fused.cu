// The elementwise steps of a decoder layer, fused, for Hopper (sm_90a):
// the residual add with the RMSNorm after it, the q|k|v bias with the
// rotary embedding and the KV-cache write (or the cache write alone, for
// attention without rotary embedding), the SiLU-gated product of the MLP
// and the squared ReLU of a non-gated one. Qwen2, DeepSeek-V2 and
// Nemotron-H decode through them.
//
// Replaces no TPU kernel: the JAX package leaves these steps to XLA, which
// fuses them into its own loops. Run as PyTorch operators, each step is
// several kernels (a Qwen2-1.5B layer ~50 launches at T = 1, 4 of them
// GEMMs), and the host's launch loop, not the card, sets the decode's pace.
// The kernels here cut a layer's elementwise work to 4 launches, each
// returning the bits of the PyTorch expressions they replace.
//
// Bound: bytes, and at the decode's sizes the launch itself. Each kernel
// does a few operations an element: at 960 rows one norm reads and writes
// ~3-8 MB (1-3 us at 3.35 TB/s), the q|k|v epilogue ~8 MB (2.3 us),
// Qwen2-1.5B's SiLU-gated product 52 MB (15 us).
//
//  * rmsnorm_rows_kernel<T, ADD>: bw lanes a row (32 at the decode's
//    row counts). ADD: h = T(h + y), rounded as PyTorch's add of two T
//    tensors rounds, written out; then (for either form) the row's sum of
//    squares in f32 in the order PyTorch's reduction kernel takes for
//    x.float().square().mean(-1), r = rsqrt(mean + eps), and x * r * scale
//    in f32, rounded to T: the plain version's bits. Lanes read 4-value
//    vectors (8 or 16 bytes) i = lane, lane + bw, ..., so neighbouring
//    lanes read neighbouring bytes; the row is read a second time for the
//    output.
//  * qkv_rope_cache_kernel<T, P>: one block a row of the q|k|v GEMM's
//    output [B, (nh + 2 kv) D]; a thread takes P elements of each half of
//    one head: + bias (rounded to T first, then the sum rounded to T),
//    then for q and k heads the half-split rotation in f32 with each
//    product and sum rounded on its own (no contraction into an FMA, so
//    the bits are apply_rope's); q heads to q [B, nh D], k and v heads to
//    slot `slot` of the layer's KV-major caches [B, kv, S, D]. ROPE false
//    (qkv_cache): no bias and no rotation, the values copied as they are.
//  * silu_mul_kernel<T, V>: out[r, c] = T(T(silu(g)) * u) with g, u =
//    gu[r, c], gu[r, I + c]; silu(g) = g / (1 + exp(-g)) in f32 (IEEE
//    division, the accurate expf), rounded as F.silu then the product.
//  * relu2_kernel<T, V>: out = T(r * r), r = relu(u): F.relu(u).square()'s
//    bits (the product of two T values formed in f32 and rounded once).
// No kernel reduces across blocks or uses atomics: two calls return the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// N elements of T from / to memory aligned to their size: one 16- or
// 8-byte access when N elements fill it, else one access an element
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&f)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(v[i]);
  } else if constexpr (N * sizeof(T) == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const T* v = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(p[i]);
  }
}
template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&f)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 r;
    T* v = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = from_f32<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = r;
  } else if constexpr (N * sizeof(T) == 8) {
    uint2 r;
    T* v = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = from_f32<T>(f[i]);
    *reinterpret_cast<uint2*>(p) = r;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<T>(f[i]);
  }
}

// ---------------------------------------------------------------------------
// RMSNorm, with the residual add before it (ADD)
// ---------------------------------------------------------------------------

// Four values of a row at element c (after the add, which is written out):
// one 8- or 16-byte access each when `vec`, else one an element.
template <typename T, bool ADD>
__device__ __forceinline__ void row4(const T* xr, const T* yr, T* hr, int c, int n, bool vec, float (&a)[4]) {
  if (vec) {
    load_n<T, 4>(xr + c, a);
    if constexpr (ADD) {
      float b[4];
      load_n<T, 4>(yr + c, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = round_to<T>(__fadd_rn(a[j], b[j]));
      store_n<T, 4>(hr + c, a);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) {
        a[j] = to_f32(xr[c + j]);
        if constexpr (ADD) {
          a[j] = round_to<T>(__fadd_rn(a[j], to_f32(yr[c + j])));
          hr[c + j] = from_f32<T>(a[j]);
        }
      }
    }
  }
}

__device__ __forceinline__ float add_sq(float acc, float a) { return __fadd_rn(acc, __fmul_rn(a, a)); }

// Block (bw, rows_per_block): threadIdx.x a lane of a row, threadIdx.y the
// row. The sum of squares follows PyTorch's CUDA reduction kernel for
// x.square().mean(-1) (Reduce.cuh), so that the norm is bit-equal to the
// plain version: each square rounded to f32; from 128 values four
// accumulators, one a position of 4-wide vectors i = lane, lane + bw, ...,
// the tail into the first; below 128 values four accumulators over
// elements lane + k bw, k mod 4; the accumulators summed in order; then
// across lanes a halving tree (lane t adds lane t + off, off = bw / 2, ...,
// 1: in shared memory down to 32 lanes, then by shuffles); times 1 / W
// (`factor`, as PyTorch forms it). The order was read off the card (torch
// 2.11): every row of x.square().mean(-1) at the models' widths and row
// counts equals it bit for bit.
// bw is PyTorch's block width for this reduction (the wrapper computes
// it). The second pass re-reads the row (after the add) for the output.
template <typename T, bool ADD>
__global__ void __launch_bounds__(512)
    rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ y, const float* __restrict__ scale,
                        T* __restrict__ h_out, T* __restrict__ out, int rows, int W, int ldx, float eps, float factor,
                        bool vec) {
  __shared__ float red[512];
  __shared__ float total[128];
  const int t = threadIdx.x, bw = blockDim.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;  // no early return: the block synchronises below
  const T* xr = x + (size_t)(live ? row : 0) * ldx;
  const T* yr = ADD ? y + (size_t)(live ? row : 0) * W : nullptr;
  T* hr = ADD ? h_out + (size_t)(live ? row : 0) * W : nullptr;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    if (W >= 128) {
      for (int i = t; 4 * i + 3 < W; i += bw) {
        float a[4];
        row4<T, ADD>(xr, yr, hr, 4 * i, 4, vec, a);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = add_sq(acc[j], a[j]);
      }
      if (t < W % 4) {
        float a[4];
        row4<T, ADD>(xr, yr, hr, W - W % 4 + t, 1, false, a);
        acc[0] = add_sq(acc[0], a[0]);
      }
    } else {
      for (int c = t; c < W; c += bw) {
        float a[4];
        row4<T, ADD>(xr, yr, hr, c, 1, false, a);
        const int k = ((c - t) / bw) % 4;
        acc[k] = add_sq(acc[k], a[0]);
      }
    }
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  const int base = threadIdx.y * bw;
  if (bw > 32) {
    red[base + t] = s;
    for (int off = bw / 2; off >= 32; off >>= 1) {
      __syncthreads();
      if (t < off) {
        s = __fadd_rn(s, red[base + t + off]);
        red[base + t] = s;
      }
    }
  }
  __syncthreads();
  for (int off = (bw < 32 ? bw : 32) / 2; off; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (t == 0) total[threadIdx.y] = s;
  __syncthreads();  // also makes the written row (after the add) visible to the block
  if (!live) return;
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total[threadIdx.y], factor), eps));
  T* orow = out + (size_t)row * W;
  const bool vec4 = vec && W % 4 == 0;
  for (int c = 4 * t; c < W; c += 4 * bw) {
    const int n = W - c < 4 ? W - c : 4;
    float a[4];
    if (vec4) {
      load_n<T, 4>((ADD ? hr : xr) + c, a);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = j < n ? to_f32((ADD ? hr : xr)[c + j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = j < n ? __fmul_rn(__fmul_rn(a[j], r), scale[c + j]) : 0.f;
    if (vec4) {
      store_n<T, 4>(orow + c, a);
    } else {
      for (int j = 0; j < n; ++j) orow[c + j] = from_f32<T>(a[j]);
    }
  }
}

template <typename T, bool ADD>
cudaError_t launch_rmsnorm(const void* x, const void* y, const float* scale, void* h_out, void* out, int rows, int W,
                           int ldx, float eps, float factor, int bw, bool vec, cudaStream_t s) {
  const int per_block = bw >= 128 ? 1 : 128 / bw;
  const dim3 block(bw, per_block);
  rmsnorm_rows_kernel<T, ADD><<<(rows + per_block - 1) / per_block, block, 0, s>>>(
      (const T*)x, (const T*)y, scale, (T*)h_out, (T*)out, rows, W, ldx, eps, factor, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// q|k|v bias, rotary embedding, KV-cache write (ROPE false: the write alone)
// ---------------------------------------------------------------------------

template <typename T, int P, bool ROPE>
__global__ void qkv_rope_cache_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                      const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                      T* __restrict__ ck, T* __restrict__ cv, T* __restrict__ q, int nh, int kv,
                                      int D, int S, int slot) {
  const int b = blockIdx.x;
  const int half = D / 2, per_head = half / P, heads = nh + 2 * kv;
  const T* row = qkv + (size_t)b * heads * D;
  const float* cr = ROPE ? cos_t + (size_t)b * half : nullptr;
  const float* sr = ROPE ? sin_t + (size_t)b * half : nullptr;
  for (int it = threadIdx.x; it < heads * per_head; it += blockDim.x) {
    const int h = it / per_head, j = (it % per_head) * P;
    const int o = h * D + j;
    float a1[P], a2[P];
    load_n<T, P>(row + o, a1);
    load_n<T, P>(row + o + half, a2);
    if constexpr (ROPE) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        a1[p] = round_to<T>(__fadd_rn(a1[p], round_to<T>(bias[o + p])));
        a2[p] = round_to<T>(__fadd_rn(a2[p], round_to<T>(bias[o + half + p])));
      }
    }
    T* dst;
    if (h < nh + kv) {  // q or k: x1 cos - x2 sin | x2 cos + x1 sin
      if constexpr (ROPE) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float c = cr[j + p], s = sr[j + p];
          const float r1 = __fsub_rn(__fmul_rn(a1[p], c), __fmul_rn(a2[p], s));
          const float r2 = __fadd_rn(__fmul_rn(a2[p], c), __fmul_rn(a1[p], s));
          a1[p] = r1, a2[p] = r2;
        }
      }
      dst = h < nh ? q + ((size_t)b * nh + h) * D : ck + (((size_t)b * kv + (h - nh)) * S + slot) * D;
    } else {
      dst = cv + (((size_t)b * kv + (h - nh - kv)) * S + slot) * D;
    }
    store_n<T, P>(dst + j, a1);
    store_n<T, P>(dst + j + half, a2);
  }
}

template <typename T, bool ROPE>
cudaError_t launch_qkv(const void* qkv, const float* bias, const float* cos_t, const float* sin_t, void* ck, void* cv,
                       void* q, int B, int nh, int kv, int D, int S, int slot, bool vec, cudaStream_t s) {
  constexpr int P = 16 / sizeof(T);
  const int per_head = vec ? D / 2 / P : D / 2;
  int threads = ((nh + 2 * kv) * per_head + 31) / 32 * 32;
  threads = threads > 256 ? 256 : threads;
  if (vec)
    qkv_rope_cache_kernel<T, P, ROPE><<<B, threads, 0, s>>>((const T*)qkv, bias, cos_t, sin_t, (T*)ck, (T*)cv, (T*)q,
                                                            nh, kv, D, S, slot);
  else
    qkv_rope_cache_kernel<T, 1, ROPE><<<B, threads, 0, s>>>((const T*)qkv, bias, cos_t, sin_t, (T*)ck, (T*)cv, (T*)q,
                                                            nh, kv, D, S, slot);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SiLU-gated product
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void silu_mul_kernel(const T* __restrict__ gu, T* __restrict__ out, int rows, int I) {
  const int per_row = I / V;
  const long long n = (long long)rows * per_row;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / per_row;
    const int c = (int)(i % per_row) * V;
    float g[V], u[V];
    load_n<T, V>(gu + r * 2 * I + c, g);
    load_n<T, V>(gu + r * 2 * I + I + c, u);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float a = round_to<T>(__fdiv_rn(g[j], __fadd_rn(1.f, expf(-g[j]))));
      g[j] = __fmul_rn(a, u[j]);
    }
    store_n<T, V>(out + r * I + c, g);
  }
}

template <typename T>
cudaError_t launch_silu(const void* gu, void* out, int rows, int I, bool vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long n = (long long)rows * (vec ? I / V : I);
  long long blocks = (n + 255) / 256;
  blocks = blocks > 8192 ? 8192 : (blocks < 1 ? 1 : blocks);
  if (vec)
    silu_mul_kernel<T, V><<<(int)blocks, 256, 0, s>>>((const T*)gu, (T*)out, rows, I);
  else
    silu_mul_kernel<T, 1><<<(int)blocks, 256, 0, s>>>((const T*)gu, (T*)out, rows, I);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// squared ReLU
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void relu2_kernel(const T* __restrict__ u, T* __restrict__ out, long long n) {
  const long long chunks = n / V;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < chunks;
       i += (long long)gridDim.x * blockDim.x) {
    float a[V];
    load_n<T, V>(u + i * V, a);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float r = a[j] < 0.f ? 0.f : a[j];  // relu: a NaN stays NaN
      a[j] = __fmul_rn(r, r);
    }
    store_n<T, V>(out + i * V, a);
  }
}

template <typename T>
cudaError_t launch_relu2(const void* u, void* out, long long n, bool vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long m = vec ? n / V : n;
  long long blocks = (m + 255) / 256;
  blocks = blocks > 8192 ? 8192 : (blocks < 1 ? 1 : blocks);
  if (vec)
    relu2_kernel<T, V><<<(int)blocks, 256, 0, s>>>((const T*)u, (T*)out, n);
  else
    relu2_kernel<T, 1><<<(int)blocks, 256, 0, s>>>((const T*)u, (T*)out, n);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0; }
bool aligned16(const void* p) { return aligned(p, 16); }

}  // namespace

// out [rows, W] = RMSNorm(x) * scale (f32 [W]), x [rows, W] with row stride
// ldx; with y (not null; y, x contiguous [rows, W]) x + y is formed first
// and written to h_out. bf16 or f32 (is_f32) throughout. bw: the lanes of
// a row, a power of two up to 512; factor: 1 / W as the plain mean forms
// it.
extern "C" int tvc_rmsnorm_rows(const void* x, const void* y, const void* scale, void* h_out, void* out, int rows,
                                int W, int ldx, float eps, float factor, int bw, int is_f32, void* stream) {
  if (W < 1 || ldx < W || (y != nullptr) != (h_out != nullptr) || bw < 1 || bw > 512 || (bw & (bw - 1)))
    return (int)cudaErrorInvalidValue;
  if (rows < 1) return (int)cudaGetLastError();
  const int vbytes = is_f32 ? 16 : 8;  // four values
  const bool vec = W % 4 == 0 && ldx % 4 == 0 && aligned(x, vbytes) && aligned(y, vbytes) &&
                   aligned(h_out, vbytes) && aligned(out, vbytes);
  const float* sc = (const float*)scale;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (is_f32)
    err = y ? launch_rmsnorm<float, true>(x, y, sc, h_out, out, rows, W, ldx, eps, factor, bw, vec, s)
            : launch_rmsnorm<float, false>(x, y, sc, h_out, out, rows, W, ldx, eps, factor, bw, vec, s);
  else
    err = y ? launch_rmsnorm<bf16, true>(x, y, sc, h_out, out, rows, W, ldx, eps, factor, bw, vec, s)
            : launch_rmsnorm<bf16, false>(x, y, sc, h_out, out, rows, W, ldx, eps, factor, bw, vec, s);
  return (int)err;
}

// qkv [B, (nh + 2 kv) D] + bias (f32) -> q [B, nh D] roped; k roped and v
// into slot `slot` of ck, cv [B, kv, S, D] (one layer of the stacked
// caches). cos, sin f32 [B, D / 2].
extern "C" int tvc_qkv_rope_cache(const void* qkv, const void* bias, const void* cos_t, const void* sin_t, void* ck,
                                  void* cv, void* q, int B, int nh, int kv, int D, int S, int slot, int is_f32,
                                  void* stream) {
  if (nh < 1 || kv < 1 || D < 2 || D % 2 || slot < 0 || slot >= S) return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  const int P = is_f32 ? 4 : 8;
  const bool vec = (D / 2) % P == 0 && aligned16(qkv) && aligned16(ck) && aligned16(cv) && aligned16(q);
  cudaStream_t s = (cudaStream_t)stream;
  const float *b = (const float*)bias, *c = (const float*)cos_t, *sn = (const float*)sin_t;
  return (int)(is_f32 ? launch_qkv<float, true>(qkv, b, c, sn, ck, cv, q, B, nh, kv, D, S, slot, vec, s)
                      : launch_qkv<bf16, true>(qkv, b, c, sn, ck, cv, q, B, nh, kv, D, S, slot, vec, s));
}

// qkv [B, (nh + 2 kv) D] -> q [B, nh D]; k and v into slot `slot` of ck, cv
// [B, kv, S, D] (one layer of the stacked caches): no bias, no rotation.
extern "C" int tvc_qkv_cache(const void* qkv, void* ck, void* cv, void* q, int B, int nh, int kv, int D, int S,
                             int slot, int is_f32, void* stream) {
  if (nh < 1 || kv < 1 || D < 2 || D % 2 || slot < 0 || slot >= S) return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  const int P = is_f32 ? 4 : 8;
  const bool vec = (D / 2) % P == 0 && aligned16(qkv) && aligned16(ck) && aligned16(cv) && aligned16(q);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_f32 ? launch_qkv<float, false>(qkv, nullptr, nullptr, nullptr, ck, cv, q, B, nh, kv, D, S, slot, vec,
                                                 s)
                      : launch_qkv<bf16, false>(qkv, nullptr, nullptr, nullptr, ck, cv, q, B, nh, kv, D, S, slot, vec,
                                                s));
}

// out [rows, I] = silu(gu[:, :I]) * gu[:, I:], gu [rows, 2 I]
extern "C" int tvc_silu_mul(const void* gu, void* out, int rows, int I, int is_f32, void* stream) {
  if (I < 1) return (int)cudaErrorInvalidValue;
  if (rows < 1) return (int)cudaGetLastError();
  const bool vec = I % (is_f32 ? 4 : 8) == 0 && aligned16(gu) && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_f32 ? launch_silu<float>(gu, out, rows, I, vec, s) : launch_silu<bf16>(gu, out, rows, I, vec, s));
}

// out [n] = relu(u)^2, u [n]
extern "C" int tvc_relu2(const void* u, void* out, long long n, int is_f32, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const bool vec = n % (is_f32 ? 4 : 8) == 0 && aligned16(u) && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_f32 ? launch_relu2<float>(u, out, n, vec, s) : launch_relu2<bf16>(u, out, n, vec, s));
}
