// Fused TVC consistency scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel tvc/core/pallas/consistency_kernel.py
// (fused_consistency_scores, body _consistency_kernel). Same formulas, in
// f32 on f32 values of the inputs:
//   orig  = cos(img, txt)
//   vsims = cos(img, variants) * vmask -> masked mean and population std
//           via vvar = max(E[x^2] - mean^2, 0)
//   rsims = cos(img, refs) * rmask     -> masked mean
//   tv    = 1 - (0.7 (1 - |orig - vmean|) + 0.3 (1 - vstd)), 0 without variants
//   sd    = 1 - rmean, 0 without refs;  cons = 1 - orig
//   agg   = (tv wt + sd ws + cons wc) / max(wt + ws + wc, 1e-12), where wt/ws
//           are zero for the methods that did not run; flag = agg > threshold
// Norms use rsqrt(max(sum x^2, eps^2)), eps = 1e-8, as the TPU kernel does.
//
// Bound: bytes. Per query it reads (2 + V + R) D elements and does ~6 flops
// per element, far below the f32 ridge (67 TF/s over 3.35 TB/s, ~20 flops a
// byte). At a serving batch (B = 256, ~5 MB) the time is latency: the launch
// and the round trips to memory on a query's critical path; at a large batch
// it is bytes in flight (~25 KB an SM to cover the memory's latency). So the
// design is about short chains and many loads in flight.
//
// Design: every row of a query is read at once, and the next query's rows
// are in flight while this one's are summed. A block takes a query at a
// time and gives each of its rows -- img, txt, the V variants, the R
// references: 2 + V + R of them -- a warp of its own (at most 32; beyond
// that the warps loop over the rows), so the rows spread over all SMs. Each
// warp reads its row's mask element (img and txt have none) and, for a valid
// row, issues the first step of its 16-byte loads before any arithmetic:
// four words a lane, consecutive lanes on consecutive words, 2 KB a warp
// (512 f32 or 1,024 bf16 elements); thread 0 reads the device-resident
// weights. A masked slot costs its mask element: no row read, no
// arithmetic. (Requesting every row before its mask arrived saved nothing
// at B = 256 and lost bandwidth at B = 4,096: scripts/sweep_consistency.py.)
// The img warp converts its row to f32 into shared memory; after a barrier
// each slot warp adds its row against it (the rest of a longer row is
// loaded a step at a time), reduces sum x^2, sum r^2 and sum x r with
// shuffles and writes the slot's cosine to shared memory. Then every warp
// requests its row of the block's next query, and only then, after a second
// barrier, does lane 0 sum this query's cosines in slot order (v = 0..V-1,
// then k = 0..R-1) and write its stats: the barriers, the sums and the
// stores of one query run under the next one's loads. The grid is
// persistent (as many blocks as fit on the SMs, none more than the batch has
// queries); the kernel is held to 56 registers so that two blocks of 18
// warps (V = 6, R = 10) share an SM. Which block takes a query does not
// change its result: two calls give the same bits whatever the grid. No
// [B, V] or [B, R] array reaches device memory.
//
// Operands: img, txt, variants and refs are each f32, bf16 or f16 (dtype
// codes below), in any mix, read as stored and converted in registers (no f32
// copy doubles a bf16 caller's bytes). img is converted once, into shared
// memory; a row's 16-byte words are converted by its dtype, a warp-uniform
// branch, so every mix runs without converting an operand in device memory.
// Any D >= 1: 16-byte vector loads where a row starts 16-byte aligned (the
// wrapper hands over 16-byte aligned bases, so every row is when D times the
// element size is a multiple of 16), scalar loads for the last D % 8
// elements and for every element of a row that is not aligned. Masks are
// absent (every slot valid) or of any element size, non-zero meaning valid
// (the sign bit of a float mask is ignored, so -0.0 is zero). Weights and
// threshold come by value, or from device pointers (a [3] weights tensor, a
// one-element threshold) read in the kernel, so a calibration update
// rebuilds and launches nothing new. Outputs: stats [7, B] f32 (tv, sd, cons,
// agg, orig, vmean, vstd) and the flag [B] as bytes (a bool tensor).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps2 = 1e-16f;     // eps^2, eps = 1e-8
constexpr int kMaxWarps = 32;       // row warps a block
constexpr int kWords = 4;           // 16-byte words of a row a lane loads before it adds
constexpr int kMaxSlots = 8192;     // 1 + V + R: 5 bytes of shared memory a slot
constexpr int kMaxD = 40960;        // img's f32 row in shared memory (with kMaxSlots: < 227 KB)
constexpr size_t kSmemDefault = 48 * 1024;

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };
constexpr int kMaskFloat = 16;  // mask code: element bytes | kMaskFloat for a float mask

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// element i of an operand of dtype code dt, as f32
__device__ __forceinline__ float elem_f(const void* base, int dt, size_t i) {
  switch (dt) {
    case kBF16:
      return __bfloat162float(static_cast<const bf16*>(base)[i]);
    case kF16:
      return __half2float(static_cast<const __half*>(base)[i]);
    default:
      return static_cast<const float*>(base)[i];
  }
}

// one row: its address, dtype and count of 16-byte words read as vectors (0
// when it does not start 16-byte aligned: scalar loads throughout)
struct Row {
  const void* ptr;
  int dt, words;
};

// issues every 16-byte load of a step: words w0 + 32 k + lane, k < kWords
// (consecutive lanes on consecutive words: a warp reads 512 contiguous bytes
// an instruction)
__device__ __forceinline__ void load_step(const Row& r, int w0, int lane, uint4 (&w)[kWords]) {
  const uint4* base = static_cast<const uint4*>(r.ptr);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int i = w0 + 32 * k + lane;
    if (i < r.words) w[k] = __ldg(base + i);
  }
}

// the elements of a 16-byte word: 4 in f32, 8 in bf16 / f16
__device__ __forceinline__ void unpack8(const uint4& v, int dt, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (dt == kBF16) {  // bf16 -> f32 is the upper half of the word
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    } else {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(u[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(u[i] >> 16)));
    }
  }
}

// (sum x^2, sum r^2, sum x r) over img (f32 in shared memory, 16-byte
// aligned) and one row, reduced across the warp; the words of the row's
// first step are already in w
__device__ __forceinline__ float3 row_sums(const float* x, const Row& r, int D, int lane, uint4 (&w)[kWords]) {
  float sxx = 0.f, srr = 0.f, sxr = 0.f;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int w0 = 0; w0 < r.words; w0 += 32 * kWords) {
    if (w0 > 0) load_step(r, w0, lane, w);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int i = w0 + 32 * k + lane;
      if (i >= r.words) continue;
      if (r.dt == kF32) {
        const float4 a = x4[i];
        const float4 b = make_float4(__uint_as_float(w[k].x), __uint_as_float(w[k].y), __uint_as_float(w[k].z),
                                     __uint_as_float(w[k].w));
        sxx += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
        srr += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
        sxr += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      } else {
        float b[8];
        unpack8(w[k], r.dt, b);
        const float4 a0 = x4[2 * i], a1 = x4[2 * i + 1];
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sxx += a[e] * a[e];
          srr += b[e] * b[e];
          sxr += a[e] * b[e];
        }
      }
    }
  }
#pragma unroll 4
  for (int i = r.words * (r.dt == kF32 ? 4 : 8) + lane; i < D; i += 32) {
    const float a = x[i], b = elem_f(r.ptr, r.dt, i);
    sxx += a * a;
    srr += b * b;
    sxr += a * b;
  }
  return make_float3(warp_sum(sxx), warp_sum(srr), warp_sum(sxr));
}

// mask element i: code 0 = no mask (valid); else its bytes | kMaskFloat
__device__ __forceinline__ bool valid_at(const void* m, int code, size_t i) {
  if (code == 0) return true;
  const bool fl = code & kMaskFloat;
  switch (code & 15) {
    case 1:
      return static_cast<const uint8_t*>(m)[i] != 0;
    case 2:
      return (static_cast<const uint16_t*>(m)[i] & (fl ? 0x7fffu : 0xffffu)) != 0;
    case 4:
      return (static_cast<const uint32_t*>(m)[i] & (fl ? 0x7fffffffu : 0xffffffffu)) != 0;
    default:
      return (static_cast<const uint64_t*>(m)[i] & (fl ? 0x7fffffffffffffffull : ~0ull)) != 0;
  }
}

struct Args {
  const void *img, *txt, *var, *ref, *vmask, *rmask;
  const float *w_ptr, *thr_ptr;  // null: the values below
  float w_tv, w_sd, w_cons, thr;
  float* stats;    // [7, B]
  uint8_t* flags;  // [B]
  int B, V, R, D, dtypes, vmask_code, rmask_code;
};

// is slot `slot` of query q valid: txt always, a variant or a reference by
// its mask
__device__ __forceinline__ bool slot_valid(const Args& p, int q, int slot) {
  if (slot == 0) return true;
  if (slot <= p.V) return valid_at(p.vmask, p.vmask_code, (size_t)q * p.V + (slot - 1));
  return valid_at(p.rmask, p.rmask_code, (size_t)q * p.R + (slot - 1 - p.V));
}

// row `it` of query q: 0 = img, 1 = txt (slot 0), then the variants and the
// references (slot it - 1)
__device__ __forceinline__ Row item_row(const Args& p, int q, int it) {
  const void* base;
  int dt;
  size_t row;
  if (it <= 1) {
    base = it == 0 ? p.img : p.txt, dt = (p.dtypes >> (2 * it)) & 3, row = q;
  } else if (it <= 1 + p.V) {
    base = p.var, dt = (p.dtypes >> 4) & 3, row = (size_t)q * p.V + (it - 2);
  } else {
    base = p.ref, dt = (p.dtypes >> 6) & 3, row = (size_t)q * p.R + (it - 2 - p.V);
  }
  const int bytes = dt == kF32 ? 4 : 2;
  const void* ptr = static_cast<const char*>(base) + row * p.D * bytes;
  return Row{ptr, dt, (reinterpret_cast<uintptr_t>(ptr) & 15) ? 0 : p.D * bytes / 16};
}

// a warp's first row of query q: its validity and, for a valid row, the
// first step of its 16-byte loads issued into w
__device__ __forceinline__ bool prefetch(const Args& p, int q, int it, int lane, Row& r, uint4 (&w)[kWords]) {
  r = item_row(p, q, it);
  const bool valid = it == 0 || slot_valid(p, q, it - 1);
  if (valid) load_step(r, 0, lane, w);
  return valid;
}

// img's row as f32 into shared memory; the words of its first step are in w
__device__ __forceinline__ void store_img(const Row& r, int D, int lane, uint4 (&w)[kWords], float* x) {
  float4* x4 = reinterpret_cast<float4*>(x);
  for (int w0 = 0; w0 < r.words; w0 += 32 * kWords) {
    if (w0 > 0) load_step(r, w0, lane, w);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int i = w0 + 32 * k + lane;
      if (i >= r.words) continue;
      if (r.dt == kF32) {
        x4[i] = make_float4(__uint_as_float(w[k].x), __uint_as_float(w[k].y), __uint_as_float(w[k].z),
                            __uint_as_float(w[k].w));
      } else {
        float f[8];
        unpack8(w[k], r.dt, f);
        x4[2 * i] = make_float4(f[0], f[1], f[2], f[3]);
        x4[2 * i + 1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }
  for (int i = r.words * (r.dt == kF32 ? 4 : 8) + lane; i < D; i += 32) x[i] = elem_f(r.ptr, r.dt, i);
}

// the stats of query q from its slots' cosines and valid flags, in slot order
__device__ __forceinline__ void write_stats(const Args& p, int q, const float* cq, const uint8_t* okq,
                                            const float* wts) {
  const int S = 1 + p.V + p.R;
  const float orig = cq[0];
  float vsum = 0.f, vsq = 0.f, vcount = 0.f;
  for (int v = 1; v <= p.V; ++v) {
    if (!okq[v]) continue;
    const float s = cq[v];
    vsum += s;
    vsq += s * s;
    vcount += 1.f;
  }
  float rsum = 0.f, rcount = 0.f;
  for (int k = 1 + p.V; k < S; ++k) {
    if (!okq[k]) continue;
    rsum += cq[k];
    rcount += 1.f;
  }
  const float vsafe = fmaxf(vcount, 1.f);
  const float vmean = vsum / vsafe;
  // no FMA contraction here: with one valid variant E[x^2] and mean^2 must
  // round identically so that var is exactly 0 (sqrt would turn a 1e-8
  // contraction residue into a 1e-4 std)
  const float vvar = fmaxf(__fsub_rn(vsq / vsafe, __fmul_rn(vmean, vmean)), 0.f);
  const float vstd = sqrtf(vvar);
  const bool v_has = vcount > 0.f;
  const float rmean = rsum / fmaxf(rcount, 1.f);
  const bool r_has = rcount > 0.f;

  float tv = 1.f - (0.7f * (1.f - fabsf(orig - vmean)) + 0.3f * (1.f - vstd));
  tv = v_has ? tv : 0.f;
  const float sd = r_has ? 1.f - rmean : 0.f;
  const float cons = 1.f - orig;
  const float wt = v_has ? wts[0] : 0.f;
  const float ws = r_has ? wts[1] : 0.f;
  const float total_w = wt + ws + wts[2];
  const float agg = (tv * wt + sd * ws + cons * wts[2]) / fmaxf(total_w, 1e-12f);

  const size_t B = p.B;
  p.stats[q] = tv;
  p.stats[B + q] = sd;
  p.stats[2 * B + q] = cons;
  p.stats[3 * B + q] = agg;
  p.stats[4 * B + q] = orig;
  p.stats[5 * B + q] = v_has ? vmean : 0.f;
  p.stats[6 * B + q] = v_has ? vstd : 0.f;
  p.flags[q] = agg > wts[3];
}

// f32 words of img's row in shared memory: D rounded up to 4
__host__ __device__ __forceinline__ int img_words(int D) { return (D + 3) & ~3; }

__global__ void __maxnreg__(56) consistency_kernel(const __grid_constant__ Args p) {
  extern __shared__ float4 smem4[];
  const int S = 1 + p.V + p.R;  // slots: txt, the variants, the references
  float* ximg = reinterpret_cast<float*>(smem4);      // [D] f32
  float* cosv = ximg + img_words(p.D);                // [S]
  float* wts = cosv + S;                              // w_tv, w_sd, w_cons, threshold
  uint8_t* ok = reinterpret_cast<uint8_t*>(wts + 4);  // [S]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  // the warp's first row (img for warp 0, else slot warp - 1) of the
  // block's first query: grid <= B, so every block has one
  Row r;
  uint4 w[kWords];
  bool valid = prefetch(p, blockIdx.x, warp, lane, r, w);
  if (threadIdx.x == 0) {
    wts[0] = p.w_ptr ? p.w_ptr[0] : p.w_tv;
    wts[1] = p.w_ptr ? p.w_ptr[1] : p.w_sd;
    wts[2] = p.w_ptr ? p.w_ptr[2] : p.w_cons;
    wts[3] = p.thr_ptr ? *p.thr_ptr : p.thr;
  }
  for (int q = blockIdx.x; q < p.B; q += gridDim.x) {
    if (warp == 0) store_img(r, p.D, lane, w, ximg);
    __syncthreads();
    for (int it = warp; it <= S; it += nwarps) {  // warp-uniform
      if (it == 0) continue;
      const bool v = it == warp ? valid : slot_valid(p, q, it - 1);
      float c = 0.f;
      if (v) {
        Row rr = r;
        if (it != warp) {
          rr = item_row(p, q, it);
          load_step(rr, 0, lane, w);
        }
        const float3 s = row_sums(ximg, rr, p.D, lane, w);
        c = s.z * rsqrtf(fmaxf(s.x, kEps2)) * rsqrtf(fmaxf(s.y, kEps2));
      }
      if (lane == 0) {
        cosv[it - 1] = c;
        ok[it - 1] = v;
      }
    }
    const int next = q + gridDim.x;  // its rows in flight from here on
    valid = next < p.B && prefetch(p, next, warp, lane, r, w);
    __syncthreads();
    if (threadIdx.x == 0) write_stats(p, q, cosv, ok, wts);
  }
}

// shared memory of a block: img's row, the cosines, weights, valid flags
size_t smem_bytes(int S, int D) { return 4 * (size_t)img_words(D) + 5 * (size_t)S + 16; }

}  // namespace

// dtypes: img | txt << 2 | var << 4 | ref << 6 (0 f32, 1 bf16, 2 f16);
// mask codes: 0 (no mask) or element bytes | 16 for a float mask.
extern "C" int tvc_consistency_scores(const void* img, const void* txt, const void* var, const void* ref,
                                      const void* vmask, const void* rmask, const void* w_ptr,
                                      const void* thr_ptr, float w_tv, float w_sd, float w_cons, float thr,
                                      void* stats, void* flags, int B, int V, int R, int D, int dtypes,
                                      int vmask_code, int rmask_code, void* stream) {
  if (B < 0 || V < 0 || R < 0 || D < 1 || D > kMaxD || 1 + V + R > kMaxSlots) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int rows = 2 + V + R;
  const int threads = 32 * (rows < kMaxWarps ? rows : kMaxWarps);
  const Args a{img, txt, var, ref, vmask, rmask, (const float*)w_ptr, (const float*)thr_ptr,
               w_tv, w_sd, w_cons, thr, (float*)stats, (uint8_t*)flags,
               B, V, R, D, dtypes, vmask_code, rmask_code};
  const size_t smem = smem_bytes(1 + V + R, D);
  cudaError_t e = cudaSuccess;
  if (smem > kSmemDefault)
    e = cudaFuncSetAttribute(consistency_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // persistent: as many blocks as fit on the card, none more than B
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, consistency_kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(B < fit ? B : fit);
  consistency_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
