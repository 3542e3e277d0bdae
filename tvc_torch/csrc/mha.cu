// Multi-head softmax attention on [B, T, H, D] q, k, v for Hopper (sm_90a):
// the port of the TPU kernel tvc/core/pallas/attention_kernel.py
// (_mha_kernel, fused_mha), which the module vision tower with
// fused_attention runs in every layer.
//
// What it computes, per (b, h): f32 logits of the operands times 1/sqrt(D),
// the optional causal mask (column <= row), an f32 softmax, the weights
// cast to the operands' type, P.V accumulated in f32, the output in the
// operands' type. That is the per-head attention the layer kernels already
// run (head_attention.cuh); only the layout differs, so this file
// instantiates the same kernel on three base pointers with the row stride
// of the [B, T, H, D] tensors (H * D, or 3W for q | k | v views of one
// packed projection, which then needs no copy).
//
// What bounds it: at ViT-B/32 (T = 50, D = 64) the work is 4 T^2 D flops
// per (b, h) against 4 T D bf16 bytes moved, ~25 flops a byte, so device
// memory bounds it (the bytes bound of q, k, v in and the output out); a
// block stages one (b, h) slice in shared memory, reads it from device
// memory once and writes its output once. The logits stay in shared
// memory, as the TPU kernel keeps them in VMEM.
//
// Instantiations: bf16 and f32 operands, head widths 32 and 64, T <= 257.

#include "head_attention.cuh"

// q, k, v: [B, T, H, D] with row stride `ld` elements (the batch stride is
// T * ld); out: contiguous [B, T, H, D] of the operands' type. Returns
// cudaErrorInvalidValue for a head width other than 32 / 64 or T > 257.
extern "C" int tvc_mha(const void* q, const void* k, const void* v, void* out, int ld, int B, int T,
                       int H, int D, int is_bf16, int causal, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (D == 64) return launch_head_attention_strided<bf16, bf16, 64>(q, k, v, out, ld, B, T, H, causal, scale, s);
    if (D == 32) return launch_head_attention_strided<bf16, bf16, 32>(q, k, v, out, ld, B, T, H, causal, scale, s);
  } else {
    if (D == 64) return launch_head_attention_strided<float, float, 64>(q, k, v, out, ld, B, T, H, causal, scale, s);
    if (D == 32) return launch_head_attention_strided<float, float, 32>(q, k, v, out, ld, B, T, H, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
