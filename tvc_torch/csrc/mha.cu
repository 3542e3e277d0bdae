// Multi-head softmax attention on [B, T, H, D] q, k, v for Hopper (sm_90a):
// the port of the TPU kernel tvc/core/pallas/attention_kernel.py
// (_mha_kernel, fused_mha), which the module vision tower with
// fused_attention runs in every layer.
//
// What it computes, per (b, h): f32 logits of the operands times 1/sqrt(D),
// the optional causal mask (column <= row), an f32 softmax, the weights
// cast to the operands' type, P.V accumulated in f32, the output in the
// operands' type. That is the per-head attention the layer kernels run
// (head_attention.cuh); only the layout differs, so this file instantiates
// the same kernels on three base pointers with the row stride of the
// [B, T, H, D] tensors (H * D, or 3W for q | k | v views of one packed
// projection, which then needs no copy).
//
// What bounds it: 4 T^2 D flops per (b, h) against 4 T D bytes moved
// (bf16: T flops a byte). At ViT-B/32 (T = 50) device memory bounds it, at
// ViT-L/14 (T = 257, 577) the work nears the bf16 ridge. bf16 operands run
// on the tensor cores (head_attention_tc_kernel: 64 query rows a block,
// wgmma for Q.K^T and P.V, k and v tiles streamed by TMA through a
// 2-stage ring, the output written once). f32 operands run on the CUDA
// cores (head_attention_kernel: 64 query rows a block, 64-row key tiles,
// the same two sweeps, f32 weights). Neither has a limit on T. Other head
// widths run the header's tail path, a warp a query row.

#include "head_attention.cuh"

// q, k, v: [B, T, H, D] with row stride `ld` elements (the batch stride is
// T * ld); out: contiguous [B, T, H, D] of the operands' type. Head widths
// other than 32 / 64 take the tail path (attention_rows_kernel).
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
  if (is_bf16) return launch_head_attention_any<bf16, bf16>(q, k, v, out, ld, B, T, H, D, causal, scale, s);
  return launch_head_attention_any<float, float>(q, k, v, out, ld, B, T, H, D, causal, scale, s);
}
