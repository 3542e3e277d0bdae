"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
computes the plain version for CPU tensors; ``<wrapper>.launches`` counts
the calls that launched the kernel.
"""

from tvc_torch.core.kernels.attention_kernel import fused_mha, mha_reference
from tvc_torch.core.kernels.attention_layer_kernel import (
    attention_layer_reference,
    fused_attention_layer,
    fused_mlp_layer,
    mlp_layer_reference,
)
from tvc_torch.core.kernels.consistency_kernel import (
    consistency_scores_reference,
    fused_consistency_scores,
)
from tvc_torch.core.kernels.decode_attention_kernel import (
    decode_gqa_attention,
    decode_gqa_attention_stacked,
    decode_gqa_reference,
)
from tvc_torch.core.kernels.decode_fused_kernel import (
    add_rmsnorm,
    add_rmsnorm_reference,
    qkv_cache,
    qkv_cache_reference,
    qkv_rope_cache,
    qkv_rope_cache_reference,
    relu2,
    relu2_reference,
    rmsnorm,
    rmsnorm_reference,
    silu_mul,
    silu_mul_reference,
)
from tvc_torch.core.kernels.dsv2_fused_kernel import (
    mla_out,
    mla_out_reference,
    mla_rope_cache,
    mla_rope_cache_reference,
    moe_combine,
    moe_combine_reference,
    moe_route,
    moe_route_reference,
)
from tvc_torch.core.kernels.kda_kernel import (
    kda_gated_norm,
    kda_gated_norm_reference,
    kda_prepare,
    kda_prepare_reference,
    kda_recurrent,
    kda_recurrent_reference,
)
from tvc_torch.core.kernels.mla_kernel import mla_decode_attention, mla_decode_reference
from tvc_torch.core.kernels.moe_kernel import moe_w8_grouped_gemm, moe_w8_grouped_reference
from tvc_torch.core.kernels.quantized_layer_kernel import (
    attention_layer_i8_reference,
    fused_attention_layer_i8,
    fused_mlp_layer_i8,
    mlp_layer_i8_reference,
    quantize_linear,
)
from tvc_torch.core.kernels.ssm_kernel import (
    ssm_gated_norm,
    ssm_gated_norm_reference,
    ssm_prepare,
    ssm_prepare_reference,
    ssm_recurrent,
    ssm_recurrent_reference,
)
from tvc_torch.core.kernels.topk_kernel import bank_topk, bank_topk_reference
from tvc_torch.core.kernels.w8_matmul_kernel import (
    w8_matmul,
    w8_matmul_plain,
    w8_matmul_reference,
    w8_matmul_stacked,
    w8a8_matmul,
    w8a8_matmul_reference,
    w8a8_matmul_stacked,
)

KERNELS = (
    fused_consistency_scores,
    fused_attention_layer,
    fused_mlp_layer,
    fused_attention_layer_i8,
    fused_mlp_layer_i8,
    decode_gqa_attention,
    decode_gqa_attention_stacked,
    w8a8_matmul,
    w8a8_matmul_stacked,
    w8_matmul,
    w8_matmul_stacked,
    bank_topk,
    fused_mha,
    moe_w8_grouped_gemm,
    mla_decode_attention,
    rmsnorm,
    add_rmsnorm,
    qkv_rope_cache,
    silu_mul,
    mla_rope_cache,
    mla_out,
    moe_route,
    moe_combine,
    kda_prepare,
    kda_recurrent,
    kda_gated_norm,
    qkv_cache,
    relu2,
    ssm_prepare,
    ssm_recurrent,
    ssm_gated_norm,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
