"""Tensor ops of the port and the wrappers of its hand-written CUDA kernels."""

from .act_quant import act_quant_int8
from .block_fusions import (gated_residual, gated_residual_bwd, layernorm_modulate, layernorm_modulate_bwd, merge_heads,
                            merge_heads_bwd, qk_norm_split, qk_norm_split_bwd)
from .conv2d import conv3x3_gn_swish
from .flash_attention import (
    flash_attn_bwd_dkv,
    flash_attn_bwd_dq,
    flash_attn_d512,
    flash_attn_fwd,
    flash_attn_fwd_lse,
    flash_attn_rope,
)
from .int4_matmul import int4_matmul
from .int8_matmul import int8_matmul
from .w8a8_matmul import w8a8_matmul

KERNELS = {
    "flash_attn_rope": flash_attn_rope,
    "flash_attn_d512": flash_attn_d512,
    "conv3x3_gn_swish": conv3x3_gn_swish,
    "flash_attn_fwd": flash_attn_fwd,
    "flash_attn_fwd_lse": flash_attn_fwd_lse,
    "flash_attn_bwd_dq": flash_attn_bwd_dq,
    "flash_attn_bwd_dkv": flash_attn_bwd_dkv,
    "int8_matmul": int8_matmul,
    "int4_matmul": int4_matmul,
    "w8a8_matmul": w8a8_matmul,
    "act_quant_int8": act_quant_int8,
    "layernorm_modulate": layernorm_modulate,
    "gated_residual": gated_residual,
    "qk_norm_split": qk_norm_split,
    "merge_heads": merge_heads,
    "layernorm_modulate_bwd": layernorm_modulate_bwd,
    "gated_residual_bwd": gated_residual_bwd,
    "qk_norm_split_bwd": qk_norm_split_bwd,
    "merge_heads_bwd": merge_heads_bwd,
}


def kernel_launches() -> dict[str, int]:
    """Launch count of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_kernel_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "kernel_launches", "reset_kernel_launches", *KERNELS]
