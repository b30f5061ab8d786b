"""Tensor ops of the port and the wrappers of its hand-written CUDA kernels."""

from .act_quant import act_quant_int8, gelu_act_quant
from .block_fusions import (gated_residual, gated_residual_bwd, layernorm_modulate, layernorm_modulate_bwd,
                            layernorm_modulate_quant, merge_heads, merge_heads_bwd, merge_heads_quant, qk_norm_split,
                            qk_norm_split_bwd)
from .conv2d import conv3x3_gn_swish
from .flash_attention import (
    flash_attn_bwd_dkv,
    flash_attn_bwd_dq,
    flash_attn_d512,
    flash_attn_fwd,
    flash_attn_fwd_lse,
    flash_attn_rope,
)
from . import group_norm as _group_norm  # the attribute stays the module; its wrapper `group_norm` is a kernel below
from .group_norm import group_norm_apply, group_norm_stats
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
    "gelu_act_quant": gelu_act_quant,
    "layernorm_modulate": layernorm_modulate,
    "gated_residual": gated_residual,
    "qk_norm_split": qk_norm_split,
    "merge_heads": merge_heads,
    "layernorm_modulate_quant": layernorm_modulate_quant,
    "merge_heads_quant": merge_heads_quant,
    "layernorm_modulate_bwd": layernorm_modulate_bwd,
    "gated_residual_bwd": gated_residual_bwd,
    "qk_norm_split_bwd": qk_norm_split_bwd,
    "merge_heads_bwd": merge_heads_bwd,
    "group_norm_stats": group_norm_stats,
    "group_norm_apply": group_norm_apply,
    "group_norm": _group_norm.group_norm,
}


def kernel_launches() -> dict[str, int]:
    """Launch count of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_kernel_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "kernel_launches", "reset_kernel_launches", *KERNELS]
