"""Tensor ops of the port and the wrappers of its hand-written CUDA kernels."""

from .conv2d import conv3x3_gn_swish
from .flash_attention import flash_attn_d512, flash_attn_rope

KERNELS = {
    "flash_attn_rope": flash_attn_rope,
    "flash_attn_d512": flash_attn_d512,
    "conv3x3_gn_swish": conv3x3_gn_swish,
}


def kernel_launches() -> dict[str, int]:
    """Launch count of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_kernel_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "conv3x3_gn_swish",
    "flash_attn_d512",
    "flash_attn_rope",
    "kernel_launches",
    "reset_kernel_launches",
]
