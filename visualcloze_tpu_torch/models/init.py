"""Building modules straight on their device and in their dtype.

A module is constructed on the meta device under the target default dtype,
then given uninitialized storage on the device, then filled: so a 12B-
parameter DiT in bf16 never exists in fp32 or on the host, and peak memory
equals resident memory.
"""

from __future__ import annotations

import contextlib
from typing import Callable, TypeVar

import torch
from torch import nn

M = TypeVar("M", bound=nn.Module)


@contextlib.contextmanager
def _default_dtype(dtype: torch.dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def materialize(ctor: Callable[[], M], device: torch.device, dtype: torch.dtype) -> M:
    """ctor() with uninitialized parameters of `dtype` on `device`, frozen
    (the port is inference only)."""
    with torch.device("meta"), _default_dtype(dtype):
        module = ctor()
    module = module.to_empty(device=device)
    module.requires_grad_(False)
    return module.eval()


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def init_linears_(module: nn.Module, generator: torch.Generator) -> None:
    """Every nn.Linear below `module`: N(0, 1/fan_in) weights, zero biases
    (the JAX package's `_init_linear`)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, m.in_features ** -0.5, generator)
            if m.bias is not None:
                m.bias.zero_()
