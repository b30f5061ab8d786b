"""Multi-axis rotary position embeddings (counterpart of visualcloze_tpu/ops/rope.py).

Tables are (cos, sin) pairs in float32. The frequencies are built host-side in
float64 and rounded to float32, as in the JAX package; only pos * omega runs
on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def rope_table(pos: torch.Tensor, dim: int, theta: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-axis rotation table: pos (..., L) -> (cos, sin), each (..., L, dim // 2) fp32."""
    assert dim % 2 == 0, f"rope dim must be even, got {dim}"
    scale = np.arange(0, dim, 2, dtype=np.float64) / dim
    omega = torch.from_numpy((1.0 / (theta ** scale)).astype(np.float32)).to(pos.device)
    out = pos[..., None].to(torch.float32) * omega
    return torch.cos(out), torch.sin(out)


def embed_nd(
    ids: torch.Tensor, axes_dim: Sequence[int], theta: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """ids (..., L, n_axes) -> (cos, sin), each (..., L, sum(axes_dim) // 2) fp32."""
    n_axes = ids.shape[-1]
    assert n_axes == len(axes_dim), (ids.shape, axes_dim)
    coss, sins = [], []
    for i, d in enumerate(axes_dim):
        c, s = rope_table(ids[..., i], d, theta)
        coss.append(c)
        sins.append(s)
    return torch.cat(coss, dim=-1), torch.cat(sins, dim=-1)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q/k stored in the de-interleaved "half" layout (first D/2
    channels = pair-even lanes, last D/2 = pair-odd lanes), in fp32."""
    x32 = x.to(torch.float32)
    e, o = x32.chunk(2, dim=-1)
    out = torch.cat([cos * e - sin * o, sin * e + cos * o], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive (even, odd) channel pairs (the reference layout), in fp32."""
    x32 = x.to(torch.float32)
    even = x32[..., 0::2]
    odd = x32[..., 1::2]
    out = torch.stack([cos * even - sin * odd, sin * even + cos * odd], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
