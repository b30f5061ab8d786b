"""Attention entry point of the FLUX blocks (counterpart of
visualcloze_tpu/ops/attention.py).

Padding is an additive key bias over static lengths; padded query rows are
zeroed at the end, as flash-attn's unpad/re-pad round trip leaves them. The
half-layout RoPE case, the only one the serving path takes, goes to kernel A
with the rotation inside the kernel. `mha_xla` is the fp32 oracle the
kernels are held against.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attn_rope

NEG_INF = -1e30


def mask_to_bias(mask: torch.Tensor | None) -> torch.Tensor | None:
    """(B, L) {0,1} key mask -> (B, L) additive fp32 bias (0 / -1e30)."""
    if mask is None:
        return None
    return torch.where(
        mask > 0,
        torch.zeros((), dtype=torch.float32, device=mask.device),
        torch.full((), NEG_INF, dtype=torch.float32, device=mask.device),
    )


def mha_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference multi-head attention with an fp32 softmax; q, k, v (B, H, L, D),
    bias (B, Lk) or None; returns q.dtype. The name follows the JAX package."""
    d = q.shape[-1]
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * d ** -0.5
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pe: tuple[torch.Tensor, torch.Tensor],
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """RoPE + masked MHA + head merge.

    q, k, v: (B, H, L, D) unrotated, in the half RoPE layout (the serving
    layout; the interleaved one needs kernel D, not ported yet); pe: (cos,
    sin), each (B, L, D/2); mask: (B, L) int {1 real, 0 pad}. Returns
    (B, L, H * D) with padded query rows zeroed."""
    cos, sin = pe
    x = flash_attn_rope(
        q.contiguous(), k.contiguous(), v.contiguous(), mask_to_bias(mask),
        cos.contiguous(), sin.contiguous(),
    )
    b, h, l, d = x.shape
    x = x.transpose(1, 2).reshape(b, l, h * d)
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    return x
