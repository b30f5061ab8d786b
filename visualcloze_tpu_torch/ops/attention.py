"""Attention entry point of the FLUX blocks (counterpart of
visualcloze_tpu/ops/attention.py).

Padding is an additive key bias over static lengths; padded query rows are
zeroed at the end, as flash-attn's unpad/re-pad round trip leaves them (and
so their output gradients are 0, which the backward kernels rely on). The
half RoPE layout, the serving one, goes to kernel A with the rotation inside
the kernel (or, under autograd, to its E/F gradient); the interleaved layout,
the reference's and the trainer's, rotates q and k here and goes to
`flash_mha` (kernel D, or E and F under autograd). The blocks' head merge
is kernel M (ops/block_fusions.py), under autograd its Function with
kernel M' as the backward. `mha_xla` is the fp32 oracle the kernels are
held against.

Under a `RingSpec` (JAX's sequence-parallel dispatch) q, k, v, the mask
and the RoPE tables are this rank's block of the sequence; q and k are
rotated first, in either layout, and ring attention runs kernel E per chunk
(F in its backward) over the spec's mesh axis; kernel A's fused rotation
does not apply there.
"""

from __future__ import annotations

import dataclasses

import torch

from .block_fusions import apply_merge_heads, merge_heads_plain
from .flash_attention import flash_mha, flash_mha_rope
from .rope import apply_rope, apply_rope_half

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Sequence-parallel attention: pass as `attn_impl` wherever the blocks
    take one (Flux.forward, the blocks, attention). Flux.forward then keeps
    each rank's block of the txt and img tokens over `axis` of `mesh`
    (parallel/mesh.Mesh), and the joint sequence is attended exactly by ring
    attention (ops/ring_attention.py): kernels E and F on CUDA tensors,
    their plain versions on CPU tensors (the rule of every wrapper)."""

    mesh: object
    axis: str = "cp"


def mha(q, k, v, bias=None, impl=None) -> torch.Tensor:
    """Attention on rotated q, k (B, H, L, D): ring attention under a
    RingSpec (q, k, v, bias this rank's sequence block), else flash_mha
    (kernel D, or E and F under autograd)."""
    if isinstance(impl, RingSpec):
        from .ring_attention import ring_attention

        return ring_attention(q, k, v, bias, impl.mesh, axis=impl.axis)
    if impl is not None:
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_mha(q, k, v, bias)


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


def rope_qk(
    q: torch.Tensor,
    k: torch.Tensor,
    pe: tuple[torch.Tensor, torch.Tensor] | None,
    rope_layout: str = "interleaved",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k ((B, H, L, D); pe = (cos, sin), each (B, L, D/2)) in
    fp32, rounded back to their dtype. Split out of attention() so that the
    two-segment remat path rotates inside its first segment."""
    if pe is None:
        return q, k
    cos, sin = pe[0][:, None], pe[1][:, None]  # broadcast over heads
    rope_fn = apply_rope_half if rope_layout == "half" else apply_rope
    return rope_fn(q, cos, sin), rope_fn(k, cos, sin)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pe: tuple[torch.Tensor, torch.Tensor] | None,
    mask: torch.Tensor | None = None,
    rope_layout: str = "half",
    impl: RingSpec | None = None,
    gelu: torch.Tensor | None = None,
    fused: bool = False,
) -> torch.Tensor:
    """RoPE + masked MHA + head merge.

    q, k, v: (B, H, L, D), unrotated (pe = (cos, sin), each (B, L, D/2)) or
    already rotated (pe None); mask: (B, L) int {1 real, 0 pad}; impl None
    (the kernels) or a RingSpec. Returns (B, L, H * D) with padded query rows
    zeroed. gelu: (B, L, G), whose gelu(tanh) is appended -> (B, L, H * D +
    G), the single block's linear2 input in one buffer. fused: the merge by
    kernel M (under autograd its Function, kernel M' the backward); else its
    plain version (calibration)."""
    bias = mask_to_bias(mask)
    if impl is None and pe is not None and rope_layout == "half" and q.shape[2] == k.shape[2]:
        x = flash_mha_rope(q, k, v, bias, pe[0].contiguous(), pe[1].contiguous())
    else:
        q, k = rope_qk(q, k, pe, rope_layout)
        x = mha(q, k, v, bias, impl)
    if fused:
        return apply_merge_heads(x, mask, gelu)
    return merge_heads_plain(x, mask, gelu)
