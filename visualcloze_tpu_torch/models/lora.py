"""LoRA factors as a tree beside the DiT (counterpart of visualcloze_tpu/models/lora.py).

The tree mirrors the JAX one key for key: every linear of the Flux module
(img_in, time_in.in_layer, ..., double_blocks.*.img_attn.qkv, ...,
final_layer.adaLN) gets an entry {"a": (in, r), "b": (r, out), "b_bias":
(out,)} with r = min(rank, in, out), A uniform in +-in^-0.5 (torch
nn.Linear's default init, as the reference), B and its bias zero. Where JAX
stacks the block entries along a leading depth axis, the port keeps a list
with one entry per block. Leaves are plain tensors: the trainer makes them
require grad, and models/layers.py applies them unfolded.

fold_lora merges the factors into the base weights for serving, one linear
at a time on the weights' device: W + scale * A@B and b + scale * b_B in
fp32 (TF32 off, so the product is a true fp32 product), rounded once to the
weight's dtype.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Mapping

import torch
from torch import nn

Lora = dict[str, Any]


def _is_linear(module: nn.Module) -> bool:
    """A dense linear, or a quantized one that takes a LoRA delta
    (layers.Int8Linear, W8A8Linear: their class sets lora_target)."""
    return isinstance(module, nn.Linear) or getattr(type(module), "lora_target", False)


def _walk(module: nn.Module, make: Callable[[nn.Module], Lora]) -> Lora:
    out: Lora = {}
    for name, child in module.named_children():
        if _is_linear(child):
            out[name] = make(child)
        elif isinstance(child, nn.ModuleList):
            out[name] = [_walk(c, make) for c in child]
        else:
            sub = _walk(child, make)
            if sub:
                out[name] = sub
    return out


def full_features(lin: nn.Module) -> tuple[int, int]:
    """(in, out) of the whole linear, also where this rank holds a tensor-
    parallel shard of it (layers.TPShard): a LoRA entry is made for the
    whole linear and replicated."""
    tp = getattr(lin, "tp", None)
    if tp is None:
        return lin.in_features, lin.out_features
    return (lin.in_features, tp.full) if tp.kind == "column" else (tp.full, lin.out_features)


def init_lora(
    flux: nn.Module,
    rank: int,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
) -> Lora:
    """A LoRA tree for every linear of `flux` (dense or quantized), on flux's device."""
    device = next(flux.parameters()).device

    def make(lin: nn.Module) -> Lora:
        d_in, d_out = full_features(lin)
        r = min(rank, d_in, d_out)
        bound = d_in ** -0.5
        a = torch.empty((d_in, r), dtype=torch.float32, device=device)
        a.uniform_(-bound, bound, generator=generator)
        return {
            "a": a.to(dtype),
            "b": torch.zeros((r, d_out), dtype=dtype, device=device),
            "b_bias": torch.zeros((d_out,), dtype=dtype, device=device),
        }

    return _walk(flux, make)


def init_moe_lora(
    flux: nn.Module,
    rank: int,
    num_experts: int,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
) -> Lora:
    """A Mixture-of-LoRA-Experts tree for every linear of `flux` (JAX
    init_moe_lora, the same shapes and initialisation): shared_a (in, r) and
    expert_a (E, in, r) uniform in +-in^-0.5, shared_b (r, out) and expert_b
    (E, r, out) zero, gate_w (in, E) normal with std 0.01, gate_b (E,) zero;
    r = min(rank, in, out), the expert axis leading. Drawn from `generator`
    linear by linear, in that order. models/layers.py applies it unfolded
    (`_moe_lora_delta`); it cannot be folded."""
    device = next(flux.parameters()).device

    def make(lin: nn.Module) -> Lora:
        d_in, d_out = full_features(lin)
        r = min(rank, d_in, d_out)
        bound = d_in ** -0.5
        shared_a = torch.empty((d_in, r), dtype=torch.float32, device=device).uniform_(
            -bound, bound, generator=generator)
        expert_a = torch.empty((num_experts, d_in, r), dtype=torch.float32, device=device).uniform_(
            -bound, bound, generator=generator)
        gate_w = torch.randn((d_in, num_experts), generator=generator, dtype=torch.float32, device=device) * 0.01
        return {
            "shared_a": shared_a.to(dtype),
            "shared_b": torch.zeros((r, d_out), dtype=dtype, device=device),
            "expert_a": expert_a.to(dtype),
            "expert_b": torch.zeros((num_experts, r, d_out), dtype=dtype, device=device),
            "gate_w": gate_w.to(dtype),
            "gate_b": torch.zeros((num_experts,), dtype=dtype, device=device),
        }

    return _walk(flux, make)


def is_moe_lora(lora: Lora) -> bool:
    """True if any entry of the tree is a MoE-LoRA entry."""
    return any("expert_a" in entry for entry in lora_entries(lora).values())


def randomize_lora_b(lora: Lora, generator: torch.Generator, scale: float = 0.02) -> Lora:
    """`lora` with its zero-init output factors ("b"; MoE-LoRA's "shared_b"
    and "expert_b") replaced by scale * N(0, 1), drawn from `generator` in
    tree order (JAX randomize_lora_b draws a key per path instead): a visible
    but bounded delta, for serving random adapters (B = 0 adds nothing)."""

    def draw(path: str, x: torch.Tensor) -> torch.Tensor:
        if path.rsplit(".", 1)[-1] not in ("b", "shared_b", "expert_b"):
            return x
        noise = torch.randn(x.shape, generator=generator, dtype=torch.float32, device=x.device)
        return (noise * scale).to(x.dtype)

    return tree_replace(lora, {path: draw(path, x) for path, x in tree_items(lora)})


def tree_items(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, leaf) pairs in a fixed order: dict order, list index."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        children = tree.items()
    elif isinstance(tree, (list, tuple)):
        children = enumerate(tree)
    else:
        raise TypeError(f"{prefix}: not a LoRA tree node: {type(tree)}")
    out = []
    for key, sub in children:
        out += tree_items(sub, f"{prefix}.{key}" if prefix else str(key))
    return out


def tree_leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in tree_items(tree)]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def tree_replace(tree, values: dict[str, torch.Tensor], prefix: str = ""):
    """`tree` with every leaf replaced by values[its dotted path]."""
    if isinstance(tree, torch.Tensor):
        return values[prefix]
    if isinstance(tree, dict):
        return {k: tree_replace(v, values, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
    return [tree_replace(v, values, f"{prefix}.{i}" if prefix else str(i)) for i, v in enumerate(tree)]


def lora_param_count(lora: Lora) -> int:
    return sum(t.numel() for t in tree_leaves(lora))


def lora_entries(lora: Lora, prefix: str = "") -> dict[str, Lora]:
    """{dotted module path of the linear: its entry} ("double_blocks.3.img_attn.qkv", ...)."""
    if isinstance(lora, Mapping) and ("a" in lora or "expert_a" in lora):
        return {prefix: lora}
    children = lora.items() if isinstance(lora, Mapping) else enumerate(lora)
    out: dict[str, Lora] = {}
    for key, sub in children:
        out.update(lora_entries(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


@contextlib.contextmanager
def full_fp32_matmul():
    """CUDA matmuls in true fp32 (TF32 off) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def check_foldable(entry: Lora, linear: nn.Module) -> None:
    if "expert_a" in entry:
        raise ValueError(
            "MoE-LoRA entries are input-gated and cannot be folded into dense weights"
        )
    if not isinstance(linear, nn.Linear):
        raise ValueError(
            "cannot fold LoRA into int8-quantized weights; fold before quantization"
        )


@torch.no_grad()
def fold_linear_(linear: nn.Linear, entry: Lora, scale: float = 1.0,
                 w_src: torch.Tensor | None = None, b_src: torch.Tensor | None = None) -> None:
    """linear.weight = (fp32(w) + scale * (A@B)^T) in the weight's dtype, and
    the bias likewise with B's bias (created when the linear has none). w_src,
    b_src: the base weight and bias to fold into, in any dtype and on any
    device (a checkpoint's tensors); default the linear's own."""
    check_foldable(entry, linear)
    w = linear.weight
    dev = w.device
    with full_fp32_matmul():
        delta = torch.matmul(entry["a"].to(dev, torch.float32), entry["b"].to(dev, torch.float32)) * scale
    base = w if w_src is None else w_src
    w.copy_(base.to(dev).to(torch.float32) + delta.T)  # host -> card in the file's dtype
    if "b_bias" in entry:
        bb = entry["b_bias"].to(dev, torch.float32) * scale
        if linear.bias is None:
            linear.bias = nn.Parameter(bb.to(w.dtype), requires_grad=False)
        else:
            base_b = linear.bias if b_src is None else b_src
            linear.bias.copy_(base_b.to(dev).to(torch.float32) + bb)
    elif b_src is not None:
        linear.bias.copy_(b_src)


def fold_lora(flux: nn.Module, lora: Lora, scale: float = 1.0) -> nn.Module:
    """Merge a LoRA tree into the linears of `flux` in place (W += scale A@B,
    b += scale b_B); returns flux. Refuses MoE-LoRA entries and int8 linears,
    as the JAX package does."""
    entries = lora_entries(lora)
    modules = dict(flux.named_modules())
    missing = sorted(set(entries) - set(modules))
    if missing:
        raise ValueError(f"LoRA entries with no linear in the model: {missing[:8]}")
    for path, entry in entries.items():
        fold_linear_(modules[path], entry, scale)
    return flux
