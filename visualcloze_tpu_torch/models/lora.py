"""LoRA factors as a tree beside the DiT (counterpart of visualcloze_tpu/models/lora.py).

The tree mirrors the JAX one key for key: every linear of the Flux module
(img_in, time_in.in_layer, ..., double_blocks.*.img_attn.qkv, ...,
final_layer.adaLN) gets an entry {"a": (in, r), "b": (r, out), "b_bias":
(out,)} with r = min(rank, in, out), A uniform in +-in^-0.5 (torch
nn.Linear's default init, as the reference), B and its bias zero. Where JAX
stacks the block entries along a leading depth axis, the port keeps a list
with one entry per block. Leaves are plain tensors: the trainer makes them
require grad, and models/layers.py applies them unfolded.
fold_lora (merging the factors into the base weights) is not ported yet:
ROADMAP item 7.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

Lora = dict[str, Any]


def _walk(module: nn.Module, make: Callable[[nn.Linear], Lora]) -> Lora:
    out: Lora = {}
    for name, child in module.named_children():
        if isinstance(child, nn.Linear):
            out[name] = make(child)
        elif isinstance(child, nn.ModuleList):
            out[name] = [_walk(c, make) for c in child]
        else:
            sub = _walk(child, make)
            if sub:
                out[name] = sub
    return out


def init_lora(
    flux: nn.Module,
    rank: int,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
) -> Lora:
    """A LoRA tree for every linear of `flux`, on flux's device."""
    device = next(flux.parameters()).device

    def make(lin: nn.Linear) -> Lora:
        d_in, d_out = lin.in_features, lin.out_features
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
