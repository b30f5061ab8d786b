"""Reference-format LoRA checkpoints <-> the port's LoRA tree (the
counterparts of `lora_to_torch_state` and `convert_lora` in
visualcloze_tpu/models/weights.py; the other converters are not ported).

The reference trainer names LoRA factors after the BFL FLUX modules,
`{module}.lora_A.weight` (r, in), `{module}.lora_B.weight` (out, r) and
`{module}.lora_B.bias` (out,); the tree stores a (in, r), b (r, out) and
b_bias (out,), with one entry per block where JAX stacks them.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..config import FluxConfig
from .lora import Lora

_TOP_LINS = {
    ("img_in",): "img_in",
    ("txt_in",): "txt_in",
    ("time_in", "in_layer"): "time_in.in_layer",
    ("time_in", "out_layer"): "time_in.out_layer",
    ("vector_in", "in_layer"): "vector_in.in_layer",
    ("vector_in", "out_layer"): "vector_in.out_layer",
    ("guidance_in", "in_layer"): "guidance_in.in_layer",
    ("guidance_in", "out_layer"): "guidance_in.out_layer",
    ("final_layer", "linear"): "final_layer.linear",
    ("final_layer", "adaLN"): "final_layer.adaLN_modulation.1",
}

_DOUBLE_LINS = {
    ("img_mod", "lin"): "img_mod.lin",
    ("txt_mod", "lin"): "txt_mod.lin",
    ("img_attn", "qkv"): "img_attn.qkv",
    ("img_attn", "proj"): "img_attn.proj",
    ("txt_attn", "qkv"): "txt_attn.qkv",
    ("txt_attn", "proj"): "txt_attn.proj",
    ("img_mlp", "0"): "img_mlp.0",
    ("img_mlp", "2"): "img_mlp.2",
    ("txt_mlp", "0"): "txt_mlp.0",
    ("txt_mlp", "2"): "txt_mlp.2",
}

_SINGLE_LINS = {
    ("linear1",): "linear1",
    ("linear2",): "linear2",
    ("modulation", "lin"): "modulation.lin",
}

_BLOCKS = (("double_blocks", _DOUBLE_LINS), ("single_blocks", _SINGLE_LINS))


def _get(tree, path):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def lora_to_torch_state(lora: Lora) -> dict[str, torch.Tensor]:
    """LoRA tree -> the reference's checkpoint naming, contiguous CPU tensors."""
    state: dict[str, torch.Tensor] = {}

    def put(key: str, e: Lora) -> None:
        state[f"{key}.lora_A.weight"] = e["a"].detach().T.contiguous().cpu()
        state[f"{key}.lora_B.weight"] = e["b"].detach().T.contiguous().cpu()
        if "b_bias" in e:
            state[f"{key}.lora_B.bias"] = e["b_bias"].detach().contiguous().cpu()

    for path, key in _TOP_LINS.items():
        e = _get(lora, path)
        if e is not None:
            put(key, e)
    for prefix, lins in _BLOCKS:
        for i, block in enumerate(lora.get(prefix) or []):
            for path, key in lins.items():
                e = _get(block, path)
                if e is not None:
                    put(f"{prefix}.{i}.{key}", e)
    return state


def _lora_entry(state: Mapping[str, torch.Tensor], key: str, dtype) -> Lora | None:
    akey = f"{key}.lora_A.weight"
    if akey not in state:
        return None
    entry = {"a": state[akey].T, "b": state[f"{key}.lora_B.weight"].T}
    if f"{key}.lora_B.bias" in state:
        entry["b_bias"] = state[f"{key}.lora_B.bias"]
    return {k: v.to(dtype).contiguous() for k, v in entry.items()}


def convert_lora(state: Mapping[str, torch.Tensor], cfg: FluxConfig, dtype=torch.float32) -> Lora:
    """Reference-trainer LoRA checkpoint (lora_A / lora_B keys) -> LoRA tree."""
    lora: Lora = {}
    for path, key in _TOP_LINS.items():
        if path[0] == "guidance_in" and not cfg.guidance_embed:
            continue
        e = _lora_entry(state, key, dtype)
        if e is not None:
            _set(lora, path, e)
    for (prefix, lins), n in zip(_BLOCKS, (cfg.depth, cfg.depth_single_blocks)):
        blocks = []
        for i in range(n):
            block: Lora = {}
            for path, key in lins.items():
                e = _lora_entry(state, f"{prefix}.{i}.{key}", dtype)
                if e is not None:
                    _set(block, path, e)
            blocks.append(block)
        if any(blocks):
            lora[prefix] = blocks
    return lora
