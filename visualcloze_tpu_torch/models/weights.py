"""Checkpoint files <-> the port's modules (counterpart of
visualcloze_tpu/models/weights.py).

Formats: BFL FLUX safetensors (flux1-fill-dev.safetensors naming) and the
diffusers FluxTransformer2DModel naming; reference-trainer LoRA checkpoints
(`{module}.lora_A.weight` (r, in), `{module}.lora_B.weight` (out, r),
`{module}.lora_B.bias` (out,)) and diffusers/peft LoRA files; the BFL and
diffusers VAE; HF T5EncoderModel and CLIPTextModel state dicts.

The converters map a checkpoint's state dict onto the port's parameter names
(`convert_*` -> {name: tensor}) and `assign_state` copies it into a module.
Tensors stay in their file dtype, and where possible stay views of the file,
until they are copied into the module on its device, one at a time: a 24 GB
checkpoint is never converted or held whole on the host. Layouts: the port's
Flux, T5 and CLIP linears are nn.Linear (out, in), as the checkpoints store
them; the VAE convs are (kh, kw, in, out) and the checkpoints' (out, in, kh,
kw). LoRA trees hold a (in, r), b (r, out) and b_bias (out,), one entry per
block where JAX stacks them.

safetensors files are read and written here without the `safetensors`
package: an 8-byte little-endian header length, a JSON header, then the raw
little-endian bytes of each tensor; reading maps the file (np.memmap) and
bf16 is read as uint16 and viewed as torch.bfloat16.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..config import AutoEncoderConfig, CLIPTextConfig, FluxConfig, T5Config
from .lora import Lora, check_foldable, fold_linear_, lora_entries

State = Mapping[str, torch.Tensor]

# ----------------------------- safetensors -----------------------------

# name -> (numpy dtype of the stored bytes, torch dtype); the writer orders
# tensors as the safetensors package does: dtypes in this order, then names
_ST_DTYPES = {
    "U64": (np.uint64, torch.uint64),
    "I64": (np.int64, torch.int64),
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "U32": (np.uint32, torch.uint32),
    "I32": (np.int32, torch.int32),
    "BF16": (np.uint16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "U16": (np.uint16, torch.uint16),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_ST_NAME = {tdt: name for name, (_, tdt) in _ST_DTYPES.items()}
_ST_RANK = {name: i for i, name in enumerate(_ST_DTYPES)}


def read_safetensors_header(path: str) -> tuple[dict, int]:
    """(the JSON header, the file offset of the tensor bytes)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A safetensors file as CPU tensors that map the file (copy-on-write:
    nothing is read until a tensor is used, and nothing is written back)."""
    header, start = read_safetensors_header(path)
    header.pop("__metadata__", None)
    buf = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, info in header.items():
        np_dt, torch_dt = _ST_DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        raw = buf[start + lo: start + hi]
        if (start + lo) % np.dtype(np_dt).itemsize:  # unaligned: copy
            raw = np.array(raw)
        arr = raw.view(np_dt).reshape(info["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def save_safetensors(state: Mapping[str, torch.Tensor], path: str, metadata: dict[str, str] | None = None) -> int:
    """Write `state` (tensors on any device) as a safetensors file, one tensor
    at a time through host memory, in the safetensors package's layout
    (tensors by dtype then name, header padded with spaces to 8 bytes).
    Returns the bytes written."""
    order = sorted(state, key=lambda k: (_ST_RANK[_ST_NAME[state[k].dtype]], k))
    header: dict = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset = 0
    for name in order:
        t = state[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAME[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    blob += b" " * ((8 - len(blob) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = state[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


# ----------------------------- placing a state -----------------------------


@torch.no_grad()
def assign_state(module: nn.Module, state: State, lora: Lora | None = None, scale: float = 1.0) -> nn.Module:
    """Copy state[name] into every parameter and buffer of `module` (on its
    device, in its dtype): each exactly once, no name left out and none
    unknown. lora: a LoRA tree whose entries are folded into their linears as
    they are placed (lora.fold_linear_, from the state's own tensors, so an
    fp32 checkpoint is rounded once)."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    unknown = sorted(set(state) - set(targets))
    missing = sorted(set(targets) - set(state))
    if unknown or missing:
        raise ValueError(f"state vs module: unknown {unknown[:8]}, missing {missing[:8]}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(targets[name].shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} vs module {tuple(targets[name].shape)}")
    entries = lora_entries(lora) if lora else {}
    modules = dict(module.named_modules())
    no_linear = sorted(p for p in entries if p not in modules)
    if no_linear:
        raise ValueError(f"LoRA entries with no linear in the model: {no_linear[:8]}")
    for path, entry in entries.items():
        check_foldable(entry, modules[path])
    folded = set()
    for path, entry in entries.items():
        lin = modules[path]
        b_src = state.get(f"{path}.bias") if lin.bias is not None else None
        fold_linear_(lin, entry, scale, w_src=state[f"{path}.weight"], b_src=b_src)
        folded |= {f"{path}.weight", f"{path}.bias"}
    for name, target in targets.items():
        if name not in folded:
            target.copy_(state[name])
    return module


def module_state(module: nn.Module) -> dict[str, torch.Tensor]:
    """Every parameter and buffer of `module` by name (detached, in place)."""
    out = {k: v.detach() for k, v in module.named_parameters()}
    out.update({k: v.detach() for k, v in module.named_buffers()})
    return out


# ----------------------------- Flux -----------------------------

# the port's module path -> the BFL module name
_TOP_LINS = {
    "img_in": "img_in",
    "txt_in": "txt_in",
    "time_in.in_layer": "time_in.in_layer",
    "time_in.out_layer": "time_in.out_layer",
    "vector_in.in_layer": "vector_in.in_layer",
    "vector_in.out_layer": "vector_in.out_layer",
    "guidance_in.in_layer": "guidance_in.in_layer",
    "guidance_in.out_layer": "guidance_in.out_layer",
    "final_layer.linear": "final_layer.linear",
    "final_layer.adaLN": "final_layer.adaLN_modulation.1",
}
_DOUBLE_LINS = ("img_mod.lin", "txt_mod.lin", "img_attn.qkv", "img_attn.proj", "txt_attn.qkv", "txt_attn.proj",
                "img_mlp.0", "img_mlp.2", "txt_mlp.0", "txt_mlp.2")
_SINGLE_LINS = ("linear1", "linear2", "modulation.lin")
_BLOCKS = (("double_blocks", _DOUBLE_LINS), ("single_blocks", _SINGLE_LINS))
# the port's norm leaf -> the BFL one
_NORMS = {"q_scale": "query_norm.scale", "k_scale": "key_norm.scale"}


def _lin(state: State, key: str, out: dict, name: str) -> None:
    out[f"{name}.weight"] = state[f"{key}.weight"]
    if f"{key}.bias" in state:
        out[f"{name}.bias"] = state[f"{key}.bias"]


def convert_flux(state: State, cfg: FluxConfig) -> dict[str, torch.Tensor]:
    """BFL/reference FLUX state dict -> the port's Flux names, with the Fill
    model's img_in zero-expansion when the checkpoint's in-features are
    narrower than cfg.in_channels."""
    out: dict[str, torch.Tensor] = {}
    for name, key in _TOP_LINS.items():
        if name.startswith("guidance_in") and not cfg.guidance_embed:
            continue
        _lin(state, key, out, name)
    w = out["img_in.weight"]
    if w.shape[1] < cfg.in_channels:  # dev's 64-channel img_in -> Fill's 384
        expanded = torch.zeros((w.shape[0], cfg.in_channels), dtype=w.dtype)
        expanded[:, : w.shape[1]] = w
        out["img_in.weight"] = expanded
    for i in range(cfg.depth):
        b = f"double_blocks.{i}."
        for name in _DOUBLE_LINS:
            _lin(state, b + name, out, b + name)
        for stream in ("img_attn", "txt_attn"):
            for leaf, key in _NORMS.items():
                out[f"{b}{stream}.norm.{leaf}"] = state[f"{b}{stream}.norm.{key}"]
    for i in range(cfg.depth_single_blocks):
        b = f"single_blocks.{i}."
        for name in _SINGLE_LINS:
            _lin(state, b + name, out, b + name)
        for leaf, key in _NORMS.items():
            out[f"{b}norm.{leaf}"] = state[f"{b}norm.{key}"]
    return out


def flux_to_torch_state(flux: nn.Module, cfg: FluxConfig) -> dict[str, torch.Tensor]:
    """A dense Flux -> BFL naming (the inverse of convert_flux): the module's
    own tensors, on its device."""
    params = module_state(flux)
    state: dict[str, torch.Tensor] = {}

    def put(name: str, key: str) -> None:
        state[f"{key}.weight"] = params[f"{name}.weight"]
        if f"{name}.bias" in params:
            state[f"{key}.bias"] = params[f"{name}.bias"]

    for name, key in _TOP_LINS.items():
        if name.startswith("guidance_in") and not cfg.guidance_embed:
            continue
        put(name, key)
    for i in range(cfg.depth):
        b = f"double_blocks.{i}."
        for name in _DOUBLE_LINS:
            put(b + name, b + name)
        for stream in ("img_attn", "txt_attn"):
            for leaf, key in _NORMS.items():
                state[f"{b}{stream}.norm.{key}"] = params[f"{b}{stream}.norm.{leaf}"]
    for i in range(cfg.depth_single_blocks):
        b = f"single_blocks.{i}."
        for name in _SINGLE_LINS:
            put(b + name, b + name)
        for leaf, key in _NORMS.items():
            state[f"{b}norm.{key}"] = params[f"{b}norm.{leaf}"]
    return state


# ----------------------------- the RoPE layout -----------------------------


def _half_perm(head_dim: int) -> np.ndarray:
    """[0, 2, ..., D-2, 1, 3, ..., D-1]: interleaved pairs -> half layout."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def _qkv_out_perm(cfg: FluxConfig) -> np.ndarray:
    """The permutation of the fused qkv output channels (k-major: kk*(H*D) +
    h*D + dd) that puts q (kk = 0) and k (kk = 1) heads in the half layout;
    v untouched. Shared by the weight and the LoRA permutations."""
    h, nh, d = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    perm_d = _half_perm(d)
    qkv_perm = np.arange(3 * h)
    for kk in range(2):
        for head in range(nh):
            base = kk * h + head * d
            qkv_perm[base: base + d] = base + perm_d
    return qkv_perm


def _extend(perm: np.ndarray, n: int, device) -> torch.Tensor:
    """perm over the first len(perm) of n channels, identity after them."""
    full = np.arange(n)
    full[: len(perm)] = perm
    return torch.from_numpy(full).to(device)


@torch.no_grad()
def permute_rope_layout(flux: nn.Module, cfg: FluxConfig) -> nn.Module:
    """Re-order the q/k output channels of every attention projection (the
    double blocks' qkv, the first 3h outputs of the single blocks' linear1)
    and the q/k norm scales into the "half" RoPE layout, in place; returns
    flux. Exact gathers on the weights' device. Valid because attention is
    invariant to one permutation of q's and k's channels. Dense and int8
    linears (Int8Linear: w_int8 (in, out) and w_scale (out,)) alike."""
    perm_d = torch.from_numpy(_half_perm(cfg.head_dim))
    qkv_perm = _qkv_out_perm(cfg)

    def permute_lin(lin: nn.Module) -> None:
        if isinstance(lin, nn.Linear):
            idx = _extend(qkv_perm, lin.weight.shape[0], lin.weight.device)
            lin.weight.copy_(lin.weight[idx])
        else:
            idx = _extend(qkv_perm, lin.w_int8.shape[1], lin.w_int8.device)
            lin.w_int8.copy_(lin.w_int8[:, idx])
            lin.w_scale.copy_(lin.w_scale[idx])
        if lin.bias is not None:
            lin.bias.copy_(lin.bias[idx.to(lin.bias.device)])

    def permute_norm(norm: nn.Module) -> None:
        for p in (norm.q_scale, norm.k_scale):
            p.copy_(p[perm_d.to(p.device)])

    for block in flux.double_blocks:
        for attn in (block.img_attn, block.txt_attn):
            permute_lin(attn.qkv)
            permute_norm(attn.norm)
    for block in flux.single_blocks:
        permute_lin(block.linear1)
        permute_norm(block.norm)
    return flux


def permute_rope_layout_lora(lora: Lora, cfg: FluxConfig) -> Lora:
    """The LoRA counterpart of permute_rope_layout: a new tree whose qkv and
    linear1 entries write their deltas in the half layout. Only the output
    side moves (b, b_bias and MoE-LoRA's shared_b and expert_b); a reads the
    unpermuted input."""
    qkv_perm = _qkv_out_perm(cfg)

    def permute_entry(e: Lora) -> Lora:
        new = dict(e)
        for key in ("b", "shared_b", "expert_b", "b_bias"):
            if key in e:
                v = e[key]
                new[key] = v[..., _extend(qkv_perm, v.shape[-1], v.device)]
        return new

    out = dict(lora)
    if "double_blocks" in lora:
        blocks = []
        for block in lora["double_blocks"]:
            block = dict(block)
            for stream in ("img_attn", "txt_attn"):
                if stream in block and "qkv" in block[stream]:
                    block[stream] = {**block[stream], "qkv": permute_entry(block[stream]["qkv"])}
            blocks.append(block)
        out["double_blocks"] = blocks
    if "single_blocks" in lora:
        out["single_blocks"] = [
            {**block, "linear1": permute_entry(block["linear1"])} if "linear1" in block else block
            for block in lora["single_blocks"]
        ]
    return out


# ----------------------------- reference-trainer LoRA -----------------------------


def _get(tree, path: tuple):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _split(name: str) -> tuple:
    return tuple(name.split("."))


def lora_to_torch_state(lora: Lora) -> dict[str, torch.Tensor]:
    """LoRA tree -> the reference's checkpoint naming, contiguous CPU tensors."""
    state: dict[str, torch.Tensor] = {}

    def put(key: str, e: Lora) -> None:
        state[f"{key}.lora_A.weight"] = e["a"].detach().T.contiguous().cpu()
        state[f"{key}.lora_B.weight"] = e["b"].detach().T.contiguous().cpu()
        if "b_bias" in e:
            state[f"{key}.lora_B.bias"] = e["b_bias"].detach().contiguous().cpu()

    for name, key in _TOP_LINS.items():
        e = _get(lora, _split(name))
        if e is not None:
            put(key, e)
    for prefix, lins in _BLOCKS:
        for i, block in enumerate(lora.get(prefix) or []):
            for name in lins:
                e = _get(block, _split(name))
                if e is not None:
                    put(f"{prefix}.{i}.{name}", e)
    return state


def _lora_entry(state: State, key: str, dtype) -> Lora | None:
    akey = f"{key}.lora_A.weight"
    if akey not in state:
        return None
    entry = {"a": state[akey].T, "b": state[f"{key}.lora_B.weight"].T}
    if f"{key}.lora_B.bias" in state:
        entry["b_bias"] = state[f"{key}.lora_B.bias"]
    return {k: v.to(dtype).contiguous() for k, v in entry.items()}


def convert_lora(state: State, cfg: FluxConfig, dtype=torch.float32) -> Lora:
    """Reference-trainer LoRA checkpoint (lora_A / lora_B keys) -> LoRA tree."""
    lora: Lora = {}
    for name, key in _TOP_LINS.items():
        if name.startswith("guidance_in") and not cfg.guidance_embed:
            continue
        e = _lora_entry(state, key, dtype)
        if e is not None:
            _set(lora, _split(name), e)
    for (prefix, lins), n in zip(_BLOCKS, (cfg.depth, cfg.depth_single_blocks)):
        blocks = []
        for i in range(n):
            block: Lora = {}
            for name in lins:
                e = _lora_entry(state, f"{prefix}.{i}.{name}", dtype)
                if e is not None:
                    _set(block, _split(name), e)
            blocks.append(block)
        if any(blocks):
            lora[prefix] = blocks
    return lora


# ----------------------------- diffusers FLUX -----------------------------
#
# diffusers' FluxTransformer2DModel renames every module, splits the fused BFL
# projections (qkv -> attn.to_q/to_k/to_v, add_q/k/v_proj for the text
# stream; linear1 -> attn.to_q/to_k/to_v + proj_mlp) and orders the final
# modulation [scale, shift] where BFL's LastLayer is [shift, scale]. The
# diffusers names are normalized onto BFL's (re-fusing the splits) and
# convert_flux does the rest.

_D_TOP = {
    "img_in": "x_embedder",
    "txt_in": "context_embedder",
    "time_in.in_layer": "time_text_embed.timestep_embedder.linear_1",
    "time_in.out_layer": "time_text_embed.timestep_embedder.linear_2",
    "vector_in.in_layer": "time_text_embed.text_embedder.linear_1",
    "vector_in.out_layer": "time_text_embed.text_embedder.linear_2",
    "guidance_in.in_layer": "time_text_embed.guidance_embedder.linear_1",
    "guidance_in.out_layer": "time_text_embed.guidance_embedder.linear_2",
    "final_layer.linear": "proj_out",
}
_D_DOUBLE = {
    "img_mod.lin": "norm1.linear",
    "txt_mod.lin": "norm1_context.linear",
    "img_attn.proj": "attn.to_out.0",
    "txt_attn.proj": "attn.to_add_out",
    "img_mlp.0": "ff.net.0.proj",
    "img_mlp.2": "ff.net.2",
    "txt_mlp.0": "ff_context.net.0.proj",
    "txt_mlp.2": "ff_context.net.2",
}
_D_DOUBLE_NORMS = {
    "img_attn.norm.query_norm.scale": "attn.norm_q.weight",
    "img_attn.norm.key_norm.scale": "attn.norm_k.weight",
    "txt_attn.norm.query_norm.scale": "attn.norm_added_q.weight",
    "txt_attn.norm.key_norm.scale": "attn.norm_added_k.weight",
}
_D_SINGLE = {"modulation.lin": "norm.linear", "linear2": "proj_out"}
_D_SINGLE_NORMS = {"norm.query_norm.scale": "attn.norm_q.weight", "norm.key_norm.scale": "attn.norm_k.weight"}
_D_QKV_DOUBLE_IMG = ("attn.to_q", "attn.to_k", "attn.to_v")
_D_QKV_DOUBLE_TXT = ("attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj")
_D_LINEAR1 = ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp")


def is_diffusers_flux_state(state: State) -> bool:
    return any(
        k.startswith(("transformer_blocks.", "single_transformer_blocks.")) or k == "x_embedder.weight"
        for k in state
    )


def _swap_scale_shift(x: torch.Tensor) -> torch.Tensor:
    """[scale, shift] <-> [shift, scale] along the first axis (its own inverse)."""
    half = x.shape[0] // 2
    return torch.cat([x[half:], x[:half]], dim=0)


def _count_blocks(state: State, prefix: str) -> int:
    idx = {int(k.split(".")[1]) for k in state if k.startswith(prefix + ".")}
    return max(idx) + 1 if idx else 0


def normalize_diffusers_flux_keys(state: State) -> dict[str, torch.Tensor]:
    """diffusers FluxTransformer2DModel state dict -> BFL naming."""
    out: dict[str, torch.Tensor] = {}

    def move(bfl: str, dif: str) -> None:
        for suffix in (".weight", ".bias"):
            if dif + suffix in state:
                out[bfl + suffix] = state[dif + suffix]

    def fuse(bfl: str, parts: tuple[str, ...], prefix: str) -> None:
        out[bfl + ".weight"] = torch.cat([state[f"{prefix}{p}.weight"] for p in parts], dim=0)
        bias_keys = [f"{prefix}{p}.bias" for p in parts]
        if all(b in state for b in bias_keys):
            out[bfl + ".bias"] = torch.cat([state[b] for b in bias_keys], dim=0)

    for bfl, dif in _D_TOP.items():
        move(bfl, dif)
    for suffix in (".weight", ".bias"):
        if "norm_out.linear" + suffix in state:
            out["final_layer.adaLN_modulation.1" + suffix] = _swap_scale_shift(state["norm_out.linear" + suffix])
    for i in range(_count_blocks(state, "transformer_blocks")):
        d, b = f"transformer_blocks.{i}.", f"double_blocks.{i}."
        for bfl, dif in _D_DOUBLE.items():
            move(b + bfl, d + dif)
        for bfl, dif in _D_DOUBLE_NORMS.items():
            out[b + bfl] = state[d + dif]
        fuse(b + "img_attn.qkv", _D_QKV_DOUBLE_IMG, d)
        fuse(b + "txt_attn.qkv", _D_QKV_DOUBLE_TXT, d)
    for i in range(_count_blocks(state, "single_transformer_blocks")):
        d, b = f"single_transformer_blocks.{i}.", f"single_blocks.{i}."
        for bfl, dif in _D_SINGLE.items():
            move(b + bfl, d + dif)
        for bfl, dif in _D_SINGLE_NORMS.items():
            out[b + bfl] = state[d + dif]
        fuse(b + "linear1", _D_LINEAR1, d)
    return out


def convert_flux_diffusers(state: State, cfg: FluxConfig) -> dict[str, torch.Tensor]:
    """diffusers FluxTransformer2DModel state dict -> the port's Flux names."""
    return convert_flux(normalize_diffusers_flux_keys(state), cfg)


def flux_to_diffusers_state(flux: nn.Module, cfg: FluxConfig) -> dict[str, torch.Tensor]:
    """A dense Flux -> diffusers FluxTransformer2DModel naming: the fused
    qkv / linear1 split (views of the module's tensors) and the final
    modulation swapped."""
    bfl = flux_to_torch_state(flux, cfg)
    h = cfg.hidden_size
    out: dict[str, torch.Tensor] = {}

    def split(bfl_key: str, parts: tuple[str, ...], prefix: str, sizes: list[int]) -> None:
        offs = np.cumsum([0] + sizes)
        for p, lo, hi in zip(parts, offs[:-1], offs[1:]):
            out[f"{prefix}{p}.weight"] = bfl[bfl_key + ".weight"][lo:hi]
            if bfl_key + ".bias" in bfl:
                out[f"{prefix}{p}.bias"] = bfl[bfl_key + ".bias"][lo:hi]

    def move(bfl_key: str, dif: str) -> None:
        for suffix in (".weight", ".bias"):
            if bfl_key + suffix in bfl:
                out[dif + suffix] = bfl[bfl_key + suffix]

    for bfl_key, dif in _D_TOP.items():
        move(bfl_key, dif)
    for suffix in (".weight", ".bias"):
        if "final_layer.adaLN_modulation.1" + suffix in bfl:
            out["norm_out.linear" + suffix] = _swap_scale_shift(bfl["final_layer.adaLN_modulation.1" + suffix])
    for i in range(cfg.depth):
        b, d = f"double_blocks.{i}.", f"transformer_blocks.{i}."
        for bfl_key, dif in _D_DOUBLE.items():
            move(b + bfl_key, d + dif)
        for bfl_key, dif in _D_DOUBLE_NORMS.items():
            out[d + dif] = bfl[b + bfl_key]
        split(b + "img_attn.qkv", _D_QKV_DOUBLE_IMG, d, [h, h, h])
        split(b + "txt_attn.qkv", _D_QKV_DOUBLE_TXT, d, [h, h, h])
    for i in range(cfg.depth_single_blocks):
        b, d = f"single_blocks.{i}.", f"single_transformer_blocks.{i}."
        for bfl_key, dif in _D_SINGLE.items():
            move(b + bfl_key, d + dif)
        for bfl_key, dif in _D_SINGLE_NORMS.items():
            out[d + dif] = bfl[b + bfl_key]
        split(b + "linear1", _D_LINEAR1, d, [h, h, h, cfg.mlp_hidden_dim])
    return out


# ----------------------------- diffusers LoRA -----------------------------


def is_diffusers_lora_state(state: State) -> bool:
    return any(
        ".lora_A." in k
        and (k.startswith(("transformer.", "transformer_blocks.", "single_transformer_blocks.")) or ".attn.to_" in k)
        for k in state
    )


def _d_lora_entry(state: State, key: str, dtype) -> Lora | None:
    """One diffusers/peft LoRA pair -> {"a": (in, r), "b": (r, out)}; an
    optional `{key}.alpha` (kohya) is folded into b as alpha / r."""
    akey = f"{key}.lora_A.weight"
    if akey not in state:
        return None
    a = state[akey].T.to(torch.float32)
    b = state[f"{key}.lora_B.weight"].T.to(torch.float32)
    if f"{key}.alpha" in state:
        b = b * (float(state[f"{key}.alpha"]) / b.shape[0])
    entry = {"a": a, "b": b}
    if f"{key}.lora_B.bias" in state:
        entry["b_bias"] = state[f"{key}.lora_B.bias"].to(torch.float32)
    return {k: v.to(dtype).contiguous() for k, v in entry.items()}


def _fuse_lora_entries(subs: list[Lora | None], out_sizes: list[int], dtype) -> Lora | None:
    """LoRA pairs on split projections -> one exact pair on the fused one: the
    A factors concatenated along the rank, each B in its projection's output
    slice (absent sub-projections contribute nothing)."""
    offs = np.cumsum([0] + out_sizes)
    present = [(s, lo, hi) for s, lo, hi in zip(subs, offs[:-1], offs[1:]) if s is not None]
    if not present:
        return None
    total_r = sum(s["a"].shape[-1] for s, _, _ in present)
    a = torch.cat([s["a"] for s, _, _ in present], dim=-1)
    b = torch.zeros((total_r, int(offs[-1])), dtype=torch.float32)
    bb = torch.zeros((int(offs[-1]),), dtype=torch.float32)
    has_bias = False
    r0 = 0
    for s, lo, hi in present:
        r = s["a"].shape[-1]
        b[r0: r0 + r, lo:hi] = s["b"]
        if "b_bias" in s:
            bb[lo:hi] = s["b_bias"]
            has_bias = True
        r0 += r
    entry = {"a": a, "b": b}
    if has_bias:
        entry["b_bias"] = bb
    return {k: v.to(dtype) for k, v in entry.items()}


def convert_lora_diffusers(state: State, cfg: FluxConfig, dtype=torch.float32) -> Lora:
    """diffusers/peft FLUX LoRA (with or without the `transformer.` prefix) ->
    LoRA tree; split q/k/v (and proj_mlp) adapters are fused exactly onto the
    BFL projections (their ranks add up)."""
    state = {k.removeprefix("transformer."): v for k, v in state.items()}
    h = cfg.hidden_size
    lora: Lora = {}

    def top(name: str, dif_key: str, swap_final: bool = False) -> None:
        e = _d_lora_entry(state, dif_key, dtype)
        if e is None:
            return
        if swap_final:
            half = e["b"].shape[1] // 2
            e = {**e, "b": torch.cat([e["b"][:, half:], e["b"][:, :half]], dim=1)}
            if "b_bias" in e:
                e["b_bias"] = _swap_scale_shift(e["b_bias"])
        _set(lora, _split(name), e)

    for name, dif_key in _D_TOP.items():
        if name.startswith("guidance_in") and not cfg.guidance_embed:
            continue
        top(name, dif_key)
    top("final_layer.adaLN", "norm_out.linear", swap_final=True)

    def block_entries(i: int, double: bool) -> Lora:
        p: Lora = {}
        d = f"transformer_blocks.{i}." if double else f"single_transformer_blocks.{i}."
        for name, dif in (_D_DOUBLE if double else _D_SINGLE).items():
            e = _d_lora_entry(state, d + dif, dtype)
            if e is not None:
                _set(p, _split(name), e)
        fused = ((("img_attn", "qkv"), _D_QKV_DOUBLE_IMG, [h, h, h]), (("txt_attn", "qkv"), _D_QKV_DOUBLE_TXT, [h, h, h])) \
            if double else ((("linear1",), _D_LINEAR1, [h, h, h, cfg.mlp_hidden_dim]),)
        for path, parts, sizes in fused:
            e = _fuse_lora_entries([_d_lora_entry(state, d + part, dtype) for part in parts], sizes, dtype)
            if e is not None:
                _set(p, path, e)
        return p

    for name, n, double in (("double_blocks", cfg.depth, True), ("single_blocks", cfg.depth_single_blocks, False)):
        per = [block_entries(i, double) for i in range(n)]
        if any(per):
            lora[name] = per
    return lora


def lora_to_diffusers_state(lora: Lora, cfg: FluxConfig) -> dict[str, torch.Tensor]:
    """LoRA tree -> diffusers/peft naming (`transformer.` prefix); a fused
    projection's adapter is split: each part shares A and takes its slice of B."""
    bfl = lora_to_torch_state(lora)
    h = cfg.hidden_size
    out: dict[str, torch.Tensor] = {}

    def move(bfl_key: str, dif: str, swap_final: bool = False) -> None:
        a = f"{bfl_key}.lora_A.weight"
        if a not in bfl:
            return
        bw, bias = bfl[f"{bfl_key}.lora_B.weight"], bfl.get(f"{bfl_key}.lora_B.bias")
        if swap_final:
            bw = _swap_scale_shift(bw)
            bias = None if bias is None else _swap_scale_shift(bias)
        out[f"transformer.{dif}.lora_A.weight"] = bfl[a]
        out[f"transformer.{dif}.lora_B.weight"] = bw
        if bias is not None:
            out[f"transformer.{dif}.lora_B.bias"] = bias

    def split(bfl_key: str, parts: tuple[str, ...], prefix: str, sizes: list[int]) -> None:
        a = f"{bfl_key}.lora_A.weight"
        if a not in bfl:
            return
        bw, bias = bfl[f"{bfl_key}.lora_B.weight"], bfl.get(f"{bfl_key}.lora_B.bias")
        offs = np.cumsum([0] + sizes)
        for p, lo, hi in zip(parts, offs[:-1], offs[1:]):
            out[f"transformer.{prefix}{p}.lora_A.weight"] = bfl[a]
            out[f"transformer.{prefix}{p}.lora_B.weight"] = bw[lo:hi]
            if bias is not None:
                out[f"transformer.{prefix}{p}.lora_B.bias"] = bias[lo:hi]

    for bfl_key, dif in _D_TOP.items():
        move(bfl_key, dif)
    move("final_layer.adaLN_modulation.1", "norm_out.linear", swap_final=True)
    for i in range(cfg.depth):
        b, d = f"double_blocks.{i}.", f"transformer_blocks.{i}."
        for bfl_key, dif in _D_DOUBLE.items():
            move(b + bfl_key, d + dif)
        split(b + "img_attn.qkv", _D_QKV_DOUBLE_IMG, d, [h, h, h])
        split(b + "txt_attn.qkv", _D_QKV_DOUBLE_TXT, d, [h, h, h])
    for i in range(cfg.depth_single_blocks):
        b, d = f"single_blocks.{i}.", f"single_transformer_blocks.{i}."
        for bfl_key, dif in _D_SINGLE.items():
            move(b + bfl_key, d + dif)
        split(b + "linear1", _D_LINEAR1, d, [h, h, h, cfg.mlp_hidden_dim])
    return out


# ----------------------------- T5 and CLIP -----------------------------


def t5_keys(cfg: T5Config) -> dict[str, str]:
    """HF T5EncoderModel name -> the port's T5Encoder name (the same (out, in)
    layout: the tensors carry over as they are)."""
    keys = {
        "shared.weight": "embed",
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": "relative_attention_bias",
        "encoder.final_layer_norm.weight": "final_ln",
    }
    for i in range(cfg.num_layers):
        p, q = f"encoder.block.{i}", f"blocks.{i}"
        keys[f"{p}.layer.0.layer_norm.weight"] = f"{q}.attn.ln"
        for n in ("q", "k", "v", "o"):
            keys[f"{p}.layer.0.SelfAttention.{n}.weight"] = f"{q}.attn.{n}.weight"
        keys[f"{p}.layer.1.layer_norm.weight"] = f"{q}.ffn.ln"
        for n in ("wi_0", "wi_1", "wo"):
            keys[f"{p}.layer.1.DenseReluDense.{n}.weight"] = f"{q}.ffn.{n}.weight"
    return keys


def clip_keys(cfg: CLIPTextConfig) -> dict[str, str]:
    """HF CLIPTextModel name -> the port's CLIPTextEncoder name (tensors as they are)."""
    keys = {
        "text_model.embeddings.token_embedding.weight": "token_embed",
        "text_model.embeddings.position_embedding.weight": "pos_embed",
    }

    def ln(hf: str, port: str) -> None:
        keys[f"{hf}.weight"], keys[f"{hf}.bias"] = f"{port}.scale", f"{port}.bias"

    def lin(hf: str, port: str) -> None:
        keys[f"{hf}.weight"], keys[f"{hf}.bias"] = f"{port}.weight", f"{port}.bias"

    for i in range(cfg.num_layers):
        p, q = f"text_model.encoder.layers.{i}", f"blocks.{i}"
        ln(f"{p}.layer_norm1", f"{q}.ln1")
        for hf, port in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o")):
            lin(f"{p}.self_attn.{hf}", f"{q}.attn.{port}")
        ln(f"{p}.layer_norm2", f"{q}.ln2")
        lin(f"{p}.mlp.fc1", f"{q}.fc1")
        lin(f"{p}.mlp.fc2", f"{q}.fc2")
    ln("text_model.final_layer_norm", "final_ln")
    return keys


def convert_t5(state: State, cfg: T5Config) -> dict[str, torch.Tensor]:
    """HF T5EncoderModel state dict -> the port's T5Encoder names."""
    return {port: state[hf] for hf, port in t5_keys(cfg).items()}


def convert_clip(state: State, cfg: CLIPTextConfig) -> dict[str, torch.Tensor]:
    """HF CLIPTextModel state dict -> the port's CLIPTextEncoder names."""
    return {port: state[hf] for hf, port in clip_keys(cfg).items()}


# ----------------------------- VAE -----------------------------


def _conv(state: State, key: str, out: dict) -> None:
    w = state[f"{key}.weight"]
    if w.ndim == 2:  # diffusers' attention projections are Linear
        w = w[:, :, None, None]
    out[f"{key}.w"] = w.permute(2, 3, 1, 0)  # OIHW -> HWIO
    out[f"{key}.b"] = state[f"{key}.bias"]


def _gn(state: State, key: str, out: dict) -> None:
    out[f"{key}.scale"], out[f"{key}.bias"] = state[f"{key}.weight"], state[f"{key}.bias"]


def _resnet(state: State, key: str, out: dict) -> None:
    _gn(state, f"{key}.norm1", out)
    _conv(state, f"{key}.conv1", out)
    _gn(state, f"{key}.norm2", out)
    _conv(state, f"{key}.conv2", out)
    if f"{key}.nin_shortcut.weight" in state:
        _conv(state, f"{key}.nin_shortcut", out)


def _attn(state: State, key: str, out: dict) -> None:
    _gn(state, f"{key}.norm", out)
    for n in ("q", "k", "v", "proj_out"):
        _conv(state, f"{key}.{n}", out)


def normalize_diffusers_vae_keys(state: State) -> dict[str, torch.Tensor]:
    """diffusers AutoencoderKL naming -> BFL naming (the decoder's up blocks
    reversed: diffusers stores them in execution order, BFL by level)."""
    out: dict[str, torch.Tensor] = {}
    for k, v in state.items():
        nk = k
        nk = nk.replace("down_blocks.", "down.")
        nk = nk.replace("up_blocks.", "up_rev.")
        nk = nk.replace(".resnets.", ".block.")
        nk = nk.replace("downsamplers.0.conv", "downsample.conv")
        nk = nk.replace("upsamplers.0.conv", "upsample.conv")
        nk = nk.replace("mid_block.block.0", "mid.block_1")
        nk = nk.replace("mid_block.block.1", "mid.block_2")
        nk = nk.replace("mid_block.attentions.0.group_norm", "mid.attn_1.norm")
        nk = nk.replace("mid_block.attentions.0.to_q", "mid.attn_1.q")
        nk = nk.replace("mid_block.attentions.0.to_k", "mid.attn_1.k")
        nk = nk.replace("mid_block.attentions.0.to_v", "mid.attn_1.v")
        nk = nk.replace("mid_block.attentions.0.to_out.0", "mid.attn_1.proj_out")
        nk = nk.replace("conv_norm_out", "norm_out")
        nk = nk.replace("conv_shortcut", "nin_shortcut")
        out[nk] = v
    n_up = len({k.split(".")[2] for k in out if k.startswith("decoder.up_rev.")})
    final = {}
    for k, v in out.items():
        if k.startswith("decoder.up_rev."):
            parts = k.split(".")
            parts[2] = str(n_up - 1 - int(parts[2]))
            k = ".".join(["decoder", "up"] + parts[2:])
        final[k] = v
    return final


def convert_vae(state: State, cfg: AutoEncoderConfig) -> dict[str, torch.Tensor]:
    """BFL ae.safetensors (or diffusers AutoencoderKL) naming -> the port's
    AutoEncoder names, conv weights as (kh, kw, in, out) views."""
    if any("down_blocks" in k or "mid_block" in k for k in state):
        state = normalize_diffusers_vae_keys(state)
    out: dict[str, torch.Tensor] = {}
    for side in ("encoder", "decoder"):
        _conv(state, f"{side}.conv_in", out)
        _resnet(state, f"{side}.mid.block_1", out)
        _attn(state, f"{side}.mid.attn_1", out)
        _resnet(state, f"{side}.mid.block_2", out)
        _gn(state, f"{side}.norm_out", out)
        _conv(state, f"{side}.conv_out", out)
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks):
            _resnet(state, f"encoder.down.{i}.block.{j}", out)
        if f"encoder.down.{i}.downsample.conv.weight" in state:
            _conv(state, f"encoder.down.{i}.downsample.conv", out)
        for j in range(cfg.num_res_blocks + 1):
            _resnet(state, f"decoder.up.{i}.block.{j}", out)
        if f"decoder.up.{i}.upsample.conv.weight" in state:
            _conv(state, f"decoder.up.{i}.upsample.conv", out)
    return out


def vae_to_torch_state(ae: nn.Module) -> dict[str, torch.Tensor]:
    """The port's AutoEncoder -> BFL naming (the inverse of convert_vae):
    convs (out, in, kh, kw) contiguous, GroupNorm weight and bias."""
    state: dict[str, torch.Tensor] = {}
    convs = {name for name, m in ae.named_modules() if hasattr(m, "w") and isinstance(m.w, torch.Tensor)}
    for name, p in module_state(ae).items():
        mod, leaf = name.rsplit(".", 1)
        if mod in convs:
            if leaf == "w":
                state[f"{mod}.weight"] = p.permute(3, 2, 0, 1).contiguous()
            else:
                state[f"{mod}.bias"] = p
        else:
            state[f"{mod}.weight" if leaf == "scale" else f"{mod}.bias"] = p
    return state
