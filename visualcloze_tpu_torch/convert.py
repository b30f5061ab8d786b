"""Weight carrier: JAX parameter pytrees (as numpy arrays) -> the port's modules.

The port's module and parameter names mirror the JAX trees, so the walk is by
name. The JAX layouts differ from PyTorch's in two places:
  - linears are stored (in, out) in JAX and (out, in) in nn.Linear: transposed;
  - block trees are stacked along a leading depth axis (scanned in JAX):
    unstacked into the nn.ModuleList of blocks.
VAE conv weights stay (kh, kw, in, out) and NHWC, as in JAX.
Quantized entries ({"w_int8", "w_scale", "b"?}, {"w_int4", "w_scale"}, and
{"w_int8", "w_scale"} token tables) keep the JAX layout in the port's
quantized modules (models/quant.py, layers.Int8Linear): int8 and uint8 codes
are copied exactly, every other leaf through fp32. A w8a8 entry ({"w_int8",
"w_scale", "b"?, "a8", "a_sinv"?}: quantize_flux_w8a8[_smooth]) becomes a
layers.W8A8Linear, its codes transposed to (out, in), the layout of kernel
H, here and once; the "a8" marker carries no data.

The auxiliary models of the BFL tools route carry over too (siglip_from_jax,
depth_anything_from_jax, vit_classifier_from_jax, redux_from_jax): their
towers keep the JAX layouts (models/vision_towers.py).
flux_from_jax takes the `params` of a JAX VisualClozeModel as they stand:
permuted by its constructor for rope_layout="half", in the reference's order
for "interleaved"; the port's Flux is then run in the same layout.
Every parameter and buffer of the target module must be assigned exactly once.
LoRA trees carry over with lora_from_jax (stacked block entries -> one per
block) and back with lora_to_jax, for the tests; so do the SmoothQuant
calibration statistics, which are trees of per-block entries too.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .config import AutoEncoderConfig, CLIPTextConfig, FluxConfig, T5Config
from .device import resolve_device
from .models.autoencoder import AutoEncoder, build_autoencoder
from .models.clip import CLIPTextEncoder, build_clip
from .models.flux import Flux, build_flux
from .models.layers import W8A8Linear, linear_kind
from .models.quant import QUANTIZED_MODULES, build_clip_int8, build_t5_int4
from .models.t5 import T5Encoder, build_t5


def config_from(obj: Any, cls):
    """A port config from any dataclass with the same fields (e.g. the JAX
    package's config of the same name)."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


class _Loader:
    def __init__(self, module: nn.Module):
        self.module = module
        self.done: set[int] = set()

    def copy(self, param: torch.Tensor, arr, where: str) -> None:
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.integer):  # int8 / uint8 codes: exact, into a buffer of the same type
            src = torch.from_numpy(np.array(arr))
            if src.dtype != param.dtype:
                raise ValueError(f"{where}: JAX {arr.dtype} codes vs port {param.dtype}")
        else:
            src = torch.from_numpy(np.array(arr, dtype=np.float32))
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{where}: JAX shape {tuple(src.shape)} vs port shape {tuple(param.shape)}")
        if id(param) in self.done:
            raise ValueError(f"{where}: assigned twice")
        with torch.no_grad():
            param.copy_(src.to(param.dtype))
        self.done.add(id(param))

    def load(self, module: nn.Module, tree: Mapping, path: str = "") -> None:
        for key, val in tree.items():
            where = f"{path}.{key}" if path else key
            target = getattr(module, key)
            if isinstance(val, Mapping):
                if isinstance(target, nn.Linear) and set(val) <= {"w", "b"}:
                    self.copy(target.weight, np.asarray(val["w"]).T, where + ".w")
                    if "b" in val:
                        self.copy(target.bias, val["b"], where + ".b")
                elif isinstance(target, QUANTIZED_MODULES):  # leaves named as the entry's; "b" is the bias
                    for leaf, arr in val.items():
                        if isinstance(target, W8A8Linear):
                            if leaf == "a8":  # the marker: no data
                                continue
                            if leaf == "w_int8":  # (in, out) -> kernel H's K-major (out, in)
                                arr = np.asarray(arr).T
                        self.copy(getattr(target, "bias" if leaf == "b" else leaf), arr, f"{where}.{leaf}")
                else:
                    self.load(target, val, where)
            elif isinstance(val, (list, tuple)):
                if len(val) != len(target):
                    raise ValueError(f"{where}: {len(val)} JAX entries vs {len(target)} modules")
                for i, item in enumerate(val):
                    self.load(target[i], item, f"{where}.{i}")
            elif isinstance(target, nn.Linear):  # a raw (in, out) matrix (T5)
                self.copy(target.weight, np.asarray(val).T, where)
            else:
                self.copy(target, val, where)

    def finish(self) -> None:
        tensors = itertools.chain(self.module.named_parameters(), self.module.named_buffers())
        missing = [n for n, p in tensors if id(p) not in self.done]
        if missing:
            raise ValueError(f"parameters or buffers not in the JAX tree: {missing[:8]}")


def _unstack(tree: Mapping, depth: int) -> list:
    """A tree of (depth, ...) stacked leaves -> `depth` trees of single blocks."""

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, Mapping) else np.asarray(t)[i]

    return [take(tree, i) for i in range(depth)]


def _carry(module: nn.Module, tree: Mapping, stacked: dict[str, int]) -> nn.Module:
    tree = dict(tree)
    for key, depth in stacked.items():
        tree[key] = _unstack(tree[key], depth)
    loader = _Loader(module)
    loader.load(module, tree)
    loader.finish()
    return module


def _linear_kinds(tree: Mapping) -> set[str]:
    """linear_kind of every linear entry ({"w"...} or {"w_int8"...}) in the
    tree; "w8a8_smooth" for a w8a8 entry with an a_sinv leaf."""
    kinds = set()
    for val in tree.values():
        if isinstance(val, Mapping):
            if {"w", "w_int8", "w_int4"} & set(val):
                kinds.add("w8a8_smooth" if "a_sinv" in val else linear_kind(val))
            else:
                kinds |= _linear_kinds(val)
    return kinds


def flux_from_jax(params: Mapping, cfg: FluxConfig, device=None, dtype=torch.float32) -> Flux:
    """A dense tree, a quantize_flux_int8 / init_flux_int8 one (every linear
    int8: Int8Linear through kernel G; biases and norms in `dtype`), a
    quantize_flux_int4 one (every linear Int4DiTLinear through kernel G4),
    or a quantize_flux_w8a8[_smooth] one (the token-dim
    block linears W8A8Linear through kernels I and H, the rest Int8Linear)."""
    cfg = config_from(cfg, FluxConfig)
    kinds = _linear_kinds(params)
    if kinds not in ({"dense"}, {"int8"}, {"int4"}, {"int8", "w8a8"}, {"int8", "w8a8_smooth"}):
        raise ValueError(f"a Flux tree with these linears together is not supported: {sorted(kinds)}")
    model = build_flux(cfg, resolve_device(device), dtype, int8=kinds == {"int8"}, w8a8=len(kinds) == 2,
                       smooth="w8a8_smooth" in kinds, int4=kinds == {"int4"})
    return _carry(model, params, {"double_blocks": cfg.depth, "single_blocks": cfg.depth_single_blocks})


def vae_from_jax(params: Mapping, cfg: AutoEncoderConfig, device=None, dtype=torch.float32) -> AutoEncoder:
    cfg = config_from(cfg, AutoEncoderConfig)
    return _carry(build_autoencoder(cfg, resolve_device(device), dtype), params, {})


def t5_from_jax(params: Mapping, cfg: T5Config, device=None, dtype=torch.float32) -> T5Encoder:
    """A dense tree, or a quantize_t5_int4 / init_t5_int4 one (int4 block
    linears, the token table int8 or not)."""
    cfg = config_from(cfg, T5Config)
    device = resolve_device(device)
    if isinstance(params["blocks"]["attn"]["q"], Mapping):
        model = build_t5_int4(cfg, device, dtype, int8_embed=isinstance(params["embed"], Mapping))
    else:
        model = build_t5(cfg, device, dtype)
    return _carry(model, params, {"blocks": cfg.num_layers})


def clip_from_jax(params: Mapping, cfg: CLIPTextConfig, device=None, dtype=torch.float32) -> CLIPTextEncoder:
    """A dense tree, or a quantize_clip_int8 / init_clip_int8 one."""
    cfg = config_from(cfg, CLIPTextConfig)
    device = resolve_device(device)
    if "w_int8" in params["blocks"]["fc1"]:
        model = build_clip_int8(cfg, device, dtype, int8_embed=isinstance(params["token_embed"], Mapping))
    else:
        model = build_clip(cfg, device, dtype)
    return _carry(model, params, {"blocks": cfg.num_layers})


def siglip_from_jax(params: Mapping, cfg, device=None) -> nn.Module:
    """A JAX SigLIP vision tree (convert_siglip_vision's) -> the port's tower, fp32."""
    from .models.vision_towers import SigLIPVisionConfig, build_siglip

    cfg = config_from(cfg, SigLIPVisionConfig)
    return _carry(build_siglip(cfg, resolve_device(device)), params, {"blocks": cfg.num_layers})


def depth_anything_from_jax(params: Mapping, cfg, device=None) -> nn.Module:
    """A JAX DepthAnything tree (convert_depth_anything's) -> the port's tower, fp32."""
    from .models.vision_towers import DepthAnythingTowerConfig, build_depth_anything

    cfg = config_from(cfg, DepthAnythingTowerConfig)
    params = dict(params, backbone=dict(params["backbone"], blocks=_unstack(params["backbone"]["blocks"],
                                                                            cfg.num_layers)))
    return _carry(build_depth_anything(cfg, resolve_device(device)), params, {})


def vit_classifier_from_jax(params: Mapping, cfg, device=None) -> nn.Module:
    """A JAX ViT classifier tree (convert_vit_classifier's) -> the port's classifier, fp32."""
    from .models.vision_towers import ViTClassifierConfig, build_vit_classifier

    cfg = config_from(cfg, ViTClassifierConfig)
    return _carry(build_vit_classifier(cfg, resolve_device(device)), params, {"blocks": cfg.num_layers})


def redux_from_jax(params: Mapping, device=None, dtype=torch.float32) -> nn.Module:
    """A JAX Redux projector tree (init_redux_projector / convert_redux) -> the port's projector."""
    from .models.image_embedders import ReduxProjector
    from .models.init import materialize

    redux_dim, txt3 = np.asarray(params["redux_up"]["w"]).shape
    module = materialize(lambda: ReduxProjector(redux_dim, txt3 // 3), resolve_device(device), dtype)
    return _carry(module, params, {})


def _tensors(tree, device, dtype):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device=device, dtype=dtype)


def lora_from_jax(lora: Mapping, cfg: FluxConfig, device=None, dtype=torch.float32) -> dict:
    """A JAX LoRA tree (block entries stacked on a depth axis) -> the port's
    LoRA tree (a list of per-block entries), as tensors on `device`."""
    cfg = config_from(cfg, FluxConfig)
    tree = dict(lora)
    for key, depth in (("double_blocks", cfg.depth), ("single_blocks", cfg.depth_single_blocks)):
        if key in tree:
            tree[key] = _unstack(tree[key], depth)
    return _tensors(tree, resolve_device(device), dtype)


def lora_to_jax(lora: Mapping) -> dict:
    """The port's LoRA tree -> numpy arrays in the JAX layout (blocks stacked)."""

    def arr(t):
        if isinstance(t, Mapping):
            return {k: arr(v) for k, v in t.items()}
        return t.detach().to("cpu", torch.float32).numpy()

    def stack(blocks):
        first = blocks[0]
        if isinstance(first, Mapping):
            return {k: stack([b[k] for b in blocks]) for k in first}
        return np.stack(blocks)

    out = {}
    for key, val in lora.items():
        out[key] = stack([arr(b) for b in val]) if isinstance(val, list) else arr(val)
    return out
