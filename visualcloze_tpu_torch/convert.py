"""Weight carrier: JAX parameter pytrees (as numpy arrays) -> the port's modules.

The port's module and parameter names mirror the JAX trees, so the walk is by
name. The JAX layouts differ from PyTorch's in two places:
  - linears are stored (in, out) in JAX and (out, in) in nn.Linear: transposed;
  - block trees are stacked along a leading depth axis (scanned in JAX):
    unstacked into the nn.ModuleList of blocks.
VAE conv weights stay (kh, kw, in, out) and NHWC, as in JAX.

flux_from_jax takes the already-permuted `params` of a JAX VisualClozeModel
built with rope_layout="half" (its constructor permutes them), LoRA folded.
Every parameter of the target module must be assigned exactly once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .config import AutoEncoderConfig, CLIPTextConfig, FluxConfig, T5Config
from .device import resolve_device
from .models.autoencoder import AutoEncoder, build_autoencoder
from .models.clip import CLIPTextEncoder, build_clip
from .models.flux import Flux, build_flux
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
        missing = [n for n, p in self.module.named_parameters() if id(p) not in self.done]
        if missing:
            raise ValueError(f"parameters not in the JAX tree: {missing[:8]}")


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


def flux_from_jax(params: Mapping, cfg: FluxConfig, device=None, dtype=torch.float32) -> Flux:
    cfg = config_from(cfg, FluxConfig)
    model = build_flux(cfg, resolve_device(device), dtype)
    return _carry(model, params, {"double_blocks": cfg.depth, "single_blocks": cfg.depth_single_blocks})


def vae_from_jax(params: Mapping, cfg: AutoEncoderConfig, device=None, dtype=torch.float32) -> AutoEncoder:
    cfg = config_from(cfg, AutoEncoderConfig)
    return _carry(build_autoencoder(cfg, resolve_device(device), dtype), params, {})


def t5_from_jax(params: Mapping, cfg: T5Config, device=None, dtype=torch.float32) -> T5Encoder:
    cfg = config_from(cfg, T5Config)
    return _carry(build_t5(cfg, resolve_device(device), dtype), params, {"blocks": cfg.num_layers})


def clip_from_jax(params: Mapping, cfg: CLIPTextConfig, device=None, dtype=torch.float32) -> CLIPTextEncoder:
    cfg = config_from(cfg, CLIPTextConfig)
    return _carry(build_clip(cfg, resolve_device(device), dtype), params, {"blocks": cfg.num_layers})
