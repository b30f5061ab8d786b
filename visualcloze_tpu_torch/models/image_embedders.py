"""Auxiliary image-conditioning encoders of the BFL tools route (counterpart
of visualcloze_tpu/models/image_embedders.py): the Canny, Depth and Redux
encoders that prepare_control and prepare_redux (models/sampling.py) take.
The VisualCloze grid pipeline uses none of them.

- CannyImageEncoder: cv2 Canny edges, local.
- DepthImageEncoder: the DepthAnything tower (models/vision_towers.py) from
  a local HF checkpoint (DEPTH_ANYTHING_PATH), a module handed in, or a
  depth callable.
- ReduxImageEncoder: the SigLIP tower (SIGLIP_PATH) and the two-layer Redux
  projector (FLUX_REDUX, a BFL flux1-redux-dev file), or modules, a SigLIP
  callable or precomputed features handed in.
Checkpoints are read by the port's own safetensors and .pth readers.
Encoders return torch tensors: image conditionings (1, H, W, 3) fp32 in
[-1, 1] (on the tower's device, the CPU for Canny), Redux tokens
(1, L, txt_dim) on the projector's device.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .init import materialize, normal_


def _load_state(path: str) -> dict[str, torch.Tensor]:
    """A local .safetensors file, an HF snapshot directory of shards, or a
    torch .pth -> a state dict of CPU tensors."""
    from ..pipeline.loader import load_sharded_safetensors, load_torch_checkpoint

    return load_sharded_safetensors(path) if os.path.isdir(path) else load_torch_checkpoint(path)


class CannyImageEncoder:
    """cv2 Canny edges as a 3-channel conditioning image in [-1, 1]."""

    def __init__(self, min_t: int = 50, max_t: int = 200):
        self.min_t = min_t
        self.max_t = max_t

    def __call__(self, img) -> torch.Tensor:
        """PIL image -> (1, H, W, 3) fp32 in [-1, 1] on the CPU."""
        import cv2

        arr = np.asarray(img.convert("RGB"))
        edges = cv2.Canny(cv2.cvtColor(arr, cv2.COLOR_RGB2GRAY), self.min_t, self.max_t)
        out = np.stack([edges] * 3, axis=-1).astype(np.float32) / 127.5 - 1.0
        return torch.from_numpy(out)[None]


class DepthImageEncoder:
    """Depth-map conditioning through the DepthAnything tower. Weight
    sources, first found first: `model` (a vision_towers.DepthAnything),
    `depth_fn` (PIL -> (H, W) array), or DEPTH_ANYTHING_PATH, a local HF
    checkpoint loaded onto `device` (None: the card)."""

    def __init__(self, depth_fn: Callable | None = None, model: nn.Module | None = None, cfg=None, device=None):
        from .vision_towers import DepthAnythingTowerConfig

        self.cfg = cfg or getattr(model, "cfg", None) or DepthAnythingTowerConfig()
        self.depth_fn = depth_fn
        self.model = model
        if self.model is None and self.depth_fn is None:
            path = os.environ.get("DEPTH_ANYTHING_PATH")
            if path and os.path.exists(path):
                from .vision_towers import convert_depth_anything

                self.model = convert_depth_anything(_load_state(path), self.cfg, device)

    @torch.no_grad()
    def _depth(self, img) -> torch.Tensor:
        from .vision_towers import depth_anything_apply, depth_anything_preprocess

        if self.model is not None:
            pixels = depth_anything_preprocess(img, target=self.cfg.image_size, multiple=self.cfg.patch_size)
            return depth_anything_apply(self.model, pixels)[0]
        if self.depth_fn is not None:
            return torch.from_numpy(np.asarray(self.depth_fn(img), dtype=np.float32))
        raise RuntimeError(
            "DepthImageEncoder needs weights: set DEPTH_ANYTHING_PATH to a local depth-anything "
            "checkpoint, pass model=, or pass depth_fn="
        )

    def __call__(self, img) -> torch.Tensor:
        """PIL image -> (1, H, W, 3) depth conditioning in [-1, 1] at the
        input's resolution: the network's depth resized back bicubically
        (jax.image's), clipped at 0 (bicubic undershoots the ReLU floor),
        divided by its maximum."""
        from .vision_towers import resize_bicubic

        depth = self._depth(img).to(torch.float32)
        w, h = img.size
        if tuple(depth.shape) != (h, w):
            depth = resize_bicubic(depth[..., None], (h, w))[..., 0]
        depth = torch.clamp_min(depth, 0.0)
        depth = depth / max(float(depth.max()), 1e-6)
        return (torch.stack([depth] * 3, dim=-1) * 2.0 - 1.0)[None]


class ReduxProjector(nn.Module):
    """SigLIP features -> T5-space tokens: redux_down(silu(redux_up(x)))."""

    def __init__(self, redux_dim: int = 1152, txt_dim: int = 4096):
        super().__init__()
        self.redux_up = nn.Linear(redux_dim, txt_dim * 3)
        self.redux_down = nn.Linear(txt_dim * 3, txt_dim)


@torch.no_grad()
def init_redux_projector(generator: torch.Generator, redux_dim: int = 1152, txt_dim: int = 4096, device=None,
                         dtype=torch.float32) -> ReduxProjector:
    """Random projector as JAX's init_redux_projector draws it (other
    numbers): N(0, 1/fan_in) weights, zero biases; on `device` (None: the card)."""
    m = materialize(lambda: ReduxProjector(redux_dim, txt_dim), resolve_device(device), dtype)
    normal_(m.redux_up.weight, redux_dim ** -0.5, generator)
    normal_(m.redux_down.weight, (txt_dim * 3) ** -0.5, generator)
    m.redux_up.bias.zero_()
    m.redux_down.bias.zero_()
    return m


def redux_project(model: ReduxProjector, siglip_features: torch.Tensor) -> torch.Tensor:
    """The projector in the features' dtype (weights cast to it, as JAX)."""
    x = siglip_features
    up, down = model.redux_up, model.redux_down
    h = F.silu(F.linear(x, up.weight.to(x.dtype), up.bias.to(x.dtype)))
    return F.linear(h, down.weight.to(h.dtype), down.bias.to(h.dtype))


def convert_redux(state: Mapping, device=None, dtype=torch.float32) -> ReduxProjector:
    """A BFL flux1-redux-dev state dict -> the projector, on `device` (None: the card)."""
    from ..convert import redux_from_jax

    def w(key):
        v = state[key]
        return v.detach().to("cpu", torch.float32).numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    tree = {"redux_up": {"w": w("redux_up.weight").T, "b": w("redux_up.bias")},
            "redux_down": {"w": w("redux_down.weight").T, "b": w("redux_down.bias")}}
    return redux_from_jax(tree, device, dtype)


class ReduxImageEncoder:
    """Style conditioning: SigLIP vision features projected into T5 token
    space. The projector: `projector`, else FLUX_REDUX; the features:
    `siglip_model` (vision_towers.SigLIPVision), `siglip_fn` (PIL ->
    (1, L, redux_dim)), SIGLIP_PATH, or feature arrays handed to the call.
    What is loaded from a path lands on `device` (None: the card)."""

    def __init__(self, projector: ReduxProjector | None = None, siglip_fn: Callable | None = None,
                 siglip_model: nn.Module | None = None, siglip_cfg=None, device=None):
        from .vision_towers import SigLIPVisionConfig

        self.projector = projector
        if self.projector is None:
            path = os.environ.get("FLUX_REDUX")
            if not path or not os.path.exists(path):
                raise RuntimeError("ReduxImageEncoder needs a projector: pass projector= or set FLUX_REDUX "
                                   "to a local flux1-redux-dev file")
            self.projector = convert_redux(_load_state(path), device)
        self.siglip_fn = siglip_fn
        self.siglip_model = siglip_model
        self.siglip_cfg = siglip_cfg or getattr(siglip_model, "cfg", None) or SigLIPVisionConfig()
        if self.siglip_model is None and self.siglip_fn is None:
            path = os.environ.get("SIGLIP_PATH")
            if path and os.path.exists(path):
                from .vision_towers import convert_siglip_vision

                self.siglip_model = convert_siglip_vision(_load_state(path), self.siglip_cfg, device)

    def _features(self, img) -> torch.Tensor:
        from .vision_towers import siglip_encode, siglip_preprocess

        if self.siglip_model is not None:
            return siglip_encode(self.siglip_model, siglip_preprocess(img, self.siglip_cfg.image_size))
        if self.siglip_fn is not None:
            return torch.as_tensor(np.asarray(self.siglip_fn(img)))
        raise RuntimeError(
            "ReduxImageEncoder needs SigLIP features: set SIGLIP_PATH to a local SigLIP checkpoint, "
            "pass siglip_model= or siglip_fn=, or call it on feature arrays"
        )

    @torch.no_grad()
    def __call__(self, img_or_features) -> torch.Tensor:
        if isinstance(img_or_features, (np.ndarray, torch.Tensor)):
            feats = torch.as_tensor(img_or_features)
        else:
            feats = self._features(img_or_features)
        return redux_project(self.projector, feats.to(self.projector.redux_up.weight.device))
