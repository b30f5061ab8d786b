"""Vision towers of the auxiliary image embedders (counterpart of
visualcloze_tpu/models/vision_towers.py).

Three networks the reference pulls from transformers, as plain fp32 PyTorch
modules (their attention and convolutions are plain PyTorch, as JAX's are
plain XLA: no kernel of the port runs here):
  - the SigLIP vision tower (google/siglip-so400m-patch14-384), which feeds
    the Redux style projector (`siglip_encode`);
  - DepthAnything (DINOv2 ViT-L/14 backbone + DPT neck and head,
    LiheYoung/depth-anything-large-hf), the depth conditioning encoder
    (`depth_anything_apply`);
  - a ViT-base image classifier (the NSFW gate's Falconsai/
    nsfw_image_detection architecture, `vit_classify`).
Pixels are NHWC. Module and parameter names mirror the JAX pytrees, with
the JAX layouts (linears (in, out) become nn.Linear; conv weights stay
(kh, kw, in, out); a transposed conv's weight stays spatially flipped, as
JAX's forward-conv form of it holds it), so convert.py carries a JAX tree
across by name. The HF converters here read the same state dicts as JAX's,
build the same tree, and load it.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import mha_xla
from .clip import LayerNorm
from .init import materialize, normal_


# ----------------------------- shared pieces -----------------------------


class Conv(nn.Module):
    """A conv with weights (kh, kw, in, out) and an optional bias (out,), on NHWC."""

    def __init__(self, k: int, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.empty(k, k, cin, cout))
        self.b = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor, stride: int = 1, padding: int | None = None) -> torch.Tensor:
        pad = self.w.shape[0] // 2 if padding is None else padding  # "SAME" for odd kernels at stride 1
        y = F.conv2d(x.permute(0, 3, 1, 2), self.w.permute(3, 2, 0, 1), self.b, stride=stride, padding=pad)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """torch's ConvTranspose2d(k, stride k), its weight held as JAX holds it:
    spatially flipped, (kh, kw, in, out)."""

    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(k, k, cin, cout))
        self.b = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        w = self.w.permute(2, 3, 0, 1).flip(2, 3)  # (in, out, kh, kw), torch's own
        return F.conv_transpose2d(x.permute(0, 3, 1, 2), w, self.b, stride=stride).permute(0, 2, 3, 1)


def patch_embed(conv: Conv, x: torch.Tensor, patch: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, H, W, 3) -> ((B, h*w, C), (h, w)) by a non-overlapping patch conv."""
    out = conv(x, stride=patch, padding=0)
    b, h, w, c = out.shape
    return out.reshape(b, h * w, c), (h, w)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, D) -> (B, L, D): heads split around the fp32-softmax attention."""
    b, L, D = q.shape

    def split(x):
        return x.reshape(b, L, num_heads, D // num_heads).transpose(1, 2)

    return mha_xla(split(q), split(k), split(v)).transpose(1, 2).reshape(b, L, D)


class Block(nn.Module):
    """A pre-norm ViT block: attention and MLP, each optionally times a layer
    scale (DINOv2's ls1, ls2); gelu tanh (SigLIP) or exact."""

    def __init__(self, d: int, ff: int, heads: int, eps: float, tanh_gelu: bool = False,
                 layer_scale: bool = False):
        super().__init__()
        self.heads, self.gelu = heads, "tanh" if tanh_gelu else "none"
        self.ln1 = LayerNorm(d, eps)
        self.q, self.k, self.v, self.o = (nn.Linear(d, d) for _ in range(4))
        self.ln2 = LayerNorm(d, eps)
        self.fc1, self.fc2 = nn.Linear(d, ff), nn.Linear(ff, d)
        self.ls1 = nn.Parameter(torch.empty(d)) if layer_scale else None
        self.ls2 = nn.Parameter(torch.empty(d)) if layer_scale else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln1(x)
        a = self.o(_sdpa(self.q(h), self.k(h), self.v(h), self.heads))
        x = x + (a if self.ls1 is None else a * self.ls1)
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate=self.gelu))
        return x + (h if self.ls2 is None else h * self.ls2)


def interpolate_bilinear(x: torch.Tensor, size: tuple[int, int], align_corners: bool) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C), bilinear with either corner
    convention (torch's F.interpolate, which JAX's map_coordinates form
    reproduces)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(int(s) for s in size), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5), as jax.image's bicubic."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of jax.image.resize(method="bicubic",
    antialias=True) along one axis: the kernel widened by the scale when
    downsampling, each column normalized, zero outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C), jax.image.resize's bicubic
    (Keys a = -0.5, antialiased; an axis of unchanged size is left as it
    is), in fp32."""
    x = x.to(torch.float32)
    h, w = x.shape[-3], x.shape[-2]
    if size[0] != h:
        x = torch.einsum("...hwc,hH->...Hwc", x, _cubic_weights(h, size[0], x.device))
    if size[1] != w:
        x = torch.einsum("...hwc,wW->...hWc", x, _cubic_weights(w, size[1], x.device))
    return x


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator` for a tower built uninitialized:
    linears and convs N(0, 1/fan_in) with zero biases, unit norms and layer
    scales, position and class embeddings N(0, 0.02^2)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, m.in_features ** -0.5, generator)
            m.bias.zero_()
        elif isinstance(m, (Conv, ConvTranspose)):
            kh, kw, cin, _ = m.w.shape
            normal_(m.w, (kh * kw * cin) ** -0.5, generator)
            if m.b is not None:
                m.b.zero_()
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Block) and m.ls1 is not None:
            m.ls1.fill_(1.0)
            m.ls2.fill_(1.0)
    for name, p in module.named_parameters():
        if name.endswith(("pos_embed", "cls_token")):
            normal_(p, 0.02, generator)
    return module


def _arr(state: Mapping, key: str) -> np.ndarray:
    v = state[key]
    return v.detach().to("cpu", torch.float32).numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _hf_getters(state: Mapping):
    def w(key):
        return _arr(state, key)

    def lin(key):
        return {"w": w(f"{key}.weight").T, "b": w(f"{key}.bias")}

    def ln(key):
        return {"scale": w(f"{key}.weight"), "bias": w(f"{key}.bias")}

    def conv(key, bias=True):
        p = {"w": w(f"{key}.weight").transpose(2, 3, 1, 0)}
        if bias:
            p["b"] = w(f"{key}.bias")
        return p

    return w, lin, ln, conv


def _load(module: nn.Module, tree: Mapping) -> nn.Module:
    from ..convert import _carry

    return _carry(module, tree, {})


def _build(make, device, dtype) -> nn.Module:
    """make() with uninitialized weights of `dtype` on `device` (None: the card)."""
    return materialize(make, resolve_device(device), dtype)


# ----------------------------- SigLIP vision -----------------------------


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    """google/siglip-so400m-patch14-384 (the Redux feature tower)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    def tiny(self) -> "SigLIPVisionConfig":
        return dataclasses.replace(self, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
                                   image_size=28)


class SigLIPVision(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embed = Conv(cfg.patch_size, 3, d)
        self.pos_embed = nn.Parameter(torch.empty((cfg.image_size // cfg.patch_size) ** 2, d))
        self.blocks = nn.ModuleList(Block(d, cfg.intermediate_size, cfg.num_heads, cfg.layer_norm_eps, tanh_gelu=True)
                                    for _ in range(cfg.num_layers))
        self.post_ln = LayerNorm(d, cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x, _ = patch_embed(self.patch_embed, pixels, self.cfg.patch_size)
        x = x + self.pos_embed[: x.shape[1]]
        for blk in self.blocks:
            x = blk(x)
        return self.post_ln(x)


def siglip_encode(model: SigLIPVision, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> last_hidden_state (B, L, D)."""
    return model(pixels.to(next(model.parameters()).device, torch.float32))


def build_siglip(cfg: SigLIPVisionConfig, device=None, dtype=torch.float32) -> SigLIPVision:
    return _build(lambda: SigLIPVision(cfg), device, dtype)


def convert_siglip_vision(state: Mapping, cfg: SigLIPVisionConfig, device=None) -> SigLIPVision:
    """An HF SiglipVisionModel state dict -> the tower, fp32 on `device`."""
    w, lin, ln, _ = _hf_getters({k[len("vision_model."):]: v for k, v in state.items()
                                 if k.startswith("vision_model.")})
    blocks = []
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        blocks.append({
            "ln1": ln(f"{p}.layer_norm1"), "q": lin(f"{p}.self_attn.q_proj"), "k": lin(f"{p}.self_attn.k_proj"),
            "v": lin(f"{p}.self_attn.v_proj"), "o": lin(f"{p}.self_attn.out_proj"), "ln2": ln(f"{p}.layer_norm2"),
            "fc1": lin(f"{p}.mlp.fc1"), "fc2": lin(f"{p}.mlp.fc2"),
        })
    tree = {
        "patch_embed": {"w": w("embeddings.patch_embedding.weight").transpose(2, 3, 1, 0),
                        "b": w("embeddings.patch_embedding.bias")},
        "pos_embed": w("embeddings.position_embedding.weight"),
        "blocks": blocks,
        "post_ln": ln("post_layernorm"),
    }
    return _load(build_siglip(cfg, device), tree)


SIGLIP_MEAN = 0.5
SIGLIP_STD = 0.5


def siglip_preprocess(img, image_size: int = 384) -> torch.Tensor:
    """PIL image -> (1, S, S, 3) normalized pixels (SiglipImageProcessor:
    resize to square, rescale 1/255, normalize mean = std = 0.5)."""
    from PIL import Image

    img = img.convert("RGB").resize((image_size, image_size), Image.BICUBIC)
    x = np.asarray(img).astype(np.float32) / 255.0
    return torch.from_numpy((x - SIGLIP_MEAN) / SIGLIP_STD)[None]


# ----------------------------- DepthAnything -----------------------------


@dataclasses.dataclass(frozen=True)
class DepthAnythingTowerConfig:
    """LiheYoung/depth-anything-large-hf: DINOv2 ViT-L/14 + DPT neck and head."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    out_indices: tuple[int, ...] = (5, 12, 18, 24)  # 1-based encoder stages
    neck_hidden_sizes: tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    image_size: int = 518  # the processor's target and the position grid's (a multiple of 14)

    def tiny(self) -> "DepthAnythingTowerConfig":
        return dataclasses.replace(self, hidden_size=32, intermediate_size=64, num_layers=4, num_heads=4,
                                   out_indices=(1, 2, 3, 4), neck_hidden_sizes=(8, 12, 16, 16),
                                   fusion_hidden_size=16, head_hidden_size=8, image_size=56)


class Dinov2Backbone(nn.Module):
    def __init__(self, cfg: DepthAnythingTowerConfig):
        super().__init__()
        self.cfg = cfg
        d, grid = cfg.hidden_size, cfg.image_size // cfg.patch_size
        self.patch_embed = Conv(cfg.patch_size, 3, d)
        self.cls_token = nn.Parameter(torch.empty(1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + grid * grid, d))
        self.blocks = nn.ModuleList(Block(d, cfg.intermediate_size, cfg.num_heads, cfg.layer_norm_eps,
                                          layer_scale=True) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(d, cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> tuple[list[torch.Tensor], tuple[int, int]]:
        """([the out_indices stages, final-normed (B, 1 + L, D)], (patch rows, patch columns))."""
        cfg = self.cfg
        x, (ph, pw) = patch_embed(self.patch_embed, pixels, cfg.patch_size)
        b = x.shape[0]
        x = torch.cat([self.cls_token.expand(b, 1, cfg.hidden_size), x], dim=1)
        pos = self.pos_embed
        if pos.shape[1] - 1 != ph * pw:  # the position grid resized bicubically (jax.image's)
            g0 = int(round(float(np.sqrt(pos.shape[1] - 1))))
            grid = resize_bicubic(pos[0, 1:].reshape(1, g0, g0, cfg.hidden_size), (ph, pw))
            pos = torch.cat([pos[:, :1], grid.reshape(1, ph * pw, cfg.hidden_size)], dim=1)
        x = x + pos
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i + 1 in cfg.out_indices:
                feats.append(self.final_ln(x))
        return feats, (ph, pw)


class _Reassemble(nn.Module):
    def __init__(self, d: int, c: int, factor: float):
        super().__init__()
        self.factor = factor
        self.projection = Conv(1, d, c)
        if factor > 1:
            self.resize = ConvTranspose(int(factor), c, c)
        elif factor < 1:
            self.resize = Conv(3, c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.projection(x)
        if self.factor > 1:
            return self.resize(x, int(self.factor))
        if self.factor < 1:  # torch's Conv2d(3, stride 2, padding 1)
            return self.resize(x, stride=int(round(1 / self.factor)), padding=1)
        return x


class _PreActResidual(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.conv2 = Conv(3, c, c), Conv(3, c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class _Fusion(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.projection = Conv(1, c, c)
        self.residual1, self.residual2 = _PreActResidual(c), _PreActResidual(c)


class _Head(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = Conv(3, c, c // 2), Conv(3, c // 2, hidden), Conv(1, hidden, 1)


class DepthAnything(nn.Module):
    def __init__(self, cfg: DepthAnythingTowerConfig):
        super().__init__()
        self.cfg = cfg
        fh = cfg.fusion_hidden_size
        self.backbone = Dinov2Backbone(cfg)
        self.reassemble = nn.ModuleList(_Reassemble(cfg.hidden_size, c, f)
                                        for c, f in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors))
        self.neck_convs = nn.ModuleList(Conv(3, c, fh, bias=False) for c in cfg.neck_hidden_sizes)
        self.fusion = nn.ModuleList(_Fusion(fh) for _ in cfg.neck_hidden_sizes)
        self.head = _Head(fh, cfg.head_hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels -> relative depth (B, H, W): DINOv2
        stages -> DPT reassemble (project, resize 4x / 2x / 1x / 0.5x) -> 3x3
        convs -> top-down fusion (pre-activation residual units,
        align_corners upsampling) -> head, as HF's DepthAnythingForDepthEstimation."""
        cfg = self.cfg
        feats, (ph, pw) = self.backbone(pixels)
        stages = []
        for f, re_, neck in zip(feats, self.reassemble, self.neck_convs):
            x = f[:, 1:].reshape(f.shape[0], ph, pw, cfg.hidden_size)
            stages.append(neck(re_(x)))
        stages = stages[::-1]  # deepest first
        fused = None
        for idx, (feat, fp) in enumerate(zip(stages, self.fusion)):
            if fused is None:
                h = feat
            else:
                res = feat
                if fused.shape != res.shape:
                    res = interpolate_bilinear(res, fused.shape[1:3], align_corners=False)
                h = fused + fp.residual1(res)
            h = fp.residual2(h)
            size = stages[idx + 1].shape[1:3] if idx != len(stages) - 1 else (h.shape[1] * 2, h.shape[2] * 2)
            fused = fp.projection(interpolate_bilinear(h, size, align_corners=True))
        x = self.head.conv1(fused)
        x = interpolate_bilinear(x, (ph * cfg.patch_size, pw * cfg.patch_size), align_corners=True)
        x = F.relu(self.head.conv2(x))
        return F.relu(self.head.conv3(x))[..., 0]


def depth_anything_apply(model: DepthAnything, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> relative depth (B, H, W)."""
    return model(pixels.to(next(model.parameters()).device, torch.float32))


def build_depth_anything(cfg: DepthAnythingTowerConfig, device=None, dtype=torch.float32) -> DepthAnything:
    return _build(lambda: DepthAnything(cfg), device, dtype)


def convert_depth_anything(state: Mapping, cfg: DepthAnythingTowerConfig, device=None) -> DepthAnything:
    """An HF DepthAnythingForDepthEstimation state dict -> the tower, fp32 on `device`."""
    w, lin, ln, conv = _hf_getters(state)

    def conv_t(key):  # torch's (in, out, kh, kw), spatially flipped: JAX's forward-conv form
        return {"w": w(f"{key}.weight")[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy(), "b": w(f"{key}.bias")}

    blocks = []
    for i in range(cfg.num_layers):
        p = f"backbone.encoder.layer.{i}"
        blocks.append({
            "ln1": ln(f"{p}.norm1"), "q": lin(f"{p}.attention.attention.query"),
            "k": lin(f"{p}.attention.attention.key"), "v": lin(f"{p}.attention.attention.value"),
            "o": lin(f"{p}.attention.output.dense"), "ls1": w(f"{p}.layer_scale1.lambda1"),
            "ln2": ln(f"{p}.norm2"), "fc1": lin(f"{p}.mlp.fc1"), "fc2": lin(f"{p}.mlp.fc2"),
            "ls2": w(f"{p}.layer_scale2.lambda1"),
        })
    reassemble = []
    for i, factor in enumerate(cfg.reassemble_factors):
        entry = {"projection": conv(f"neck.reassemble_stage.layers.{i}.projection")}
        if factor > 1:
            entry["resize"] = conv_t(f"neck.reassemble_stage.layers.{i}.resize")
        elif factor < 1:
            entry["resize"] = conv(f"neck.reassemble_stage.layers.{i}.resize")
        reassemble.append(entry)

    def residual(p):
        return {"conv1": conv(f"{p}.convolution1"), "conv2": conv(f"{p}.convolution2")}

    tree = {
        "backbone": {
            "patch_embed": {"w": w("backbone.embeddings.patch_embeddings.projection.weight").transpose(2, 3, 1, 0),
                            "b": w("backbone.embeddings.patch_embeddings.projection.bias")},
            "cls_token": w("backbone.embeddings.cls_token")[0],
            "pos_embed": w("backbone.embeddings.position_embeddings"),
            "blocks": blocks,
            "final_ln": ln("backbone.layernorm"),
        },
        "reassemble": reassemble,
        "neck_convs": [conv(f"neck.convs.{i}", bias=False) for i in range(len(cfg.neck_hidden_sizes))],
        "fusion": [{"projection": conv(f"neck.fusion_stage.layers.{i}.projection"),
                    "residual1": residual(f"neck.fusion_stage.layers.{i}.residual_layer1"),
                    "residual2": residual(f"neck.fusion_stage.layers.{i}.residual_layer2")}
                   for i in range(len(cfg.neck_hidden_sizes))],
        "head": {"conv1": conv("head.conv1"), "conv2": conv("head.conv2"), "conv3": conv("head.conv3")},
    }
    return _load(build_depth_anything(cfg, device), tree)


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def depth_anything_preprocess(img, target: int = 518, multiple: int = 14) -> torch.Tensor:
    """PIL image -> (1, H', W', 3) ImageNet-normalized pixels, both dims
    multiples of `multiple` (DPTImageProcessor's keep_aspect_ratio: of the
    two per-axis scales to `target`, the one closest to 1)."""
    from PIL import Image

    w, h = img.size
    scale_h, scale_w = target / h, target / w
    scale = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
    nh = max(multiple, int(round(h * scale / multiple)) * multiple)
    nw = max(multiple, int(round(w * scale / multiple)) * multiple)
    img = img.convert("RGB").resize((nw, nh), Image.BICUBIC)
    x = np.asarray(img).astype(np.float32) / 255.0
    return torch.from_numpy((x - IMAGENET_MEAN) / IMAGENET_STD)[None]


# ----------------------------- ViT classifier -----------------------------


@dataclasses.dataclass(frozen=True)
class ViTClassifierConfig:
    """A ViT-base image classifier (the NSFW gate's Falconsai/
    nsfw_image_detection: 2 labels)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    num_labels: int = 2
    layer_norm_eps: float = 1e-12

    def tiny(self) -> "ViTClassifierConfig":
        return dataclasses.replace(self, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
                                   image_size=28, patch_size=14)


class ViTClassifier(nn.Module):
    def __init__(self, cfg: ViTClassifierConfig):
        super().__init__()
        self.cfg = cfg
        d, grid = cfg.hidden_size, cfg.image_size // cfg.patch_size
        self.patch_embed = Conv(cfg.patch_size, 3, d)
        self.cls_token = nn.Parameter(torch.empty(1, d))
        self.pos_embed = nn.Parameter(torch.empty(1 + grid * grid, d))
        self.blocks = nn.ModuleList(Block(d, cfg.intermediate_size, cfg.num_heads, cfg.layer_norm_eps)
                                    for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(d, cfg.layer_norm_eps)
        self.classifier = nn.Linear(d, cfg.num_labels)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x, _ = patch_embed(self.patch_embed, pixels, self.cfg.patch_size)
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, self.cfg.hidden_size), x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.classifier(self.final_ln(x)[:, 0])


def vit_classify(model: ViTClassifier, pixels: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) normalized pixels -> logits (B, num_labels)."""
    return model(pixels.to(next(model.parameters()).device, torch.float32))


def build_vit_classifier(cfg: ViTClassifierConfig, device=None, dtype=torch.float32) -> ViTClassifier:
    return _build(lambda: ViTClassifier(cfg), device, dtype)


def convert_vit_classifier(state: Mapping, cfg: ViTClassifierConfig, device=None) -> ViTClassifier:
    """An HF ViTForImageClassification state dict -> the classifier, fp32 on `device`."""
    w, lin, ln, _ = _hf_getters(state)
    blocks = []
    for i in range(cfg.num_layers):
        p = f"vit.encoder.layer.{i}"
        blocks.append({
            "ln1": ln(f"{p}.layernorm_before"), "q": lin(f"{p}.attention.attention.query"),
            "k": lin(f"{p}.attention.attention.key"), "v": lin(f"{p}.attention.attention.value"),
            "o": lin(f"{p}.attention.output.dense"), "ln2": ln(f"{p}.layernorm_after"),
            "fc1": lin(f"{p}.intermediate.dense"), "fc2": lin(f"{p}.output.dense"),
        })
    tree = {
        "patch_embed": {"w": w("vit.embeddings.patch_embeddings.projection.weight").transpose(2, 3, 1, 0),
                        "b": w("vit.embeddings.patch_embeddings.projection.bias")},
        "cls_token": w("vit.embeddings.cls_token")[0],
        "pos_embed": w("vit.embeddings.position_embeddings")[0],
        "blocks": blocks,
        "final_ln": ln("vit.layernorm"),
        "classifier": lin("classifier"),
    }
    return _load(build_vit_classifier(cfg, device), tree)


def vit_preprocess(img, image_size: int = 224) -> torch.Tensor:
    """PIL image -> (1, S, S, 3), ViTImageProcessor's defaults (resize,
    rescale 1/255, normalize mean = std = 0.5)."""
    from PIL import Image

    img = img.convert("RGB").resize((image_size, image_size), Image.BILINEAR)
    x = np.asarray(img).astype(np.float32) / 255.0
    return torch.from_numpy((x - 0.5) / 0.5)[None]
