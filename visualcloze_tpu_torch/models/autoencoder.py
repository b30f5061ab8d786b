"""FLUX VAE (AutoencoderKL), NHWC (counterpart of visualcloze_tpu/models/autoencoder.py).

Activations are NHWC and conv weights HWIO (3, 3, C, Cout), as in JAX.
GroupNorm statistics are fp32 torch ops; every resnet half-block
(GroupNorm -> swish -> conv3x3) and every upsample conv goes through kernel B,
and the bottleneck attention through kernel C, at every sequence length.
The remaining convs (conv_in/out, the stride-2 downsample, 1x1 projections)
are plain PyTorch convs, as they were plain XLA convs in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AutoEncoderConfig
from ..ops.conv2d import conv3x3_gn_swish
from ..ops.flash_attention import flash_attn_d512
from .init import materialize, normal_


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar in `like`'s dtype: JAX rounds a weakly typed scalar to
    the array's dtype before a bf16 op, PyTorch would keep it in fp32."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


class Conv(nn.Module):
    """Conv weights (kh, kw, in, out) and bias (out,)."""

    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(k, k, cin, cout))
        self.b = nn.Parameter(torch.empty(cout))


class GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


def conv2d(p: Conv, x: torch.Tensor, stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """NHWC conv in the weight dtype, bias added after (a plain PyTorch conv)."""
    w = p.w
    k = w.shape[0]
    pad = (k // 2) if padding == "SAME" else 0
    y = F.conv2d(
        x.to(w.dtype).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=pad
    ).permute(0, 2, 3, 1)
    return y + p.b.to(y.dtype)


def group_norm_affine(p: GroupNorm, x: torch.Tensor, groups: int | None = None, eps: float = 1e-6):
    """GroupNorm collapsed to a per-(batch, channel) fp32 affine y = x * a + b."""
    b, h, w, c = x.shape
    if groups is None:
        groups = min(32, c)
    cg = c // groups
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=(1, 2)).reshape(b, groups, cg).mean(-1)
    mu_c = mu.repeat_interleave(cg, dim=-1)
    var_c = (x32 - mu_c[:, None, None, :]).square().mean(dim=(1, 2))
    var = var_c.reshape(b, groups, cg).mean(-1)
    rsig_c = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1)
    a = rsig_c * p.scale.to(torch.float32)[None]
    bb = p.bias.to(torch.float32)[None] - mu_c * a
    return a, bb


def group_norm(p: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    a, bb = group_norm_affine(p, x)
    return (x.to(torch.float32) * a[:, None, None, :] + bb[:, None, None, :]).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _gn_swish_conv(norm: GroupNorm, conv: Conv, x: torch.Tensor, residual=None) -> torch.Tensor:
    """GroupNorm -> swish -> conv3x3 (+ residual): one launch of kernel B."""
    y = conv3x3_gn_swish(x, conv.w, conv.b, pre_affine=group_norm_affine(norm, x))
    return y if residual is None else y + residual.to(y.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv(3, cin, cout)
        self.norm2 = GroupNorm(cout)
        self.conv2 = Conv(3, cout, cout)
        self.nin_shortcut = Conv(1, cin, cout) if cin != cout else None

    def forward(self, x):
        h = _gn_swish_conv(self.norm1, self.conv1, x)
        res = conv2d(self.nin_shortcut, x) if self.nin_shortcut is not None else x
        return _gn_swish_conv(self.norm2, self.conv2, h, residual=res)


class AttnBlock(nn.Module):
    """Single-head spatial self-attention at the bottleneck (kernel C)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q = Conv(1, c, c)
        self.k = Conv(1, c, c)
        self.v = Conv(1, c, c)
        self.proj_out = Conv(1, c, c)

    def forward(self, x):
        b, h, w, c = x.shape
        hn = group_norm(self.norm, x)
        q, k, v = (conv2d(m, hn).reshape(b, 1, h * w, c).contiguous() for m in (self.q, self.k, self.v))
        o = flash_attn_d512(q, k, v).reshape(b, h, w, c)
        return x + conv2d(self.proj_out, o)


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(3, c, c)

    def forward(self, x):
        """Stride-2 conv after the reference's asymmetric (0, 1) pad."""
        return conv2d(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding="VALID")


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(3, c, c)

    def forward(self, x):
        """Nearest-neighbour 2x, then the conv through kernel B without affine."""
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv3x3_gn_swish(x, self.conv.w, self.conv.b, act="none")


class Level(nn.Module):
    def __init__(self, blocks: list[ResnetBlock], resample: nn.Module | None, name: str):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, name, resample)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoEncoderConfig):
        super().__init__()
        ch = cfg.ch
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        self.conv_in = Conv(3, cfg.in_channels, ch)
        levels = []
        block_in = ch
        for i_level in range(len(cfg.ch_mult)):
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * cfg.ch_mult[i_level]
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            last = i_level == len(cfg.ch_mult) - 1
            levels.append(Level(blocks, None if last else Downsample(block_in), "downsample"))
        self.down = nn.ModuleList(levels)
        self.mid = nn.ModuleDict({
            "block_1": ResnetBlock(block_in, block_in),
            "attn_1": AttnBlock(block_in),
            "block_2": ResnetBlock(block_in, block_in),
        })
        self.norm_out = GroupNorm(block_in)
        self.conv_out = Conv(3, block_in, 2 * cfg.z_channels)

    def forward(self, x):
        """(B, H, W, 3) pixels in [-1, 1] -> (B, H/8, W/8, 2z) moments."""
        h = conv2d(self.conv_in, x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid["block_1"](h)
        h = self.mid["attn_1"](h)
        h = self.mid["block_2"](h)
        return conv2d(self.conv_out, swish(group_norm(self.norm_out, h)))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoEncoderConfig):
        super().__init__()
        ch = cfg.ch
        block_in = ch * cfg.ch_mult[-1]
        self.conv_in = Conv(3, cfg.z_channels, block_in)
        self.mid = nn.ModuleDict({
            "block_1": ResnetBlock(block_in, block_in),
            "attn_1": AttnBlock(block_in),
            "block_2": ResnetBlock(block_in, block_in),
        })
        up: list[Level | None] = [None] * len(cfg.ch_mult)
        for i_level in reversed(range(len(cfg.ch_mult))):
            block_out = ch * cfg.ch_mult[i_level]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            up[i_level] = Level(blocks, Upsample(block_in) if i_level != 0 else None, "upsample")
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = Conv(3, block_in, cfg.out_ch)

    def forward(self, z):
        """(B, h, w, z) latent -> (B, 8h, 8w, 3) pixels."""
        h = conv2d(self.conv_in, z)
        h = self.mid["block_1"](h)
        h = self.mid["attn_1"](h)
        h = self.mid["block_2"](h)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return conv2d(self.conv_out, swish(group_norm(self.norm_out, h)))


def diagonal_gaussian(z: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Split moments into (mean, logvar) and sample mean + std * eps, eps a
    standard normal of the mean's shape (drawn by the caller)."""
    mean, logvar = z.chunk(2, dim=-1)
    std = torch.exp(0.5 * logvar.to(torch.float32))
    return (mean.to(torch.float32) + std * eps.to(torch.float32)).to(mean.dtype)


class AutoEncoder(nn.Module):
    """encode/decode with the (z - shift) * scale latent normalization."""

    def __init__(self, cfg: AutoEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "AutoEncoder":
        for m in self.modules():
            if isinstance(m, Conv):
                kh, kw, cin, _ = m.w.shape
                normal_(m.w, (kh * kw * cin) ** -0.5, generator)
                m.b.zero_()
            elif isinstance(m, GroupNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
        return self

    @torch.no_grad()
    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    @torch.no_grad()
    def encode(self, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Pixels -> scaled latent; eps is the posterior noise."""
        z = diagonal_gaussian(self.encode_moments(x), eps)
        return (z - _scalar(self.cfg.shift_factor, z)) * _scalar(self.cfg.scale_factor, z)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z / _scalar(self.cfg.scale_factor, z) + _scalar(self.cfg.shift_factor, z)
        return self.decoder(z)


def build_autoencoder(cfg: AutoEncoderConfig, device, dtype) -> AutoEncoder:
    return materialize(lambda: AutoEncoder(cfg), device, dtype)
