"""Plain float32 FLUX autoencoder (the AutoencoderKL of FLUX.1, 16 latent
channels): encoder and decoder of resnet blocks (GroupNorm of 32 groups,
eps 1e-6, swish, 3x3 convs), a single-head attention block at the
bottleneck, stride-2 downsampling after a (0, 1) pad, nearest 2x
upsampling; latents scaled as (z - shift) * scale. NHWC in and out; NCHW
inside. Weights are reference/weights.vae_groups' (convs (k, k, in, out)).
mode "fp8" is the control: every conv's weights per output channel and its
input per tensor rounded to float8 e4m3."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flux import fp8_round


class _Net:
    def __init__(self, W: dict, mode: str):
        self.W, self.fp8 = W, mode == "fp8"

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, pad: int | None = None) -> torch.Tensor:
        w = self.W[f"{name}.w"].permute(3, 2, 0, 1)
        if self.fp8:
            w = fp8_round(w.reshape(w.shape[0], -1)).reshape(w.shape)
            x = fp8_round(x.reshape(1, -1)).reshape(x.shape)
        k = w.shape[-1]
        return F.conv2d(x, w, self.W[f"{name}.b"], stride=stride, padding=k // 2 if pad is None else pad)

    def norm(self, name: str, x: torch.Tensor, swish: bool) -> torch.Tensor:
        y = F.group_norm(x, min(32, x.shape[1]), self.W[f"{name}.scale"], self.W[f"{name}.bias"], eps=1e-6)
        return y * torch.sigmoid(y) if swish else y

    def resnet(self, p: str, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(f"{p}.conv1", self.norm(f"{p}.norm1", x, True))
        h = self.conv(f"{p}.conv2", self.norm(f"{p}.norm2", h, True))
        return h + (self.conv(f"{p}.nin_shortcut", x) if f"{p}.nin_shortcut.w" in self.W else x)

    def attn(self, p: str, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(f"{p}.norm", x, False)
        q, k, v = (self.conv(f"{p}.{n}", hn).reshape(b, c, h * w).transpose(1, 2) for n in ("q", "k", "v"))
        o = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1) @ v
        return x + self.conv(f"{p}.proj_out", o.transpose(1, 2).reshape(b, c, h, w))

    def mid(self, p: str, x: torch.Tensor) -> torch.Tensor:
        return self.resnet(f"{p}.block_2", self.attn(f"{p}.attn_1", self.resnet(f"{p}.block_1", x)))


@torch.no_grad()
def encode(W, cfg: dict, pixels: torch.Tensor, eps: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """(1, H, W, 3) pixels in [-1, 1], posterior noise (1, H/8, W/8, z) -> the scaled latent (NHWC)."""
    net = _Net(W, mode)
    h = net.conv("encoder.conv_in", pixels.float().permute(0, 3, 1, 2))
    n = len(cfg["ch_mult"])
    for i in range(n):
        for j in range(cfg["num_res_blocks"]):
            h = net.resnet(f"encoder.down.{i}.block.{j}", h)
        if i != n - 1:
            h = net.conv(f"encoder.down.{i}.downsample.conv", F.pad(h, (0, 1, 0, 1)), stride=2, pad=0)
    h = net.mid("encoder.mid", h)
    moments = net.conv("encoder.conv_out", net.norm("encoder.norm_out", h, True)).permute(0, 2, 3, 1)
    mean, logvar = moments.chunk(2, dim=-1)
    z = mean + torch.exp(0.5 * logvar) * eps.float()
    return (z - cfg["shift_factor"]) * cfg["scale_factor"]


@torch.no_grad()
def decode(W, cfg: dict, z: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """(1, h, w, z) scaled latent -> (1, 8h, 8w, 3) pixels (NHWC)."""
    net = _Net(W, mode)
    h = net.conv("decoder.conv_in", (z.float() / cfg["scale_factor"] + cfg["shift_factor"]).permute(0, 3, 1, 2))
    h = net.mid("decoder.mid", h)
    for i in reversed(range(len(cfg["ch_mult"]))):
        for j in range(cfg["num_res_blocks"] + 1):
            h = net.resnet(f"decoder.up.{i}.block.{j}", h)
        if i != 0:
            h = net.conv(f"decoder.up.{i}.upsample.conv", F.interpolate(h, scale_factor=2.0, mode="nearest"))
    return net.conv("decoder.conv_out", net.norm("decoder.norm_out", h, True)).permute(0, 2, 3, 1)
