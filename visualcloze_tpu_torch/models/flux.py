"""The FLUX flow-matching DiT (counterpart of visualcloze_tpu/models/flux.py).

Inference path only: the 19 double and 38 single blocks are modules in
nn.ModuleLists (the JAX package stacks their parameters and scans); no remat,
no activation capture, no calibration statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import FluxConfig
from ..ops.rope import embed_nd
from ..ops.schedule import timestep_embedding
from .init import init_linears_, materialize
from .layers import DoubleBlock, LastLayer, Linear, MLPEmbedder, SingleBlock


class Flux(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.img_in = Linear(cfg.in_channels, h)
        self.txt_in = Linear(cfg.context_in_dim, h)
        self.time_in = MLPEmbedder(256, h)
        self.vector_in = MLPEmbedder(cfg.vec_in_dim, h)
        self.guidance_in = MLPEmbedder(256, h) if cfg.guidance_embed else None
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg) for _ in range(cfg.depth))
        self.single_blocks = nn.ModuleList(SingleBlock(cfg) for _ in range(cfg.depth_single_blocks))
        self.final_layer = LastLayer(cfg)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "Flux":
        """Random weights as the JAX package's init_flux draws them (other numbers)."""
        init_linears_(self, generator)
        for name, p in self.named_parameters():
            if name.endswith(("q_scale", "k_scale")):
                p.fill_(1.0)
        return self

    def embed_inputs(self, img, img_ids, txt, txt_ids, timesteps, y, txt_mask, img_mask, guidance):
        """Token embeddings, the modulation vector, RoPE tables and the joint
        attention mask (None when nothing is padded)."""
        cfg = self.cfg
        img = self.img_in(img)
        vec = self.time_in(timestep_embedding(timesteps, 256))
        if cfg.guidance_embed:
            if guidance is None:
                raise ValueError("guidance_embed model needs a guidance vector")
            vec = vec + self.guidance_in(timestep_embedding(guidance, 256))
        vec = vec + self.vector_in(y)
        txt = self.txt_in(txt)
        pe = embed_nd(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta)
        b, txt_len = txt.shape[:2]
        if txt_mask is None and img_mask is None:
            attn_mask = None
        else:
            if txt_mask is None:
                txt_mask = torch.ones((b, txt_len), dtype=torch.int32, device=txt.device)
            if img_mask is None:
                img_mask = torch.ones((b, img.shape[1]), dtype=torch.int32, device=img.device)
            attn_mask = torch.cat([txt_mask, img_mask], dim=1)
        return img, txt, vec, pe, attn_mask

    @torch.no_grad()
    def forward(self, *, img, img_ids, txt, txt_ids, timesteps, y, txt_mask=None, img_mask=None,
                guidance=None) -> torch.Tensor:
        """(B, L_img, in_channels) tokens -> (B, L_img, out_channels) velocity.
        txt/img masks are (B, L) int {1 real, 0 pad}; timesteps (B,) flux time."""
        img, txt, vec, pe, attn_mask = self.embed_inputs(
            img, img_ids, txt, txt_ids, timesteps, y, txt_mask, img_mask, guidance
        )
        txt_len = txt.shape[1]
        for block in self.double_blocks:
            img, txt = block(img, txt, vec, pe, attn_mask)
        x = torch.cat([txt, img], dim=1)
        for block in self.single_blocks:
            x = block(x, vec, pe, attn_mask)
        return self.final_layer(x[:, txt_len:], vec)


def build_flux(cfg: FluxConfig, device, dtype) -> Flux:
    """A Flux with uninitialized weights of `dtype` allocated on `device`."""
    return materialize(lambda: Flux(cfg), device, dtype)
