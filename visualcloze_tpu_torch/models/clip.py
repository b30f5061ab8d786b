"""CLIP-L text encoder (openai/clip-vit-large-patch14) (counterpart of
visualcloze_tpu/models/clip.py).

FLUX consumes only the pooled output: the final-LN hidden state at the EOT
token, located by the argmax of the input ids. Causal mask, no padding mask,
as in the reference. Attention is plain matmul, as it is plain einsum in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPTextConfig
from .init import init_linears_, materialize, normal_


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        x32 = x.to(torch.float32)
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(torch.float32) + self.bias.to(torch.float32)).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(torch.tensor(1.702, dtype=x.dtype, device=x.device) * x)


class CLIPAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (nn.Linear(d, d) for _ in range(4))


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps)
        self.attn = CLIPAttention(d)
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.token_embed = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_length, d))
        self.blocks = nn.ModuleList(CLIPBlock(cfg) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(d, cfg.layer_norm_eps)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "CLIPTextEncoder":
        init_linears_(self, generator)
        normal_(self.token_embed, 0.02, generator)
        normal_(self.pos_embed, 0.01, generator)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
        return self

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """input_ids (B, L) -> (last_hidden_state (B, L, D), pooled (B, D))."""
        cfg = self.cfg
        b, L = input_ids.shape
        tok = F.embedding(input_ids, self.token_embed)
        h = tok + self.pos_embed[:L].to(tok.dtype)
        heads, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        causal = torch.triu(torch.full((L, L), -1e9, dtype=torch.float32, device=h.device), diagonal=1)

        def split(t):
            return t.reshape(b, L, heads, hd).transpose(1, 2)

        for blk in self.blocks:
            x = blk.ln1(h)
            a = blk.attn
            q, k, v = split(a.q(x)), split(a.k(x)), split(a.v(x))
            logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
            probs = torch.softmax(logits * hd ** -0.5 + causal, dim=-1).to(v.dtype)
            o = torch.matmul(probs, v).transpose(1, 2).reshape(b, L, cfg.hidden_size)
            h = h + a.o(o)
            h = h + blk.fc2(quick_gelu(blk.fc1(blk.ln2(h))))
        h = self.final_ln(h)
        eot = input_ids.argmax(dim=-1)
        return h, h[torch.arange(b, device=h.device), eot]


def build_clip(cfg: CLIPTextConfig, device, dtype) -> CLIPTextEncoder:
    return materialize(lambda: CLIPTextEncoder(cfg), device, dtype)
