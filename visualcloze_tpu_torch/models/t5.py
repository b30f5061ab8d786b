"""T5 v1.1 encoder (google/t5-v1_1-xxl) (counterpart of visualcloze_tpu/models/t5.py).

RMSNorm with fp32 statistics, no biases, a relative position bias from one
bucket table shared by all layers, unscaled q, gated-GELU FFN. Like the
reference, no attention mask. Attention is plain matmul, as it is
plain einsum in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import T5Config
from .init import materialize, normal_


def t5_rms_norm(weight: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    x32 = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return x32.to(x.dtype) * weight.to(x.dtype)


def relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    """HF T5 bidirectional bucket function (host-side; positions are static)."""
    ret = np.zeros_like(relative_position)
    num_buckets //= 2
    ret += (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret


def position_bias_table(cfg: T5Config, seq_len: int) -> np.ndarray:
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    return relative_position_bucket(
        mem - ctx,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance,
    )


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        d, kd = cfg.d_model, cfg.num_heads * cfg.d_kv
        self.ln = nn.Parameter(torch.ones(d))
        self.q = nn.Linear(d, kd, bias=False)
        self.k = nn.Linear(d, kd, bias=False)
        self.v = nn.Linear(d, kd, bias=False)
        self.o = nn.Linear(kd, d, bias=False)


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.ln = nn.Parameter(torch.ones(d))
        self.wi_0 = nn.Linear(d, f, bias=False)
        self.wi_1 = nn.Linear(d, f, bias=False)
        self.wo = nn.Linear(f, d, bias=False)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.attn = T5Attention(cfg)
        self.ffn = T5FFN(cfg)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.relative_attention_bias = nn.Parameter(
            torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads)
        )
        self.blocks = nn.ModuleList(T5Block(cfg) for _ in range(cfg.num_layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "T5Encoder":
        cfg = self.cfg
        normal_(self.embed, 1.0, generator)
        normal_(self.relative_attention_bias, 0.1, generator)
        for blk in self.blocks:
            for lin in (blk.attn.q, blk.attn.k, blk.attn.v, blk.ffn.wi_0, blk.ffn.wi_1):
                normal_(lin.weight, cfg.d_model ** -0.5, generator)
            normal_(blk.attn.o.weight, (cfg.num_heads * cfg.d_kv) ** -0.5, generator)
            normal_(blk.ffn.wo.weight, cfg.d_ff ** -0.5, generator)
            blk.attn.ln.fill_(1.0)
            blk.ffn.ln.fill_(1.0)
        self.final_ln.fill_(1.0)
        return self

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, L) -> last_hidden_state (B, L, d_model)."""
        cfg = self.cfg
        b, L = input_ids.shape
        x = F.embedding(input_ids, self.embed)
        buckets = torch.from_numpy(position_bias_table(cfg, L)).to(x.device)
        pos_bias = self.relative_attention_bias[buckets].to(torch.float32)  # (L, L, H)
        pos_bias = pos_bias.permute(2, 0, 1)[None]  # (1, H, L, L)

        def heads(t):
            return t.reshape(b, L, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        for blk in self.blocks:
            p = blk.attn
            hn = t5_rms_norm(p.ln, x)
            q, k, v = heads(p.q(hn)), heads(p.k(hn)), heads(p.v(hn))
            logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
            probs = torch.softmax(logits + pos_bias, dim=-1).to(v.dtype)
            o = torch.matmul(probs, v).transpose(1, 2).reshape(b, L, cfg.num_heads * cfg.d_kv)
            x = x + p.o(o)
            f = blk.ffn
            hn = t5_rms_norm(f.ln, x)
            gate = F.gelu(f.wi_0(hn), approximate="tanh")
            x = x + f.wo(gate * f.wi_1(hn))
        return t5_rms_norm(self.final_ln, x)


def build_t5(cfg: T5Config, device, dtype) -> T5Encoder:
    return materialize(lambda: T5Encoder(cfg), device, dtype)
