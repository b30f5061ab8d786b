"""Plain float32 text encoders and the tokenizer the served stack uses.

No tokenizer files ship with the repository, so a served stack without them
tokenizes with a deterministic word hash (each whitespace word -> one id,
then EOS, padded to the maximum length); `hash_ids` writes that rule down
again. T5 v1.1 encoder (google/t5-v1_1-xxl): RMSNorm, no biases, one
relative position bias table for all layers, unscaled q.k, gated tanh-GELU
FFN, no attention mask. CLIP-L text encoder: LayerNorm, causal mask,
quick-GELU MLP; the pooled output is the final-LN state at the first
position of the largest id (the EOT token)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .flux import fp8_round

def hash_ids(text: str, max_length: int, vocab_size: int, pad_id: int, eos_id: int, bos_id: int | None) -> np.ndarray:
    ids = [] if bos_id is None else [bos_id]
    for word in text.split():
        h = 0
        for ch in word:
            h = (h * 131 + ord(ch)) % (vocab_size - 16)
        ids.append(h + 8)
    ids.append(eos_id)
    if len(ids) > max_length:
        ids = ids[: max_length - 1] + [eos_id]
    out = np.full((max_length,), pad_id, dtype=np.int64)
    out[: len(ids)] = ids
    return out


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, mode: str = "fp32") -> torch.Tensor:
    """x @ w^T + b; mode "fp8" (the control): weights per output channel and inputs per token in float8 e4m3."""
    if mode == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return F.linear(x, w, b)


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * w


def _buckets(n: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    rel = torch.arange(n)[None, :] - torch.arange(n)[:, None]
    half = num_buckets // 2
    out = (rel > 0).long() * half
    a = rel.abs()
    exact = half // 2
    large = exact + (torch.log(a.clamp_min(1).double() / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    return out + torch.where(a < exact, a, large.clamp_max(half - 1))


@torch.no_grad()
def t5_encode(group_weights, cfg: dict, ids_list: list[torch.Tensor], mode: str = "fp32") -> list[torch.Tensor]:
    """Each prompt's ids (L,) -> its last hidden state (L, d_model) fp32; layer by layer over the prompts."""
    R = group_weights("t5.rest")
    heads, dk = cfg["num_heads"], cfg["d_kv"]
    xs = [R["embed"][ids] for ids in ids_list]
    biases = [R["relative_attention_bias"][_buckets(ids.shape[0], cfg["relative_attention_num_buckets"],
                                                     cfg["relative_attention_max_distance"]).to(ids.device)]
              .permute(2, 0, 1) for ids in ids_list]  # (H, L, L)
    for i in range(cfg["num_layers"]):
        W = group_weights(f"t5.blocks.{i}")
        p = f"blocks.{i}"
        for j, (x, bias) in enumerate(zip(xs, biases)):
            L = x.shape[0]
            h = _rms(x, W[f"{p}.attn.ln"])
            q, k, v = (_linear(h, W[f"{p}.attn.{n}.weight"], mode=mode).reshape(L, heads, dk).transpose(0, 1) for n in "qkv")
            o = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1) @ v
            x = x + _linear(o.transpose(0, 1).reshape(L, heads * dk), W[f"{p}.attn.o.weight"], mode=mode)
            h = _rms(x, W[f"{p}.ffn.ln"])
            gate = F.gelu(_linear(h, W[f"{p}.ffn.wi_0.weight"], mode=mode), approximate="tanh")
            xs[j] = x + _linear(gate * _linear(h, W[f"{p}.ffn.wi_1.weight"], mode=mode), W[f"{p}.ffn.wo.weight"],
                                 mode=mode)
    return [_rms(x, R["final_ln"]) for x in xs]


@torch.no_grad()
def clip_pooled(group_weights, cfg: dict, ids_list: list[torch.Tensor], mode: str = "fp32") -> list[torch.Tensor]:
    """Each prompt's ids (L,) -> its pooled output (d,) fp32; layer by layer over the prompts."""
    R = group_weights("clip.rest")
    d, heads = cfg["hidden_size"], cfg["num_heads"]
    hd = d // heads
    eps = cfg["layer_norm_eps"]

    def ln(W, name, x):
        return F.layer_norm(x, (d,), W[f"{name}.scale"], W[f"{name}.bias"], eps=eps)

    hs = [R["token_embed"][ids] + R["pos_embed"][: ids.shape[0]] for ids in ids_list]
    for i in range(cfg["num_layers"]):
        W = group_weights(f"clip.blocks.{i}")
        p = f"blocks.{i}"
        for j, h in enumerate(hs):
            L = h.shape[0]
            causal = torch.triu(torch.full((L, L), float("-inf"), device=h.device), diagonal=1)
            x = ln(W, f"{p}.ln1", h)
            q, k, v = (_linear(x, W[f"{p}.attn.{n}.weight"], W[f"{p}.attn.{n}.bias"], mode).reshape(L, heads, hd)
                       .transpose(0, 1) for n in "qkv")
            o = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5 + causal, dim=-1) @ v
            h = h + _linear(o.transpose(0, 1).reshape(L, d), W[f"{p}.attn.o.weight"], W[f"{p}.attn.o.bias"], mode)
            x = _linear(ln(W, f"{p}.ln2", h), W[f"{p}.fc1.weight"], W[f"{p}.fc1.bias"], mode)
            hs[j] = h + _linear(x * torch.sigmoid(1.702 * x), W[f"{p}.fc2.weight"], W[f"{p}.fc2.bias"], mode)
    return [ln(R, "final_ln", h)[int(torch.argmax(ids))] for h, ids in zip(hs, ids_list)]
