"""Plain float32 FLUX DiT: one evaluation at a time, computed block by block.

Written from the published FLUX.1 architecture (19 double-stream blocks with
joint attention over text then image tokens, 38 single-stream blocks with
the MLP parallel to attention, adaLN modulation from the time, guidance and
pooled-text vector, q/k RMSNorm, 3-axis RoPE over (row, y, x) ids), in the
"half" channel layout: each head's first D/2 channels are the even lanes of
the rotation pairs, its last D/2 the odd ones. Only real tokens are computed:
padded keys are masked in the program, so real rows do not depend on them.

The linears compute in one of four ways (`mode`):
- "fp32": x @ W^T + b;
- "w8a8": the configuration's w8a8 scheme, emulated in fp32: the block's
  token-dim linears (qkv, proj, mlp.0, mlp.2, linear1, linear2) take the
  input quantized per token to int8 (absmax / 127) and the weight per output
  channel to int8; every other linear the int8 weight alone;
- "fp8" (control of a bf16 configuration): weights per output channel and
  inputs per token rounded to float8 e4m3 (absmax / 448);
- "w4a8" (control of a w8a8 configuration): as "w8a8", the weights in int4
  (absmax / 7 over each 128 inputs of an output channel).
Everything else is float32. The caller turns TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

A8_KEYS = ("qkv", "proj", "mlp.0", "mlp.2", "linear1", "linear2")
MODES = ("fp32", "w8a8", "fp8", "w4a8")
INT4_GROUP = 128


def _per_row(x: torch.Tensor, top: float) -> torch.Tensor:
    return torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8) / torch.tensor(top, device=x.device)


def int_round(x: torch.Tensor, top: int) -> torch.Tensor:
    """x quantized per row (last axis) to integers in [-top, top], dequantized."""
    s = _per_row(x, float(top))
    return torch.clamp(torch.round(x / s), -top, top) * s


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    s = _per_row(x, 448.0)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def int4_weight(w: torch.Tensor) -> torch.Tensor:
    out_f, in_f = w.shape
    g = math.gcd(in_f, INT4_GROUP)
    return int_round(w.reshape(out_f, in_f // g, g), 7).reshape(out_f, in_f)


def prepare_linear(w: torch.Tensor, b: torch.Tensor | None, name: str, mode: str):
    """(weight as the mode computes with it, bias, whether the input is quantized and how)."""
    a8 = any(name.endswith(k + ".weight") for k in A8_KEYS)
    if mode == "fp32":
        return w, b, None
    if mode == "fp8":
        return fp8_round(w), b, "fp8"
    wq = int_round(w, 127) if mode == "w8a8" else int4_weight(w)
    return wq, b, ("int8" if a8 else None)


def linear(x: torch.Tensor, p) -> torch.Tensor:
    w, b, act = p
    if act == "int8":
        x = int_round(x, 127)
    elif act == "fp8":
        x = fp8_round(x)
    y = x @ w.t()
    return y if b is None else y + b


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    t = 1000.0 * t.to(torch.float32)
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_tables(ids: torch.Tensor, axes_dim, theta: int):
    """ids (L, 3) -> cos, sin (L, D/2): each axis' pairs, axis after axis."""
    cos, sin = [], []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
        ang = ids[:, i:i + 1].to(torch.float32) * omega.to(torch.float32).to(ids.device)
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    e, o = x.chunk(2, dim=-1)
    return torch.cat([cos * e - sin * o, sin * e + cos * o], dim=-1)


def _attend(qkv_parts, heads: int, pe, q_scale_k_scale) -> torch.Tensor:
    """qkv_parts: [(L_i, 3 * H * D)] stacked in sequence order, their norm
    scales; returns the merged heads (L, H * D)."""
    qs, ks, vs = [], [], []
    for qkv, (qsc, ksc) in zip(qkv_parts, q_scale_k_scale):
        q, k, v = qkv.reshape(qkv.shape[0], 3, heads, -1).permute(1, 2, 0, 3)
        qs.append(_rms(q, qsc))
        ks.append(_rms(k, ksc))
        vs.append(v)
    q, k, v = (torch.cat(t, dim=1) for t in (qs, ks, vs))
    cos, sin = pe
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    att = torch.softmax((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)
    o = att @ v  # (H, L, D)
    return o.transpose(0, 1).reshape(o.shape[1], -1)


def _mod(W, prefix: str, vec: torch.Tensor, n: int):
    out = linear(F.silu(vec), W[f"{prefix}.lin"])
    return out.chunk(n, dim=-1)


def embed(W, e: dict, cfg: dict) -> dict:
    """The state before the blocks of one evaluation's inputs (real tokens, fp32)."""
    img = e["img"].float()[: e["n_img"]]
    txt = e["txt"].float()[: e["n_txt"]]
    vec = linear(F.silu(linear(timestep_embedding(e["timesteps"]), W["time_in.in_layer"])),
                 W["time_in.out_layer"])
    if cfg["guidance_embed"]:
        vec = vec + linear(F.silu(linear(timestep_embedding(e["guidance"]), W["guidance_in.in_layer"])),
                           W["guidance_in.out_layer"])
    vec = vec + linear(F.silu(linear(e["y"].float(), W["vector_in.in_layer"])), W["vector_in.out_layer"])
    ids = torch.cat([e["txt_ids"][: e["n_txt"]], e["img_ids"][: e["n_img"]]], dim=0)
    return {"img": linear(img, W["img_in"]), "txt": linear(txt, W["txt_in"]), "vec": vec,
            "pe": rope_tables(ids.float(), cfg["axes_dim"], cfg["theta"])}


def double_block(W, p: str, s: dict, heads: int) -> dict:
    img, txt, vec = s["img"], s["txt"], s["vec"]
    im = _mod(W, f"{p}.img_mod", vec, 6)
    tm = _mod(W, f"{p}.txt_mod", vec, 6)

    def modulate(x, shift, scale):
        return (1 + scale) * _layer_norm(x) + shift

    qkv_img = linear(modulate(img, im[0], im[1]), W[f"{p}.img_attn.qkv"])
    qkv_txt = linear(modulate(txt, tm[0], tm[1]), W[f"{p}.txt_attn.qkv"])
    scales = [(W[f"{p}.{s_}_attn.norm.q_scale"], W[f"{p}.{s_}_attn.norm.k_scale"]) for s_ in ("txt", "img")]
    attn = _attend([qkv_txt, qkv_img], heads, s["pe"], scales)
    n_txt = txt.shape[0]
    img = img + im[2] * linear(attn[n_txt:], W[f"{p}.img_attn.proj"])
    h = F.gelu(linear(modulate(img, im[3], im[4]), W[f"{p}.img_mlp.0"]), approximate="tanh")
    img = img + im[5] * linear(h, W[f"{p}.img_mlp.2"])
    txt = txt + tm[2] * linear(attn[:n_txt], W[f"{p}.txt_attn.proj"])
    h = F.gelu(linear(modulate(txt, tm[3], tm[4]), W[f"{p}.txt_mlp.0"]), approximate="tanh")
    txt = txt + tm[5] * linear(h, W[f"{p}.txt_mlp.2"])
    return dict(s, img=img, txt=txt)


def single_block(W, p: str, s: dict, heads: int, hidden: int) -> dict:
    x = s["x"]
    shift, scale, gate = _mod(W, f"{p}.modulation", s["vec"], 3)
    h = linear((1 + scale) * _layer_norm(x) + shift, W[f"{p}.linear1"])
    attn = _attend([h[:, : 3 * hidden]], heads, s["pe"], [(W[f"{p}.norm.q_scale"], W[f"{p}.norm.k_scale"])])
    out = linear(torch.cat([attn, F.gelu(h[:, 3 * hidden:], approximate="tanh")], dim=-1), W[f"{p}.linear2"])
    return dict(s, x=x + gate * out)


def final_layer(W, s: dict) -> torch.Tensor:
    shift, scale = linear(F.silu(s["vec"]), W["final_layer.adaLN"]).chunk(2, dim=-1)
    x = s["x"][s["n_txt"]:]
    return linear((1 + scale) * _layer_norm(x) + shift, W["final_layer.linear"])


@torch.no_grad()
def evaluate(evals: list[dict], cfg: dict, group_weights, mode: str = "fp32") -> list[torch.Tensor]:
    """The velocity (n_img, out_channels) fp32 of each evaluation's real image
    tokens. evals: dicts of one DiT call's inputs (batch 1, leading axis
    dropped) with n_img / n_txt real tokens; group_weights(group) -> {name:
    fp32 tensor} of one group of reference/weights.flux_groups."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    heads, hidden = cfg["num_heads"], cfg["hidden_size"]

    def weights(group: str, prefix: str = "") -> dict:
        raw = group_weights(group)
        out = {}
        for name, t in raw.items():
            if name.endswith(".weight"):
                base = name[: -len(".weight")]
                out[base] = prepare_linear(t, raw.get(base + ".bias"), name, mode)
            elif not name.endswith(".bias") or name[: -len(".bias")] + ".weight" not in raw:
                out[name] = t
        return out

    W = weights("flux.rest")
    states = [embed(W, e, cfg) for e in evals]
    for s, e in zip(states, evals):
        s["n_txt"] = e["n_txt"]
    for i in range(cfg["depth"]):
        Wb = weights(f"flux.double_blocks.{i}")
        states = [double_block(Wb, f"double_blocks.{i}", s, heads) for s in states]
    for s in states:
        s["x"] = torch.cat([s.pop("txt"), s.pop("img")], dim=0)
    for i in range(cfg["depth_single_blocks"]):
        Wb = weights(f"flux.single_blocks.{i}")
        states = [single_block(Wb, f"single_blocks.{i}", s, heads, hidden) for s in states]
    return [final_layer(W, s) for s in states]
