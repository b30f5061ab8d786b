"""The benchmark's weights: what each tensor is, and how it is drawn from the seed.

Every model is a list of groups (a block, or the tensors outside the blocks),
each a list of (name, shape, mean, std). A group is drawn on the device in one
call: a torch.Generator seeded from (seed, group name) fills one fp32 buffer
with N(0, 1), each tensor is its slice times std plus mean, rounded once to
the served dtype. So the harness fills the program's modules group by group,
and the reference draws any one block again, alone, to the same bits. The
names are the parameter names of the measured package's modules; the harness
checks that they match exactly.

Linear and conv weights are N(0, 1/fan_in) (T5's q: its own init, below),
biases N(0, 0.02), norm scales N(1, 0.1): every bias and scale is nonzero,
so a path that drops one shows.
"""

from __future__ import annotations

import hashlib
import math

import torch

BIAS_STD = 0.02
SCALE_STD = 0.1


def _linear(name: str, d_in: int, d_out: int, bias: bool = True) -> list[tuple]:
    out = [(f"{name}.weight", (d_out, d_in), 0.0, d_in ** -0.5)]
    if bias:
        out.append((f"{name}.bias", (d_out,), 0.0, BIAS_STD))
    return out


def flux_groups(cfg: dict) -> list[tuple[str, list[tuple]]]:
    h = cfg["hidden_size"]
    mh = int(h * cfg["mlp_ratio"])
    d = h // cfg["num_heads"]
    qkv_bias = cfg["qkv_bias"]
    rest = (_linear("img_in", cfg["in_channels"], h) + _linear("txt_in", cfg["context_in_dim"], h)
            + _linear("time_in.in_layer", 256, h) + _linear("time_in.out_layer", h, h)
            + _linear("vector_in.in_layer", cfg["vec_in_dim"], h) + _linear("vector_in.out_layer", h, h))
    if cfg["guidance_embed"]:
        rest += _linear("guidance_in.in_layer", 256, h) + _linear("guidance_in.out_layer", h, h)
    rest += _linear("final_layer.linear", h, cfg["out_channels"]) + _linear("final_layer.adaLN", h, 2 * h)
    groups = [("flux.rest", rest)]
    for i in range(cfg["depth"]):
        p = f"double_blocks.{i}"
        entries = []
        for s in ("img", "txt"):
            entries += _linear(f"{p}.{s}_mod.lin", h, 6 * h)
            entries += _linear(f"{p}.{s}_attn.qkv", h, 3 * h, qkv_bias) + _linear(f"{p}.{s}_attn.proj", h, h)
            entries += [(f"{p}.{s}_attn.norm.q_scale", (d,), 1.0, SCALE_STD),
                        (f"{p}.{s}_attn.norm.k_scale", (d,), 1.0, SCALE_STD)]
            entries += _linear(f"{p}.{s}_mlp.0", h, mh) + _linear(f"{p}.{s}_mlp.2", mh, h)
        groups.append((f"flux.{p}", entries))
    for i in range(cfg["depth_single_blocks"]):
        p = f"single_blocks.{i}"
        entries = (_linear(f"{p}.linear1", h, 3 * h + mh) + _linear(f"{p}.linear2", h + mh, h)
                   + [(f"{p}.norm.q_scale", (d,), 1.0, SCALE_STD), (f"{p}.norm.k_scale", (d,), 1.0, SCALE_STD)]
                   + _linear(f"{p}.modulation.lin", h, 3 * h))
        groups.append((f"flux.{p}", entries))
    return groups


def t5_groups(cfg: dict) -> list[tuple[str, list[tuple]]]:
    dm, kd, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    groups = [("t5.rest", [("embed", (cfg["vocab_size"], dm), 0.0, 1.0),
                           ("relative_attention_bias", (cfg["relative_attention_num_buckets"], cfg["num_heads"]),
                            0.0, 0.1),
                           ("final_ln", (dm,), 1.0, SCALE_STD)])]
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}"
        # q drawn at T5's own init scale, 1/sqrt(d_model * d_kv): its attention is unscaled, and at
        # 1/sqrt(d_model) its logits would spread by sqrt(d_kv) and every softmax be a near-tie argmax
        entries = [(f"{p}.attn.ln", (dm,), 1.0, SCALE_STD), (f"{p}.attn.q.weight", (kd, dm), 0.0, (dm * cfg["d_kv"]) ** -0.5)]
        for n in ("k", "v"):
            entries += _linear(f"{p}.attn.{n}", dm, kd, bias=False)
        entries += _linear(f"{p}.attn.o", kd, dm, bias=False)
        entries += [(f"{p}.ffn.ln", (dm,), 1.0, SCALE_STD)]
        entries += _linear(f"{p}.ffn.wi_0", dm, ff, bias=False) + _linear(f"{p}.ffn.wi_1", dm, ff, bias=False)
        entries += _linear(f"{p}.ffn.wo", ff, dm, bias=False)
        groups.append((f"t5.{p}", entries))
    return groups


def _layer_norm(name: str, d: int) -> list[tuple]:
    return [(f"{name}.scale", (d,), 1.0, SCALE_STD), (f"{name}.bias", (d,), 0.0, BIAS_STD)]


def clip_groups(cfg: dict) -> list[tuple[str, list[tuple]]]:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    groups = [("clip.rest", [("token_embed", (cfg["vocab_size"], d), 0.0, 0.02),
                             ("pos_embed", (cfg["max_length"], d), 0.0, 0.01)] + _layer_norm("final_ln", d))]
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}"
        entries = _layer_norm(f"{p}.ln1", d)
        for n in ("q", "k", "v", "o"):
            entries += _linear(f"{p}.attn.{n}", d, d)
        entries += _layer_norm(f"{p}.ln2", d) + _linear(f"{p}.fc1", d, ff) + _linear(f"{p}.fc2", ff, d)
        groups.append((f"clip.{p}", entries))
    return groups


def _conv(name: str, k: int, cin: int, cout: int) -> list[tuple]:
    return [(f"{name}.w", (k, k, cin, cout), 0.0, (k * k * cin) ** -0.5), (f"{name}.b", (cout,), 0.0, BIAS_STD)]


def _resnet(name: str, cin: int, cout: int) -> list[tuple]:
    out = _layer_norm(f"{name}.norm1", cin) + _conv(f"{name}.conv1", 3, cin, cout)
    out += _layer_norm(f"{name}.norm2", cout) + _conv(f"{name}.conv2", 3, cout, cout)
    if cin != cout:
        out += _conv(f"{name}.nin_shortcut", 1, cin, cout)
    return out


def _mid(name: str, c: int) -> list[tuple]:
    attn = _layer_norm(f"{name}.attn_1.norm", c)
    for n in ("q", "k", "v", "proj_out"):
        attn += _conv(f"{name}.attn_1.{n}", 1, c, c)
    return _resnet(f"{name}.block_1", c, c) + attn + _resnet(f"{name}.block_2", c, c)


def vae_groups(cfg: dict) -> list[tuple[str, list[tuple]]]:
    ch, mult, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    enc = _conv("encoder.conv_in", 3, cfg["in_channels"], ch)
    block_in = ch
    for i, m in enumerate(mult):
        block_in = ch * ((1,) + tuple(mult))[i]
        for j in range(nres):
            enc += _resnet(f"encoder.down.{i}.block.{j}", block_in, ch * m)
            block_in = ch * m
        if i != len(mult) - 1:
            enc += _conv(f"encoder.down.{i}.downsample.conv", 3, block_in, block_in)
    enc += _mid("encoder.mid", block_in) + _layer_norm("encoder.norm_out", block_in)
    enc += _conv("encoder.conv_out", 3, block_in, 2 * cfg["z_channels"])
    block_in = ch * mult[-1]
    dec = _conv("decoder.conv_in", 3, cfg["z_channels"], block_in) + _mid("decoder.mid", block_in)
    for i in reversed(range(len(mult))):
        for j in range(nres + 1):
            dec += _resnet(f"decoder.up.{i}.block.{j}", block_in, ch * mult[i])
            block_in = ch * mult[i]
        if i != 0:
            dec += _conv(f"decoder.up.{i}.upsample.conv", 3, block_in, block_in)
    dec += _layer_norm("decoder.norm_out", block_in) + _conv("decoder.conv_out", 3, block_in, cfg["out_ch"])
    return [("ae.encoder", enc), ("ae.decoder", dec)]


GROUPS = {"flux": flux_groups, "t5": t5_groups, "clip": clip_groups, "ae": vae_groups}


def group_seed(seed: int, group: str) -> int:
    """A 63-bit generator seed from the run's seed and the group's name."""
    digest = hashlib.sha256(f"{int(seed)}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


@torch.no_grad()
def draw_group(seed: int, group: str, entries: list[tuple], device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """{name: tensor in dtype} of one group, drawn on `device` in one call."""
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    total = sum(math.prod(shape) for _, shape, _, _ in entries)
    z = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for name, shape, mean, std in entries:
        n = math.prod(shape)
        out[name] = (z[off:off + n].view(shape) * std + mean).to(dtype)
        off += n
    return out
