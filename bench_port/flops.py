"""Operations and bytes of the served models' work, counted from shapes, and
the card's peaks: the yardstick of query_mfu and the kernels' rooflines.

A unit of work is a tuple logged by the harness: ("dit", n_img, n_txt) one
DiT evaluation over n_img real image and n_txt text tokens; ("vae_encode",
H, W) / ("vae_decode", H, W) one autoencoder call at H x W pixels; ("t5", L)
/ ("clip", L) one prompt of L tokens. Each is broken into operation classes
(linear layers by the precision they run in, attention, convolution) with
their multiply-adds counted twice. Elementwise work (norms, activations,
residual adds) is not counted as operations.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
# the token-dim linears of the DiT's blocks, which a w8a8 configuration runs on int8 activations
A8 = ("qkv", "proj", "mlp.0", "mlp.2", "linear1", "linear2")


def dit_linears(cfg: dict, n_img: int, n_txt: int) -> list[tuple[str, int, int, int]]:
    """(name, rows, in, out) of every linear call of one evaluation."""
    h = cfg["hidden_size"]
    mh = int(h * cfg["mlp_ratio"])
    out = [("img_in", n_img, cfg["in_channels"], h), ("txt_in", n_txt, cfg["context_in_dim"], h),
           ("time_in", 1, 256, h), ("time_in", 1, h, h), ("vector_in", 1, cfg["vec_in_dim"], h),
           ("vector_in", 1, h, h)]
    if cfg["guidance_embed"]:
        out += [("guidance_in", 1, 256, h), ("guidance_in", 1, h, h)]
    for _ in range(cfg["depth"]):
        for n in (n_img, n_txt):
            out += [("mod", 1, h, 6 * h), ("qkv", n, h, 3 * h), ("proj", n, h, h), ("mlp.0", n, h, mh),
                    ("mlp.2", n, mh, h)]
    n = n_img + n_txt
    for _ in range(cfg["depth_single_blocks"]):
        out += [("mod", 1, h, 3 * h), ("linear1", n, h, 3 * h + mh), ("linear2", n, h + mh, h)]
    return out + [("adaLN", 1, h, 2 * h), ("final", n_img, h, cfg["out_channels"])]


def linear_cost(name: str, m: int, k: int, n: int, quant: str | None) -> tuple[str, float, float]:
    """(peak class, operations, bytes) of one linear call; quant None (bf16)
    or "w8a8" (token-dim linears on int8 codes, the others int8 weights)."""
    ops = 2.0 * m * k * n
    if quant == "w8a8" and name in A8:  # codes + row scales in, int8 weight + scales, bf16 out and bias
        return "int8", ops, m * k + 4.0 * m + k * n + 4.0 * n + 2.0 * m * n + 2.0 * n
    if quant == "w8a8":  # bf16 input, int8 weight + scales
        return "bf16", ops, 2.0 * m * k + k * n + 4.0 * n + 2.0 * m * n + 2.0 * n
    return "bf16", ops, 2.0 * (m * k + k * n + m * n + n)


def attention_cost(cfg: dict, n_img: int, n_txt: int) -> tuple[float, float]:
    """(operations, bytes) of one joint attention call: QK^T and PV over the real tokens."""
    L, d = n_img + n_txt, cfg["hidden_size"]
    return 4.0 * L * L * d, 4.0 * L * d * 2


def dit_cost(cfg: dict, n_img: int, n_txt: int, quant: str | None) -> dict[str, list[float]]:
    """{class: [operations, bound seconds]} of one evaluation: "linear.bf16",
    "linear.int8" and "attention"; bound = max(ops / peak, bytes / HBM)."""
    out: dict[str, list[float]] = {}
    for name, m, k, n in dit_linears(cfg, n_img, n_txt):
        peak, ops, nbytes = linear_cost(name, m, k, n, quant)
        acc = out.setdefault(f"linear.{peak}", [0.0, 0.0])
        acc[0] += ops
        acc[1] += max(ops / PEAK[peak], nbytes / HBM_BYTES_PER_S)
    ops, nbytes = attention_cost(cfg, n_img, n_txt)
    per = cfg["depth"] + cfg["depth_single_blocks"]
    out["attention"] = [per * ops, per * max(ops / PEAK["bf16"], nbytes / HBM_BYTES_PER_S)]
    return out


def vae_ops(cfg: dict, part: str, hpx: int, wpx: int) -> float:
    """Convolution and attention operations of one encode or decode at hpx x wpx pixels."""
    ch, mult, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    total = 0.0

    def conv(res_h, res_w, k, cin, cout):
        nonlocal total
        total += 2.0 * res_h * res_w * k * k * cin * cout

    def resnet(rh, rw, cin, cout):
        conv(rh, rw, 3, cin, cout)
        conv(rh, rw, 3, cout, cout)
        if cin != cout:
            conv(rh, rw, 1, cin, cout)

    def mid(rh, rw, c):
        nonlocal total
        resnet(rh, rw, c, c)
        for _ in range(4):
            conv(rh, rw, 1, c, c)
        total += 4.0 * (rh * rw) ** 2 * c
        resnet(rh, rw, c, c)

    n = len(mult)
    if part == "vae_encode":
        conv(hpx, wpx, 3, cfg["in_channels"], ch)
        block_in, rh, rw = ch, hpx, wpx
        for i, m in enumerate(mult):
            for _ in range(nres):
                resnet(rh, rw, block_in, ch * m)
                block_in = ch * m
            if i != n - 1:
                rh, rw = rh // 2, rw // 2
                conv(rh, rw, 3, block_in, block_in)
        mid(rh, rw, block_in)
        conv(rh, rw, 3, block_in, 2 * cfg["z_channels"])
        return total
    f = 2 ** (n - 1)
    rh, rw = hpx // f, wpx // f
    block_in = ch * mult[-1]
    conv(rh, rw, 3, cfg["z_channels"], block_in)
    mid(rh, rw, block_in)
    for i in reversed(range(n)):
        for _ in range(nres + 1):
            resnet(rh, rw, block_in, ch * mult[i])
            block_in = ch * mult[i]
        if i != 0:
            rh, rw = rh * 2, rw * 2
            conv(rh, rw, 3, block_in, block_in)
    conv(rh, rw, 3, block_in, cfg["out_ch"])
    return total


def t5_ops(cfg: dict, L: int) -> float:
    d, kd, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    per = 2.0 * L * d * kd * 4 + 4.0 * L * L * kd + 2.0 * L * d * ff * 3
    return cfg["num_layers"] * per


def clip_ops(cfg: dict, L: int) -> float:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    per = 2.0 * L * d * d * 4 + 4.0 * L * L * d + 2.0 * L * d * ff * 2
    return cfg["num_layers"] * per


def work_cost(config: dict, work: list[tuple]) -> dict[str, list[float]]:
    """{class: [operations, bound seconds]} of logged work units; classes
    "linear.bf16", "linear.int8", "attention", "vae", "text" (the last two
    carry no bound: 0)."""
    quant = config.get("dit_quant")
    out: dict[str, list[float]] = {}

    def add(cls, ops, bound=0.0):
        acc = out.setdefault(cls, [0.0, 0.0])
        acc[0] += ops
        acc[1] += bound

    for unit in work:
        kind = unit[0]
        if kind == "dit":
            for cls, (ops, bound) in dit_cost(config["flux"], unit[1], unit[2], quant).items():
                add(cls, ops, bound)
        elif kind in ("vae_encode", "vae_decode"):
            add("vae", vae_ops(config["vae"], kind, unit[1], unit[2]))
        elif kind == "t5":
            add("text", t5_ops(config["t5"], unit[1]))
        elif kind == "clip":
            add("text", clip_ops(config["clip"], unit[1]))
        else:
            raise ValueError(f"unknown work unit {unit!r}")
    return out


def seconds_at_peak(cost: dict[str, list[float]]) -> float:
    """The least time the card could take for the operations: each class at
    the peak of the precision it runs in (int8 linears at the int8 peak,
    everything else at bf16's)."""
    return sum(ops / PEAK["int8" if cls == "linear.int8" else "bf16"] for cls, (ops, _) in cost.items())
