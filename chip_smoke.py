#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each followed by one flushed JSON line on stdout:
  env        the card (nvidia-smi name and power limit), torch and CUDA versions;
  build      the CUDA kernels of visualcloze_tpu_torch/csrc, one nvcc per source
             in parallel, with ptxas' register/spill report;
  kernel     each kernel against its plain PyTorch version at main-path shapes
             (bf16, on the card): max |err| beside the tolerance (attention:
             4 bf16 ulps at the largest output, and kernel A's padded keys
             against fp32 attention that never sees them; conv: 1% of the
             largest output), the kernel's,
             the plain version's and a PyTorch library call's ms (CUDA events),
             and the bound from the H100 SXM data sheet (989 TFLOP/s bf16 dense,
             3.35 TB/s);
  reference  the full-width DiT and VAE through the kernels against the same
             modules through the plain versions, on a small input;
  request    full-width random weights (FLUX.1-Fill 19+38 blocks at hidden
             3072, T5-XXL, CLIP-L, VAE) in bf16; two queries through
             VisualClozeModel.process_images: a 2x3 grid at 384 with SDEdit
             (30 + 10 steps, the default query) and a 3x3 grid at 384 without
             (5760 tokens with padding, so kernel A's bias path runs). Launch
             counters are zeroed just before and read just after.
Then the kernels line, the nvidia-smi line, and {"ok": true, "device": ...}
last. Exits non-zero, with no result line, without a CUDA device, outside a
checkout of the repository, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

T0 = time.perf_counter()
TIME_LIMIT_S = 1200
PEAK_FLOPS = 989e12  # H100 SXM, bf16 dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
REPLACES = {
    "flash_attn_rope": "visualcloze_tpu/ops/flash_attention.py:487",
    "flash_attn_d512": "visualcloze_tpu/ops/flash_attention.py:575",
    "conv3x3_gn_swish": "visualcloze_tpu/ops/conv2d.py:147",
}
SOURCES = {
    "flash_attn_rope": "visualcloze_tpu_torch/csrc/flash_attn_rope.cu",
    "flash_attn_d512": "visualcloze_tpu_torch/csrc/flash_attn_d512.cu",
    "conv3x3_gn_swish": "visualcloze_tpu_torch/csrc/conv3x3_gn_swish.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def elapsed() -> float:
    return time.perf_counter() - T0


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_ulps_tol(want, ulps: int = 4) -> float:
    """`ulps` bf16 ulps at the output's largest magnitude (8 significant bits):
    the attention kernels round q, k, P and the output to bf16 and sum in
    another order, measured at 1-2 ulps."""
    import math

    top = want.abs().max().item()
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def attention_over_keys(q, k, v, cos, sin, n: int):
    """fp32 softmax(rot(q) rot(k)[:n]^T / sqrt(D)) v[:n]: attention that never
    sees the keys from n on, to hold the padding bias against."""
    import torch

    from visualcloze_tpu_torch.ops import flash_attention as fa

    q32, k32 = fa._rot_half(q.float(), cos, sin), fa._rot_half(k.float(), cos, sin)[..., :n, :]
    s = torch.matmul(q32, k32.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v[..., :n, :].float())


# ----------------------------- kernel checks -----------------------------


def check_attention_rope(L: int, padded: bool, reps: int) -> dict:
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops import flash_attention as fa
    from visualcloze_tpu_torch.ops.attention import mask_to_bias
    from visualcloze_tpu_torch.ops.rope import apply_rope_half

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(L)
    b, h, d = (2 if padded else 1), 24, 128
    q, k, v = (torch.randn((b, h, L, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    ang = torch.rand((b, L, d // 2), generator=g, device=dev) * 40.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    bias = None
    valid = [L] * b
    if padded:  # batch 0: the last 64 keys are padding; batch 1: every key masked
        mask = torch.ones((b, L), dtype=torch.int32, device=dev)
        mask[0, L - 64:] = 0
        mask[1] = 0
        bias = mask_to_bias(mask)
        valid = [L - 64, 0]
    got = fa.flash_attn_rope(q, k, v, bias, cos, sin)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, bias, cos, sin)
    err = (got.float() - want.float()).abs().max().item()
    tol = bf16_ulps_tol(want)
    rms = want.float().pow(2).mean().sqrt().item()
    del want
    masked_zero, pad_err = True, None
    if padded:  # batch 0 against attention over its first L - 64 keys only
        masked_zero = bool((got[1] == 0).all().item())
        want0 = attention_over_keys(q[:1], k[:1], v[:1], cos[:1], sin[:1], L - 64)
        pad_err = (got[:1].float() - want0).abs().max().item()
        del want0
    ms = cuda_ms(lambda: fa.flash_attn_rope(q, k, v, bias, cos, sin), reps)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias, cos, sin), 2)
    qr, kr = apply_rope_half(q, cos[:, None], sin[:, None]), apply_rope_half(k, cos[:, None], sin[:, None])
    amask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=amask), reps)
    flops = sum(4.0 * h * L * n * d for n in valid)
    nbytes = 4 * b * h * L * d * 2 + 2 * b * L * (d // 2) * 4 + (b * L * 4 if padded else 0)
    bms, by = bound(flops, nbytes)
    return dict(name="flash_attn_rope", shape=[b, h, L, d], bias=padded, max_abs_err=err, tol=tol,
                rms_plain=rms, padded_keys_err=pad_err,
                ok=err <= tol and masked_zero and (pad_err is None or pad_err <= tol),
                masked_batch_zero=masked_zero, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library="F.scaled_dot_product_attention on pre-rotated q, k",
                bound_ms=bms, bound_by=by)


def check_attention_d512(L: int, reps: int) -> dict:
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(L)
    q, k, v = (torch.randn((1, 1, L, 512), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    got = fa.flash_attn_d512(q, k, v)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    tol = bf16_ulps_tol(want)
    rms = want.float().pow(2).mean().sqrt().item()
    del want
    ms = cuda_ms(lambda: fa.flash_attn_d512(q, k, v), reps)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 2)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps)
    bms, by = bound(4.0 * L * L * 512, 4 * L * 512 * 2)
    return dict(name="flash_attn_d512", shape=[1, 1, L, 512], max_abs_err=err, tol=tol, rms_plain=rms,
                ok=err <= tol,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, library="F.scaled_dot_product_attention",
                bound_ms=bms, bound_by=by)


def check_conv(shape, pre: bool, reps: int) -> dict:
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops import conv2d as cv

    B, H, W, C, Co = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(H * W + C)
    x = torch.randn((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, C, Co), generator=g, device=dev) * (9 * C) ** -0.5).to(torch.bfloat16)
    b = torch.randn((Co,), generator=g, device=dev) * 0.1
    aff = None
    if pre:
        aff = (torch.rand((B, C), generator=g, device=dev) + 0.5, torch.randn((B, C), generator=g, device=dev))
    act = "swish" if pre else "none"
    got = cv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act=act)
    torch.cuda.synchronize()
    want = cv.conv3x3_plain(x, w, b, aff, act)
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-2 * want.abs().max().item()  # bf16 in, fp32 sums of 9*C terms in another order
    del want
    ms = cuda_ms(lambda: cv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act=act), reps)
    plain_ms = cuda_ms(lambda: cv.conv3x3_plain(x, w, b, aff, act), 2)
    x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC tensor
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b16 = b.to(torch.bfloat16)
    if pre:
        a4, o4 = aff[0].to(torch.bfloat16)[:, :, None, None], aff[1].to(torch.bfloat16)[:, :, None, None]
        lib = lambda: F.conv2d(F.silu(x_nchw * a4 + o4), w_oihw, b16, padding=1)  # noqa: E731
    else:
        lib = lambda: F.conv2d(x_nchw, w_oihw, b16, padding=1)  # noqa: E731
    library_ms = cuda_ms(lib, reps)
    bms, by = bound(2.0 * B * H * W * C * Co * 9, (B * H * W * (C + Co) + 9 * C * Co) * 2 + Co * 4)
    return dict(name="conv3x3_gn_swish", shape=[B, H, W, C, Co], act=act, max_abs_err=err, tol=tol,
                ok=err <= tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library="F.conv2d(F.silu(x * a + b0)) bf16 channels_last" if pre else "F.conv2d bf16",
                bound_ms=bms, bound_by=by)


# ----------------------------- reference on a small input -----------------------------


def reference_checks(model) -> dict:
    """The full-width DiT and VAE through the kernels vs through the plain
    versions (same weights, same small input); relative RMS error."""
    import torch

    import visualcloze_tpu_torch.models.autoencoder as ae_mod
    import visualcloze_tpu_torch.ops.attention as att_mod
    from visualcloze_tpu_torch.ops import conv2d as cv
    from visualcloze_tpu_torch.ops import flash_attention as fa

    dev = model.device
    g = torch.Generator(device=dev).manual_seed(3)
    cfg = model.cfg
    l_img, l_txt = 256, 64
    ids = torch.zeros((1, l_img, 3), device=dev)
    ids[..., 0] = 1
    ids[..., 1] = (torch.arange(l_img, device=dev) // 16).float()
    ids[..., 2] = (torch.arange(l_img, device=dev) % 16).float()
    inp = dict(
        img=torch.randn((1, l_img, cfg.in_channels), generator=g, device=dev).to(torch.bfloat16),
        img_ids=ids,
        txt=torch.randn((1, l_txt, cfg.context_in_dim), generator=g, device=dev).to(torch.bfloat16),
        txt_ids=torch.zeros((1, l_txt, 3), device=dev),
        timesteps=torch.full((1,), 0.5, device=dev).to(torch.bfloat16),
        y=torch.randn((1, cfg.vec_in_dim), generator=g, device=dev).to(torch.bfloat16),
        guidance=torch.full((1,), 30.0, device=dev).to(torch.bfloat16),
    )
    z = torch.randn((1, 16, 32, model.ae.cfg.z_channels), generator=g, device=dev).to(torch.bfloat16)

    def run():
        return model.flux(**inp).float(), model.ae.decode(z).float()

    dit_k, vae_k = run()
    saved = (att_mod.flash_attn_rope, ae_mod.conv3x3_gn_swish, ae_mod.flash_attn_d512)
    att_mod.flash_attn_rope = fa.flash_attention_plain
    ae_mod.conv3x3_gn_swish = lambda x, w, b, pre_affine=None, act="swish": cv.conv3x3_plain(
        x, w, b, pre_affine, act)
    ae_mod.flash_attn_d512 = fa.flash_attention_plain
    try:
        dit_p, vae_p = run()
    finally:
        att_mod.flash_attn_rope, ae_mod.conv3x3_gn_swish, ae_mod.flash_attn_d512 = saved

    def rel(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    out = dict(dit_rel_rms_err=rel(dit_k, dit_p), vae_rel_rms_err=rel(vae_k, vae_p),
               finite=bool(torch.isfinite(dit_k).all() and torch.isfinite(vae_k).all()))
    # bf16 roundings of 57 blocks (resp. ~30 VAE layers) in another order
    out["tol"] = 5e-2
    out["ok"] = out["finite"] and out["dit_rel_rms_err"] <= out["tol"] and out["vae_rel_rms_err"] <= out["tol"]
    return out


# ----------------------------- the main path -----------------------------


def synthetic_grid(rows: int, cols: int, seed: int):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)

    def cell():
        base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        return Image.fromarray(base).resize((1024, 1024), Image.BILINEAR)

    grid = [[cell() for _ in range(cols)] for _ in range(rows)]
    grid[-1][-1] = None
    return grid


def run_request(model, name, rows, cols, steps, upsampling, seed) -> dict:
    import torch

    from visualcloze_tpu_torch import ops

    samples = []
    orig = model.denoise_query

    def recording(q, stage="denoise"):
        out = orig(q, stage)
        samples.append((stage, tuple(q["x"].shape), out))
        return out

    model.denoise_query = recording
    grid = synthetic_grid(rows, cols, seed)
    model.set_grid_size(rows, cols)
    prompts = [
        f"A grid layout with {rows} rows and {cols} columns, displaying {rows * cols} images arranged side by side.",
        "Each row shows a photo and its edited versions.",
        "The content of the last image in the final row is: a photo.",
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    try:
        images = model.process_images(grid, prompts, seed=seed, steps=steps, upsampling_steps=10,
                                      upsampling_noise=0.4, is_upsampling=upsampling)
        torch.cuda.synchronize()
    finally:
        model.denoise_query = orig
    seconds = time.perf_counter() - t0
    launches = ops.kernel_launches()
    import numpy as np

    arrs = [np.asarray(im) for im in images]
    finite = all(bool(torch.isfinite(s).all()) for _, _, s in samples)
    want_size = (1024, 1024) if upsampling else (384, 384)
    out = dict(
        phase="request", name=name, grid=[rows, cols], steps=steps, sdedit_steps=10 if upsampling else 0,
        seconds=seconds, stage_seconds=model.stage_seconds,
        sequences=[{"stage": st, "tokens_img": shp[1]} for st, shp, _ in samples],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        images=[list(im.size) for im in images], latents_finite=finite,
        image_std=[float(a.std()) for a in arrs], launches=launches,
    )
    out["ok"] = (finite and len(images) == 1 and images[0].size == want_size
                 and all(s > 0 for s in out["image_std"]) and all(n > 0 for n in launches.values()))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.ops import cuda_build
    from visualcloze_tpu_torch.pipeline import random_components

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    emit(dict(phase="env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
              tf32_matmul=False, tf32_cudnn=False))

    secs = cuda_build.build(force=True)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in cuda_build.BUILD_LOG.items()}
    emit(dict(phase="build", seconds=max(secs.values()), per_source=secs, ptxas=ptxas))

    checks = [
        lambda: check_attention_rope(3968, False, 20),
        lambda: check_attention_rope(4608, False, 20),
        lambda: check_attention_rope(5760, True, 10),
        lambda: check_attention_d512(6912, 10),
        lambda: check_attention_d512(16384, 5),
        lambda: check_conv((1, 384, 1152, 128, 128), True, 10),  # encoder/decoder level 0
        lambda: check_conv((1, 192, 576, 128, 256), True, 10),   # encoder level 1, first conv
        lambda: check_conv((1, 96, 288, 512, 512), False, 10),   # decoder upsample conv
        lambda: check_conv((1, 48, 144, 512, 512), True, 20),    # bottleneck
        lambda: check_conv((1, 1024, 1024, 128, 128), True, 5),  # SDEdit image, level 0
    ]
    first = {}
    for fn in checks:
        r = fn()
        emit(dict(phase="kernel", **r))
        if not r["ok"]:
            raise RuntimeError(f"kernel check failed: {r}")
        first.setdefault(r["name"], r)
    torch.cuda.empty_cache()

    t = time.perf_counter()
    model = random_components(tiny=False, dtype=torch.bfloat16, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0), resolution=384)
    torch.cuda.synchronize()
    emit(dict(phase="init", seconds=time.perf_counter() - t,
              params_gib=torch.cuda.memory_allocated() / 2 ** 30,
              depth=[model.cfg.depth, model.cfg.depth_single_blocks], hidden=model.cfg.hidden_size))

    ref = reference_checks(model)
    emit(dict(phase="reference", **ref))
    if not ref["ok"]:
        raise RuntimeError(f"reference check failed: {ref}")

    r1 = run_request(model, "2x3 default query with SDEdit", 2, 3, 30, True, seed=1)
    emit(r1)
    if not r1["ok"]:
        raise RuntimeError("request 1 failed")
    # cut the second request's steps, never its width or depth, if time runs short
    per_step = r1["stage_seconds"].get("denoise", 60.0) / 29
    budget = TIME_LIMIT_S * 0.75 - elapsed() - 60
    steps2 = int(max(2, min(30, 1 + budget / (per_step * 1.6))))
    r2 = run_request(model, "3x3 query, padded to 5760 tokens", 3, 3, steps2, False, seed=2)
    emit(r2)
    if not r2["ok"]:
        raise RuntimeError("request 2 failed")

    kernels = []
    for name, r in first.items():
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=r1["launches"][name] + r2["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
        ))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as exc:  # report the failed phase, then fail
        traceback.print_exc()
        emit({"phase": "failed", "error": f"{type(exc).__name__}: {exc}", "elapsed_s": elapsed()})
        code = 1
    sys.exit(code)
