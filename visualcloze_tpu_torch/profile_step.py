"""Where a denoise step of the default query (or a LoRA train step, or the
query's VAE work) spends its device time.

    python -m visualcloze_tpu_torch.profile_step [--steps 3] [--out profile_step.json] [--train | --quantize int8|w8a8|int4 | --vae]

Builds the full-width random-weight model in bf16 on the GPU, prepares the
default query (a 2x3 grid at 384: 3456 image + 512 text tokens), times
`--steps` Euler steps with CUDA events, then traces the same steps with
torch.profiler and sums the device time of every CUDA kernel by class:
the DiT's GEMMs (cuBLAS through F.linear), the attention (kernel D, or
kernel A with its rotation pass a class of its own), kernels J-M (the blocks' LayerNorm-modulate, gated
residual, head split with q/k norm, head merge with gelu) and, in a train
step, their backward kernels J'-M' and J'-L''s column sums, and the rest
(the modulation and embedders' small ops, RoPE tables, the LoRA-free glue,
casts and copies). The linears' FLOPs are counted with forward hooks
on one untraced step, so their rate is their FLOPs over their own kernel
time. Prints one JSON object (device ms and kernel launches per class and
step, idle share, and the "other" class split by kernel name: its 12
costliest kernels); writes the 30 costliest kernels to --out.
Exits 1 if the trace holds no device events.

--quantize int8 profiles the same step of the single-card int8 stack
(synthetic_full_components: int8 DiT, int4 T5, int8 CLIP), whose linears are
kernel G instead of cuBLAS GEMMs. --quantize w8a8 profiles it on the
random bf16 model with its DiT quantized to w8a8 (quantize_flux_w8a8): the
token-dim block linears are kernel H, the others G; H takes the codes that
J, M and O (gelu + quantize) write (classes of their own), and kernel I
quantizes only off that fused route (a LoRA entry, a tp shard, autograd). --quantize int4
profiles it with the DiT quantized to int4 (quantize_flux_int4, the bf16 DiT
freed): every linear is kernel G4.

--train profiles the trainer's step instead: the same model in the
interleaved layout with a rank-128 LoRA, per-block remat "full", one
micro-batch of random tokens of the default query's size per step (3456
image + 512 text); attention is then kernels E (forward) and F (backward).

--vae profiles the default query's VAE work instead, on the full-width VAE
alone (random weights, bf16): its vae_encode and vae_decode stages (two
384x1152 rows encoded, two decoded) and the VAE calls of sdedit_prepare and
sdedit_decode (the 1024^2 image and a blank one encoded, one decoded). Each
part is timed with CUDA events (mean of --steps), then all are traced once;
device time is summed as kernel B (GroupNorm affine + swish + conv3x3),
kernel C (the D = 512 attention), kernel N (GroupNorm statistics and apply)
and other (the plain convs, resampling, residual adds, casts; the
GroupNorm passes of a tree without kernel N). The traced pass wraps the autoencoder's
functions in profiler ranges (VAE_SPANS) and splits "other" by the range
that launched each kernel (other_by_span: GroupNorm statistics, GroupNorm
apply + swish, plain convs, residual adds, upsampling, padding, attention
glue; "unlabeled" is the rest), and names its 12 costliest kernels
(other_by_kernel).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .models.layers import Int4DiTLinear, Int8Linear, Linear, W8A8Linear
from .models.quant import quantize_flux_int4, quantize_flux_w8a8
from .pipeline import random_components, synthetic_full_components

# demangled names of csrc/flash_attn_rope.cu (A, D, E) and flash_attn_bwd.cu (F)
ATTENTION_KERNEL = re.compile(r"\bflash_fwd[<(]")
ROPE_PASS_KERNEL = re.compile(r"\brope_rotate[<(]")  # kernel A's rotation pass
LSE_KERNEL = re.compile(r"\bflash_fwd<true>")
BACKWARD_KERNEL = re.compile(r"\bflash_bwd_(dq|dkv)\(")
# csrc/int8_matmul.cu: its GEMV body, and the shared wide body (weight_only_wide.cuh) with G's policy
INT8_KERNEL = re.compile(r"\bint8_(matmul\w*|gemv)<|\bmatmul_wide<[^,]*\bInt8Convert\b")
INT4_KERNEL = re.compile(r"\bint4_gemv<|\bmatmul_wide<[^,]*\bInt4Convert\b")  # csrc/int4_matmul.cu (G4)
W8A8_KERNEL = re.compile(r"\bw8a8_matmul_kernel[<(]")  # csrc/w8a8_matmul.cu (H)
ACT_QUANT_KERNEL = re.compile(r"\bact_quant_kernel<")  # csrc/act_quant_int8.cu (I)
# the w8a8 DiT's fused route: J and M writing their consumer linears' codes (layernorm_modulate.cu,
# merge_heads.cu) and kernel O, gelu + quantize (gelu_act_quant.cu)
QUANT_FUSION_KERNELS = ((re.compile(r"\bln_modulate_quant_kernel<"), "layernorm modulate + quantize (kernel J, codes)"),
                        (re.compile(r"\bmerge_heads_quant_kernel[<(]"), "head merge + quantize (kernel M, codes)"),
                        (re.compile(r"\bgelu_act_quant_kernel\("), "gelu + quantize (kernel O)"))
# the DiT blocks' fused passes: csrc/layernorm_modulate.cu (J), gated_residual.cu (K), qk_norm_split.cu (L),
# merge_heads.cu (M), and their backward kernels, csrc/*_bwd.cu (J'-M'; J', K' and L''s second pass, the
# fixed-order column sums of colsum.cuh, is a class of its own)
FUSION_KERNELS = ((re.compile(r"\bln_modulate_kernel<"), "layernorm modulate (kernel J)"),
                  (re.compile(r"\bgated_residual_kernel\("), "gated residual (kernel K)"),
                  (re.compile(r"\bqk_norm_split_kernel\("), "head split + q/k norm (kernel L)"),
                  (re.compile(r"\bmerge_heads_kernel\("), "head merge + gelu (kernel M)"),
                  (re.compile(r"\bln_modulate_bwd_kernel<"), "layernorm modulate backward (kernel J')"),
                  (re.compile(r"\bgated_residual_bwd_kernel\("), "gated residual backward (kernel K')"),
                  (re.compile(r"\bqk_norm_split_bwd_kernel\("), "head split + q/k norm backward (kernel L')"),
                  (re.compile(r"\bmerge_heads_bwd_kernel\("), "head merge + gelu backward (kernel M')"),
                  (re.compile(r"\bcolumn_sums\("), "column sums (J', K', L')"))
GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass")
CONV_KERNEL = re.compile(r"\bconv3x3_kernel<")  # csrc/conv3x3_gn_swish.cu (B)
D512_KERNEL = re.compile(r"\bflash_d512")  # csrc/flash_attn_d512.cu (C)
GROUP_NORM_KERNEL = re.compile(r"\bgroup_norm_(stats|apply|fused)\w*[<(]")  # csrc/group_norm.cu (N)
# profiler ranges around models/autoencoder.py's functions in the traced VAE pass: (owner, attribute, span);
# a kernel counts to the innermost range that launched it; an attribute a tree lacks is skipped (swish: a
# tree without kernel N applies it apart)
VAE_SPANS = ((None, "group_norm_affine", "group norm statistics"), (None, "group_norm", "group norm apply + swish"),
             (None, "swish", "group norm apply + swish"), (None, "conv2d", "plain conv + bias"),
             (None, "_gn_swish_conv", "resnet residual add"), ("Upsample", "forward", "upsample repeat"),
             ("Downsample", "forward", "downsample pad"), ("AttnBlock", "forward", "attention glue"))
SPAN_PREFIX = "vae_span::"
VAE_ROW, VAE_SDEDIT = (384, 1152), (1024, 1024)  # the default query's rows and its SDEdit image
OTHER_TOP = 12  # the "other" class's kernels named in a step's result, costliest first


def kernel_class(name: str) -> str:
    if W8A8_KERNEL.search(name):
        return "w8a8 matmul (kernel H)"
    if ACT_QUANT_KERNEL.search(name):
        return "activation quantize (kernel I)"
    for pattern, cls in QUANT_FUSION_KERNELS:
        if pattern.search(name):
            return cls
    if INT8_KERNEL.search(name):
        return "int8 matmul (kernel G)"
    if INT4_KERNEL.search(name):
        return "int4 matmul (kernel G4)"
    if LSE_KERNEL.search(name):
        return "attention forward (kernel E)"
    if BACKWARD_KERNEL.search(name):
        return "attention backward (kernel F)"
    if ROPE_PASS_KERNEL.search(name):
        return "rotation pass (kernel A)"
    if ATTENTION_KERNEL.search(name):
        return "attention (kernel A or D)"
    for pattern, cls in FUSION_KERNELS:
        if pattern.search(name):
            return cls
    if any(m in name.lower() for m in GEMM_MARKS):
        return "gemm (linears)"
    return "other"


def vae_class(name: str) -> str:
    if CONV_KERNEL.search(name):
        return "conv (kernel B)"
    if D512_KERNEL.search(name):
        return "attention (kernel C)"
    if GROUP_NORM_KERNEL.search(name):
        return "group norm (kernel N)"
    return "other"


@contextlib.contextmanager
def vae_spans():
    """Wrap the autoencoder's functions named in VAE_SPANS in profiler ranges
    while the block runs."""
    from .models import autoencoder

    saved = []
    for owner_name, attr, span in VAE_SPANS:
        owner = autoencoder if owner_name is None else getattr(autoencoder, owner_name)
        fn = getattr(owner, attr, None)
        if fn is None:
            continue

        @functools.wraps(fn)
        def spanned(*args, _fn=fn, _span=SPAN_PREFIX + span, **kwargs):
            with torch.profiler.record_function(_span):
                return _fn(*args, **kwargs)

        saved.append((owner, attr, fn))
        setattr(owner, attr, spanned)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def other_by_span(prof) -> dict[str, float]:
    """Device ms of the "other" VAE class by the innermost VAE_SPANS range
    that launched each kernel."""

    def own_us(ev):
        us = sum(k.duration for k in ev.kernels if vae_class(k.name) == "other")
        return us + sum(own_us(ch) for ch in ev.cpu_children if not ch.name.startswith(SPAN_PREFIX))

    out: dict[str, float] = {}
    for ev in prof.events():
        if ev.name.startswith(SPAN_PREFIX):
            span = ev.name[len(SPAN_PREFIX):]
            out[span] = out.get(span, 0.0) + own_us(ev) / 1e3
    return out


def device_time(prof) -> tuple[dict[str, list], float, float]:
    """({kernel name: [us, calls]}, busy us (the union of kernel intervals),
    window us) of the CUDA kernels in a torch.profiler trace."""
    per_kernel: dict[str, list] = {}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith(SPAN_PREFIX):
            continue  # a VAE_SPANS range's device-side copy is no kernel
        spans.append((e.time_range.start, e.time_range.end))
        acc = per_kernel.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    busy, cursor = 0.0, None
    for s, e in sorted(spans):
        if cursor is None or s > cursor:
            busy += e - s
            cursor = e
        elif e > cursor:
            busy += e - cursor
            cursor = e
    window = max(e for _, e in spans) - min(s for s, _ in spans) if spans else 0.0
    return per_kernel, busy, window


def vae_work(ae, generator) -> dict:
    """{part: run()} for the default query's VAE work: "rows" encodes and
    decodes the two 384x1152 rows (vae_encode, vae_decode); "sdedit" encodes
    the 1024^2 image and a blank one and decodes one (sdedit_prepare,
    sdedit_decode). Inputs are made once from `generator`."""
    dev = next(ae.parameters()).device
    f, z = ae.cfg.downsample_factor, ae.cfg.z_channels

    def inputs(h, w):
        x = torch.rand((1, h, w, 3), generator=generator, device=dev) * 2 - 1
        return x, torch.randn((1, h // f, w // f, z), generator=generator, device=dev)

    rows = [inputs(*VAE_ROW) for _ in range(2)]
    sdedit = [inputs(*VAE_SDEDIT) for _ in range(2)]

    def run_rows():
        for lat in [ae.encode(x, eps) for x, eps in rows]:
            ae.decode(lat)

    def run_sdedit():
        lat = [ae.encode(x, eps) for x, eps in sdedit]
        ae.decode(lat[0])

    return {"rows": run_rows, "sdedit": run_sdedit}


def vae_profile(ae, generator, reps: int) -> dict:
    """CUDA-event ms of each part of vae_work (mean of `reps`, after a
    warm-up), then one traced pass of every part: device ms by class
    (vae_class), launches, idle share, "other" split (other_by_span,
    other_by_kernel) and the 20 costliest kernels; each part's peak GiB of
    device memory."""
    parts = vae_work(ae, generator)
    for run in parts.values():
        run()
    torch.cuda.synchronize()
    part_ms, part_peak = {}, {}
    for name, run in parts.items():
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        part_ms[name] = start.elapsed_time(end) / reps
        part_peak[name] = torch.cuda.max_memory_allocated() / 2**30
    with vae_spans(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for run in parts.values():
            run()
        torch.cuda.synchronize()
    per_kernel, busy, window = device_time(prof)
    if not per_kernel:
        return {"error": "the trace holds no device events", "part_ms_cuda_events": part_ms}
    classes: dict[str, list] = {}
    for name, (us, n) in per_kernel.items():
        acc = classes.setdefault(vae_class(name), [0.0, 0])
        acc[0] += us / 1e3
        acc[1] += n
    kernel_ms = sum(ms for ms, _ in classes.values())
    total_ms = sum(part_ms.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    other = sorted(((n, v) for n, v in per_kernel.items() if vae_class(n) == "other"), key=lambda kv: -kv[1][0])
    spans = other_by_span(prof)
    spans["unlabeled"] = classes.get("other", [0.0])[0] - sum(spans.values())
    return dict(
        part_ms_cuda_events=part_ms, part_peak_gib=part_peak, ms_cuda_events=total_ms, kernel_ms_traced=kernel_ms,
        class_ms={k: ms for k, (ms, _) in sorted(classes.items())},
        class_share={k: ms / kernel_ms for k, (ms, _) in sorted(classes.items())},
        class_launches={k: n for k, (_, n) in sorted(classes.items())},
        device_idle_share=1.0 - kernel_ms / total_ms, device_idle_share_traced=1.0 - busy / window,
        other_by_span=dict(sorted(spans.items(), key=lambda kv: -kv[1])),
        other_by_kernel=[dict(name=n[:160], ms=us / 1e3, calls=c) for n, (us, c) in other[:OTHER_TOP]],
        top=[dict(name=n, ms=us / 1e3, calls=c) for n, (us, c) in top],
    )


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main_vae(args) -> int:
    from .config import AutoEncoderConfig
    from .models.autoencoder import build_autoencoder

    gen = torch.Generator(device="cuda").manual_seed(0)
    ae = build_autoencoder(AutoEncoderConfig(), torch.device("cuda"), torch.bfloat16).init_random_(gen)
    result = vae_profile(ae, gen, args.steps)
    result = dict(device=smi_line(), torch=torch.__version__, mode="vae", reps=args.steps, **result)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    result.pop("top", None)
    print(json.dumps(result), flush=True)
    return 0 if "error" not in result else 1


def default_query(model):
    from PIL import Image

    model.set_grid_size(2, 3)
    cell = Image.new("RGB", (1024, 1024), (120, 180, 90))
    grid = [[cell] * 3, [cell, cell, None]]
    prompts = ["A grid layout with 2 rows and 3 columns, displaying 6 images arranged side by side.",
               "Each row shows a photo and its edited versions.",
               "The content of the last image in the final row is: a photo."]
    return model.prepare_query(grid, prompts, seed=1, steps=30)


def train_runner():
    """(run(n): n LoRA train steps, tokens per step) of the full-width trainer."""
    from .models.lora import init_lora
    from .training.remat_probe import synthetic_batch
    from .training.step import init_train_state, make_optimizer, make_train_step
    from .transport import create_transport

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = random_components(tiny=False, dtype=torch.bfloat16, device="cuda", generator=gen,
                              rope_layout="interleaved")
    opt = make_optimizer()
    state = init_train_state(model.flux, init_lora(model.flux, 128, generator=gen), opt, "lora")
    step = make_train_step(create_transport("Linear", "velocity", snr_type="lognorm"), opt, "lora",
                           ema_decay=None, remat=True, remat_policy=None, rope_layout="interleaved")
    batch = synthetic_batch(model.cfg, 3456, 512, torch.device("cuda"), gen)

    def run(n):
        for _ in range(n):
            step(state, batch, gen)

    return model, run, 3456 + 512


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default="profile_step.json")
    p.add_argument("--train", action="store_true", help="profile a LoRA train step, not a denoise step")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "w8a8", "int4"],
                   help="int8: the denoise step of the single-card int8 stack (kernel G); w8a8: of the "
                        "bf16 model with a w8a8 DiT (kernels I, H and G); int4: with an int4 DiT (kernel G4)")
    p.add_argument("--vae", action="store_true", help="profile the default query's VAE work (kernels B, C and N)")
    args = p.parse_args(argv)
    if args.train and args.quantize:
        p.error("--quantize profiles a denoise step; the trainer trains the bf16 DiT")
    if args.vae and (args.train or args.quantize):
        p.error("--vae profiles the VAE alone")
    if args.vae:
        return main_vae(args)

    if args.train:
        model, run, tokens = train_runner()
    else:
        if args.quantize == "int8":
            model = synthetic_full_components(t5_int4=True, device="cuda", resolution=384)
        else:
            model = random_components(tiny=False, dtype=torch.bfloat16, device="cuda", resolution=384)
            if args.quantize == "w8a8":
                model.flux = quantize_flux_w8a8(model.flux)
            elif args.quantize == "int4":
                model.flux = quantize_flux_int4(model.flux)
                torch.cuda.empty_cache()  # the bf16 DiT is gone
        q = default_query(model)
        tokens = q["x"].shape[1] + q["txt"].shape[1]

        def run(n):
            model.denoise_query(dict(q, ts=q["ts"][: n + 1]))

    flops = [0.0]

    def count(mod, inp, out):
        rows = inp[0].numel() // mod.in_features
        flops[0] += 2.0 * rows * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(count) for m in model.flux.modules()
             if isinstance(m, (Linear, Int8Linear, W8A8Linear, Int4DiTLinear))]
    run(1)  # warm-up, and the linears' FLOPs of one step
    for h in hooks:
        h.remove()
    if args.train:  # the hooks saw the forward and its recomputation; the backward does 2x the forward
        flops[0] *= 2  # (the LoRA factors' products are not counted)
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(args.steps)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(args.steps)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    per_kernel, busy, window = device_time(prof)
    if not per_kernel:
        print(json.dumps({"error": "the trace holds no device events", "step_ms_cuda_events": step_ms}))
        return 1
    classes: dict[str, float] = {}
    counts: dict[str, int] = {}
    for name, (us, calls) in per_kernel.items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + us
        counts[kernel_class(name)] = counts.get(kernel_class(name), 0) + calls
    kernel_ms = sum(classes.values()) / 1e3 / args.steps
    gemm_ms = sum(classes.get(k, 0.0) for k in ("gemm (linears)", "int8 matmul (kernel G)", "int4 matmul (kernel G4)",
                                                "w8a8 matmul (kernel H)")) / 1e3 / args.steps
    result = dict(
        device=smi_line(), torch=torch.__version__, mode="train" if args.train else "denoise", quantize=args.quantize,
        tokens=tokens,
        steps=args.steps,
        step_ms_cuda_events=step_ms, step_ms_traced_host=traced_ms,
        kernel_ms_per_step=kernel_ms,
        class_ms_per_step={k: v / 1e3 / args.steps for k, v in sorted(classes.items())},
        class_share={k: v / 1e3 / args.steps / kernel_ms for k, v in sorted(classes.items())},
        device_idle_share_traced=1.0 - busy / window,
        # the traced kernels' time against the untraced steps' CUDA-event time
        device_idle_share=1.0 - kernel_ms / step_ms,
        linear_tflop_per_step=flops[0] / 1e12,
        linear_tflops_rate=flops[0] / (gemm_ms * 1e-3) / 1e12 if gemm_ms else None,
        kernels_per_step=sum(n for _, n in per_kernel.values()) / args.steps,
        class_kernels_per_step={k: v / args.steps for k, v in sorted(counts.items())},
    )
    # "other" split by kernel name: its costliest kernels (names cut to 160 characters)
    other = sorted(((n, us, c) for n, (us, c) in per_kernel.items() if kernel_class(n) == "other"),
                   key=lambda t: -t[1])[:OTHER_TOP]
    result["other_by_kernel"] = [dict(name=n[:160], ms_per_step=us / 1e3 / args.steps, calls_per_step=c / args.steps)
                                 for n, us, c in other]
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:30]
    with open(args.out, "w") as f:
        json.dump(dict(result, top=[dict(name=n, ms_per_step=us / 1e3 / args.steps, calls=c)
                                    for n, (us, c) in top]), f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
