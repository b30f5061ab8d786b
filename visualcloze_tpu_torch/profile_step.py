"""Where a denoise step of the default query spends its device time.

    python -m visualcloze_tpu_torch.profile_step [--steps 3] [--out profile_step.json]

Builds the full-width random-weight model in bf16 on the GPU, prepares the
default query (a 2x3 grid at 384: 3456 image + 512 text tokens), times
`--steps` Euler steps with CUDA events, then traces the same steps with
torch.profiler and sums the device time of every CUDA kernel by class:
the DiT's GEMMs (cuBLAS through F.linear), kernel A (the rotation pass and
the attention kernel), and the rest (norms, modulation, RoPE tables,
elementwise and copies). The linears' FLOPs are counted with forward hooks
on one untraced step, so their rate is their FLOPs over their own kernel
time. Prints one JSON object; writes the 30 costliest kernels to --out.
Exits 1 if the trace holds no device events.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .models.layers import Linear
from .pipeline import random_components

ATTENTION_KERNEL = re.compile(r"\b(rope_rotate|flash_fwd)\(")  # demangled csrc/flash_attn_rope.cu
GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass")


def kernel_class(name: str) -> str:
    if ATTENTION_KERNEL.search(name):
        return "attention (kernel A)"
    if any(m in name.lower() for m in GEMM_MARKS):
        return "gemm (linears)"
    return "other"


def default_query(model):
    from PIL import Image

    model.set_grid_size(2, 3)
    cell = Image.new("RGB", (1024, 1024), (120, 180, 90))
    grid = [[cell] * 3, [cell, cell, None]]
    prompts = ["A grid layout with 2 rows and 3 columns, displaying 6 images arranged side by side.",
               "Each row shows a photo and its edited versions.",
               "The content of the last image in the final row is: a photo."]
    return model.prepare_query(grid, prompts, seed=1, steps=30)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default="profile_step.json")
    args = p.parse_args(argv)

    model = random_components(tiny=False, dtype=torch.bfloat16, device="cuda", resolution=384)
    q = default_query(model)
    tokens = q["x"].shape[1] + q["txt"].shape[1]

    def run(n):
        model.denoise_query(dict(q, ts=q["ts"][: n + 1]))

    flops = [0.0]

    def count(mod, inp, out):
        rows = inp[0].numel() // mod.in_features
        flops[0] += 2.0 * rows * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(count) for m in model.flux.modules() if isinstance(m, Linear)]
    run(1)  # warm-up, and the linears' FLOPs of one step
    for h in hooks:
        h.remove()
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

    per_kernel: dict[str, list] = {}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
        acc = per_kernel.setdefault(e.name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    if not spans:
        print(json.dumps({"error": "the trace holds no device events", "step_ms_cuda_events": step_ms}))
        return 1
    busy, cursor = 0.0, None
    for s, e in sorted(spans):  # union of kernel intervals
        if cursor is None or s > cursor:
            busy += e - s
            cursor = e
        elif e > cursor:
            busy += e - cursor
            cursor = e
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    classes: dict[str, float] = {}
    for name, (us, _) in per_kernel.items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + us
    kernel_ms = sum(classes.values()) / 1e3 / args.steps
    gemm_ms = classes.get("gemm (linears)", 0.0) / 1e3 / args.steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = dict(
        device=smi, torch=torch.__version__, tokens=tokens, steps=args.steps,
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
    )
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:30]
    with open(args.out, "w") as f:
        json.dump(dict(result, top=[dict(name=n, ms_per_step=us / 1e3 / args.steps, calls=c)
                                    for n, (us, c) in top]), f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
