"""Inference CLI of the port (counterpart of inference.py).

Runs one in-context grid through the pipeline and saves the generated cell.

From checkpoint files (the reference flow):

  FLUX_DEV_FILL=flux1-fill-dev.safetensors AE=ae.safetensors \\
  T5_PATH=t5-v1_1-xxl/ CLIP_PATH=clip-vit-large-patch14/ \\
  python -m visualcloze_tpu_torch.inference --model_path visualcloze-384.pth \\
      --rows a.png,b.png --rows query.png,MASK --solver euler -o out.jpg
      reads the FLUX.1-Fill base, folds the VisualCloze LoRA (a reference
      .pth or a diffusers/peft .safetensors) into it on the card, permutes it
      into the half RoPE layout and serves the query through the CUDA
      kernels; --model_path may instead be a diffusers pipeline snapshot
      directory (VisualClozePipeline-384/-512). --quantize int8 serves an
      int8 DiT (every linear through kernel G), --quantize w8a8 a w8a8 one
      (the token-dim block linears through kernels I and H, the rest
      through G), --quantize w8a8_smooth the same after a SmoothQuant
      calibration on a blank 2x2 grid (30 steps), --t5_int4 an int4 T5-XXL.
      The files hold the published widths; --device cpu runs the same flow
      on the CPU (fp32, the kernels' plain versions).

With random weights (no files):

  python -m visualcloze_tpu_torch.inference --demo -o out.jpg
      the full-width FLUX.1-Fill / T5-XXL / CLIP-L / VAE stack in bf16 on the
      GPU, through the CUDA kernels;
  python -m visualcloze_tpu_torch.inference --demo --device cpu -o out.jpg
      a tiny fp32 model on the CPU (the plain PyTorch versions of the
      kernels). The device sets the size: the kernels take the published
      widths only, and the full-width model is too large for the CPU.
  ... --quantize int8 --t5_int4
      the single-card int8 stack: on the GPU the full-width int8 DiT, int4
      T5-XXL, int8 CLIP-L and bf16 VAE (synthetic_full_components); on the
      CPU the tiny model quantized after the fact.
  ... --quantize w8a8 | w8a8_smooth
      the bf16 (GPU) or tiny fp32 (CPU) model with its DiT quantized to
      w8a8 after the fact; w8a8_smooth calibrates first, on a blank 2x2
      grid with 4 Euler steps, statistics every 2nd, as the JAX CLI's demo.

Runtime adapters (--lora, --adapter, --lora_scale: ROADMAP item 2),
multi-card serving (--tp, --fsdp, --cp: item 4) and compiled-program caches
(--aot_dir, --no_aot: item 2) are not ported: they raise
NotImplementedError naming the item.
--rows takes image paths per grid row (comma-separated, MASK for the target).
"""

from __future__ import annotations

import argparse

import torch
from PIL import Image

from .device import resolve_device
from .models.quant import quantize_flux_int8, quantize_flux_w8a8, quantize_t5_int4
from .pipeline import build_visualcloze, random_components, synthetic_full_components
from .transport.sampling import solver_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None,
                   help="VisualCloze LoRA checkpoint, or a diffusers pipeline snapshot directory")
    p.add_argument("--model_name", default="flux-dev-fill-lora")
    p.add_argument("--resolution", type=int, default=384)
    p.add_argument("--lora_rank", type=int, default=256)
    p.add_argument("--demo", action="store_true", help="random weights, no checkpoint files")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--rows", action="append", default=[],
                   help="comma-separated image paths per row; MASK for the target cell")
    p.add_argument("--layout", default=None)
    p.add_argument("--task", default="")
    p.add_argument("--content", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg", type=float, default=30.0)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--upsampling_steps", type=int, default=10)
    p.add_argument("--upsampling_noise", type=float, default=0.4)
    p.add_argument("--no_upsampling", action="store_true")
    p.add_argument("--solver", default="euler", type=solver_arg,
                   help="ODE method: euler, heun, ab2, dopri5, or cached[:K] (K >= 1: the model every "
                        "K-th step, the velocity extrapolated between)")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "w8a8", "w8a8_smooth"],
                   help="int8: weight-only int8 DiT (every linear through kernel G); w8a8: int8 activations "
                        "too in the token-dim block linears (kernels I and H); w8a8_smooth: the same after "
                        "a SmoothQuant calibration")
    p.add_argument("--t5_int4", action="store_true", help="int4 weight-only T5-XXL")
    p.add_argument("--tp", type=int, default=1, help="not ported (ROADMAP item 4)")
    p.add_argument("--fsdp", type=int, default=1, help="not ported (ROADMAP item 4)")
    p.add_argument("--cp", type=int, default=1, help="not ported (ROADMAP item 4)")
    p.add_argument("--lora", action="append", default=[], metavar="NAME=PATH",
                   help="runtime LoRA adapter: not ported (ROADMAP item 2)")
    p.add_argument("--adapter", default=None, help="not ported (ROADMAP item 2)")
    p.add_argument("--lora_scale", type=float, default=1.0, help="not ported (ROADMAP item 2)")
    p.add_argument("--aot_dir", default=None, help="not ported (ROADMAP item 2: CUDA graphs)")
    p.add_argument("--no_aot", action="store_true", help="not ported (ROADMAP item 2: CUDA graphs)")
    p.add_argument("-o", "--output", default="example.jpg")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """The reference CLI's flags the port does not serve yet, by ROADMAP item."""
    if args.lora or args.adapter is not None or args.lora_scale != 1.0:
        raise NotImplementedError("runtime LoRA adapters (--lora, --adapter, --lora_scale) are not ported yet: "
                                  "ROADMAP item 2")
    if max(args.tp, args.fsdp, args.cp) > 1:
        raise NotImplementedError("multi-card serving (--tp, --fsdp, --cp) is not ported yet: ROADMAP item 4")
    if args.aot_dir is not None or args.no_aot:
        raise NotImplementedError("compiled-program caches (--aot_dir, --no_aot) are not ported yet: "
                                  "ROADMAP item 2 (CUDA graphs of the denoise step)")


def build_model(args, device: torch.device):
    """The demo model for `device`: on the card the full-width stack (the
    single-card int8 one with --quantize int8), on the CPU the tiny fp32 one;
    the DiT quantized after the fact as the JAX CLI's --demo does (w8a8_smooth
    after calibrating with steps=4, stride=2)."""
    full = device.type == "cuda"
    resolution = 384 if full else 64
    if full and args.quantize == "int8":
        model = synthetic_full_components(t5_int4=args.t5_int4, device=device, resolution=resolution)
        model.solver = args.solver
        return model
    model = random_components(
        tiny=not full,
        dtype=torch.bfloat16 if full else torch.float32,
        device=device,
        resolution=resolution,
    )
    model.solver = args.solver
    if args.quantize == "w8a8_smooth":
        model.calibrate_w8a8_smooth(steps=4, stride=2)
    elif args.quantize:
        model.flux = {"int8": quantize_flux_int8, "w8a8": quantize_flux_w8a8}[args.quantize](model.flux)
    if args.t5_int4:
        model.t5.model = quantize_t5_int4(model.t5.model)
    return model


def load_model(args, device: torch.device):
    """The model from checkpoint files (build_visualcloze): bf16 on the card,
    fp32 on the CPU."""
    model = build_visualcloze(
        model_path=args.model_path,
        model_name=args.model_name,
        lora_rank=args.lora_rank,
        solver=args.solver,
        resolution=args.resolution,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
        quantize=args.quantize,
        device=device,
    )
    if args.t5_int4:
        model.t5.model = quantize_t5_int4(model.t5.model)
    return model


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    if not args.demo and not args.rows:
        raise SystemExit("--rows is required (repeat once per grid row, comma-separated cells, MASK for "
                         "the target), e.g. --rows a.png,b.png --rows query.png,MASK")
    device = resolve_device(args.device)
    model = build_model(args, device) if args.demo else load_model(args, device)
    resolution = model.resolution
    if args.rows:
        grid = [
            [None if cell.strip() == "MASK" else Image.open(cell.strip()).convert("RGB")
             for cell in row.split(",")]
            for row in args.rows
        ]
    else:
        cell = Image.new("RGB", (resolution, resolution), (120, 180, 90))
        grid = [[cell, cell], [cell, None]]
    grid_h, grid_w = len(grid), len(grid[0])
    model.set_grid_size(grid_h, grid_w)
    layout = args.layout or (
        f"A grid layout with {grid_h} rows and {grid_w} columns, "
        f"displaying {grid_h * grid_w} images arranged side by side."
    )
    images = model.process_images(
        grid, [layout, args.task, args.content],
        seed=args.seed, cfg=args.cfg, steps=args.steps,
        upsampling_steps=args.upsampling_steps, upsampling_noise=args.upsampling_noise,
        is_upsampling=not args.no_upsampling,
    )
    images[0].save(args.output)
    print(f"saved {args.output} ({images[0].size})")


if __name__ == "__main__":
    main()
