"""Inference CLI of the port (counterpart of inference.py --demo).

Runs one in-context grid through the pipeline and saves the generated cell.
No checkpoints are in the repository, so the model has random weights:

  python -m visualcloze_tpu_torch.inference --demo -o out.jpg
      the full-width FLUX.1-Fill / T5-XXL / CLIP-L / VAE stack in bf16 on the
      GPU, through the CUDA kernels;
  python -m visualcloze_tpu_torch.inference --demo --device cpu -o out.jpg
      a tiny fp32 model on the CPU (the plain PyTorch versions of the
      kernels). The device sets the size: the kernels take the published
      widths only, and the full-width model is too large for the CPU.

--rows takes image paths per grid row (comma-separated, MASK for the target).
"""

from __future__ import annotations

import argparse

import torch
from PIL import Image

from .device import resolve_device
from .pipeline import random_components


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--demo", action="store_true", help="random weights (required: no checkpoints)")
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
    p.add_argument("-o", "--output", default="example.jpg")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.demo:
        raise SystemExit("no checkpoints can be loaded yet: pass --demo (random weights)")
    device = resolve_device(args.device)
    full = device.type == "cuda"
    resolution = 384 if full else 64
    model = random_components(
        tiny=not full,
        dtype=torch.bfloat16 if full else torch.float32,
        device=device,
        resolution=resolution,
    )
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
