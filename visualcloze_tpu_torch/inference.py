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

Runtime adapters: --lora NAME=PATH (repeatable; PATH a reference .pth or a
diffusers/peft safetensors LoRA, or `random` with --demo) registers an
unfolded adapter, --adapter NAME applies it to the query, --lora_scale
weighs its delta. The kernels' shared libraries live under --aot_dir
(default $VISUALCLOZE_AOT_DIR, else build/torch_kernels/), where the next
process finds them built; --no_aot rebuilds them.

Across cards (one process per card, launched by torchrun):

  torchrun --nproc_per_node 2 -m visualcloze_tpu_torch.inference --demo --tp 2 -o out.jpg
      --tp N shards the DiT's blocks over N cards (tensor parallelism),
      --fsdp N its weights (FSDP2), --cp N splits the DiT's tokens over N
      cards (ring attention through kernels E and F); the product is
      the number of processes. Every rank runs the query; rank 0 saves it.
--rows takes image paths per grid row (comma-separated, MASK for the target).
"""

from __future__ import annotations

import argparse
import functools

import torch
from PIL import Image

from .device import resolve_device
from .models.lora import init_lora, randomize_lora_b
from .models.quant import quantize_flux_int8, quantize_flux_w8a8, quantize_t5_int4
from .ops import cuda_build
from .pipeline import build_visualcloze, random_components, synthetic_full_components
from .pipeline.loader import convert_lora_any, load_torch_checkpoint, place_model
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
    add_mesh_args(p)
    add_adapter_args(p)
    p.add_argument("--adapter", default=None, help="the runtime adapter (a --lora NAME) this query uses")
    add_aot_args(p)
    p.add_argument("-o", "--output", default="example.jpg")
    return p.parse_args(argv)


def add_adapter_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--lora", action="append", default=[], metavar="NAME=PATH",
                   help="register a runtime LoRA adapter (repeatable): PATH a reference .pth or a diffusers/peft "
                        "safetensors LoRA, or 'random' with --demo (rank 4, B drawn N(0, 0.02))")
    p.add_argument("--lora_scale", type=float, default=1.0, help="weight of the runtime adapters' deltas")


def add_aot_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--aot_dir", default=None,
                   help="directory of the compiled kernels (default $VISUALCLOZE_AOT_DIR, else "
                        "build/torch_kernels/): a later process loads them instead of running nvcc")
    p.add_argument("--no_aot", action="store_true", help="rebuild the kernels (nvcc) instead of loading them")


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel cards for the DiT (torchrun)")
    p.add_argument("--fsdp", type=int, default=1, help="FSDP cards for the DiT's weights (torchrun)")
    p.add_argument("--cp", type=int, default=1, help="ring-attention (sequence-parallel) cards (torchrun)")


def serving_mesh(args, device: torch.device):
    """The (fsdp, tp, cp) serving mesh over the launcher's ranks, or None for
    one card (JAX inference.serving_mesh). It needs tp x fsdp x cp ranks."""
    from .parallel import create_mesh, initialize_distributed

    need = args.tp * args.fsdp * args.cp
    if need <= 1:
        return None
    _, world, _ = initialize_distributed(device)
    if world != need:
        raise SystemExit(f"--tp {args.tp} --fsdp {args.fsdp} --cp {args.cp} needs {need} ranks, found {world} "
                         f"(launch with torchrun --nproc_per_node {need})")
    return create_mesh(fsdp=args.fsdp, tp=args.tp, cp=args.cp, device=device)


def serving_attn_impl(args, mesh):
    """A RingSpec over cp when --cp > 1 (JAX inference.serving_attn_impl), else None."""
    if args.cp <= 1 or mesh is None:
        return None
    from .ops.attention import RingSpec

    return RingSpec(mesh, "cp")


def serving_device(args) -> torch.device:
    """--device, or under torchrun this rank's card."""
    from .parallel.mesh import launch_env

    device = resolve_device(args.device)
    env = launch_env()
    if device.type == "cuda" and env is not None:
        device = torch.device("cuda", env[2])
    return device


def parse_adapters(specs: list[str]) -> dict[str, str]:
    """--lora NAME=PATH specs -> {name: path}; a repeated name is refused."""
    out: dict[str, str] = {}
    for spec in specs:
        if "=" not in spec:
            raise SystemExit(f"--lora expects NAME=PATH, got {spec!r}")
        name, path = spec.split("=", 1)
        if name in out:
            raise SystemExit(f"duplicate --lora adapter name {name!r} ({out[name]!r} vs {path!r})")
        out[name] = path
    return out


def add_adapters(model, args) -> None:
    """Register the --lora adapters on `model` at --lora_scale. `random`
    (with --demo only): init_lora rank 4 and randomize_lora_b, from seeds
    100 + i and 200 + i on the model's device."""
    model.lora_scale = args.lora_scale
    for i, (name, path) in enumerate(parse_adapters(args.lora).items()):
        if path == "random":
            if not args.demo:
                raise SystemExit("--lora NAME=random needs --demo")
            gen = functools.partial(torch.Generator, device=model.device)
            tree = randomize_lora_b(init_lora(model.flux, 4, generator=gen().manual_seed(100 + i)),
                                    gen().manual_seed(200 + i))
        else:
            tree = convert_lora_any(load_torch_checkpoint(path), model.cfg)
        model.add_adapter(name, tree)


def kernel_cache(args, device: torch.device):
    """--aot_dir / --no_aot, before anything launches a kernel: build and
    load the kernels under the directory (VisualClozeModel.enable_aot's);
    with --no_aot on the card, rebuild every kernel now. Returns the
    directory."""
    directory = cuda_build.set_build_dir(args.aot_dir)
    if args.no_aot and device.type == "cuda":
        cuda_build.build(force=True)
    return directory


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


def load_model(args, device: torch.device, mesh=None):
    """The model from checkpoint files (build_visualcloze): bf16 on the card,
    fp32 on the CPU; its DiT on `mesh`."""
    model = build_visualcloze(
        model_path=args.model_path,
        model_name=args.model_name,
        solver=args.solver,
        resolution=args.resolution,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
        quantize=args.quantize,
        device=device,
        mesh=mesh,
        attn_impl=serving_attn_impl(args, mesh),
    )
    if args.t5_int4:
        model.t5.model = quantize_t5_int4(model.t5.model)
    return model


def main(argv=None):
    args = parse_args(argv)
    if not args.demo and not args.rows:
        raise SystemExit("--rows is required (repeat once per grid row, comma-separated cells, MASK for "
                         "the target), e.g. --rows a.png,b.png --rows query.png,MASK")
    device = serving_device(args)
    kernel_cache(args, device)
    mesh = serving_mesh(args, device)
    if args.demo:
        model = place_model(build_model(args, device), mesh, serving_attn_impl(args, mesh))
    else:
        model = load_model(args, device, mesh)
    add_adapters(model, args)
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
        adapter=args.adapter,
    )
    if mesh is None or mesh.device_mesh is None or torch.distributed.get_rank() == 0:
        images[0].save(args.output)
        print(f"saved {args.output} ({images[0].size})")
    return images


if __name__ == "__main__":
    main()
