"""Graph200K test-set evaluation sweep of the port (counterpart of the root
sample.py).

    python -m visualcloze_tpu_torch.sample --test_json test/data.json --model_path visualcloze-384.pth
    python -m visualcloze_tpu_torch.sample --test_json test/data.json --demo --device cpu

Iterates test items x context counts {1, 2, 3} x the evaluation tasks,
builds each grid with the item processor in test mode, masks the target
cell, generates without upsampling, and saves the composite grid and an
incremental data.json manifest (a rerun skips the ids already in it). Every
sample's randomness is a function of (--seed, its id). --demo serves random
weights: full width on the card, the tiny model with --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np
import torch
from PIL import Image

from .data import Graph200KItemProcessor, check_item_graph200k
from .data.prefix_instruction import PROMPT_BANKS, set_prompt_bank, test_task_dicts
from .device import resolve_device
from .pipeline import build_visualcloze, random_components
from .transport.sampling import solver_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None)
    p.add_argument("--model_name", default="flux-dev-fill-lora")
    p.add_argument("--test_json", required=True, help="Graph200K test split data.json")
    p.add_argument("--output_dir", default="./samples")
    p.add_argument("--resolution", type=int, default=384)
    p.add_argument("--lora_rank", type=int, default=256)
    p.add_argument("--guidance", type=float, default=30.0)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--solver", default="euler", type=solver_arg)
    p.add_argument("--prompt_bank", default="reference", choices=list(PROMPT_BANKS),
                   help="prompt template bank; 'reference' (default) draws the strings the released LoRAs "
                        "were trained on")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_items", type=int, default=0)
    p.add_argument("--demo", action="store_true", help="random weights, no checkpoint files")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--shard", type=int, default=0, help="this worker's shard index (items split round-robin)")
    p.add_argument("--num_shards", type=int, default=1,
                   help="sweep workers, each with its own shard of the items and its own manifest")
    return p.parse_args(argv)


def concat_images_grid(rows: list[list[Image.Image]]) -> Image.Image:
    """Compose the full grid into one image for review."""
    widths = [sum(img.width for img in row) for row in rows]
    heights = [max(img.height for img in row) for row in rows]
    canvas = Image.new("RGB", (max(widths), sum(heights)), (255, 255, 255))
    y = 0
    for row, h in zip(rows, heights):
        x = 0
        for img in row:
            canvas.paste(img, (x, y))
            x += img.width
        y += h
    return canvas


def main(argv=None):
    args = parse_args(argv)
    set_prompt_bank(args.prompt_bank)
    random.seed(args.seed)
    np.random.seed(args.seed)
    device = resolve_device(args.device)
    full = device.type == "cuda"
    dtype = torch.bfloat16 if full else torch.float32

    if args.demo:
        resolution = args.resolution if full else 64
        model = random_components(tiny=not full, dtype=dtype, device=device, resolution=resolution)
        model.solver = args.solver
    else:
        model = build_visualcloze(
            model_path=args.model_path, model_name=args.model_name, lora_rank=args.lora_rank,
            resolution=args.resolution, solver=args.solver, device=device, dtype=dtype,
        )
        resolution = args.resolution

    with open(args.test_json) as f:
        items = json.load(f)
    if args.max_items:
        items = items[: args.max_items]

    os.makedirs(args.output_dir, exist_ok=True)
    if args.num_shards > 1:
        assert 0 <= args.shard < args.num_shards
        manifest_path = os.path.join(
            args.output_dir, f"data.{args.shard:02d}-of-{args.num_shards:02d}.json"
        )
    else:
        manifest_path = os.path.join(args.output_dir, "data.json")
    manifest: list[dict] = []
    collected: set[str] = set()
    if os.path.exists(manifest_path):  # resume
        with open(manifest_path) as f:
            manifest = json.load(f)
        collected = {m["id"] for m in manifest}

    processor = Graph200KItemProcessor(resolution=resolution)
    # items passing a row spec, computed once per DISTINCT spec (scanning all
    # N items inside the innermost loop was O(N^2 * tasks) host work)
    pass_cache: dict[tuple, list[int]] = {}

    def passing(row_spec) -> list[int]:
        key = tuple(row_spec)
        if key not in pass_cache:
            pass_cache[key] = [
                k for k, x in enumerate(items) if check_item_graph200k(x, row_spec)
            ]
        return pass_cache[key]

    for item_idx, item in enumerate(items):
        if item_idx % args.num_shards != args.shard:
            continue  # another worker's item (partners still drawn from all)
        for context_num in (1, 2, 3):
            for task in test_task_dicts:
                for row_spec in task["image_list"]:
                    sample_id = f"{item_idx}_{context_num}_{task['task_name']}_{'-'.join(row_spec)}"
                    if sample_id in collected:
                        continue
                    if not check_item_graph200k(item, row_spec):
                        continue
                    partners = [items[k] for k in passing(row_spec) if k != item_idx]
                    if len(partners) < context_num - 1:
                        continue
                    # every per-sample draw (partners, generation seed,
                    # templates) is a function of (--seed, sample_id), so a
                    # resume, another sharding or a rerun draws the same
                    srng = random.Random(f"{args.seed}:{sample_id}")
                    gen_seed = srng.randrange(1, 2**31)  # 0 means "random" downstream
                    records = srng.sample(partners, context_num - 1) + [item]
                    _, image_list, prompts, _, (cols, rows_n) = processor.process_item(
                        records, training_mode=False, image_type_list=list(row_spec),
                        context_num=context_num, group_name="image_grid_graph200k",
                        rng=srng,
                    )
                    image_list[-1][-1] = None  # mask the target
                    try:
                        outs = model.process_images(
                            image_list, prompts, seed=gen_seed, cfg=args.guidance, steps=args.steps,
                            is_upsampling=False, grid_size=(rows_n, cols),
                        )
                    except ValueError as e:  # a query the model refuses; device and kernel faults propagate
                        print(f"[skip] {sample_id}: {e}")
                        continue
                    image_list[-1][-1] = outs[0]
                    grid = concat_images_grid(image_list)
                    out_path = os.path.join(args.output_dir, f"{sample_id}.jpg")
                    grid.save(out_path, quality=92)
                    manifest.append(
                        {"id": sample_id, "image": out_path,
                         "task": task["task_name"], "types": list(row_spec),
                         "context_num": context_num, "prompts": prompts,
                         "seed": gen_seed}
                    )
                    with open(manifest_path, "w") as f:
                        json.dump(manifest, f, indent=1)
                    print(f"[{len(manifest)}] {sample_id}")
    print(f"done: {len(manifest)} samples in {args.output_dir}")


if __name__ == "__main__":
    main()
