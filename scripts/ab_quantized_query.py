"""The default query on the w8a8 and int4 DiTs, another checkout against this one, in turns.

    python scripts/ab_quantized_query.py OTHER_CHECKOUT

Each turn is a fresh process in one checkout, in the order other, this,
this, other. It builds that checkout's kernels and its full-width stack
from seed 0 (`pipeline.random_components`: FLUX.1-Fill 19 + 38 blocks at
hidden 3072, T5-XXL, CLIP-L, the VAE, bf16), quantizes the DiT to w8a8
(`quantize_flux_w8a8`: kernels I and H, and G) and to int4
(`quantize_flux_int4`: kernel G4) beside the bf16 one, and serves with each
in turn the query `chip_smoke.py`'s `request_w8a8` and `request_int4`
serve: a 2x3 grid at 384 (seed 1), 30 Euler steps, then SDEdit at 1024^2
with 10, after one warm-up query (a 2x2 grid, 3 steps, no SDEdit). The
query and the timing are this file's code, the same in both checkouts.

One JSON line per DiT and turn: the query's seconds (host clock around
`process_images`, synchronised), its stage seconds, the peak device memory,
and a hash of the output image's pixels (the same inputs in every turn:
equal digests say that the two checkouts computed the same image). Then the
card's name and power limit. Needs a CUDA card with room for the bf16
stack and both quantized DiTs (~55 GB); compare two checkouts only within
one run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TURN = r'''
import hashlib, json, time
import numpy as np
import torch
from PIL import Image

from visualcloze_tpu_torch.models.quant import quantize_flux_int4, quantize_flux_w8a8
from visualcloze_tpu_torch.ops import cuda_build
from visualcloze_tpu_torch.pipeline import random_components

cuda_build.build()
model = random_components(tiny=False, dtype=torch.bfloat16, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0), resolution=384)
dits = {"w8a8": quantize_flux_w8a8(model.flux), "int4": quantize_flux_int4(model.flux)}
torch.cuda.synchronize()


def grid(rows, cols, seed):
    rng = np.random.default_rng(seed)
    cells = [[Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).resize((1024, 1024), Image.BILINEAR)
              for _ in range(cols)] for _ in range(rows)]
    cells[-1][-1] = None
    return cells


def query(rows, cols, seed, steps, upsampling):
    model.set_grid_size(rows, cols)
    prompts = [f"A grid layout with {rows} rows and {cols} columns, displaying {rows * cols} images arranged side "
               "by side.", "Each row shows a photo and its edited versions.",
               "The content of the last image in the final row is: a photo."]
    cells = grid(rows, cols, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    images = model.process_images(cells, prompts, seed=seed, steps=steps, upsampling_steps=10,
                                  upsampling_noise=0.4, is_upsampling=upsampling)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, images


for name, flux in dits.items():
    model.flux = flux
    query(2, 2, 5, 3, False)  # warm-up
    seconds, images = query(2, 3, 1, 30, True)
    print(json.dumps(dict(dit=name, seconds=seconds, stage_seconds=model.stage_seconds,
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                          image=list(images[0].size),
                          digest=hashlib.sha1(np.asarray(images[0]).tobytes()).hexdigest()[:16])), flush=True)
'''


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout to compare with (it builds its own kernels)")
    args = p.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": HERE}
    for turn in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", TURN], cwd=trees[turn], capture_output=True, text=True)
        for line in out.stdout.splitlines():
            print(json.dumps({"tree": turn, **json.loads(line)}), flush=True)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
