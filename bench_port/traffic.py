"""The one traffic generator: it reads a mix's parameters from
traffic/<mix>.json and makes that mix's queries from the run's seed.

A mix is a closed loop of one client sending grid queries: "cycle" lists
the grid shapes [rows, cols] in the order they are sent, repeated for as
long as the window lasts, so every seed sends the same shapes in the same
proportions and the seed draws only pictures, prompts and noise. Each cell
of a grid is a smooth random photo of image_size^2 pixels (random colours
on a coarse grid, upsampled bilinearly) drawn from a pool made once per
run; the last cell of the last row is the masked query. The three prompts
are the layout, task and content templates of "prompts", filled in. Query
seeds are drawn from the run's seed and are never 0 (0 asks the pipeline
for a random seed).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
POOL = 16  # distinct photos per run
COARSE = 32  # the photos' random grid before upsampling


def load_mix(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def _rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, int(seed) // 2 ** 63, sum(map(ord, stream)), len(stream)])


class Traffic:
    """The queries of one mix under one seed: query(i) is the i-th sent."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        rng = _rng(seed, "pool")
        size = mix["image_size"]
        self.pool = [Image.fromarray(rng.integers(0, 256, (COARSE, COARSE, 3), dtype=np.uint8)).resize(
            (size, size), Image.BILINEAR) for _ in range(POOL)]

    @property
    def cycle(self) -> list[tuple[int, int]]:
        return [tuple(s) for s in self.mix["cycle"]]

    def shapes(self) -> list[tuple[int, int]]:
        """The distinct grid shapes of the mix, in first-sent order."""
        return list(dict.fromkeys(self.cycle))

    def query(self, i: int) -> dict:
        rows, cols = self.cycle[i % len(self.cycle)]
        rng = _rng(self.seed + i, "query")
        picks = rng.integers(0, POOL, rows * cols)
        grid = [[self.pool[picks[r * cols + c]] for c in range(cols)] for r in range(rows)]
        grid[-1][-1] = None
        p = self.mix["prompts"]

        def pick(options):
            return options[int(rng.integers(len(options)))]

        layout = pick(p["layout"]).format(rows=rows, cols=cols, total=rows * cols)
        task = pick(p["task"]).format(condition_prompt=pick(p["condition"]), target_prompt=pick(p["target"]))
        content = pick(p["content"]) + pick(p["target"]) + "."
        m = self.mix
        return dict(index=i, grid=grid, shape=(rows, cols), prompts=[layout, task, content],
                    seed=int(rng.integers(1, 2 ** 31 - 1)), image_size=m["image_size"], cfg=m["cfg"], steps=m["steps"],
                    upsampling=m["upsampling"], upsampling_steps=m["upsampling_steps"],
                    upsampling_noise=m["upsampling_noise"])
