"""The plain reference the benchmark judges the program by: float32 PyTorch
and PIL, written from the published models, importing nothing of the
measured package. Weights are drawn again from the seed (weights.py)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def grid_rows(cells: list[list[Image.Image | None]], resolution: int) -> list[np.ndarray]:
    """The pixel rows a square-celled grid becomes: each cell resized to
    resolution^2 (Lanczos), the missing query cell black, values in [-1, 1]."""
    side = resolution // 16 * 16
    rows = []
    for row in cells:
        arrs = []
        for img in row:
            cell = Image.new("RGB", (side, side)) if img is None else img.resize((side, side), Image.LANCZOS)
            arrs.append(np.asarray(cell, dtype=np.float32) / 255.0 * 2.0 - 1.0)
        rows.append(np.concatenate(arrs, axis=1))
    return rows
