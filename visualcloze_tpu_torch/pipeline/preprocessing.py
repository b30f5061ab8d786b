"""Host-side grid preprocessing (a copy of visualcloze_tpu/pipeline/preprocessing.py,
kept here so that the port imports nothing of the JAX package).

Mirrors the reference's pixel-exact resize/crop rules (visualcloze.py:16-75,
298-360) — these determine output fidelity, so the logic is replicated
rule-for-rule: per-row reference sizing, aspect-preserving area resize to
resolution^2 with /16-divisible dims, center-crop of non-reference cells,
black placeholders + mask for missing query cells, and the multi-mask width
normalization.

Everything here is PIL/numpy on the host: data preparation, not device work.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def to_rgb_if_rgba(img: Image.Image) -> Image.Image:
    """util/imgproc.to_rgb_if_rgba parity: composite RGBA over white."""
    if img.mode == "RGBA":
        background = Image.new("RGB", img.size, (255, 255, 255))
        background.paste(img, mask=img.split()[3])
        return background
    return img.convert("RGB") if img.mode != "RGB" else img


def center_crop(image: Image.Image, target_size: tuple[int, int]) -> Image.Image:
    """ref visualcloze.py:16-25."""
    width, height = image.size
    new_width, new_height = target_size
    left = (width - new_width) // 2
    top = (height - new_height) // 2
    return image.crop((left, top, left + new_width, top + new_height))


def resize_with_aspect_ratio(
    img: Image.Image,
    resolution: int,
    divisible: int = 16,
    aspect_ratio: float | None = None,
) -> Image.Image:
    """Area ~= resolution^2, aspect kept, dims /16 (ref visualcloze.py:28-75)."""
    w, h = img.size
    if aspect_ratio is None:
        aspect_ratio = w / h
    target_area = resolution * resolution
    new_h = int((target_area / aspect_ratio) ** 0.5)
    new_w = int(new_h * aspect_ratio)
    new_w = max(new_w // divisible, 1) * divisible
    new_h = max(new_h // divisible, 1) * divisible
    return img.resize((new_w, new_h), Image.LANCZOS)


def image_to_array(img: Image.Image) -> np.ndarray:
    """PIL -> (H, W, 3) float32 in [-1, 1] (the reference's
    ToTensor+Normalize(0.5, 0.5), visualcloze.py:133-137), NHWC."""
    arr = np.asarray(to_rgb_if_rgba(img), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def array_to_image(arr: np.ndarray) -> Image.Image:
    """(H, W, 3) float in [0, 1] -> PIL (to_pil_image parity)."""
    arr = np.clip(np.asarray(arr, dtype=np.float32), 0.0, 1.0)
    return Image.fromarray((arr * 255.0).round().astype(np.uint8))


def preprocess_grid(
    images: list[list[Image.Image | None]],
    grid_h: int,
    grid_w: int,
    resolution: int,
) -> tuple[list[Image.Image], list[int], tuple[int, int] | None, tuple[int, int] | None]:
    """Resize/crop the grid (ref visualcloze.py:298-360).

    Returns (processed_images flat row-major, mask_position (query row,
    1=masked cell), target_size, upsampling_size).
    """
    images = [
        [img.convert("RGB") if img is not None else None for img in row] for row in images
    ]
    processed: list[Image.Image] = []
    mask_position: list[int] = []
    target_size = None
    upsampling_size = None

    for i in range(grid_h):
        reference_size = None
        ref_j, ref_resized = None, None  # reuse the reference cell's LANCZOS
        for j in range(grid_w):
            if images[i][j] is not None:
                if i == grid_h - 1 and upsampling_size is None:
                    upsampling_size = images[i][j].size
                ref_resized = resize_with_aspect_ratio(images[i][j], resolution)
                reference_size = ref_resized.size
                ref_j = j
                if i == grid_h - 1 and target_size is None:
                    target_size = reference_size
                break
        for j in range(grid_w):
            if images[i][j] is not None:
                target = (
                    ref_resized if j == ref_j
                    else resize_with_aspect_ratio(images[i][j], resolution)
                )
                if target.width <= target.height:
                    target = target.resize(
                        (reference_size[0], int(reference_size[0] / target.width * target.height))
                    )
                    target = center_crop(target, reference_size)
                else:
                    target = target.resize(
                        (int(reference_size[1] / target.height * target.width), reference_size[1])
                    )
                    target = center_crop(target, reference_size)
                processed.append(target)
                if i == grid_h - 1:
                    mask_position.append(0)
            else:
                if reference_size:
                    blank = Image.new("RGB", reference_size, (0, 0, 0))
                else:
                    blank = Image.new("RGB", (resolution, resolution), (0, 0, 0))
                processed.append(blank)
                if i == grid_h - 1:
                    mask_position.append(1)
                else:
                    raise ValueError("Please provide each image in the in-context example.")

    # multi-mask width normalization (ref visualcloze.py:350-360; the 384
    # fallback is the reference's literal constant, not this pipeline's
    # resolution setting — kept for pixel-exact parity)
    if len(mask_position) > 1 and sum(mask_position) > 1:
        new_w = 384 if target_size is None else target_size[0]
        for i in range(len(processed)):
            if processed[i] is not None:
                new_h = int(processed[i].height * (new_w / processed[i].width))
                new_w16 = int(new_w / 16) * 16
                new_h16 = int(new_h / 16) * 16
                processed[i] = processed[i].resize((new_w16, new_h16))

    return processed, mask_position, target_size, upsampling_size


def build_grid_rows(
    processed: list[Image.Image],
    mask_position: list[int],
    grid_h: int,
    grid_w: int,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Concatenate each row horizontally; build pixel masks
    (ref visualcloze.py:363-374).

    Returns (row_images [(H, W_row, 3) float32 in [-1,1]],
             row_masks  [(H, W_row) float32 0/1]).
    """
    row_images, row_masks = [], []
    for i in range(grid_h):
        cells = processed[i * grid_w : (i + 1) * grid_w]
        arrs = [image_to_array(img) for img in cells]
        row = np.concatenate(arrs, axis=1)
        masks = []
        for j, arr in enumerate(arrs):
            fill = float(mask_position[j]) if i == grid_h - 1 else 0.0
            masks.append(np.full(arr.shape[:2], fill, dtype=np.float32))
        row_images.append(row)
        row_masks.append(np.concatenate(masks, axis=1))
    return row_images, row_masks
