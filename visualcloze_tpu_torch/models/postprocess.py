"""Output postprocessing of the BFL tools route: an invisible watermark and
gated image saving (counterpart of visualcloze_tpu/models/postprocess.py).

The watermark is a blind block-DCT mark in numpy and cv2 carrying the
reference's fixed 48-bit payload in the blue channel, with its extractor;
the NSFW gate is the ViT-base classifier tower (models/vision_towers.py) on
local weights.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# the fixed 48-bit message, bits as in the reference
WATERMARK_MESSAGE = 0b001010101111111010000111100111001111010100101000
WATERMARK_BITS = [int(b) for b in bin(WATERMARK_MESSAGE)[2:].zfill(48)]

_BLOCK = 8
_COEF_A, _COEF_B = (3, 1), (1, 3)  # the mid-frequency DCT coefficient pair


def _iter_blocks(h: int, w: int):
    for by in range(h // _BLOCK):
        for bx in range(w // _BLOCK):
            yield by * _BLOCK, bx * _BLOCK


def embed_watermark(image: np.ndarray, strength: float = 6.0) -> np.ndarray:
    """The 48-bit payload in the blue channel's 8x8 block DCT: uint8 RGB
    (H, W, 3) -> a watermarked copy. A bit orders the (3, 1) / (1, 3)
    coefficient pair at least `strength` apart; the payload repeats over
    every whole block."""
    import cv2

    out = image.astype(np.float32).copy()
    chan = out[..., 2]
    h, w = chan.shape
    for i, (y, x) in enumerate(_iter_blocks(h, w)):
        bit = WATERMARK_BITS[i % len(WATERMARK_BITS)]
        block = cv2.dct(chan[y: y + _BLOCK, x: x + _BLOCK])
        a, b = block[_COEF_A], block[_COEF_B]
        if bit and a - b < strength:
            mid = (a + b) / 2
            block[_COEF_A], block[_COEF_B] = mid + strength / 2, mid - strength / 2
        elif not bit and b - a < strength:
            mid = (a + b) / 2
            block[_COEF_A], block[_COEF_B] = mid - strength / 2, mid + strength / 2
        chan[y: y + _BLOCK, x: x + _BLOCK] = cv2.idct(block)
    out[..., 2] = chan
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def extract_watermark_score(image: np.ndarray) -> float:
    """The fraction of blocks whose coefficient order matches the payload
    (0.5 at random, near 1.0 watermarked)."""
    import cv2

    chan = image.astype(np.float32)[..., 2]
    h, w = chan.shape
    match = total = 0
    for i, (y, x) in enumerate(_iter_blocks(h, w)):
        bit = WATERMARK_BITS[i % len(WATERMARK_BITS)]
        block = cv2.dct(chan[y: y + _BLOCK, x: x + _BLOCK])
        match += (1 if block[_COEF_A] > block[_COEF_B] else 0) == bit
        total += 1
    return match / max(total, 1)


def build_nsfw_classifier(path: str | None = None, nsfw_label: int = 1, model=None, cfg=None, device=None):
    """A callable PIL -> p(nsfw) from the ViT classifier tower: `model` (a
    vision_towers.ViTClassifier), else the HF snapshot at `path` or
    NSFW_MODEL_PATH (a ViT classifier such as Falconsai/nsfw_image_detection,
    whose label 1 is "nsfw") loaded onto `device` (None: the card). None
    when no weights are found: the gate is then off."""
    from .vision_towers import ViTClassifierConfig, convert_vit_classifier, vit_classify, vit_preprocess

    if model is None:
        path = path or os.environ.get("NSFW_MODEL_PATH")
        if not path or not os.path.exists(path):
            return None
        from .image_embedders import _load_state

        model = convert_vit_classifier(_load_state(path), cfg or ViTClassifierConfig(), device)
    cfg = model.cfg

    @torch.no_grad()
    def nsfw_prob(img) -> float:
        probs = torch.softmax(vit_classify(model, vit_preprocess(img, cfg.image_size)), dim=-1)
        return float(probs[0, nsfw_label])

    return nsfw_prob


def save_image(image, path: str, add_watermark: bool = True, nsfw_classifier=None, nsfw_threshold: float = 0.85,
               metadata: dict | None = None) -> str | None:
    """The NSFW gate (a callable PIL -> p(nsfw), e.g. build_nsfw_classifier's;
    None skips it), the watermark, and a save with EXIF Software and
    ImageDescription tags. Returns the path, or None when the gate rejects
    the image."""
    from PIL import Image

    if nsfw_classifier is not None and float(nsfw_classifier(image)) >= nsfw_threshold:
        return None
    arr = np.asarray(image.convert("RGB"))
    if add_watermark:
        arr = embed_watermark(arr)
    out = Image.fromarray(arr)
    exif = out.getexif()
    exif[0x0131] = "visualcloze-tpu"  # Software
    if metadata:
        exif[0x010E] = str(metadata)  # ImageDescription
    out.save(path, exif=exif)
    return path
