"""The pipeline's glue between its models, as VisualCloze and FLUX state it:
the token packing of latents and masks, the rectified-flow time grids,
SDEdit's noise mix and the pictures handed from one stage to the next.
check.py rebuilds each hand-off from the stage before it with these."""

from __future__ import annotations

import math

import numpy as np
import torch
from PIL import Image

TIME_SHIFTING_FACTOR = 1.0  # VisualCloze's sampling default: t -> t / (t + f - f t) leaves t as it is
SDEDIT_MAX_PIXELS = 1024 * 1024


def patchify(latent: torch.Tensor) -> torch.Tensor:
    """(h, w, c) latent -> (h/2 * w/2, 4c) tokens, FLUX's "c (h ph) (w pw) -> (h w) (c ph pw)"."""
    h, w, c = latent.shape
    x = latent.reshape(h // 2, 2, w // 2, 2, c).permute(0, 2, 4, 1, 3)  # (h2, w2, c, ph, pw)
    return x.reshape((h // 2) * (w // 2), 4 * c)


def unpatchify(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h/2 * w/2, 4c) tokens -> (h, w, c), the inverse of patchify."""
    c = tokens.shape[-1] // 4
    x = tokens.reshape(h // 2, w // 2, c, 2, 2).permute(0, 3, 1, 4, 2)  # (h2, ph, w2, pw, c)
    return x.reshape(h, w, c)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) pixel mask -> (H/16 * W/16, 256) tokens: each 8x8 pixel block
    to 64 channels (row-major in the block), then patchify."""
    hp, wp = mask.shape
    x = mask.reshape(hp // 8, 8, wp // 8, 8).permute(0, 2, 1, 3).reshape(hp // 8, wp // 8, 64)
    return patchify(x)


def pad_tokens(tokens: torch.Tensor, length: int) -> torch.Tensor:
    """(n, d) tokens with zero rows appended to `length`."""
    out = torch.zeros((length, tokens.shape[1]), dtype=tokens.dtype, device=tokens.device)
    out[: tokens.shape[0]] = tokens
    return out


def _mu(seq_len: int) -> float:
    """FLUX's resolution shift: linear in the image tokens through (256, 0.5) and (4096, 1.15)."""
    m = (1.15 - 0.5) / (4096 - 256)
    return m * seq_len + (0.5 - m * 256)


def time_grid(num_points: int, seq_len: int, shift: bool, strength: float | None = None) -> np.ndarray:
    """The descending grid of flux times a loop evaluates at (1 is noise, 0
    data): num_points evenly in [strength, 1] (SDEdit starts at 1 - strength),
    warped by the time-shifting factor, then as s = 1 - t; with `shift`
    FLUX's exp(mu) / (exp(mu) + 1/s - 1) at the loop's image tokens, ending
    at 0. Float64, handed on as float32."""
    t0 = 0.0 if strength is None else (1.0 - 0.0) * strength + 0.0
    t = np.linspace(t0, 1.0, num_points, dtype=np.float64)
    f = TIME_SHIFTING_FACTOR
    t = t / (t + f - f * t)
    s = 1.0 - t
    if shift:
        with np.errstate(divide="ignore"):
            s = math.exp(_mu(seq_len)) / (math.exp(_mu(seq_len)) + (1.0 / s - 1.0) ** 1.0)
        s[np.isnan(s)] = 0.0
        s[-1] = 0.0
    return s.astype(np.float32)


def sdedit_start(noise_tokens: torch.Tensor, latent_tokens: torch.Tensor, strength: float) -> torch.Tensor:
    """SDEdit's start state in bf16: noise x (1 - s) + latent x s, each
    factor and product rounded to bf16 as the served dtype holds them."""
    bf16 = torch.bfloat16
    a = torch.tensor(1.0 - strength, dtype=bf16, device=noise_tokens.device)
    b = torch.tensor(strength, dtype=bf16, device=noise_tokens.device)
    return noise_tokens.to(bf16) * a + latent_tokens.to(bf16) * b


def to_picture(decoded: torch.Tensor) -> np.ndarray:
    """A decoder's (H, W, 3) output in [-1, 1] -> the uint8 picture it stands for."""
    arr = (decoded.to(torch.float32).cpu().numpy() + 1.0) / 2.0
    arr = np.clip(arr, 0.0, 1.0)
    return (arr * 255.0).round().astype(np.uint8)


def to_pixels(picture: Image.Image) -> np.ndarray:
    """A picture -> (H, W, 3) float32 in [-1, 1], the encoder's input."""
    return np.asarray(picture.convert("RGB"), dtype=np.float32) / 255.0 * 2.0 - 1.0


def crop_cell(picture: np.ndarray, col: int, cols: int) -> Image.Image:
    """Cell `col` of a row picture `cols` cells wide."""
    img = Image.fromarray(picture)
    w, h = img.size
    return img.crop((col * w // cols, 0, (col + 1) * w // cols, h))


def sdedit_size(size: tuple[int, int]) -> tuple[int, int]:
    """SDEdit's output size for the query row's photo size: capped at
    1024^2 pixels at the photo's aspect, both sides floored to 16."""
    w, h = size
    if w * h > SDEDIT_MAX_PIXELS:
        aspect = w / h
        h = int((SDEDIT_MAX_PIXELS / aspect) ** 0.5)
        w = int(h * aspect)
    return w // 16 * 16, h // 16 * 16
