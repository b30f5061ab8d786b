"""Latent <-> token packing (counterpart of visualcloze_tpu/ops/packing.py).

Latents are NHWC; token features follow the reference's channel-first
(c, ph, pw) order: token[k] = latent[c, 2y + ph, 2x + pw] with k = 4c + 2ph + pw.
"""

from __future__ import annotations

import numpy as np
import torch


def patchify(latent: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/2 * W/2, 4C) tokens, feature order (c, ph, pw)."""
    *lead, h, w, c = latent.shape
    assert h % 2 == 0 and w % 2 == 0, (h, w)
    x = latent.reshape(*lead, h // 2, 2, w // 2, 2, c)
    x = torch.movedim(x, (-4, -2), (-2, -1))  # (..., h2, w2, c, ph, pw)
    return x.reshape(*lead, (h // 2) * (w // 2), c * 4)


def unpatchify(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`patchify`: (..., h/2 * w/2, 4C) -> (..., h, w, C)."""
    *lead, L, d = tokens.shape
    assert L == (h // 2) * (w // 2), (L, h, w)
    c = d // 4
    x = tokens.reshape(*lead, h // 2, w // 2, c, 2, 2)
    x = torch.movedim(x, (-2, -1), (-4, -2))  # (..., h2, ph, w2, pw, c)
    return x.reshape(*lead, h, w, c)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W) pixel mask (H, W multiples of 16) -> (..., H/16 * W/16, 256):
    8x8 pixel blocks to 64 channels, then a 2x2 patchify."""
    *lead, hpx, wpx = mask.shape
    assert hpx % 16 == 0 and wpx % 16 == 0, (hpx, wpx)
    h8, w8 = hpx // 8, wpx // 8
    x = mask.reshape(*lead, h8, 8, w8, 8)
    x = torch.movedim(x, -3, -2)  # (..., h8, w8, ph, pw)
    x = x.reshape(*lead, h8, w8, 64)
    return patchify(x)


def make_img_ids(h_tok: int, w_tok: int, row_index: int) -> np.ndarray:
    """(h_tok * w_tok, 3) position ids of one grid row: (row_index + 1, y, x)."""
    ids = np.zeros((h_tok, w_tok, 3), dtype=np.float32)
    ids[..., 0] = row_index + 1
    ids[..., 1] += np.arange(h_tok, dtype=np.float32)[:, None]
    ids[..., 2] += np.arange(w_tok, dtype=np.float32)[None, :]
    return ids.reshape(h_tok * w_tok, 3)


def pack_sequences(tokens, ids, pad_to: int | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad a batch of (tokens (L_i, D), ids (L_i, 3)) sequences, tensors or
    arrays, to one length: `pad_to` (a bucket, at least the longest) or the
    longest. Returns (img (B, L, D) in the tokens' dtype, img_ids (B, L, 3)
    fp32, img_mask (B, L) int32 {1 real, 0 pad}) on the first tokens'
    device, zero past each sequence's end."""
    tokens = [torch.as_tensor(t) for t in tokens]
    ids = [torch.as_tensor(x) for x in ids]
    if len(tokens) != len(ids):
        raise ValueError(f"{len(tokens)} token sequences but {len(ids)} id sequences")
    max_len = max(t.shape[0] for t in tokens)
    if pad_to is not None:
        if pad_to < max_len:
            raise ValueError(f"pad_to {pad_to} is shorter than the longest sequence, {max_len}")
        max_len = pad_to
    dev = tokens[0].device
    b, d = len(tokens), tokens[0].shape[-1]
    img = torch.zeros((b, max_len, d), dtype=tokens[0].dtype, device=dev)
    img_ids = torch.zeros((b, max_len, 3), dtype=torch.float32, device=dev)
    img_mask = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
    for i, (t, x) in enumerate(zip(tokens, ids)):
        n = t.shape[0]
        if x.shape[0] != n:
            raise ValueError(f"sequence {i}: {n} tokens but {x.shape[0]} ids")
        img[i, :n] = t.to(dev)
        img_ids[i, :n] = x.to(dev, torch.float32)
        img_mask[i, :n] = 1
    return img, img_ids, img_mask


def bucket_length(n: int, bucket: int = 256, minimum: int | None = None) -> int:
    """Round a sequence length up to a bucket boundary (at least `minimum`,
    which defaults to the bucket)."""
    minimum = bucket if minimum is None else minimum
    return max(minimum, ((n + bucket - 1) // bucket) * bucket)
