"""Training batch preparation: grid rows -> packed token batches (counterpart
of visualcloze_tpu/training/batch.py).

Query-cell mask sampling, masked-cond construction, VAE encoding of conds and
targets, token packing with batch padding, and text conditioning with caption
dropout. Host randomness (masks, dropout) comes from a numpy Generator, as in
JAX; the VAE posterior noise from a torch.Generator, or from `vae_noise`, the
arrays handed in (one per distinct row shape, in order of first appearance),
since jax.random and torch.Generator give different numbers from one seed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.sampling import prepare_modified
from ..ops.packing import pack_mask, patchify


def sample_random_mask(h: int, w: int, w_grid: int, context: bool, rng: np.random.Generator) -> np.ndarray:
    """Pixel mask for one grid row: context rows are all-zero; the query row
    masks one cell of a 1 x w_grid strip, 50% a random cell, 50% the last."""
    mask = np.zeros((h, w), np.float32)
    if context:
        return mask
    w_stride = w // w_grid
    if rng.random() < 0.5:
        w_idx = int(rng.integers(0, w_grid))
        mask[:, w_idx * w_stride : (w_idx + 1) * w_stride] = 1.0
    else:
        mask[:, w - w_stride :] = 1.0
    return mask


@torch.no_grad()
def prepare_train_batch(
    ae,
    t5,
    clip,
    rows_batch: list[list[np.ndarray]],
    prompts: list[str],
    grid_shapes: list[tuple[int, int]],
    rng: np.random.Generator,
    caption_dropout: float = 0.1,
    bucket: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
    generator: torch.Generator | None = None,
    vae_noise: list | None = None,
) -> dict[str, torch.Tensor]:
    """The train-step batch from dataset output, on the VAE's device.

    rows_batch[i]: the (H, W_row, 3) [-1, 1] float rows of sample i;
    grid_shapes[i] = (cols, rows). Returns x1, cond, img_ids, img_mask, txt,
    txt_ids, txt_mask, vec, each (B, ...). All rows of one pixel shape, masked
    and clean, go through one batched VAE encode."""
    device = next(ae.parameters()).device
    z_ch = ae.cfg.z_channels
    f = ae.cfg.downsample_factor
    given = list(vae_noise) if vae_noise is not None else None
    entries: list[tuple[np.ndarray, np.ndarray]] = []  # (row, mask), flat
    for i, rows in enumerate(rows_batch):
        w_grid = grid_shapes[i][0]
        for j, row in enumerate(rows):
            h, w = row.shape[:2]
            mask = sample_random_mask(h, w, w_grid, context=j < len(rows) - 1, rng=rng)
            entries.append((np.asarray(row), mask))

    by_shape: dict[tuple, list[int]] = {}
    for k, (row, _) in enumerate(entries):
        by_shape.setdefault(row.shape, []).append(k)

    row_cond: dict[int, torch.Tensor] = {}  # flat row id -> (L, 4z + 256) cond tokens
    row_x: dict[int, torch.Tensor] = {}  # flat row id -> (1, h, w, z) latent
    for shape, idxs in by_shape.items():
        n = len(idxs)
        stack = np.stack(
            [entries[k][0] * (1.0 - entries[k][1][..., None]) for k in idxs]
            + [entries[k][0] for k in idxs]
        ).astype(np.float32)
        eps_shape = (2 * n, shape[0] // f, shape[1] // f, z_ch)
        if given is not None:
            eps = torch.from_numpy(np.array(given.pop(0), dtype=np.float32)).to(device)
            if tuple(eps.shape) != eps_shape:
                raise ValueError(f"vae_noise entry has shape {tuple(eps.shape)}, need {eps_shape}")
        else:
            eps = torch.randn(eps_shape, generator=generator, dtype=torch.float32, device=device)
        z = ae.encode(torch.from_numpy(stack).to(device), eps)  # (2n, h/8, w/8, z)
        cond_t = patchify(z[:n].to(compute_dtype))
        masks = torch.from_numpy(np.stack([entries[k][1] for k in idxs])).to(device, compute_dtype)
        toks = torch.cat([cond_t, pack_mask(masks)], dim=-1)
        for pos, k in enumerate(idxs):
            row_cond[k] = toks[pos]
            row_x[k] = z[n + pos][None].to(compute_dtype)

    cond_tok_list, x_rows_list = [], []
    cursor = 0
    for rows in rows_batch:
        ids = range(cursor, cursor + len(rows))
        cursor += len(rows)
        cond_tok_list.append(torch.cat([row_cond[k] for k in ids], dim=0))
        x_rows_list.append([row_x[k] for k in ids])

    inp = prepare_modified(
        t5, clip, x_rows_list, prompts, bucket=bucket,
        proportion_empty_prompts=caption_dropout, is_train=True, rng=rng,
    )
    max_len = inp["img"].shape[1]
    cond = torch.stack([F.pad(ct, (0, 0, 0, max_len - ct.shape[0])) for ct in cond_tok_list])
    return {
        "x1": inp["img"],
        "cond": cond,
        "img_ids": inp["img_ids"],
        "img_mask": inp["img_mask"],
        "txt": inp["txt"],
        "txt_ids": inp["txt_ids"],
        "txt_mask": inp["txt_mask"],
        "vec": inp["vec"],
    }


def to_micro_batches(batch: dict, micro_bs: int) -> dict:
    """(B, ...) -> (accum, micro_bs, ...) for the accumulation loop."""
    b = batch["x1"].shape[0]
    if b % micro_bs:
        raise ValueError(f"batch {b} is not a multiple of the micro batch {micro_bs}")
    accum = b // micro_bs
    return {k: v.reshape(accum, micro_bs, *v.shape[1:]) for k, v in batch.items()}
