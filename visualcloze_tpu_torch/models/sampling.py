"""Token preparation for sampling (counterpart of visualcloze_tpu/models/sampling.py).

`prepare_modified` packs per-row latents into one padded token sequence and
encodes the prompt, with the trainer's caption dropout.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.packing import bucket_length, make_img_ids, patchify


def prepare_modified(
    t5: Callable,
    clip: Callable,
    img: Sequence[Sequence[torch.Tensor]],
    prompt: str | Sequence[str],
    bucket: int | None = None,
    proportion_empty_prompts: float = 0.0,
    is_train: bool = False,
    rng: np.random.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """img: batch of samples, each a list of per-row NHWC latents (1, h, w, c)
    or (h, w, c); row j gets position ids (j + 1, y, x). Rows are concatenated
    and the batch padded to a common (optionally bucketed) length with
    img_mask 1 real / 0 pad. Each prompt is blanked with probability
    proportion_empty_prompts (caption dropout, drawn from `rng`); a list
    prompt takes a random entry in training, else its first."""
    assert isinstance(img, (list, tuple)) and all(isinstance(r, (list, tuple)) for r in img)
    bs = len(img)
    flat_tokens, flat_ids = [], []
    for rows in img:
        toks, ids = [], []
        for j, lat in enumerate(rows):
            if lat.dim() == 4:
                lat = lat[0]
            h, w, _ = lat.shape
            toks.append(patchify(lat))
            ids.append(make_img_ids(h // 2, w // 2, j))
        flat_tokens.append(torch.cat(toks, dim=0))
        flat_ids.append(np.concatenate(ids, axis=0))

    max_len = max(t.shape[0] for t in flat_tokens)
    if bucket:
        max_len = bucket_length(max_len, bucket)

    device = flat_tokens[0].device
    padded, padded_ids = [], []
    img_mask = np.zeros((bs, max_len), dtype=np.int32)
    for i, (t, x) in enumerate(zip(flat_tokens, flat_ids)):
        L = t.shape[0]
        padded.append(F.pad(t, (0, 0, 0, max_len - L)))
        padded_ids.append(np.pad(x, ((0, max_len - L), (0, 0))))
        img_mask[i, :L] = 1
    img_tok = torch.stack(padded, dim=0)
    img_ids = torch.from_numpy(np.stack(padded_ids, axis=0)).to(device)

    prompt = [prompt] if isinstance(prompt, str) else list(prompt)
    if len(prompt) != bs:
        raise ValueError(f"batch mismatch: {bs} image sample(s) vs {len(prompt)} prompt(s)")
    rng = rng or np.random.default_rng()
    for idx in range(bs):
        if proportion_empty_prompts > 0 and rng.random() < proportion_empty_prompts:
            prompt[idx] = ""
        elif isinstance(prompt[idx], (list, tuple)):
            options = prompt[idx]
            prompt[idx] = options[int(rng.integers(len(options)))] if is_train else options[0]
    txt = t5(prompt)
    vec = clip(prompt)
    return {
        "img": img_tok,
        "img_ids": img_ids,
        "txt": txt,
        "txt_ids": torch.zeros((bs, txt.shape[1], 3), dtype=torch.float32, device=device),
        "vec": vec,
        "img_mask": torch.from_numpy(img_mask).to(device),
        "txt_mask": torch.ones((bs, txt.shape[1]), dtype=torch.int32, device=device),
    }
