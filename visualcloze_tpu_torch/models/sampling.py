"""Token preparation for sampling (counterpart of visualcloze_tpu/models/sampling.py).

`prepare_modified` packs per-row latents into one padded token sequence and
encodes the prompt, with the trainer's caption dropout (the VisualCloze
pipeline). The original BFL packers serve the tools route: `prepare` (one
image, 2-D position ids with row axis 0), `prepare_fill` (the masked image
VAE-encoded and the mask packed, concatenated on channels), `prepare_control`
(a Canny or depth conditioning image VAE-encoded), `prepare_redux` (SigLIP
tokens projected into T5 space and appended to the text); `get_noise` and
`unpack` go between latents and tokens. Latents are NHWC. The VAE's
posterior noise is drawn from a torch.Generator, or handed in (`eps`).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.packing import bucket_length, make_img_ids, pack_mask, patchify, unpatchify


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


def get_noise(num_samples: int, height: int, width: int, dtype=torch.bfloat16, generator=None,
              device=None) -> torch.Tensor:
    """Latent-shaped unit noise, NHWC (num_samples, 2 ceil(height/2), 2
    ceil(width/2), 16): height and width are latent dims (pixels / 8)."""
    shape = (num_samples, 2 * math.ceil(height / 2), 2 * math.ceil(width / 2), 16)
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device).to(dtype)


def _batched(t: torch.Tensor, bs: int) -> torch.Tensor:
    return t.expand(bs, *t.shape[1:]) if t.shape[0] == 1 and bs > 1 else t


def prepare(t5: Callable, clip: Callable, img: torch.Tensor, prompt: str | Sequence[str]) -> dict[str, torch.Tensor]:
    """The original BFL single-image packer: img (B, H, W, C) latent ->
    tokens with 2-D position ids (row axis 0), no padding, T5 and CLIP
    features of the prompt(s); a single image is repeated to the prompts'
    batch."""
    bs, h, w, _ = img.shape
    if bs == 1 and not isinstance(prompt, str):
        bs = len(prompt)
    tok = _batched(patchify(img), bs)
    ids = torch.from_numpy(make_img_ids(h // 2, w // 2, row_index=-1)).to(img.device)  # axis 0 = 0
    prompt = [prompt] if isinstance(prompt, str) else list(prompt)
    txt = _batched(t5(prompt), bs)
    vec = _batched(clip(prompt), bs)
    return {
        "img": tok,
        "img_ids": ids[None].expand(bs, *ids.shape),
        "txt": txt,
        "txt_ids": torch.zeros((bs, txt.shape[1], 3), dtype=torch.float32, device=txt.device),
        "vec": vec,
    }


def _vae_encode(ae, pixels: torch.Tensor, eps: torch.Tensor | None, generator) -> torch.Tensor:
    """ae.encode of (1, H, W, 3) pixels on the VAE's device and dtype; eps the
    posterior noise (1, H/8, W/8, z) or drawn from `generator`."""
    p = next(ae.parameters())
    pixels = pixels.to(device=p.device, dtype=p.dtype)
    if eps is None:
        b, hh, ww, _ = pixels.shape
        eps = torch.randn((b, hh // 8, ww // 8, ae.cfg.z_channels), generator=generator, dtype=torch.float32,
                          device=p.device)
    return ae.encode(pixels, eps.to(p.device))


def prepare_fill(t5: Callable, clip: Callable, img: torch.Tensor, prompt: str | Sequence[str], ae,
                 img_cond: np.ndarray, mask: np.ndarray, eps: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """The BFL Fill packer: `prepare`, plus img_cond = the masked image
    VAE-encoded and patchified, concatenated on channels with the mask packed
    from 8x8 pixel blocks (64 + 256 channels for FLUX.1-Fill). img: (B, h, w,
    16) noise latent; img_cond: (H, W, 3) pixels in [-1, 1]; mask: (H, W)
    in [0, 1]."""
    masked = torch.from_numpy(np.asarray(img_cond * (1.0 - mask[..., None]), dtype=np.float32))
    lat = _vae_encode(ae, masked[None], eps, generator).to(device=img.device, dtype=img.dtype)
    mask_t = torch.from_numpy(np.asarray(mask, dtype=np.float32)).to(device=img.device, dtype=img.dtype)
    bs = img.shape[0]
    out = prepare(t5, clip, img, prompt)
    out["img_cond"] = torch.cat([_batched(patchify(lat), bs), _batched(pack_mask(mask_t[None]), bs)], dim=-1)
    return out


def prepare_control(t5: Callable, clip: Callable, img: torch.Tensor, prompt: str | Sequence[str], ae,
                    encoder: Callable, img_cond_pil, eps: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """The BFL Canny / Depth packer: `prepare`, plus img_cond = the control
    encoder's (1, H, W, 3) image in [-1, 1], VAE-encoded and patchified."""
    lat = _vae_encode(ae, encoder(img_cond_pil), eps, generator).to(device=img.device, dtype=img.dtype)
    out = prepare(t5, clip, img, prompt)
    out["img_cond"] = _batched(patchify(lat), img.shape[0])
    return out


def prepare_redux(t5: Callable, clip: Callable, img: torch.Tensor, prompt: str | Sequence[str],
                  encoder: Callable, img_cond_pil) -> dict[str, torch.Tensor]:
    """The BFL Redux packer: `prepare`, with the encoder's (1, L, context
    dim) image tokens appended to the T5 sequence."""
    out = prepare(t5, clip, img, prompt)
    img_cond = encoder(img_cond_pil).to(device=out["txt"].device, dtype=out["txt"].dtype)
    bs = out["img"].shape[0]
    txt = _batched(torch.cat([out["txt"], _batched(img_cond, out["txt"].shape[0])], dim=-2), bs)
    out["txt"] = txt
    out["txt_ids"] = torch.zeros((bs, txt.shape[1], 3), dtype=torch.float32, device=txt.device)
    return out


def unpack(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Tokens -> NHWC latent; height and width in pixels."""
    return unpatchify(x, 2 * math.ceil(height / 16), 2 * math.ceil(width / 16))
