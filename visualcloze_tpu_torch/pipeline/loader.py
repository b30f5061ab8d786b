"""Random-weight components (counterpart of visualcloze_tpu/pipeline/loader.py:random_components).

No checkpoints are in the repository and none may be fetched, so the port's
pipeline runs on random weights at the published widths. Every tensor is
created in its final dtype directly on the device (peak memory = resident:
about 24 GB DiT + 9.5 GB T5-XXL + CLIP-L + VAE in bf16 at full size).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import AutoEncoderConfig, CLIPTextConfig, FluxConfig, T5Config
from ..device import resolve_device
from ..models.autoencoder import build_autoencoder
from ..models.clip import build_clip
from ..models.conditioner import FallbackTokenizer, TextEncoder, default_tokenizer
from ..models.flux import build_flux
from ..models.t5 import build_t5
from .visualcloze import VisualClozeModel


def random_components(
    tiny: bool = True,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    resolution: int = 384,
) -> VisualClozeModel:
    """A randomly initialized pipeline. Random weights are a valid half RoPE
    layout as they stand, so no permutation is applied. The tokenizers are
    FallbackTokenizers (tiny vocabularies, or the full T5/CLIP ones)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    flux_cfg = FluxConfig().tiny() if tiny else FluxConfig()
    ae_cfg = AutoEncoderConfig().tiny() if tiny else AutoEncoderConfig()
    t5_cfg = T5Config().tiny() if tiny else T5Config()
    clip_cfg = CLIPTextConfig().tiny() if tiny else CLIPTextConfig()
    if tiny:  # the tiny DiT takes the tiny VAE's latents + the 256-channel mask
        flux_cfg = dataclasses.replace(
            flux_cfg,
            in_channels=4 * ae_cfg.z_channels + 256 + 4 * ae_cfg.z_channels,
            out_channels=4 * ae_cfg.z_channels,
            vec_in_dim=clip_cfg.hidden_size,
            context_in_dim=t5_cfg.d_model,
        )
    flux = build_flux(flux_cfg, device, dtype).init_random_(generator)
    ae = build_autoencoder(ae_cfg, device, dtype).init_random_(generator)
    t5_model = build_t5(t5_cfg, device, dtype).init_random_(generator)
    clip_model = build_clip(clip_cfg, device, dtype).init_random_(generator)
    if tiny:
        t5_tok, clip_tok = FallbackTokenizer(t5_cfg.vocab_size), FallbackTokenizer(clip_cfg.vocab_size)
    else:
        t5_tok, clip_tok = default_tokenizer("t5"), default_tokenizer("clip")
    t5 = TextEncoder("t5", t5_model, t5_tok, t5_cfg.max_length)
    clip = TextEncoder("clip", clip_model, clip_tok, clip_cfg.max_length)
    return VisualClozeModel(flux_cfg, flux, ae, t5, clip, resolution=resolution, device=device)
