"""Random-weight components (counterpart of visualcloze_tpu/pipeline/loader.py:
random_components and synthetic_full_components).

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
from ..models.quant import init_clip_int8, init_flux_int8, init_t5_int4
from ..models.t5 import build_t5
from .visualcloze import VisualClozeModel


def _configs(tiny: bool):
    """(flux, ae, t5, clip) configs: the published widths, or the tiny ones,
    where the DiT takes the tiny VAE's latents + the 256-channel mask."""
    if not tiny:
        return FluxConfig(), AutoEncoderConfig(), T5Config(), CLIPTextConfig()
    ae_cfg, t5_cfg, clip_cfg = AutoEncoderConfig().tiny(), T5Config().tiny(), CLIPTextConfig().tiny()
    flux_cfg = dataclasses.replace(
        FluxConfig().tiny(),
        in_channels=4 * ae_cfg.z_channels + 256 + 4 * ae_cfg.z_channels,
        out_channels=4 * ae_cfg.z_channels,
        vec_in_dim=clip_cfg.hidden_size,
        context_in_dim=t5_cfg.d_model,
    )
    return flux_cfg, ae_cfg, t5_cfg, clip_cfg


def random_components(
    tiny: bool = True,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    resolution: int = 384,
    rope_layout: str = "half",
) -> VisualClozeModel:
    """A randomly initialized pipeline. Random weights are valid in either
    RoPE layout as they stand, so no permutation is applied: rope_layout
    "half" serves through kernel A, "interleaved" (the reference's channel
    order, which the trainer keeps) through kernel D. The tokenizers are
    FallbackTokenizers (tiny vocabularies, or the full T5/CLIP ones)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    flux_cfg, ae_cfg, t5_cfg, clip_cfg = _configs(tiny)
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
    return VisualClozeModel(flux_cfg, flux, ae, t5, clip, resolution=resolution, device=device,
                            rope_layout=rope_layout)


def synthetic_full_components(
    tiny: bool = False,
    t5_int4: bool = True,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    resolution: int = 384,
) -> VisualClozeModel:
    """The single-card int8 serving stack with random weights (counterpart of
    visualcloze_tpu/pipeline/loader.py:synthetic_full_components): an int8
    DiT (every linear through kernel G), an int4 T5-XXL with an int8 token
    table (a bf16 T5 with t5_int4=False), an int8 CLIP-L and a bf16 VAE, all
    resident together (about 14.5 GiB at full width). Each quantized model is
    initialized straight in its quantized layout, so peak memory equals
    resident memory. Random weights are a valid half layout as they stand: no
    permutation. The tokenizers are FallbackTokenizers over each vocabulary,
    as in JAX. tiny=True builds the same wiring at the tiny widths (the CPU
    tests)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    flux_cfg, ae_cfg, t5_cfg, clip_cfg = _configs(tiny)
    if t5_int4:
        t5_model = init_t5_int4(t5_cfg, device, generator)
    else:
        t5_model = build_t5(t5_cfg, device, torch.bfloat16).init_random_(generator)
    flux = init_flux_int8(flux_cfg, device, generator)
    ae = build_autoencoder(ae_cfg, device, torch.bfloat16).init_random_(generator)
    clip_model = init_clip_int8(clip_cfg, device, generator)
    t5 = TextEncoder("t5", t5_model, FallbackTokenizer(t5_cfg.vocab_size), t5_cfg.max_length)
    clip = TextEncoder("clip", clip_model, FallbackTokenizer(clip_cfg.vocab_size), clip_cfg.max_length)
    return VisualClozeModel(flux_cfg, flux, ae, t5, clip, resolution=resolution, device=device, rope_layout="half")
