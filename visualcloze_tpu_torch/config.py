"""Model configurations of the PyTorch port.

A copy of `visualcloze_tpu/config.py`: the four hyperparameter records
(FluxConfig, AutoEncoderConfig, T5Config, CLIPTextConfig), the named-model
registry (`ModelSpec`, `configs`) and the checkpoint environment variables
(`checkpoint_path_env`), kept here so that the port imports nothing of the
JAX package. Field names, defaults and `.tiny()` miniatures are identical,
so a config of either package describes the same model.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class FluxConfig:
    """FLUX DiT hyperparameters (FLUX.1-Fill-dev by default)."""

    in_channels: int = 384
    out_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: tuple[int, ...] = (16, 56, 56)
    theta: int = 10_000
    qkv_bias: bool = True
    guidance_embed: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    def __post_init__(self):
        if self.hidden_size % self.num_heads != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by num_heads {self.num_heads}"
            )
        if sum(self.axes_dim) != self.head_dim:
            raise ValueError(f"axes_dim {self.axes_dim} must sum to head_dim {self.head_dim}")

    def tiny(self) -> "FluxConfig":
        """A CPU-testable miniature with the same topology."""
        return dataclasses.replace(
            self,
            in_channels=24,
            out_channels=4,
            vec_in_dim=32,
            context_in_dim=48,
            hidden_size=64,
            num_heads=4,
            depth=2,
            depth_single_blocks=2,
            axes_dim=(4, 6, 6),
        )


@dataclass(frozen=True)
class AutoEncoderConfig:
    """FLUX VAE hyperparameters."""

    resolution: int = 256
    in_channels: int = 3
    ch: int = 128
    out_ch: int = 3
    ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    def tiny(self) -> "AutoEncoderConfig":
        # keeps the real 8x downsample factor: the grid packing assumes /8
        # latents and /16 tokens
        return dataclasses.replace(
            self, ch=16, ch_mult=(1, 1, 1, 1), num_res_blocks=1, z_channels=4
        )


@dataclass(frozen=True)
class T5Config:
    """T5 encoder (google/t5-v1_1-xxl) hyperparameters."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 512

    def tiny(self) -> "T5Config":
        return dataclasses.replace(
            self, vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
            max_length=16,
        )


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text encoder (openai/clip-vit-large-patch14) hyperparameters."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    layer_norm_eps: float = 1e-5

    def tiny(self) -> "CLIPTextConfig":
        return dataclasses.replace(
            self, vocab_size=256, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, max_length=16,
        )


@dataclass(frozen=True)
class ModelSpec:
    """A named model configuration."""

    name: str
    flux: FluxConfig
    ae: AutoEncoderConfig
    repo_id: str | None = None
    repo_flow: str | None = None
    repo_ae: str | None = None
    lora_repo_id: str | None = None
    lora_filename: str | None = None


_BASE_AE = AutoEncoderConfig()
_DEV_FLUX = FluxConfig(in_channels=64, guidance_embed=True)
_SCHNELL_FLUX = FluxConfig(in_channels=64, guidance_embed=False)
_FILL_FLUX = FluxConfig(in_channels=384, guidance_embed=True)
_CONTROL_FLUX = FluxConfig(in_channels=128, guidance_embed=True)

# The nine named models of the JAX package's registry.
configs: dict[str, ModelSpec] = {
    "flux-dev": ModelSpec(
        name="flux-dev", flux=_DEV_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-dev", repo_flow="flux1-dev.safetensors",
        repo_ae="ae.safetensors",
    ),
    "flux-dev-lora": ModelSpec(
        name="flux-dev-lora", flux=_DEV_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-dev", repo_flow="flux1-dev.safetensors",
        repo_ae="ae.safetensors",
    ),
    "flux-dev-fill-lora": ModelSpec(
        name="flux-dev-fill-lora", flux=_FILL_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-Fill-dev", repo_flow="flux1-fill-dev.safetensors",
        repo_ae="ae.safetensors",
    ),
    "flux-schnell": ModelSpec(
        name="flux-schnell", flux=_SCHNELL_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-schnell", repo_flow="flux1-schnell.safetensors",
        repo_ae="ae.safetensors",
    ),
    "flux-dev-canny": ModelSpec(
        name="flux-dev-canny", flux=_CONTROL_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-Canny-dev", repo_flow="flux1-canny-dev.safetensors",
        repo_ae="ae.safetensors",
    ),
    "flux-dev-canny-lora": ModelSpec(
        name="flux-dev-canny-lora", flux=_DEV_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-dev", repo_flow="flux1-dev.safetensors",
        repo_ae="ae.safetensors",
        lora_repo_id="black-forest-labs/FLUX.1-Canny-dev-lora",
        lora_filename="flux1-canny-dev-lora.safetensors",
    ),
    "flux-dev-depth": ModelSpec(
        name="flux-dev-depth", flux=_CONTROL_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-Depth-dev", repo_flow="flux1-depth-dev.safetensors",
        repo_ae="ae.safetensors",
    ),
    "flux-dev-depth-lora": ModelSpec(
        name="flux-dev-depth-lora", flux=_DEV_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-dev", repo_flow="flux1-dev.safetensors",
        repo_ae="ae.safetensors",
        lora_repo_id="black-forest-labs/FLUX.1-Depth-dev-lora",
        lora_filename="flux1-depth-dev-lora.safetensors",
    ),
    "flux-dev-fill": ModelSpec(
        name="flux-dev-fill", flux=_FILL_FLUX, ae=_BASE_AE,
        repo_id="black-forest-labs/FLUX.1-Fill-dev", repo_flow="flux1-fill-dev.safetensors",
        repo_ae="ae.safetensors",
    ),
}


def checkpoint_path_env(name: str) -> str | None:
    """The checkpoint path an environment variable names for a model (FLUX_DEV,
    FLUX_DEV_FILL, FLUX_SCHNELL) or for the VAE ("ae" -> AE), else None."""
    env = {
        "flux-dev": "FLUX_DEV",
        "flux-dev-fill": "FLUX_DEV_FILL",
        "flux-dev-fill-lora": "FLUX_DEV_FILL",
        "flux-schnell": "FLUX_SCHNELL",
        "ae": "AE",
    }.get(name)
    return os.environ.get(env) if env else None
