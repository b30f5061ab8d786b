"""Components from checkpoint files, or random (counterpart of
visualcloze_tpu/pipeline/loader.py).

build_visualcloze reads the FLUX base (BFL safetensors, a directory of
shards, or a diffusers snapshot), the VisualCloze LoRA (reference-trainer
.pth or diffusers/peft safetensors), the VAE, T5-XXL and CLIP-L, folds the
LoRA into the base as it places the weights on the device, and hands the DiT
to VisualClozeModel, whose constructor permutes it into the half RoPE
layout. Paths come from the arguments or the environment: FLUX_DEV_FILL (the
base), AE, T5_PATH and CLIP_PATH (directories of HF shards). Every module is
built empty in its final dtype on the device and filled one tensor at a
time from the mapped files: nothing is converted to fp32 on the host, and
the host holds at most one tensor beyond the files' mapped pages.

random_components and synthetic_full_components build the same stacks with
random weights (no checkpoints are in the repository): every tensor is
created in its final dtype directly on the device (peak memory = resident:
about 24 GB DiT + 9.5 GB T5-XXL + CLIP-L + VAE in bf16 at full size).
"""

from __future__ import annotations

import dataclasses
import glob
import os

import torch

from ..config import AutoEncoderConfig, CLIPTextConfig, FluxConfig, T5Config, checkpoint_path_env, configs
from ..device import resolve_device
from ..models import weights as W
from ..models.autoencoder import AutoEncoder, build_autoencoder
from ..models.clip import build_clip
from ..models.conditioner import FallbackTokenizer, TextEncoder, default_tokenizer
from ..models.flux import Flux, build_flux
from ..models.lora import Lora
from ..models.quant import init_clip_int8, init_flux_int8, init_t5_int4, quantize_flux_int8, quantize_flux_w8a8
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
    mesh=None,
    attn_impl=None,
) -> VisualClozeModel:
    """A randomly initialized pipeline. Random weights are valid in either
    RoPE layout as they stand, so no permutation is applied: rope_layout
    "half" (kernel L rotates q and k) and "interleaved" (the reference's
    channel order, which the trainer keeps) both attend through kernel D. The tokenizers are
    FallbackTokenizers (tiny vocabularies, or the full T5/CLIP ones). mesh,
    attn_impl: as build_visualcloze (every rank draws the same weights from
    the same generator seed)."""
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
    model = VisualClozeModel(flux_cfg, flux, ae, t5, clip, resolution=resolution, device=device,
                             rope_layout=rope_layout, permute_params=False)
    return place_model(model, mesh, attn_impl)


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
    return VisualClozeModel(flux_cfg, flux, ae, t5, clip, resolution=resolution, device=device, rope_layout="half",
                            permute_params=False)


# ----------------------------- checkpoint files -----------------------------


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A .pth (torch) or .safetensors state dict as CPU tensors (mapped, not read)."""
    if path.endswith(".safetensors"):
        return W.load_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return dict(state)


def load_sharded_safetensors(directory: str) -> dict[str, torch.Tensor]:
    """Every *.safetensors shard of a directory (HF snapshot layout), merged."""
    state: dict[str, torch.Tensor] = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.safetensors"))):
        state.update(W.load_safetensors(path))
    if not state:
        raise FileNotFoundError(f"no safetensors found under {directory}")
    return state


def load_flux_state(path: str) -> dict[str, torch.Tensor]:
    """A FLUX transformer state dict from a safetensors file, a directory of
    shards, or a diffusers pipeline snapshot (its transformer/ subdirectory)."""
    if os.path.isdir(path):
        sub = os.path.join(path, "transformer")
        return load_sharded_safetensors(sub if os.path.isdir(sub) else path)
    return W.load_safetensors(path)


def convert_flux_any(state, flux_cfg: FluxConfig) -> dict[str, torch.Tensor]:
    """BFL or diffusers FluxTransformer2DModel naming -> the port's Flux names."""
    if W.is_diffusers_flux_state(state):
        return W.convert_flux_diffusers(state, flux_cfg)
    return W.convert_flux(state, flux_cfg)


def convert_lora_any(state, flux_cfg: FluxConfig, dtype=torch.float32) -> Lora:
    """Reference-trainer (lora_A / lora_B on BFL modules) or diffusers/peft LoRA -> LoRA tree."""
    if W.is_diffusers_lora_state(state):
        return W.convert_lora_diffusers(state, flux_cfg, dtype)
    return W.convert_lora(state, flux_cfg, dtype)


def load_flux_params(
    model_name: str,
    lora_path: str | None = None,
    lora_scale: float = 1.0,
    dtype: torch.dtype = torch.bfloat16,
    base_path: str | None = None,
    device: str | torch.device | None = None,
) -> tuple[FluxConfig, Flux]:
    """The base weights with the LoRA folded in, on the device, in the
    reference (interleaved) channel order: (config, Flux). The LoRA is folded
    per linear as the weights are placed (fp32 on the device, one rounding to
    `dtype`)."""
    flux_cfg = configs[model_name].flux
    base_path = base_path or checkpoint_path_env(model_name)
    if base_path is None or not os.path.exists(base_path):
        raise FileNotFoundError(
            f"set {model_name}'s checkpoint env var (e.g. FLUX_DEV_FILL) to a "
            "local safetensors file or diffusers snapshot directory"
        )
    state = convert_flux_any(load_flux_state(base_path), flux_cfg)
    lora = None
    if lora_path:
        lora = convert_lora_any(load_torch_checkpoint(lora_path), flux_cfg)
    flux = build_flux(flux_cfg, resolve_device(device), dtype)
    W.assign_state(flux, state, lora=lora, scale=lora_scale)
    return flux_cfg, flux


def load_ae(dtype: torch.dtype = torch.bfloat16, path: str | None = None, device=None) -> AutoEncoder:
    cfg = AutoEncoderConfig()
    path = path or os.environ.get("AE")
    if path is None or not os.path.exists(path):
        raise FileNotFoundError("set AE env var to a local VAE safetensors file")
    state = load_sharded_safetensors(path) if os.path.isdir(path) else W.load_safetensors(path)
    return W.assign_state(build_autoencoder(cfg, resolve_device(device), dtype), W.convert_vae(state, cfg))


def load_t5(max_length: int = 512, dtype: torch.dtype = torch.bfloat16, directory: str | None = None,
            tokenizer_dir: str | None = None, device=None) -> TextEncoder:
    cfg = T5Config(max_length=max_length)
    directory = directory or os.environ.get("T5_PATH")
    if directory is None or not os.path.isdir(directory):
        raise FileNotFoundError("set T5_PATH env var to a local T5-XXL snapshot dir")
    model = W.assign_state(build_t5(cfg, resolve_device(device), dtype),
                           W.convert_t5(load_sharded_safetensors(directory), cfg))
    return TextEncoder("t5", model, default_tokenizer("t5", tokenizer_dir or directory), max_length)


def load_clip(dtype: torch.dtype = torch.bfloat16, directory: str | None = None,
              tokenizer_dir: str | None = None, device=None) -> TextEncoder:
    cfg = CLIPTextConfig()
    directory = directory or os.environ.get("CLIP_PATH")
    if directory is None or not os.path.isdir(directory):
        raise FileNotFoundError("set CLIP_PATH env var to a local CLIP-L snapshot dir")
    model = W.assign_state(build_clip(cfg, resolve_device(device), dtype),
                           W.convert_clip(load_sharded_safetensors(directory), cfg))
    return TextEncoder("clip", model, default_tokenizer("clip", tokenizer_dir or directory), cfg.max_length)


def is_diffusers_snapshot(path: str | None) -> bool:
    """A diffusers pipeline snapshot directory (model_index.json, transformer/,
    vae/, text_encoder*/, tokenizer*/), as the released VisualClozePipeline-384/-512."""
    return bool(path) and os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "model_index.json"))
        or os.path.isdir(os.path.join(path, "transformer"))
    )


def build_visualcloze(
    model_path: str | None = None,
    model_name: str = "flux-dev-fill-lora",
    max_length: int = 512,
    lora_rank: int = 256,
    solver: str = "euler",
    time_shifting_factor: float = 1.0,
    resolution: int = 384,
    mesh=None,
    dtype: torch.dtype = torch.bfloat16,
    quantize: str | None = None,
    device: str | torch.device | None = None,
    calib_queries=None,
    attn_impl=None,
) -> VisualClozeModel:
    """The serving pipeline from checkpoint files (the JAX build_visualcloze).

    model_path: the VisualCloze LoRA (.pth or .safetensors, reference-trainer
    or diffusers/peft naming) folded into $FLUX_DEV_FILL, or a diffusers
    pipeline snapshot directory (VisualClozePipeline-384/-512: the LoRA
    already merged into transformer/; vae/ and the text encoders are taken
    from the snapshot where present, else from AE / T5_PATH / CLIP_PATH).
    quantize="int8": the weight-only int8 DiT (every linear through kernel
    G), quantized from the folded weights; "w8a8": the token-dim block
    linears w8a8 (kernels I and H), the others int8 (G); "w8a8_smooth": the
    folded DiT, permuted to the half layout, calibrated on calib_queries
    (process_images' (images, prompts) pairs; None: a blank 2x2 grid) with
    VisualClozeModel.calibrate_w8a8_smooth's defaults, then quantized with
    SmoothQuant equalization. Each frees the dense DiT once its quantized
    copy exists. mesh (parallel.Mesh): the DiT is sharded over it once built
    (parallel.shard_params: tp shards, FSDP2 over fsdp), after the
    calibration of w8a8_smooth; attn_impl: a RingSpec for cp. lora_rank is
    read from the checkpoint's shapes."""
    del lora_rank
    if quantize not in (None, "int8", "w8a8", "w8a8_smooth"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    device = resolve_device(device)
    snapshot = model_path if is_diffusers_snapshot(model_path) else None
    if snapshot:
        flux_cfg, flux = load_flux_params(model_name, dtype=dtype, base_path=snapshot, device=device)
    else:
        flux_cfg, flux = load_flux_params(model_name, lora_path=model_path, dtype=dtype, device=device)
    if quantize in ("int8", "w8a8"):  # the dense DiT is freed as soon as its quantized copy is made
        flux = (quantize_flux_int8 if quantize == "int8" else quantize_flux_w8a8)(flux)

    def sub(name: str) -> str | None:
        p = os.path.join(snapshot, name) if snapshot else None
        return p if p and os.path.isdir(p) else None

    model = VisualClozeModel(
        flux_cfg,
        flux,
        load_ae(dtype, path=sub("vae"), device=device),
        load_t5(max_length, dtype, directory=sub("text_encoder_2"), tokenizer_dir=sub("tokenizer_2"),
                device=device),
        load_clip(dtype, directory=sub("text_encoder"), tokenizer_dir=sub("tokenizer"), device=device),
        resolution=resolution,
        solver=solver,
        time_shifting_factor=time_shifting_factor,
        device=device,
    )
    if quantize == "w8a8_smooth":  # the calibration runs the dense DiT in the model's (half) layout
        del flux
        model.calibrate_w8a8_smooth(queries=calib_queries)
    return place_model(model, mesh, attn_impl)


def place_model(model: VisualClozeModel, mesh, attn_impl) -> VisualClozeModel:
    """Shard the model's DiT over `mesh` (after its constructor's RoPE
    permutation, as JAX does) and set its attention dispatch."""
    if mesh is not None:
        from ..parallel import shard_params

        shard_params(model.flux, mesh)
    model.mesh, model.attn_impl = mesh, attn_impl
    return model
