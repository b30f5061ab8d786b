"""Diffusers-style API over VisualClozeModel (counterpart of
visualcloze_tpu/pipeline/diffusers_api.py).

The reference's diffusers pipeline is driven as

    pipe = VisualClozePipeline.from_pretrained(snapshot, resolution=384)
    out = pipe(task_prompt=..., content_prompt=..., image=[[a, b], [c, None]],
               upsampling_height=1632, upsampling_width=1232,
               upsampling_strength=0.3, guidance_scale=30,
               num_inference_steps=30, seed=0)
    out.images[0][0].save("result.png")

and this module takes the same call. Mapping:
- `image` is a list of grid rows, None marking the query cells; a cell may be
  a PIL image, a numpy array or a file path, converted to RGB as diffusers'
  load_image does.
- the layout prompt is the reference bank's first template for the grid's
  shape unless `layout_prompt` is given.
- `upsampling_strength` keeps diffusers' img2img meaning (1.0 regenerates,
  0.0 returns the plain resize); the model's own knob is the latent mix
  weight `upsampling_noise`, and upsampling_noise = 1 - upsampling_strength.
  The upsampling pass always runs, to upsampling_width x upsampling_height
  if given, else to the query cell's own size.
- `generator`: an int seed or anything with initial_seed() (a
  torch.Generator); `seed=` is the native spelling.
- the batch size is 1; `.images` nests one level for `.images[0][cell]`.
- the model is placed on its device when it is built: `to()` accepts that
  device and refuses another.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Any, Sequence

import numpy as np
from PIL import Image

from ..data.prefix_instruction import get_layout_instruction
from ..device import same_device
from ..models.lora import fold_lora
from ..models.weights import permute_rope_layout_lora
from .loader import build_visualcloze, convert_lora_any, load_torch_checkpoint


@dataclasses.dataclass
class VisualClozePipelineOutput:
    """`.images[batch][cell]`, as diffusers' pipeline output."""

    images: list[list[Image.Image]]


def _as_image(cell: Any) -> Image.Image | None:
    """An RGB PIL image from a PIL image, a path or an array (None stays None)."""
    if cell is None:
        return None
    if isinstance(cell, Image.Image):
        return cell.convert("RGB")
    if isinstance(cell, (str, Path)):
        return Image.open(cell).convert("RGB")
    if isinstance(cell, np.ndarray):
        return Image.fromarray(cell).convert("RGB")
    raise TypeError(f"unsupported image cell type {type(cell).__name__}")


def default_layout_prompt(rows: int, cols: int) -> str:
    """The reference bank's first layout template for the grid (the string
    the reference pipelines render)."""
    return get_layout_instruction(cols, rows, rng=random.Random(0), bank="reference")


class VisualClozePipeline:
    """A diffusers-shaped front over a VisualClozeModel."""

    def __init__(self, model):
        self.model = model

    @classmethod
    def from_pretrained(cls, pretrained_path: str | Path | None = None, *, resolution: int = 384,
                        **model_kwargs) -> "VisualClozePipeline":
        """Build from local files, as pipeline.loader.build_visualcloze does: a
        diffusers VisualClozePipeline-384/-512 snapshot directory, or a
        reference .pth / peft LoRA folded into $FLUX_DEV_FILL (with AE, T5_PATH,
        CLIP_PATH). Nothing is downloaded."""
        model = build_visualcloze(model_path=str(pretrained_path) if pretrained_path is not None else None,
                                  resolution=resolution, **model_kwargs)
        return cls(model)

    def load_lora_weights(self, path: str | Path, weight_name: str | None = None,
                          adapter_name: str | None = None) -> "VisualClozePipeline":
        """With adapter_name, the LoRA becomes a named runtime adapter (pass
        adapter= to the call); without it, it is folded into the DiT at the
        model's lora_scale, as diffusers' load_lora_weights + fuse_lora.
        Reads reference-trainer .pth and diffusers/peft safetensors."""
        path = Path(path)
        if weight_name is not None:
            path = path / weight_name
        m = self.model
        lora = convert_lora_any(load_torch_checkpoint(str(path)), m.cfg)
        if adapter_name is not None:
            m.add_adapter(adapter_name, lora)
        else:
            if m.rope_layout == "half":
                lora = permute_rope_layout_lora(lora, m.cfg)
            fold_lora(m.flux, lora, scale=m.lora_scale)
        return self

    def to(self, device=None):
        """The model is placed when it is built: its own device returns the
        pipeline, another raises."""
        if device is not None and not same_device(device, self.model.device):
            raise ValueError(f"the model lives on {self.model.device}; build it on {device} instead "
                             "(from_pretrained(..., device=...))")
        return self

    def __call__(
        self,
        task_prompt: str | Sequence[str],
        content_prompt: str | Sequence[str] | None = None,
        image: Sequence[Sequence[Any]] | None = None,
        layout_prompt: str | None = None,
        upsampling_width: int | None = None,
        upsampling_height: int | None = None,
        upsampling_strength: float = 1.0,
        upsampling_steps: int = 10,
        guidance_scale: float = 30.0,
        num_inference_steps: int = 30,
        max_sequence_length: int | None = None,
        seed: int = 0,
        generator=None,
        adapter: str | None = None,
    ) -> VisualClozePipelineOutput:
        if image is None:
            raise ValueError("`image` (the grid rows, None = query cells) is required")
        if not isinstance(task_prompt, str):  # diffusers takes per-batch lists; the batch is 1
            (task_prompt,) = task_prompt
        if content_prompt is not None and not isinstance(content_prompt, str):
            (content_prompt,) = content_prompt
        m = self.model
        if max_sequence_length is not None and max_sequence_length != m.t5.max_length:
            raise ValueError(f"max_sequence_length={max_sequence_length} differs from the loaded T5 encoder's "
                             f"length {m.t5.max_length}; set it when the model is built")
        if generator is not None:
            if hasattr(generator, "initial_seed"):
                seed = int(generator.initial_seed()) % (2 ** 31 - 1)
            elif isinstance(generator, int):
                seed = generator
            else:
                raise TypeError("generator must be an int seed or expose initial_seed()")

        grid = [[_as_image(c) for c in row] for row in image]
        rows, cols = len(grid), len(grid[0])
        if any(len(r) != cols for r in grid):
            raise ValueError("all grid rows must have the same length")
        prompts = [layout_prompt or default_layout_prompt(rows, cols), task_prompt, content_prompt or ""]
        q = m.prepare_query(grid, prompts, seed=seed, cfg=guidance_scale, steps=num_inference_steps,
                            grid_size=(rows, cols), adapter=adapter)
        if upsampling_width is not None or upsampling_height is not None:
            if upsampling_width is None or upsampling_height is None:
                raise ValueError("pass both upsampling_width and upsampling_height")
            q["upsampling_size"] = (upsampling_width, upsampling_height)  # PIL (w, h)
        if not 0.0 <= upsampling_strength <= 1.0:
            raise ValueError("upsampling_strength must be in [0, 1]")
        samples = m.denoise_query(q)
        cells = m.finalize_query(q, samples, upsampling_steps=upsampling_steps,
                                 upsampling_noise=1.0 - upsampling_strength, is_upsampling=True)
        return VisualClozePipelineOutput(images=[cells])
