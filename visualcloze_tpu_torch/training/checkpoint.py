"""Checkpoint save/resume (counterpart of visualcloze_tpu/training/checkpoint.py).

{ckpt_root}/{step:07d}/ holds
  - state.pt: torch.save of the train state (step, the LoRA tree or the
    trained base parameters, AdamW's state, the EMA), where JAX writes an
    Orbax tree. The frozen base of a LoRA run is not in it: it is rebuilt
    from --init_random's seed (or the base checkpoint) on resume, and at 12B
    it would add 24 GB to every checkpoint;
  - consolidated.00-of-01.pth (and consolidated_ema.00-of-01.pth): the LoRA
    in the reference's naming, which JAX's load_torch_lora reads;
  - model_args.json, and resume_step.txt written LAST as the commit marker:
    find_latest_checkpoint skips a directory without it, so an interrupted
    save is never resumed from.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

import torch

from ..config import FluxConfig
from ..models.lora import tree_items, tree_replace
from ..models.weights import convert_lora, lora_to_torch_state
from .step import TrainState


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree


def save_checkpoint(
    ckpt_root: str,
    step: int,
    state: TrainState,
    model_args: dict[str, Any] | None = None,
    save_ema: bool = True,
) -> str:
    """Write {ckpt_root}/{step:07d}/; returns its path."""
    ckpt_dir = Path(ckpt_root) / f"{step:07d}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    trained = None if state.lora is not None else state.trainable()
    torch.save(
        {
            "step": state.step,
            "lora": _cpu(state.lora),
            "params": _cpu(trained),
            "opt_state": state.opt_state.state_dict(),
            "ema": _cpu(state.ema),
        },
        ckpt_dir / "state.pt",
    )
    if state.lora is not None:
        torch.save(lora_to_torch_state(state.lora), ckpt_dir / "consolidated.00-of-01.pth")
        if save_ema and state.ema is not None:
            ema_tree = tree_replace(state.lora, state.ema)
            torch.save(lora_to_torch_state(ema_tree), ckpt_dir / "consolidated_ema.00-of-01.pth")
    if model_args is not None:
        (ckpt_dir / "model_args.json").write_text(json.dumps(model_args, indent=2))
    (ckpt_dir / "resume_step.txt").write_text(str(step))
    return str(ckpt_dir)


def find_latest_checkpoint(ckpt_root: str) -> str | None:
    """Latest COMPLETE step directory (resume_step.txt present)."""
    root = Path(ckpt_root)
    if not root.is_dir():
        return None
    dirs = sorted(
        d for d in root.iterdir()
        if re.fullmatch(r"\d{7}", d.name) and (d / "resume_step.txt").exists()
    )
    return str(dirs[-1]) if dirs else None


def load_checkpoint(ckpt_dir: str) -> dict:
    """The state dict written by save_checkpoint, on the CPU."""
    return torch.load(Path(ckpt_dir) / "state.pt", map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_into(state: TrainState, restored: dict) -> TrainState:
    """Copy a restored state into `state`'s tensors (their devices and
    dtypes), in place; shapes must match."""

    def copy(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor], what: str) -> None:
        if set(dst) != set(src):
            raise ValueError(f"{what}: checkpoint keys differ from the state's")
        for k, t in dst.items():
            t.copy_(src[k])

    trainable = state.trainable()
    if state.lora is not None:
        copy(trainable, dict(tree_items(restored["lora"])), "lora")
    else:
        copy(trainable, restored["params"], "params")
    if state.ema is not None and restored["ema"] is not None:
        copy(state.ema, restored["ema"], "ema")
    state.opt_state.load_state_dict(restored["opt_state"])
    state.step = int(restored["step"])
    return state


def load_resume_step(ckpt_dir: str) -> int:
    path = Path(ckpt_dir) / "resume_step.txt"
    return int(path.read_text().strip()) if path.exists() else 0


def load_torch_lora(path: str, flux_cfg: FluxConfig):
    """A reference-format consolidated LoRA checkpoint -> LoRA tree (fp32, CPU)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return convert_lora(state, flux_cfg)
