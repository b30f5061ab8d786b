"""Training step: masked velocity loss, gradient accumulation, clipping,
AdamW, EMA, selective trainability (counterpart of
visualcloze_tpu/training/step.py).

As in JAX: gradients are averaged over the accumulation micro-batches, their
global norm (trainable leaves only) is clipped to `grad_clip` the way optax's
clip_by_global_norm does (g * clip / norm once norm >= clip), then AdamW with
b1 0.9, b2 0.95, eps 1e-8 and decoupled weight decay (optax's adamw:
m / (1 - b1^t) over sqrt(v / (1 - b2^t)) + eps; torch.optim.AdamW computes the
same). Frozen leaves get no update; the EMA covers the trainable leaves only.
In the masked types ("double_block", "bias", "norm") every base leaf is
differentiated, as JAX differentiates the whole tree, and the logged
grad_norm is the global norm of all those gradients, frozen ones included
(JAX's optax.global_norm(grads)); the clip still sees the trainable ones only.

Precision: the trainable leaves are fp32 masters, cast to the compute dtype
inside the differentiated function. For training_type "lora" the frozen base
is kept in the compute dtype itself (bf16 on the card): the same numbers as
JAX's per-step cast of fp32 masters, without 48 GB of fp32 copies of a 12B
base. The other types keep fp32 masters of the base and cast them per step
(torch.func.functional_call).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..models.lora import tree_items, tree_leaves, tree_map
from ..transport import Transport

TRAINING_TYPES = ("lora", "full_model", "double_block", "bias", "norm")


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module  # the Flux module: frozen base (lora) or fp32 masters
    lora: Any | None  # LoRA tree of fp32 leaves; None for the other training types
    opt_state: torch.optim.Optimizer
    ema: dict[str, torch.Tensor] | None  # EMA of the trainable leaves, by name
    mask: dict[str, bool] | None = None  # the base leaves that train (masked types)

    def trainable(self) -> dict[str, torch.Tensor]:
        """The leaves the optimizer updates, by dotted name."""
        if self.lora is not None:
            return dict(tree_items(self.lora))
        return {n: p for n, p in self.params.named_parameters() if self.mask is None or self.mask[n]}

    def differentiated(self) -> list[torch.Tensor]:
        """The leaves whose gradients the step computes and logs the norm of:
        the trainable ones, and in the masked types every base leaf."""
        if self.lora is not None:
            return tree_leaves(self.lora)
        return [p for p in self.params.parameters() if p.requires_grad]


def trainable_mask(params: nn.Module, training_type: str) -> dict[str, bool]:
    """Which base parameters train, by name, for the name-filtered types."""

    def keep(name: str) -> bool:
        keys = name.split(".")
        if training_type == "full_model":
            return True
        if training_type == "double_block":
            return keys[0] == "double_blocks"
        if training_type == "bias":
            return keys[-1] in ("b", "bias")
        if training_type == "norm":
            return keys[-1] in ("q_scale", "k_scale", "scale", "ln")
        raise ValueError(training_type)

    return {name: keep(name) for name, _ in params.named_parameters()}


ADAM_BETAS, ADAM_EPS = (0.9, 0.95), 1e-8  # optax.adamw(lr, b1=0.9, b2=0.95) as JAX builds it


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 2.0


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.0, grad_clip: float = 2.0) -> OptimizerConfig:
    """AdamW with global-norm clipping; the trainable set is fixed by
    init_train_state (the mask there freezes the rest entirely)."""
    return OptimizerConfig(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


@torch.no_grad()
def update_ema(ema: dict[str, torch.Tensor], new: dict[str, torch.Tensor], decay: float = 0.95) -> None:
    """ema = decay * ema + (1 - decay) * new, in place, over ema's own keys
    (a mask-pruned subset of `new`)."""
    for name, e in ema.items():
        e.mul_(decay).add_(new[name].detach(), alpha=1.0 - decay)


def prune_to_mask(tree: dict[str, torch.Tensor], mask: dict[str, bool] | None) -> dict[str, torch.Tensor]:
    """The entries of `tree` whose mask is True (mask None keeps all)."""
    if mask is None:
        return dict(tree)
    return {k: v for k, v in tree.items() if mask[k]}


def init_train_state(
    params: nn.Module,
    lora,
    optimizer: OptimizerConfig,
    training_type: str = "lora",
    use_ema: bool = False,
    mask: dict[str, bool] | None = None,
) -> TrainState:
    """Make the differentiated leaves require grad (the LoRA leaves, or every
    base parameter) and build the AdamW state over the trainable ones (the LoRA
    leaves, or the base parameters that `mask` keeps, all of them without a
    mask); the EMA starts as a copy of those leaves."""
    if training_type not in TRAINING_TYPES:
        raise ValueError(training_type)
    params.requires_grad_(False)
    if training_type == "lora":
        if lora is None:
            raise ValueError("training_type 'lora' needs a LoRA tree")
        for t in tree_leaves(lora):
            t.requires_grad_(True)
    else:
        lora = None
        params.requires_grad_(True)
    state = TrainState(step=0, params=params, lora=lora, opt_state=None, ema=None,
                       mask=None if training_type == "lora" else mask)
    trainable = state.trainable()
    state.opt_state = torch.optim.AdamW(
        list(trainable.values()), lr=optimizer.lr, betas=ADAM_BETAS, eps=ADAM_EPS,
        weight_decay=optimizer.weight_decay,
    )
    if use_ema:
        state.ema = {k: v.detach().clone() for k, v in prune_to_mask(trainable, mask).items()}
    return state


def _global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element, fp32."""
    return torch.sqrt(sum(g.to(torch.float32).square().sum() for g in grads))


def _cast_model(flux: nn.Module, compute_dtype: torch.dtype):
    """flux itself when its weights are in the compute dtype, else a function
    that runs it on weights cast per call (differentiably)."""
    if all(p.dtype == compute_dtype for p in flux.parameters()):
        return flux

    def call(**kwargs):
        cast = {n: p.to(compute_dtype) if p.dtype == torch.float32 else p for n, p in flux.named_parameters()}
        return torch.func.functional_call(flux, cast, (), kwargs)

    return call


def make_train_step(
    transport: Transport,
    optimizer: OptimizerConfig,
    training_type: str = "lora",
    ema_decay: float | None = 0.95,
    remat: bool = True,
    remat_policy: str | None = "dots",
    compute_dtype: torch.dtype = torch.bfloat16,
    rope_layout: str = "interleaved",
):
    """The train step: train_step(state, batch, generator=None, draws=None)
    -> metrics {"loss", "grad_norm"} (fp32 scalars), updating `state` in place.

    batch: x1, cond, img_ids, img_mask, txt, txt_ids, txt_mask, vec, each
    (accum, micro_bs, ...); the micro-batches are run in turn and their
    gradients averaged. t and the noise come from `generator`, or per
    micro-batch from draws[i] = {"t": ..., "noise": ...}."""
    if training_type not in TRAINING_TYPES:
        raise ValueError(training_type)

    def loss_fn(state: TrainState, micro: dict, generator, draw: dict):
        model = _cast_model(state.params, compute_dtype)
        clora = None
        if state.lora is not None:
            clora = tree_map(lambda t: t.to(compute_dtype) if t.dtype == torch.float32 else t, state.lora)

        def model_fn(img, timesteps, **kw):
            return model(img=img.to(compute_dtype), timesteps=timesteps, lora=clora, remat=remat,
                         remat_policy=remat_policy, rope_layout=rope_layout, **kw)

        b = micro["x1"].shape[0]
        model_kwargs = dict(
            img_ids=micro["img_ids"], txt=micro["txt"].to(compute_dtype), txt_ids=micro["txt_ids"],
            txt_mask=micro["txt_mask"], img_mask=micro["img_mask"], y=micro["vec"].to(compute_dtype),
            guidance=torch.ones((b,), dtype=compute_dtype, device=micro["x1"].device),
        )
        return transport.training_losses(
            model_fn, micro["x1"].to(compute_dtype), model_kwargs=model_kwargs,
            cond=micro["cond"].to(compute_dtype), img_mask=micro["img_mask"],
            t=draw.get("t"), noise=draw.get("noise"), generator=generator,
        )

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None,
                   draws: list[dict] | None = None) -> dict[str, torch.Tensor]:
        trainable = state.trainable()
        leaves = list(trainable.values())
        differentiated = state.differentiated()
        for p in differentiated:
            p.grad = None
        accum = batch["x1"].shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            terms = loss_fn(state, micro, generator, draws[i] if draws else {})
            loss = terms["loss"].mean()
            loss.backward()
            loss_sum += loss.detach()
        with torch.no_grad():
            for p in differentiated:
                p.grad = (p.grad if p.grad is not None else torch.zeros_like(p)).div_(accum)
            grad_norm = _global_norm([p.grad for p in differentiated])
            grads = [p.grad for p in leaves]
            clip_norm = _global_norm(grads)  # the trainable leaves' norm: optax's clip sits inside the mask
            if not bool(clip_norm < optimizer.grad_clip):  # optax clip_by_global_norm
                grads = [g / clip_norm * optimizer.grad_clip for g in grads]
            for p, g in zip(leaves, grads):
                p.grad = g
        state.opt_state.step()
        for p in differentiated:
            p.grad = None
        if state.ema is not None and ema_decay is not None:
            update_ema(state.ema, trainable, ema_decay)
        state.step += 1
        return {"loss": loss_sum / accum, "grad_norm": grad_norm}

    return train_step
