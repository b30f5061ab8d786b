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

Across ranks (a parallel.Mesh in the state) the loss is the mean over the
n = dp x fsdp x pp shares of the batch, so every gradient is a sum over
those ranks divided by n (the cp ranks of a share each hold their tokens'
part of its gradient, summed over cp first): a leaf every rank holds is summed over all of
them (a pp stage's LoRA entries of the trunk get gradients on their stage
only, the sum carries them to all); a pp stage's own trunk weights (the
full-model types; no other stage holds them) already hold every pp
share's contribution and are summed over dp x fsdp; FSDP2 has averaged
its sharded parameters over dp x fsdp itself. The clip's global norm sums
each sharded tensor's squares over its shard group. "sdp" (ZeRO-2, JAX's
opt_mesh) keeps the trainable leaves whole on every rank but gives each
dp x fsdp rank 1/n of their gradients (a reduce-scatter) and of the AdamW
state (`ZeroAdamW`), then gathers the updated leaves.
With a pp mesh the forward runs the single trunk as a GPipe pipeline
(`pp_microbatches`, default pp), with a RingSpec the attention is ring
attention.

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
import torch.distributed as dist
from torch import nn

from ..models.lora import tree_items, tree_leaves, tree_map
from ..ops.attention import RingSpec
from ..parallel.collectives import all_reduce_, group_size
from ..parallel.mesh import DATA_AXES, SYNC_AXES
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
    mesh: Any | None = None  # parallel.Mesh when the step runs across ranks

    def trainable(self) -> dict[str, torch.Tensor]:
        """The leaves the optimizer updates, by dotted name."""
        if self.lora is not None:
            return dict(tree_items(self.lora))
        return {n: p for n, p in self.params.named_parameters() if self.mask is None or self.mask[n]}

    def differentiated(self) -> dict[str, torch.Tensor]:
        """The leaves whose gradients the step computes and logs the norm of,
        by name: the trainable ones, and in the masked types every base leaf."""
        if self.lora is not None:
            return dict(tree_items(self.lora))
        return {n: p for n, p in self.params.named_parameters() if p.requires_grad}


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


def _flat_sum_(grads: list[torch.Tensor], group) -> None:
    """Sum the gradients over `group` in place, as one flat all-reduce."""
    if not grads or group_size(group) == 1:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1).to(torch.float32) for g in grads]), group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


class ZeroAdamW:
    """ZeRO-2 AdamW (the trainer's --sdp): the leaves stay whole on every
    rank; dp x fsdp rank r keeps the fp32 slice r of their concatenation as
    the one parameter of a torch AdamW (its moments 1/n of the whole).
    step(): the gradients (those of leaves every pp stage holds first summed
    over pp) are reduce-scattered over dp x fsdp into the slice, averaged
    over the n batch shares, clipped by the global norm and applied, and the
    updated slices are all-gathered back into the leaves. AdamW is
    elementwise, so the update equals the unsharded one. `axes`: per leaf,
    the mesh axes its tensor is a shard over (`norm_axes`); the leaves are
    ordered by them, so that each kind's squares sum over its own axes."""

    def __init__(self, leaves: list[torch.Tensor], mesh, axes: list[tuple[str, ...]], grad_clip: float, **adamw):
        kinds = sorted(set(axes))
        order = [i for kind in kinds for i in range(len(leaves)) if axes[i] == kind]
        self.leaves = [leaves[i] for i in order]
        self.axes = [axes[i] for i in order]
        self.mesh, self.grad_clip = mesh, grad_clip
        self.group = mesh.group(DATA_AXES)
        self.n, self.rank = group_size(self.group), mesh.rank(DATA_AXES)
        self.per = -(-sum(t.numel() for t in leaves) // self.n)
        flat = self._flat([t.detach() for t in self.leaves])
        self.shard = nn.Parameter(flat[self.rank * self.per:(self.rank + 1) * self.per].clone())
        self.opt = torch.optim.AdamW([self.shard], **adamw)

    def _flat(self, ts: list[torch.Tensor]) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in ts])
        return torch.nn.functional.pad(flat, (0, self.per * self.n - flat.numel()))

    def reduce_grads(self) -> torch.Tensor:
        """The slice of the averaged gradient; returns the squared global
        norm of the whole gradient."""
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in self.leaves]
        _flat_sum_(grads, self.mesh.group("cp"))  # each cp rank's tokens' part
        _flat_sum_([g for g, ax in zip(grads, self.axes) if "pp" not in ax], self.mesh.group("pp"))
        flat = self._flat(grads)
        if self.n > 1 and dist.get_backend(self.group) == "nccl":
            g = torch.empty(self.per, dtype=flat.dtype, device=flat.device)
            dist.reduce_scatter_tensor(g, flat, group=self.group)
        else:  # gloo has no reduce-scatter of one tensor
            g = all_reduce_(flat, self.group)[self.rank * self.per:(self.rank + 1) * self.per].clone()
        self.shard.grad = g.div_(self.mesh.size(SYNC_AXES))
        total, start = torch.zeros((), dtype=torch.float32, device=g.device), 0
        for kind in sorted(set(self.axes)):  # the slice's elements of each kind, in the flat order
            end = start + sum(t.numel() for t, ax in zip(self.leaves, self.axes) if ax == kind)
            lo, hi = (min(max(x - self.rank * self.per, 0), self.per) for x in (start, end))
            part = all_reduce_(g[lo:hi].square().sum(), self.group)
            for a in kind:
                all_reduce_(part, self.mesh.group(a))
            total, start = total + part, end
        return total

    @torch.no_grad()
    def step(self, clip_norm: torch.Tensor) -> None:
        if not bool(clip_norm < self.grad_clip):
            self.shard.grad.mul_(self.grad_clip / clip_norm)
        self.opt.step()
        parts = [self.shard.detach()]
        if self.n > 1:
            parts = [torch.empty_like(self.shard) for _ in range(self.n)]
            dist.all_gather(parts, self.shard.detach(), group=self.group)
        flat, off = torch.cat(parts), 0
        for t in self.leaves:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    def state_dict(self) -> dict:
        return self.opt.state_dict() | {"shard": self.shard.detach().clone()}

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        with torch.no_grad():
            self.shard.copy_(state.pop("shard"))
        self.opt.load_state_dict(state)


def init_train_state(
    params: nn.Module,
    lora,
    optimizer: OptimizerConfig,
    training_type: str = "lora",
    use_ema: bool = False,
    mask: dict[str, bool] | None = None,
    mesh=None,
    sdp: bool = False,
) -> TrainState:
    """Make the differentiated leaves require grad (the LoRA leaves, or every
    base parameter) and build the AdamW state over the trainable ones (the LoRA
    leaves, or the base parameters that `mask` keeps, all of them without a
    mask); the EMA starts as a copy of those leaves. mesh: the parallel.Mesh
    the step runs on; sdp: ZeRO-2, the AdamW state sharded over its data
    ranks (ZeroAdamW)."""
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
                       mask=None if training_type == "lora" else mask, mesh=mesh)
    trainable = state.trainable()
    adamw = dict(lr=optimizer.lr, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=optimizer.weight_decay)
    if sdp:
        if mesh is None:
            raise ValueError("sdp (ZeRO-2) needs a mesh")
        state.opt_state = ZeroAdamW(list(trainable.values()), mesh,
                                    [norm_axes(n, t, state) for n, t in trainable.items()], optimizer.grad_clip,
                                    **adamw)
    else:
        state.opt_state = torch.optim.AdamW(list(trainable.values()), **adamw)
    if use_ema:
        state.ema = {k: v.detach().clone() for k, v in prune_to_mask(trainable, mask).items()}
    return state


def norm_axes(name: str, g: torch.Tensor, state: TrainState) -> tuple[str, ...]:
    """The mesh axes over which the tensor of leaf `name` is a shard, so that
    its squares sum over them in the global norm: FSDP2's over fsdp,
    tensor-parallel weights over tp, a pp stage's own weights over pp,
    MoE-LoRA experts over ep; () for a replica."""
    from torch.distributed.tensor import DTensor

    mesh, axes = state.mesh, []
    if isinstance(g, DTensor):
        axes.append("fsdp")
    if state.lora is None and name in getattr(state.params, "tp_sharded", ()):
        axes.append("tp")
    if stage_local(name, state):
        axes.append("pp")
    if state.lora is not None and mesh.shape["ep"] > 1 and name.endswith((".expert_a", ".expert_b")):
        axes.append("ep")
    return tuple(axes)


def _sq_norm(grads: dict[str, torch.Tensor], state: TrainState) -> torch.Tensor:
    """Sum of squares of every element of the (named) gradients, fp32, across
    ranks: each shard's squares summed over its `norm_axes`, replicas
    counted once."""
    by_axes: dict[tuple[str, ...], list[torch.Tensor]] = {}
    for name, g in grads.items():
        axes = norm_axes(name, g, state)
        g = g.to_local() if "fsdp" in axes else g
        by_axes.setdefault(axes, []).append(g.to(torch.float32).square().sum())
    total = None
    for axes, sqs in by_axes.items():
        part = sum(sqs[1:], sqs[0])  # in order: one group of replicas sums as the one-process norm does
        for a in axes:
            all_reduce_(part, state.mesh.group(a))
        total = part if total is None else total + part
    return total


def _global_norm(grads: dict[str, torch.Tensor], state: TrainState | None = None) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element, fp32."""
    if state is None:
        return torch.sqrt(sum(g.to(torch.float32).square().sum() for g in grads.values()))
    return torch.sqrt(_sq_norm(grads, state))


def stage_local(name: str, state: TrainState) -> bool:
    """A pp stage's own trunk weight (full-model types): no other stage holds it."""
    mesh = state.mesh
    return state.lora is None and mesh is not None and mesh.shape["pp"] > 1 and name.startswith("single_blocks.")


def _sync_grads(grads: dict[str, torch.Tensor], state: TrainState) -> None:
    """Turn every rank's gradients of its own share's loss into those of the
    mean loss over the n = dp x fsdp x pp shares (see the module docstring):
    every gradient first summed over cp (each cp rank's is its tokens'
    part), then leaves every rank holds summed over all of them, a stage's own ones over
    dp x fsdp, in one flat all-reduce each; FSDP2's over pp (FSDP2 averaged
    them over dp x fsdp); then each divided by its remaining factor."""
    from torch.distributed.tensor import DTensor

    mesh = state.mesh
    n, pp = mesh.size(SYNC_AXES), mesh.shape["pp"]
    plain = {k: g for k, g in grads.items() if not isinstance(g, DTensor)}
    _flat_sum_(list(plain.values()), mesh.group("cp"))
    for g in grads.values():
        if isinstance(g, DTensor):
            all_reduce_(g.to_local(), mesh.group("cp"))
    everywhere = [g for k, g in plain.items() if not stage_local(k, state)]
    own = [g for k, g in plain.items() if stage_local(k, state)]
    _flat_sum_(everywhere, mesh.group(SYNC_AXES))
    _flat_sum_(own, mesh.group(DATA_AXES))
    for g in plain.values():
        g.div_(n)
    for k, g in grads.items():
        if isinstance(g, DTensor) and pp > 1:
            if not stage_local(k, state):
                all_reduce_(g.to_local(), mesh.group("pp"))
            g.to_local().div_(pp)


def _cast_model(flux: nn.Module, compute_dtype: torch.dtype):
    """flux itself when its weights are in the compute dtype (or FSDP2 casts
    them: its mixed-precision policy), else a function that runs it on
    weights cast per call (differentiably)."""
    from ..parallel.sharding import is_fsdp

    if all(p.dtype == compute_dtype for p in flux.parameters()) or is_fsdp(flux):
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
    attn_impl=None,
    mesh=None,
    pp_microbatches: int | None = None,
):
    """The train step: train_step(state, batch, generator=None, draws=None)
    -> metrics {"loss", "grad_norm"} (fp32 scalars), updating `state` in place.

    batch: x1, cond, img_ids, img_mask, txt, txt_ids, txt_mask, vec, each
    (accum, micro_bs, ...) -- this rank's share of it across ranks -- the
    micro-batches are run in turn and their gradients averaged. t and the
    noise come from `generator`, or per micro-batch from draws[i] = {"t":
    ..., "noise": ...}. attn_impl: None or a RingSpec (cp); mesh with pp > 1:
    the single trunk pipelined in pp_microbatches (default pp) microbatches."""
    if training_type not in TRAINING_TYPES:
        raise ValueError(training_type)
    if mesh is not None and mesh.shape["cp"] > 1 and not isinstance(attn_impl, RingSpec):
        raise ValueError("a mesh with cp > 1 splits the sequence: pass attn_impl=RingSpec(mesh, 'cp')")
    pipeline = None
    if mesh is not None and mesh.shape["pp"] > 1:
        from ..parallel.pipeline import PipelineSpec

        pipeline = PipelineSpec(mesh, pp_microbatches or mesh.shape["pp"])

    def loss_fn(state: TrainState, micro: dict, generator, draw: dict):
        model = _cast_model(state.params, compute_dtype)
        clora = None
        if state.lora is not None:
            clora = tree_map(lambda t: t.to(compute_dtype) if t.dtype == torch.float32 else t, state.lora)

        def model_fn(img, timesteps, **kw):
            return model(img=img.to(compute_dtype), timesteps=timesteps, lora=clora, remat=remat,
                         remat_policy=remat_policy, rope_layout=rope_layout, attn_impl=attn_impl,
                         pipeline=pipeline, **kw)

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
        for p in differentiated.values():
            p.grad = None
        accum = batch["x1"].shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            terms = loss_fn(state, micro, generator, draws[i] if draws else {})
            loss = terms["loss"].mean()
            loss.backward()
            loss_sum += loss.detach()
        zero = state.opt_state if isinstance(state.opt_state, ZeroAdamW) else None
        with torch.no_grad():
            for p in differentiated.values():
                p.grad = (p.grad if p.grad is not None else torch.zeros_like(p)).div_(accum)
            if state.mesh is not None:
                _sync_grads({n: p.grad for n, p in differentiated.items() if zero is None or n not in trainable},
                            state)
            if zero is not None:  # ZeRO-2: the trainable gradients are reduce-scattered instead
                clip_sq = zero.reduce_grads()
                frozen = {n: p.grad for n, p in differentiated.items() if n not in trainable}
                grad_norm = torch.sqrt(clip_sq + (_sq_norm(frozen, state) if frozen else 0.0))
                zero.step(torch.sqrt(clip_sq))
            else:
                across = state if state.mesh is not None else None
                grad_norm = _global_norm({n: p.grad for n, p in differentiated.items()}, across)
                grads = [p.grad for p in leaves]
                clip_norm = _global_norm(dict(zip(trainable, grads)), across)  # optax's clip sits inside the mask
                if not bool(clip_norm < optimizer.grad_clip):  # optax clip_by_global_norm
                    grads = [g / clip_norm * optimizer.grad_clip for g in grads]
                for p, g in zip(leaves, grads):
                    p.grad = g
        if zero is None:
            state.opt_state.step()
        for p in differentiated.values():
            p.grad = None
        if state.ema is not None and ema_decay is not None:
            update_ema(state.ema, trainable, ema_decay)
        state.step += 1
        loss = loss_sum / accum
        if state.mesh is not None:  # the mean over every rank's share of the batch
            n = state.mesh.size(SYNC_AXES)
            loss = all_reduce_(loss, state.mesh.group(SYNC_AXES)) / n
        return {"loss": loss, "grad_norm": grad_norm}

    return train_step
