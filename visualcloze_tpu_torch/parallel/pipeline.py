"""Pipeline parallelism over the pp mesh axis: GPipe over the single-block
trunk (counterpart of visualcloze_tpu/parallel/pipeline.py).

FLUX's 38 single blocks are uniform and 38 = 2 x 19, so the trunk splits
into pp equal stages (parallel/sharding.shard_params keeps only this stage's
blocks); the embedders, the 19 double blocks and the final layer run data-
parallel across pp, each pp rank on its share of the batch. The trunk
gathers the pp ranks' streams into one batch, cuts it into M microbatches
(M % pp == 0) and runs T = M + pp - 1 ticks: at tick t stage s runs
microbatch t - s and sends its output to stage s + 1 (`batch_isend_irecv`);
the last stage's outputs go back to every rank (one sum over pp), which
keeps its own share.

JAX gets the reverse pipeline from jax.grad of the tick scan. Autograd does
not cross a send or receive, so the backward is written out: the trunk is
one autograd Function whose forward keeps each (stage, microbatch) graph and
whose backward runs the ticks in reverse -- stage s back-propagates
microbatch t - (pp - 1 - s) at tick t, the last stage from the output's
gradient, the others from the gradient stage s + 1 sends -- accumulating
the stage's LoRA (or weight) gradients where they live and returning the
gradients of the gathered stream and of the modulation vector.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from .collectives import all_gather_cat, all_reduce_, gather_cat, group_size, own_block


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Run Flux's single trunk pipelined over mesh's pp axis in `microbatches`
    microbatches (default pp)."""

    mesh: object
    microbatches: int | None = None


def stage_range(depth: int, mesh) -> range:
    """The single blocks this rank's pp stage owns."""
    pp = mesh.shape["pp"]
    if depth % pp:
        raise ValueError(f"depth_single_blocks={depth} not divisible by pp={pp}")
    per = depth // pp
    return range(mesh.coord["pp"] * per, (mesh.coord["pp"] + 1) * per)


class _Remote(torch.nn.Module):
    """The place of a single block another pp stage holds."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this single block lives on another pipeline stage")


def keep_stage_blocks(flux, mesh) -> None:
    """Drop the single blocks of the other pp stages (their memory is the
    point of pp)."""
    mine = stage_range(len(flux.single_blocks), mesh)
    for i in range(len(flux.single_blocks)):
        if i not in mine:
            flux.single_blocks[i] = _Remote()


def _p2p(group, sends: list, recvs: list) -> None:
    """One batch of sends [(tensor, group rank)] and receives [(buffer, group rank)]."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, r), group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, r), group) for t, r in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Trunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vec, anchor, stage, side, group, m):
        """anchor: a scalar that requires grad whenever the caller's grad mode
        is on, so that the backward runs even if neither x nor vec needs a
        gradient (the stage's own leaves may)."""
        pp, s = group_size(group), dist.get_rank(group)
        grad = anchor.requires_grad
        xs, vecs = x.chunk(m), vec.chunk(m)
        sides = [tuple(t.chunk(m)[j] if t is not None else None for t in side) for j in range(m)]
        ctx.graphs = {}
        out = torch.zeros_like(x)
        outs = out.chunk(m)
        recv = None
        for t in range(m + pp - 1):
            j = t - s
            y = None
            if 0 <= j < m:
                with torch.set_grad_enabled(grad):
                    inp = (xs[j] if s == 0 else recv).detach().requires_grad_(grad)
                    vj = vecs[j].detach().requires_grad_(grad and vec.requires_grad)
                    y = stage(inp, vj, *sides[j])
                if grad:
                    ctx.graphs[j] = (inp, vj, y)
                if s == pp - 1:
                    outs[j].copy_(y.detach())
            sends = [(y.detach().contiguous(), s + 1)] if y is not None and s < pp - 1 else []
            recvs = []
            if s > 0 and 0 <= t - (s - 1) < m:
                recv = torch.empty_like(xs[0])
                recvs = [(recv, s - 1)]
            _p2p(group, sends, recvs)
        ctx.group, ctx.m, ctx.x_grad = group, m, x.requires_grad
        return all_reduce_(out, group)  # only the last stage wrote: a broadcast

    @staticmethod
    def backward(ctx, g):
        group, m = ctx.group, ctx.m
        pp, s = group_size(group), dist.get_rank(group)
        g = all_reduce_(g.contiguous().clone(), group).chunk(m)  # each rank held its own share's gradient
        dx = [torch.zeros_like(c) for c in g]
        dvec = [None] * m
        recv = None
        for t in range(m + pp - 1):
            j = t - (pp - 1 - s)
            send = None
            if 0 <= j < m:
                inp, vj, y = ctx.graphs.pop(j)
                grad_y = g[j] if s == pp - 1 else recv
                torch.autograd.backward([y], [grad_y])
                if vj.grad is not None:
                    dvec[j] = vj.grad
                if inp.grad is not None:
                    if s == 0:
                        dx[j] = inp.grad
                    else:
                        send = inp.grad.contiguous()
                elif s > 0:
                    send = torch.zeros_like(inp)
            sends = [(send, s - 1)] if send is not None else []
            recvs = []
            if s < pp - 1 and 0 <= t - (pp - 2 - s) < m:
                recv = torch.empty_like(g[0])
                recvs = [(recv, s + 1)]
            _p2p(group, sends, recvs)
        dvec_full = None
        if any(d is not None for d in dvec):
            ref = next(d for d in dvec if d is not None)
            dvec_full = torch.cat([d if d is not None else torch.zeros_like(ref) for d in dvec])
        return (torch.cat(dx) if ctx.x_grad else None), dvec_full, None, None, None, None, None


def pipeline_single_trunk(flux, spec: PipelineSpec, x, vec, pe, attn_mask, slora, *, lora_scale=1.0,
                          attn_impl=None, remat: bool = False, remat_policy: str | None = "dots",
                          rope_layout: str = "interleaved"):
    """The single-block stack of `flux` as a GPipe pipeline over spec.mesh's
    pp axis. x: (B, L, H) this rank's share of the concat(txt, img) stream;
    vec, pe, attn_mask: its side inputs (embed_inputs); slora: the single
    blocks' LoRA entries (all of them; this stage uses its own). Returns
    (B, L, H), equal to the sequential trunk."""
    from ..ops.attention import RingSpec
    from ..models.flux import _checkpointed

    mesh = spec.mesh
    pp = mesh.shape["pp"]
    if pp <= 1:
        raise ValueError("pipeline_single_trunk needs a pp>1 mesh axis")
    if isinstance(attn_impl, RingSpec):
        raise ValueError("pipeline parallelism cannot nest a RingSpec (cp ring attention) inside the "
                         "trunk; pick one of --cp and --pp")
    if remat and remat_policy == "dots_split":
        raise ValueError("remat_policy='dots_split' (two-segment seg remat) is not implemented for the "
                         "pipelined trunk; use 'dots' or full with --pp")
    mine = stage_range(len(flux.single_blocks), mesh)
    group = mesh.group("pp")
    m = spec.microbatches or pp
    b = x.shape[0] * pp  # the gathered batch
    if b % m or m % pp:
        raise ValueError(f"need B({b}) % M({m}) == 0 and M % pp({pp}) == 0 (microbatches)")

    def stage(h, vec_mb, cos, sin, mask):
        for i in mine:
            fn = functools.partial(flux.single_blocks[i], lora_scale=lora_scale, rope_layout=rope_layout,
                                   attn_impl=attn_impl)
            if remat:
                fn = _checkpointed(fn, remat_policy)
            h = fn(h, vec_mb, (cos, sin), mask, slora[i] if slora else None)
        return h

    xg = gather_cat(x, group, 0)
    vg = gather_cat(vec, group, 0)
    side = tuple(None if t is None else all_gather_cat(t, group, 0) for t in (pe[0], pe[1], attn_mask))
    anchor = torch.ones((), device=x.device, requires_grad=torch.is_grad_enabled())
    out = _Trunk.apply(xg, vg, anchor, stage, side, group, m)
    return _OwnShare.apply(out, group)


class _OwnShare(torch.autograd.Function):
    """This rank's share of a tensor every pp rank holds whole; the gradient
    is zero outside the share (the trunk's backward sums the shares)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.shape = group, x.shape
        return own_block(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        full = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        full.chunk(group_size(ctx.group))[dist.get_rank(ctx.group)].copy_(g)
        return full, None
