"""Ring attention: exact attention with the sequence split over a mesh axis
(counterpart of visualcloze_tpu/ops/ring_attention.py).

Each rank of the `cp` group holds its block of the queries, keys, values and
key bias and returns its block of the output, as JAX's shard_map does: the
DiT keeps its tokens split over cp from the input embedding to the final
layer (models/flux.py). The key/value blocks travel round the ring
(`dist.batch_isend_irecv` to the next rank, from the previous one); each
hop's transfer is posted before the current chunk's kernels run, so the two
overlap. Each hop's chunk output is merged into the running one with its
log-sum-exp in log2 units:  m = max(lse1, lse2); w_i = 2^(lse_i - m); o =
sum w_i o_i / sum w_i, rounded to the chunk dtype after every merge, as JAX
does.

The backward is fused (an autograd Function, no autograd through the
forward): a second ring pass recomputes each chunk's probabilities from the
saved GLOBAL lse and delta = rowsum(dO * O); dq accumulates locally in fp32
while the dk and dv accumulators travel with their chunk and take one last
rotation home.

Chunks run through kernel E (forward, `flash_attn_fwd_lse`) and kernel F
(backward, `chunk_bwd`: F-dq and F-dkv from the given lse and delta), whose
wrappers take their plain versions for CPU tensors. Chunk lengths are
L / cp, multiples of no tile (992 of the default 3968-token query at
cp = 4); the kernels take any length.

The schedule functions (`_ring_fwd_lse`, `_ring_bwd_pass`) work on lists of
per-rank blocks and a ring that rotates them: `GroupRing` over a process
group holds one block (this rank's), `LocalRing` holds all P blocks in one
process and rotates by indexing, the same schedule on one card.
Data-parallel ranks hold their own batch share already
(parallel/sharding.shard_micro_batches), the counterpart of JAX sharding
the batch over (dp, fsdp) inside its shard_map.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import group_size
from .flash_attention import chunk_bwd, flash_attn_fwd_lse


def _chunk_attention_lse(q, k, v, bias):
    """(o (B, H, Lq, D) in q.dtype, lse (B, H, Lq) fp32 in log2 units) of one chunk."""
    return flash_attn_fwd_lse(q.contiguous(), k.contiguous(), v.contiguous(), bias)


def _chunk_bwd(q, k, v, bias, do, lse, delta):
    """Partial (dq, dk, dv) in fp32 of one (query block, key chunk) pair from
    the global lse (log2 units) and delta = rowsum(dO * O_final)."""
    return tuple(t.to(torch.float32) for t in chunk_bwd(q, k, v, bias, do, lse, delta))


def _merge(o1, lse1, o2, lse2):
    """Merge two normalised chunk outputs by their log2 log-sum-exps; o is
    rounded to o1's dtype (JAX rounds after every merge). Fully masked
    chunks carry lse = -1e30: the weights stay finite (2^0 at worst)."""
    m = torch.maximum(lse1, lse2)
    e1, e2 = torch.exp2(lse1 - m), torch.exp2(lse2 - m)
    w1, w2 = e1[..., None], e2[..., None]
    o = (o1.to(torch.float32) * w1 + o2.to(torch.float32) * w2) / (w1 + w2)
    return o.to(o1.dtype), m + torch.log2(e1 + e2)


class _Posted:
    """A rotation in flight: wait() returns the received blocks."""

    def __init__(self, reqs, out):
        self.reqs, self.out = reqs, out

    def wait(self) -> tuple[list, ...]:
        for req in self.reqs:
            req.wait()
        return self.out


class GroupRing:
    """Rotation over a process group: each rank sends its blocks to the next
    rank and receives the previous rank's (JAX's ppermute i -> i + 1)."""

    def __init__(self, group):
        self.group = group
        self.size = group_size(group)
        if self.size > 1:
            r = dist.get_rank(group)
            self.next = dist.get_global_rank(group, (r + 1) % self.size)
            self.prev = dist.get_global_rank(group, (r - 1) % self.size)

    def start(self, *slots: list) -> _Posted:
        """Post the rotation of the slots (each a one-element list: this
        rank's block, or None). The send buffers are only read until wait()."""
        if self.size == 1:
            return _Posted([], slots)
        ops, out = [], []
        for (t,) in slots:
            if t is None:
                out.append([None])
                continue
            buf = torch.empty_like(t)
            ops += [dist.P2POp(dist.isend, t.contiguous(), self.next, self.group),
                    dist.P2POp(dist.irecv, buf, self.prev, self.group)]
            out.append([buf])
        return _Posted(dist.batch_isend_irecv(ops) if ops else [], tuple(out))


class LocalRing:
    """All P blocks in one process; a rotation moves block i to slot i + 1."""

    def __init__(self, size: int):
        self.size = size

    def start(self, *slots: list) -> _Posted:
        return _Posted([], tuple(s if s[0] is None else [s[-1]] + s[:-1] for s in slots))


def _ring_fwd_lse(qs, ks, vs, bs, ring):
    """Forward ring pass over per-rank blocks. Returns ([o], [lse])."""
    os_, lses = [None] * len(qs), [None] * len(qs)
    for hop in range(ring.size):
        nxt = ring.start(ks, vs, bs) if hop < ring.size - 1 else None  # travels while this hop's chunks run
        for i, (q, k, v, b) in enumerate(zip(qs, ks, vs, bs)):
            o_i, lse_i = _chunk_attention_lse(q, k, v, b)
            os_[i], lses[i] = (o_i, lse_i) if hop == 0 else _merge(os_[i], lses[i], o_i, lse_i)
        if nxt is not None:
            ks, vs, bs = nxt.wait()
    return os_, lses


def _ring_bwd_pass(qs, ks, vs, bs, os_, lses, dos, ring):
    """Backward ring pass: dq accumulates locally; the dk/dv accumulators
    rotate with their key chunk (after the hop's chunks add to them) and
    land home with the last hop's rotation."""
    deltas = [(do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1) for do, o in zip(dos, os_)]
    dqs, dks, dvs = [None] * len(qs), [None] * len(qs), [None] * len(qs)
    for hop in range(ring.size):
        nxt = ring.start(ks, vs, bs) if hop < ring.size - 1 else None
        for i in range(len(qs)):
            d = _chunk_bwd(qs[i], ks[i], vs[i], bs[i], dos[i], lses[i], deltas[i])
            if hop == 0:
                dqs[i], dks[i], dvs[i] = d
            else:
                dqs[i], dks[i], dvs[i] = dqs[i] + d[0], dks[i] + d[1], dvs[i] + d[2]
        if nxt is not None:
            ks, vs, bs = nxt.wait()
        dks, dvs = ring.start(dks, dvs).wait()
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)], [dk.to(k.dtype) for dk, k in zip(dks, ks)],
            [dv.to(v.dtype) for dv, v in zip(dvs, vs)])


class _RingAttention(torch.autograd.Function):
    """This rank's q, k, v and bias blocks in, its o block out."""

    @staticmethod
    def forward(ctx, q, k, v, bias, group):
        q, k, v = (t.contiguous() for t in (q, k, v))
        (o,), (lse,) = _ring_fwd_lse([q], [k], [v], [bias], GroupRing(group))
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.group = group
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, b, o, lse = ctx.saved_tensors
        (dq,), (dk,), (dv,) = _ring_bwd_pass([q], [k], [v], [b], [o], [lse], [do.contiguous()], GroupRing(ctx.group))
        return dq, dk, dv, None, None


def ring_attention(q, k, v, bias, mesh, axis: str = "cp") -> torch.Tensor:
    """Exact attention with the sequence split over the mesh axis `axis`.

    q, k, v: (B, H, L / n, D), this rank's block of the sequence (the n
    ranks of the axis hold equal blocks); bias: (B, L / n) additive fp32 key
    bias of this rank's keys, or None. Returns this rank's (B, H, L / n, D)
    block of full attention over the whole sequence; differentiable."""
    return _RingAttention.apply(q, k, v, bias, mesh.group(axis))
