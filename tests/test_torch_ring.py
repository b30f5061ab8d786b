"""Ring attention of the port (ops/ring_attention.py) against the JAX
package's on its 8 virtual CPU devices, and the port's chunk backward
against chunk_bwd_pallas in interpret mode.

The port's side runs on four gloo ranks (tests/torch_parallel_jobs.py),
each on its dp share of the batch and its cp block of the sequence; fp32,
max |Δ| <= 1e-5 against JAX forward and backward. The ring's schedule is
also run in one process over P chunks (LocalRing, as chip_smoke.py's
ring_chunks runs it on the card)."""

import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_jobs import RankGroup
from visualcloze_tpu.ops import flash_attention as jfa
from visualcloze_tpu.ops.attention import mask_to_bias as jmask_to_bias
from visualcloze_tpu.ops.ring_attention import ring_attention as jring
from visualcloze_tpu.parallel import create_mesh as jcreate_mesh
from visualcloze_tpu_torch.ops import flash_attention as fa
from visualcloze_tpu_torch.ops.ring_attention import LocalRing, _merge, _ring_bwd_pass, _ring_fwd_lse

TOL = 1e-5


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    g = RankGroup(4, tmp_path_factory.mktemp("ring"))
    yield g
    g.close()


def _case(b=2, h=2, L=32, d=16, seed=0, padded=True):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(4))
    bias = None
    if padded:
        mask = np.ones((b, L), np.int32)
        mask[0, L * 5 // 8:] = 0
        mask[-1, L - 3:] = 0
        bias = np.array(jmask_to_bias(jnp.asarray(mask)))
    return q, k, v, bias, do


def _interpret():
    orig = jfa.pl.pallas_call

    def call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    return um.patch.object(jfa.pl, "pallas_call", call)


def _jax_ring(q, k, v, bias, do, axes, impl):
    """JAX ring_attention's output and (dq, dk, dv) of <o, do> on the mesh."""
    mesh = jcreate_mesh(**axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])
    jb = None if bias is None else jnp.asarray(bias)

    def f(q, k, v):
        return jring(q, k, v, jb, mesh, axis="cp", impl=impl)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(do)))]


def _block(r, axes, b, L):
    """The (batch, sequence) block of the global arrays rank r holds."""
    dp, cp = axes.get("dp", 1), axes.get("cp", 1)
    i, j = r["coord"]["dp"], r["coord"]["cp"]
    return slice(i * b // dp, (i + 1) * b // dp), slice(None), slice(j * L // cp, (j + 1) * L // cp)


@pytest.mark.parametrize("axes, padded", [({"cp": 4}, True), ({"dp": 2, "cp": 2}, True), ({"cp": 4}, False)],
                         ids=["cp4-bias", "dp2-cp2-bias", "cp4-nobias"])
def test_ring_matches_jax_forward_and_backward(group4, axes, padded):
    """The port's ring (kernels E and F's plain versions on the CPU), each
    rank on its batch share and sequence block, against JAX's
    ring_attention with impl "xla": o, dq, dk, dv within 1e-5 on every
    rank's block."""
    q, k, v, bias, do = _case(padded=padded)
    want = dict(zip(("o", "dq", "dk", "dv"), _jax_ring(q, k, v, bias, do, axes, "xla")))
    for r in group4.run("job_ring", q=q, k=k, v=v, bias=bias, do=do, axes=axes, timeout=60):
        blk = _block(r, axes, q.shape[0], q.shape[2])
        for name, w in want.items():
            np.testing.assert_allclose(r[name], w[blk], rtol=0, atol=TOL, err_msg=name)


def test_ring_matches_jax_pallas_chunks_in_interpret_mode(group4):
    """JAX's ring with its Pallas chunk kernels (E's and F's counterparts,
    interpret mode) against the port's ring on E and F's plain versions, at
    cp 4 with a padding bias: 1e-5."""
    q, k, v, bias, do = _case(b=1, L=512, d=32, seed=3)
    bias[0, 400:] = -1e30
    with _interpret():
        want = _jax_ring(q, k, v, bias, do, {"cp": 4}, "pallas")
    for r in group4.run("job_ring", q=q, k=k, v=v, bias=bias, do=do, axes={"cp": 4}, timeout=60):
        blk = _block(r, {"cp": 4}, 1, 512)
        for name, w in zip(("o", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(r[name], w[blk], rtol=0, atol=TOL, err_msg=name)


def test_chunk_bwd_matches_jax_chunk_bwd_pallas():
    """chunk_bwd (F-dq and F-dkv's plain versions) against JAX's
    chunk_bwd_pallas (interpret mode) for one (query block, key chunk) pair
    of unequal, untiled lengths with the GLOBAL lse and delta: 1e-5."""
    rng = np.random.default_rng(4)
    b, h, lq, lk, d = 1, 2, 96, 160, 32
    q, do = (rng.standard_normal((b, h, lq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, lk, d)).astype(np.float32) for _ in range(2))
    bias = np.zeros((b, lk), np.float32)
    bias[0, 150:] = -1e30
    # a global lse / delta as the ring would hold them: from attention over more keys than this chunk
    lse = (rng.standard_normal((b, h, lq)) + 8.0).astype(np.float32)
    delta = rng.standard_normal((b, h, lq)).astype(np.float32)
    with _interpret():
        want = jfa.chunk_bwd_pallas(*(jnp.asarray(a) for a in (q, k, v, bias, do, lse, delta)))
    got = fa.chunk_bwd(*(torch.from_numpy(a) for a in (q, k, v, bias, do, lse, delta)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("P", [2, 4])
def test_local_ring_schedule_matches_whole_sequence(P):
    """The ring's own schedule in one process over P chunks, rotated by
    indexing (chip_smoke.py's ring_chunks on the CPU): o, dq, dk, dv against
    whole-sequence E and F (plain versions), 1e-5; a fully masked key chunk
    (lse -1e30 from E) merges without NaN."""
    q, k, v, bias, do = (torch.tensor(a) for a in _case(b=1, L=64, seed=5, padded=True))
    bias[0, 48:] = -1e30  # the last of 4 chunks has no key at all
    o, lse = fa.flash_fwd_lse_plain(q, k, v, bias)
    delta = (do * o).sum(-1)
    want = [o, fa.flash_bwd_dq_plain(q, k, v, bias, do, lse, delta),
            *fa.flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta)]

    def split(t, dim=2):
        return [c.contiguous() for c in t.chunk(P, dim=dim)]

    qs, ks, vs, dos, bs = split(q), split(k), split(v), split(do), split(bias, 1)
    os_, lses = _ring_fwd_lse(qs, ks, vs, bs, LocalRing(P))
    grads = _ring_bwd_pass(qs, ks, vs, bs, os_, lses, dos, LocalRing(P))
    got = [torch.cat(os_, 2)] + [torch.cat(g, 2) for g in grads]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=TOL, err_msg=name)


def test_merge_keeps_a_fully_masked_chunk_finite_and_rounds_per_merge():
    """_merge of a chunk with no key (o 0, lse -1e30) leaves the other chunk
    as it was, finite; two masked chunks stay 0; o is rounded to the chunk
    dtype (bf16) after the merge, as JAX rounds after every merge."""
    o1 = torch.randn(1, 1, 4, 8)
    lse1 = torch.randn(1, 1, 4)
    dead_o, dead_lse = torch.zeros_like(o1), torch.full_like(lse1, -1e30)
    o, lse = _merge(o1, lse1, dead_o, dead_lse)
    assert torch.equal(o, o1) and torch.allclose(lse, lse1)
    o, lse = _merge(dead_o, dead_lse, dead_o, dead_lse)
    assert torch.isfinite(o).all() and (o == 0).all() and torch.isfinite(lse).all()
    o, _ = _merge(o1.bfloat16(), lse1, o1.bfloat16(), lse1)
    assert o.dtype == torch.bfloat16
