"""Kernel N (ops/group_norm.py) on the CPU, and the DiT's serving route
that no longer reaches kernel A.

- group_norm_stats_plain against JAX's `group_norm_affine`, and
  group_norm_apply_plain (act none and swish) against JAX's `group_norm`
  and `swish(group_norm(...))`, on NHWC inputs made with numpy: two VAE-like
  shapes and a tiny-config C < 32 (groups = min(32, C)), in fp32 and bf16.
  Bounds: fp32 max |Δ| <= 1e-6 of the largest |want| (the same fp32 chain,
  sums in another order); bf16 inputs: a and bb 1e-6 of their largest
  (fp32 statistics of the same bf16 values) and the bf16 outputs one bf16
  ulp at the largest (JAX may round sigmoid(h) * h once where PyTorch
  rounds twice).
- The wrappers on CPU tensors run their plain versions bit for bit and
  count no launch; the tiny VAE calls N's statistics once per GroupNorm
  and the apply once per attention block and norm_out (chip_smoke's
  group_norm_calls, which the card's launch checks use).
- stats_plan, the design kernel N's statistics take on an H100 (132 SMs,
  232,448 bytes of shared memory a CTA, a 50 MiB L2): the design, cluster
  and block at each of a default query's 16 shapes, a CTA's bytes within
  the limit, every channel (so every group) of every batch element in one
  cluster and every pixel in one CTA; a torch fp32 emulation of the cluster design's
  partition and summation order against JAX's `group_norm_affine` (1e-5 of
  the largest a and bb); profile_step's class for the new kernel's symbol.
- The half layout without a gradient (serving's route) with kernel A's
  entry patched to raise: the tiny double and single blocks and the tiny
  DiT complete through kernel L's rotation and match JAX within
  tests/test_torch_rope_fusion.py's and test_torch_models.py's bounds
  (1e-4 of the output RMS).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from visualcloze_tpu.config import AutoEncoderConfig as JaxAutoEncoderConfig
from visualcloze_tpu.config import FluxConfig
from visualcloze_tpu.models import autoencoder as jae
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu_torch import convert, ops
from visualcloze_tpu_torch.config import AutoEncoderConfig
from visualcloze_tpu_torch.models import autoencoder as tae
from visualcloze_tpu_torch.ops import attention as tatt
from visualcloze_tpu_torch.ops.group_norm import (CLUSTER_WARPS, MAX_BLOCK_CHUNKS, MAX_CLUSTER, MOMENTS_CONSUMERS,
                                                  MOMENTS_STAGE_BYTES, cluster_plan, group_norm, group_norm_apply,
                                                  group_norm_apply_plain, group_norm_plain, group_norm_stats,
                                                  group_norm_stats_plain, moments_plan, moments_tile, stats_plan)
from visualcloze_tpu_torch.profile_step import GROUP_NORM_KERNEL, vae_class

F32, BF16 = torch.float32, torch.bfloat16
JAX_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}
SHAPES = [(2, 16, 24, 64), (1, 8, 8, 512), (1, 6, 10, 16)]  # the last: the tiny configs' C < 32


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Tiny ops: one intra-op thread under several test workers, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(shape, seed):
    """x with per-channel offsets (the group mean matters), scale and bias."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape) * rng.uniform(0.5, 3.0, c) + rng.uniform(-2.0, 2.0, c)
    scale = 1.0 + 0.2 * rng.standard_normal(c)
    bias = 0.3 * rng.standard_normal(c)
    return [a.astype(np.float32) for a in (x, scale, bias)]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_rel(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _assert_ulp(got, want, what):
    """One bf16 ulp at the largest |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_jax(shape, dtype):
    x, scale, bias = _inputs(shape, sum(shape))
    jd = JAX_DTYPE[dtype]
    p = {"scale": jnp.asarray(scale).astype(jd), "bias": jnp.asarray(bias).astype(jd)}
    jx = jnp.asarray(x).astype(jd)
    tx = torch.from_numpy(x).to(dtype)
    tscale, tbias = torch.from_numpy(scale).to(dtype), torch.from_numpy(bias).to(dtype)
    groups = min(32, shape[-1])
    a, bb = group_norm_stats_plain(tx, tscale, tbias, groups)
    wa, wbb = jae.group_norm_affine(p, jx)
    assert a.dtype == bb.dtype == F32
    _assert_rel(a, wa, 1e-6, "a")
    _assert_rel(bb, wbb, 1e-6, "bb")
    close = (lambda g, w, what: _assert_rel(g, w, 1e-6, what)) if dtype == F32 else _assert_ulp
    y = group_norm_apply_plain(tx, a, bb)
    assert y.dtype == dtype
    close(y, jae.group_norm(p, jx), "apply")
    close(group_norm_apply_plain(tx, a, bb, "swish"), jae.swish(jae.group_norm(p, jx)), "apply + swish")


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_wrappers_on_cpu_tensors_run_the_plain_versions_and_count_no_launch(dtype):
    x, scale, bias = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 5, 7, 64), 3))
    ops.reset_kernel_launches()
    a, bb = group_norm_stats(x, scale, bias, 32)
    pa, pbb = group_norm_stats_plain(x, scale, bias, 32)
    assert torch.equal(a, pa) and torch.equal(bb, pbb)
    for act in ("none", "swish"):
        assert torch.equal(group_norm_apply(x, a, bb, act), group_norm_apply_plain(x, a, bb, act))
    with pytest.raises(ValueError, match="unknown act"):
        group_norm_apply(x, a, bb, "gelu")
    assert ops.kernel_launches()["group_norm_stats"] == 0
    assert ops.kernel_launches()["group_norm_apply"] == 0


@pytest.mark.parametrize("act", ["none", "swish"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_group_norm_on_cpu_tensors_is_the_plain_two_step_and_counts_no_launch(dtype, act):
    """The folded entry group_norm on a CPU tensor: the plain statistics,
    then the plain apply, bit for bit (group_norm_plain too); no launch."""
    x, scale, bias = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 5, 7, 64), 4))
    ops.reset_kernel_launches()
    got = group_norm(x, scale, bias, 32, act=act)
    want = group_norm_apply_plain(x, *group_norm_stats_plain(x, scale, bias, 32), act)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(group_norm_plain(x, scale, bias, 32, act=act), want)
    with pytest.raises(ValueError, match="unknown act"):
        group_norm(x, scale, bias, 32, act="gelu")
    assert not any(ops.kernel_launches().values())


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 8, 8, 512), (2, 16, 24, 128), (1, 6, 10, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_group_norm_matches_jax(shape, dtype):
    """group_norm (act none and swish) against JAX's `group_norm` and
    `swish(group_norm(...))` at the VAE's 512 and 128 channels and the tiny
    configs' C < 32: test_plain_versions_match_jax's bounds."""
    x, scale, bias = _inputs(shape, sum(shape) + 1)
    jd = JAX_DTYPE[dtype]
    p = {"scale": jnp.asarray(scale).astype(jd), "bias": jnp.asarray(bias).astype(jd)}
    jx = jnp.asarray(x).astype(jd)
    tx, tscale, tbias = (torch.from_numpy(v).to(dtype) for v in (x, scale, bias))
    groups = min(32, shape[-1])
    close = (lambda g, w, what: _assert_rel(g, w, 1e-6, what)) if dtype == F32 else _assert_ulp
    close(group_norm(tx, tscale, tbias, groups), jae.group_norm(p, jx), "group_norm")
    close(group_norm(tx, tscale, tbias, groups, act="swish"), jae.swish(jae.group_norm(p, jx)), "group_norm + swish")


def test_the_tiny_vae_calls_n_once_per_group_norm(monkeypatch):
    """Encoder and decoder of the tiny VAE: N's statistics once per resnet
    GroupNorm (two a resnet block), group_norm (the statistics and the
    apply, folded where the card's plan allows) at the attention block and
    norm_out (with swish there), as chip_smoke.group_norm_calls counts them;
    and the same numbers as JAX's encode_moments / decode on the same weights
    (1e-4, test_vae_tiny_matches_jax's bound)."""
    cfg = AutoEncoderConfig().tiny()
    seen = {"stats": 0, "none": 0, "swish": 0}

    def stats(*args, **kwargs):
        seen["stats"] += 1
        return group_norm_stats(*args, **kwargs)

    def folded(x, scale, bias, groups, eps=1e-6, act="none"):
        seen[act] += 1
        return group_norm(x, scale, bias, groups, eps, act)

    monkeypatch.setattr(tae, "group_norm_stats", stats)
    monkeypatch.setattr(tae, "group_norm_act", folded)
    jcfg = JaxAutoEncoderConfig().tiny()
    jmodel = jae.AutoEncoder(jcfg, jae.init_autoencoder(jax.random.PRNGKey(5), jcfg))
    model = convert.vae_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    got = model.encode_moments(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.encode_moments(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    calls = chip_smoke.group_norm_calls(cfg)
    assert seen == {"stats": calls["encode"]["stats"], "none": 1, "swish": 1}, seen
    z = rng.standard_normal((1, 4, 6, cfg.z_channels)).astype(np.float32)
    got = model.decoder(torch.from_numpy(z)).numpy()
    want = np.asarray(jae.decoder_apply(jcfg, jmodel.params["decoder"], jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert seen == {"stats": calls["encode"]["stats"] + calls["decode"]["stats"], "none": 2, "swish": 2}, seen
    assert calls["encode"]["group_norm"] == calls["decode"]["group_norm"] == 2
    full = chip_smoke.group_norm_calls(AutoEncoderConfig())
    assert full == {"encode": {"stats": 20, "group_norm": 2}, "decode": {"stats": 28, "group_norm": 2}}


@pytest.fixture
def no_kernel_a(monkeypatch):
    """Kernel A's entry (attention's flash_mha_rope) raises if reached."""

    def refuse(*args, **kwargs):
        raise AssertionError("the DiT reached kernel A's route")

    monkeypatch.setattr(tatt, "flash_mha_rope", refuse)


@pytest.mark.parametrize("kind", ["double", "single"])
def test_the_serving_route_rotates_in_l_without_kernel_a(no_kernel_a, kind):
    """The half layout with no gradient: the tiny blocks complete with
    kernel A's entry raising, and equal JAX's (1e-4 of each output's RMS)."""
    from test_torch_rope_fusion import _assert_rms_close, _block_run

    for what, got, want in _block_run(kind, "half", False):
        _assert_rms_close(got, want, what)


def test_the_tiny_dit_serves_without_kernel_a(no_kernel_a):
    """The tiny DiT's no-grad forward in the half layout (the pipeline's)
    with padding masks, kernel A's entry raising: L rotates at every block
    and the velocity equals JAX's flux_apply within 1e-4 of its RMS."""
    from test_torch_models import _flux_inputs

    cfg = FluxConfig().tiny()
    params = init_flux(jax.random.PRNGKey(1), cfg)
    inp = _flux_inputs(cfg, 2, 64, 16, 0, True)
    want = np.asarray(jax_flux_apply(cfg, params, **{k: jnp.asarray(v) for k, v in inp.items()},
                                     rope_layout="half", attn_impl="xla"))
    model = convert.flux_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(np.array(v)) for k, v in inp.items()}, rope_layout="half").numpy()
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert float(np.abs(got - want).max()) <= 1e-4 * rms


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_native_group_norm_yardstick_computes_kernel_n(shape):
    """The PyTorch call chip_smoke.py times beside N (aten's
    native_group_norm on the channels-last view of x) computes the plain
    apply of N's statistics without an act: fp32, max |Δ| <= 1e-5 of the
    largest output (its statistics sum in another order)."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(shape, 7))
    b, h, w, c = shape
    out, _, _ = torch.ops.aten.native_group_norm(x.permute(0, 3, 1, 2), scale, bias, b, c, h * w, 32, 1e-6)
    want = group_norm_apply_plain(x, *group_norm_stats_plain(x, scale, bias, 32))
    _assert_rel(out.permute(0, 2, 3, 1), want, 1e-5, "native_group_norm")


H100 = (132, 232448, 52428800)  # SMs, the shared memory a CTA may opt in to, L2 bytes
QUERY = (((384, 1152), 2, 2), ((1024, 1024), 2, 1))  # (image, encodes, decodes) of a default query
# the design and (cluster, groups a block) stats_plan gives each shape of a default query on an H100
QUERY_PLANS = {
    # x of at most CLUSTER_MAX_BYTES, rows of 32 bytes or more: a cluster holds the slab
    (1, 48, 144, 512): ("cluster", 8, 4), (1, 96, 288, 256): ("cluster", 8, 4), (1, 128, 128, 512): ("cluster", 8, 2),
    (1, 96, 288, 512): ("cluster", 8, 2),
    # 16-byte rows, or larger x: one read of x by the moments design
    **{s: ("moments", 1, 32) for s in ((1, 192, 576, 128), (1, 256, 256, 256), (1, 192, 576, 256), (1, 512, 512, 128),
                                       (1, 256, 256, 512), (1, 384, 1152, 128), (1, 192, 576, 512), (1, 512, 512, 256),
                                       (1, 384, 1152, 256), (1, 1024, 1024, 128), (1, 512, 512, 512),
                                       (1, 1024, 1024, 256))}}
ON_CLUSTER = 93  # of a default query's 178 statistics calls


def _query_shapes() -> dict:
    """{x shape: statistics calls} of a default query's VAE work."""
    cfg, out = AutoEncoderConfig(), {}
    for hw, enc, dec in QUERY:
        for part, n in (("encode", enc), ("decode", dec)):
            for shape, calls in chip_smoke.group_norm_shapes(cfg, *hw, part).items():
                out[shape] = out.get(shape, 0) + n * calls
    return out


def test_the_query_runs_sixteen_group_norm_shapes():
    shapes = _query_shapes()
    assert len(shapes) == 16 and sum(shapes.values()) == 178
    small = {s: n for s, n in shapes.items() if math.prod(s) * 2 <= 34e6}
    assert small == {(1, 48, 144, 512): 42, (1, 128, 128, 512): 31, (1, 96, 288, 512): 18, (1, 96, 288, 256): 2,
                     (1, 256, 256, 256): 2, (1, 192, 576, 128): 2}


@pytest.mark.parametrize("shape", sorted(QUERY_PLANS), ids=lambda s: "x".join(map(str, s)))
def test_stats_plan_at_the_query_shapes(shape):
    """The design, cluster and block of every default-query shape:
    ON_CLUSTER of the query's 178 statistics calls on the cluster design,
    the others one read of x each; the moments design one CTA an SM at
    most, 2 stages of 32 KB."""
    p = stats_plan(*shape, 32, *H100)
    assert (p.design, p.cluster, p.block_groups) == QUERY_PLANS[shape], p
    if p.design == "moments":
        assert p.ctas <= H100[0] and p.stages == 2 and p.cta_bytes == 2 * MOMENTS_STAGE_BYTES
    on_cluster = sum(n for s, n in _query_shapes().items() if QUERY_PLANS[s][0] == "cluster")
    assert on_cluster == ON_CLUSTER


def test_the_query_folds_eleven_group_norms():
    """A default query's VAE work on an H100 by chip_smoke.group_norm_launches:
    every attention-block norm and the encoders' norm_outs sit at a latent
    the cluster design holds, one group_norm launch each (11); the three
    decoders' norm_outs at full resolution take the statistics and the
    apply; the statistics launch at the other 167 of the 178 GroupNorms."""
    cfg, total = AutoEncoderConfig(), {"group_norm_stats": 0, "group_norm_apply": 0, "group_norm": 0}
    for (h, w), enc, dec in QUERY:
        for part, n, shape in (("encode", enc, (1, h, w, 3)), ("decode", dec, (1, h // 8, w // 8, cfg.z_channels))):
            for k, v in chip_smoke.group_norm_launches(cfg, shape, part, H100).items():
                total[k] += n * v
    assert total == {"group_norm_stats": 167, "group_norm_apply": 3, "group_norm": 11}
    assert sum(_query_shapes().values()) == total["group_norm_stats"] + total["group_norm"]


PLAN_CASES = sorted(_query_shapes()) + [(2, 37, 91, 512), (4, 48, 144, 512), (1, 37, 91, 128), (3, 5, 7, 128),
                                        (1, 64, 64, 2048), (1, 1, 3, 256), (8, 128, 128, 512), (1, 8, 8, 32),
                                        (2, 37, 91, 384), (300, 4, 4, 256)]


@pytest.mark.parametrize("shape", PLAN_CASES, ids=lambda s: "x".join(map(str, s)))
def test_stats_plan_covers_every_group_and_pixel_once(shape):
    """The plan on an H100: a cluster design's CTA fits the card's shared
    memory, its cluster is a power of two up to 8, its group blocks are 8 K
    channels (K a power of two up to 32) and tile the channels once, its
    ranks' pixel ranges tile the pixels once, and its rows are 32 bytes or
    more; the moments design's CTAs take runs of whole tiles that cover the
    pixels once, none empty, in teams whose tickets fit a slot."""
    b, h, w, c = shape
    groups = min(32, c)
    plan = stats_plan(b, h, w, c, groups, *H100)
    hw, cg = h * w, c // groups
    if plan.design == "moments":
        assert plan.block_groups == groups and plan.cluster == 1 and 2 <= plan.stages <= 6
        assert plan.per % moments_tile(c) == 0 and b * plan.ctas <= max(H100[0], b)
        seen_pixels = np.zeros(hw, int)
        for r in range(plan.ctas):
            run = range(r * plan.per, min(hw, (r + 1) * plan.per))
            assert len(run) > 0
            seen_pixels[run.start:run.stop] += 1
        assert (seen_pixels == 1).all()
        assert plan.team == math.ceil(math.sqrt(plan.ctas)) and b * (-(-plan.ctas // plan.team) + 1) <= 4096
        return
    channels = plan.block_groups * cg
    k = channels // 8
    assert channels % 8 == 0 and k <= MAX_BLOCK_CHUNKS and k & (k - 1) == 0
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= MAX_CLUSTER
    assert plan.cta_bytes <= H100[1]
    assert plan.cta_bytes == plan.per * channels * 2 + (CLUSTER_WARPS + 4) * channels * 4
    assert channels * 2 >= 32
    # the grid as the kernel reads it: blockIdx.x / cluster is the group block, the rank its pixel share
    seen_channels = np.zeros(c, int)
    for blk in range(plan.ctas // plan.cluster):
        seen_channels[blk * channels:(blk + 1) * channels] += 1
        assert (blk * channels) % cg == 0  # a block holds whole groups
    assert (seen_channels == 1).all()
    seen_pixels = np.zeros(hw, int)
    for rank in range(plan.cluster):
        seen_pixels[rank * plan.per:min(hw, (rank + 1) * plan.per)] += 1
    assert (seen_pixels == 1).all()


def test_stats_plan_sizes_clusters_as_designed():
    """Rows of up to 128 bytes (one L2 line) where 8 CTAs hold the slab, then
    the cluster halves while a CTA's share fits half its shared memory; the
    cluster design only for x of at most CLUSTER_MAX_BYTES, the moments
    design above and wherever no cluster holds the slab in 32-byte rows."""
    p = stats_plan(1, 48, 144, 512, 32, *H100)  # 4 groups: 128-byte rows, 113 KB a CTA
    assert (p.design, p.cluster, p.block_groups, p.ctas, p.per) == ("cluster", 8, 4, 64, 864)
    p = stats_plan(2, 37, 91, 512, 32, *H100)  # 3367 pixels: 4 CTAs of 110 KB
    assert (p.design, p.cluster, p.block_groups) == ("cluster", 4, 4)
    assert stats_plan(1, 8, 8, 32, 32, *H100).cluster == 1
    assert stats_plan(1, 37, 91, 128, 32, *H100).block_groups == 16  # C = 128: 16 groups of 4 channels a row
    assert stats_plan(1, 64, 64, 2048, 32, *H100).block_groups == 1  # 64 channels a group: one 128-byte row
    # cg = 12: no run of whole groups is 8 K channels with K a power of two
    assert stats_plan(2, 37, 91, 384, 32, *H100).design == "moments"
    # 16-byte rows (the slab fits 8 CTAs only one 8-channel block wide), and x above CLUSTER_MAX_BYTES or the L2
    assert cluster_plan(1, 192, 576, 128, 32, H100[1]) is None
    assert stats_plan(1, 24, 72, 128, 32, *H100).design == "cluster"
    assert cluster_plan(1, 128, 256, 512, 32, H100[1]) is not None
    assert stats_plan(1, 128, 256, 512, 32, *H100).design == "moments"
    assert stats_plan(1, 48, 144, 512, 32, 132, 232448, 4 << 20).design == "moments"
    # one CTA an SM over the batch, runs of whole tiles
    p = moments_plan(1, 1024 * 1024, 128, 32, 132)
    assert (p.ctas, p.per, p.team, p.stages) == (131, 63 * 128, 12, 2)
    p = moments_plan(2, 37 * 91, 512, 32, 132)
    assert (p.ctas, p.per, p.team) == (53, 64, 8)
    with pytest.raises(ValueError, match="bytes of shared memory a CTA"):
        stats_plan(1, 1024, 1024, 128, 32, 132, 48 << 10, 52428800)


def emulate_cluster_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                          eps: float = 1e-6, parts: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The cluster design (csrc/group_norm.cu group_norm_stats_resident) in
    torch fp32, one operation per kernel step, on cluster_plan's H100 plan:
    thread t of a CTA sums its chunks t, t + 512, ... in order; a butterfly
    over the warp's lanes of the same chunk; the 16 warps in order; the
    cluster's ranks in order; / HW; the group's channels in order; / cg;
    pass 2 the same on (x - mu)^2. parts: a dict that receives each rank's
    pass-2 sums ("pass2", (b, blocks, cluster, channels)) and the group
    means by channel ("mu_c", (b, blocks, channels))."""
    b, h, w, c = x.shape
    plan = cluster_plan(b, h, w, c, groups, H100[1])
    hw, cg, cl, per = h * w, c // groups, plan.cluster, plan.per
    channels = plan.block_groups * cg
    k, nblk, threads = channels // 8, c // channels, 32 * CLUSTER_WARPS
    x = x.float().reshape(b, hw, nblk, k, 8).permute(0, 2, 1, 3, 4)  # (b, blk, pixel, chunk, 8)
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, cl * per - hw))
    valid = (torch.arange(cl * per) < hw)[:, None].expand(cl * per, k)
    chunks = x.reshape(b, nblk, cl, per * k, 8)
    valid = valid.reshape(cl, per * k)
    j = -(-per * k // threads)
    chunks = torch.nn.functional.pad(chunks, (0, 0, 0, j * threads - per * k)).reshape(b, nblk, cl, j, threads, 8)
    valid = torch.nn.functional.pad(valid, (0, j * threads - per * k)).reshape(cl, j, threads, 1)
    lane = torch.arange(32)
    chunk_of_thread = torch.arange(threads) % k

    def cta_sums(acc):  # (b, blk, cl, threads, 8) -> (b, blk, cl, channels)
        acc = acc.reshape(b, nblk, cl, CLUSTER_WARPS, 32, 8)
        off = 16
        while off >= k:
            acc = acc + acc[:, :, :, :, lane ^ off]
            off //= 2
        wsum = acc[:, :, :, :, :k].reshape(b, nblk, cl, CLUSTER_WARPS, channels)
        v = torch.zeros(b, nblk, cl, channels)
        for wi in range(CLUSTER_WARPS):
            v = v + wsum[:, :, :, wi]
        return v

    def cluster_means(part):  # (b, blk, cl, channels) -> channel means, then group means
        v = torch.zeros(b, nblk, channels)
        for r in range(cl):
            v = v + part[:, :, r]
        chan = (v / float(hw)).reshape(b, nblk, plan.block_groups, cg)
        g = torch.zeros(b, nblk, plan.block_groups)
        for i in range(cg):
            g = g + chan[..., i]
        return g / float(cg)

    acc = torch.zeros(b, nblk, cl, threads, 8)
    for i in range(j):
        acc = acc + torch.where(valid[:, i], chunks[:, :, :, i], 0.0)
    mu = cluster_means(cta_sums(acc))  # (b, blk, block_groups)
    mu_c = mu.repeat_interleave(cg, dim=-1)  # (b, blk, channels)
    mu_t = mu_c.reshape(b, nblk, k, 8)[:, :, chunk_of_thread][:, :, None]  # (b, blk, 1, threads, 8)
    acc = torch.zeros(b, nblk, cl, threads, 8)
    for i in range(j):
        d = chunks[:, :, :, i] - mu_t
        acc = acc + torch.where(valid[:, i], d * d, 0.0)
    pass2 = cta_sums(acc)
    if parts is not None:
        parts.update(pass2=pass2, mu_c=mu_c)
    var = cluster_means(pass2)
    rsig = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1).reshape(b, c)
    a = rsig * scale.float()[None]
    return a, bias.float()[None] - mu_c.reshape(b, c) * a


@pytest.mark.parametrize("shape", [(1, 48, 144, 512), (1, 128, 128, 512), (2, 37, 91, 512), (1, 37, 91, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_design_order_matches_jax(shape):
    """The emulated cluster design on bf16 x, scale and bias against JAX's
    group_norm_affine on the same values: a and bb within 1e-5 of their
    largest magnitude (fp32 sums in another order)."""
    x, scale, bias = (torch.from_numpy(v).to(BF16) for v in _inputs(shape, sum(shape)))
    a, bb = emulate_cluster_stats(x, scale, bias, 32)
    p = {"scale": jnp.asarray(scale.float().numpy()).astype(jnp.bfloat16),
         "bias": jnp.asarray(bias.float().numpy()).astype(jnp.bfloat16)}
    wa, wbb = jae.group_norm_affine(p, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    _assert_rel(a, wa, 1e-5, "a")
    _assert_rel(bb, wbb, 1e-5, "bb")


@pytest.mark.parametrize("shape", [(1, 48, 144, 512), (1, 128, 128, 512), (2, 37, 91, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_folded_launch_forms_the_same_a_and_bb_in_every_rank(shape):
    """The folded launch's order (csrc/group_norm.cu resident_body, Y > 0):
    each rank of a cluster reads every rank's pass-2 sums through DSMEM in
    rank order (its own part a copy among them, ranks past the cluster +0)
    and forms var, a and bb itself. Emulated per rank on the emulated
    cluster design's partial sums: every rank's a and bb equal rank 0's
    bits, which the statistics launch writes, and the apply of them is
    within the bound of JAX's group_norm + swish."""
    x, scale, bias = (torch.from_numpy(v).to(BF16) for v in _inputs(shape, sum(shape)))
    parts = {}
    a0, bb0 = emulate_cluster_stats(x, scale, bias, 32, parts=parts)
    plan = cluster_plan(*shape, 32, H100[1])
    b, h, w, c = shape
    cg, channels = c // 32, plan.block_groups * (c // 32)
    mu_c = parts["mu_c"]  # (b, blocks, channels)
    for rank in range(plan.cluster):
        # this rank's view: a copy of each peer's shared-memory part, read in rank order
        view = [parts["pass2"][:, :, r].clone() for r in range(plan.cluster)]
        total = torch.zeros_like(view[0])
        for r in range(MAX_CLUSTER):
            total = total + (view[r] if r < plan.cluster else 0.0)
        chan = (total / float(h * w)).reshape(*total.shape[:2], plan.block_groups, cg)
        var = torch.zeros(chan.shape[:-1])
        for i in range(cg):
            var = var + chan[..., i]
        var = (var / float(cg)).repeat_interleave(cg, dim=-1)
        a = (torch.rsqrt(var + 1e-6) * scale.float().reshape(-1, channels)[None]).reshape(b, c)
        bb = bias.float()[None] - mu_c.reshape(b, c) * a
        assert torch.equal(a, a0) and torch.equal(bb, bb0), rank
    p = {"scale": jnp.asarray(scale.float().numpy()).astype(jnp.bfloat16),
         "bias": jnp.asarray(bias.float().numpy()).astype(jnp.bfloat16)}
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    _assert_ulp(group_norm_apply_plain(x, a0, bb0, "swish"), jae.swish(jae.group_norm(p, jx)), "apply + swish")


def emulate_moments_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, plan,
                          eps: float = 1e-6, one_pass: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The moments design (csrc/group_norm.cu group_norm_stats_moments_kernel)
    in torch fp32, one operation per kernel step, on `plan`: CTA r takes
    pixels [r * per, + per) in tiles of 8 P pixels; consumer (t, p) holds
    pixels p, p + P, ..., p + 7 P of a tile at channels 8 t .. 8 t + 7, pieces
    of W = gcd(cg, 8) channels; per tile the channel sums (vectors in order),
    piece means, the moment about them (vectors, then channels), merged into
    the thread's pieces by the identity; the CTA's channel sums (lanes in
    order), group means and moments about them (lanes, then pieces); teams of
    `team` CTAs merged in order by the last of each, the teams by the last
    team, the final means in JAX's order. one_pass: the same partition and
    order with sums of x and x^2 in place of the moments, var = E[x^2] -
    E[x]^2 (what the kernel does not do)."""
    b, h, w, c = x.shape
    hw, cg, G = h * w, c // groups, groups
    T = c // 8
    P = MOMENTS_CONSUMERS // T
    tp, W = moments_tile(c), math.gcd(cg, 8)
    n, per, team = plan.ctas, plan.per, plan.team
    ntiles, pieces = per // tp, cg // W
    r = torch.arange(n)[:, None, None, None]
    pix = r * per + torch.arange(ntiles)[:, None, None] * tp + torch.arange(P)[:, None] + torch.arange(8) * P
    valid = pix < torch.clamp(r * per + per, max=hw)  # (n, tiles, P, 8)
    data = x.float().reshape(b, hw, c)[:, pix.clamp(max=hw - 1)]
    data = torch.where(valid[None, ..., None], data, 0.0).reshape(b, n, ntiles, P, 8, T, 8)
    zeros = lambda *s: torch.zeros(b, n, P, *s)  # noqa: E731
    acc, mean, m2, seen = zeros(T, 8), zeros(T, 8 // W), zeros(T, 8 // W), torch.zeros(1, n, P, 1, 1)
    for k in range(ntiles):
        f = data[:, :, k]  # (b, n, P, vector, T, channel)
        cnt = valid[:, k].sum(-1).float()[None, :, :, None, None]
        live = cnt > 0
        ts = zeros(T, 8)
        for q in range(8):
            ts = ts + f[:, :, :, q]
        s = zeros(T, 8 // W)
        for j in range(W):
            s = s + ts.reshape(b, n, P, T, 8 // W, W)[..., j]
        tm = s / (cnt * W)
        tq = zeros(T, 8 // W)
        for q in range(8):
            on = valid[:, k, :, q][None, :, :, None, None]
            for j in range(8):
                d = f[:, :, :, q, :, j] if one_pass else f[:, :, :, q, :, j] - tm[..., j // W]
                tq[..., j // W] = torch.where(on[..., 0], tq[..., j // W] + d * d, tq[..., j // W])
        if one_pass:  # raw sums: of x (from the channel sums) and of x^2
            mean, m2 = torch.where(live, mean + s, mean), torch.where(live, m2 + tq, m2)
        else:
            tot = seen + cnt
            frac = cnt / tot
            wgt = (seen * frac) * W
            d = tm - mean
            mean = torch.where(live, mean + d * frac, mean)
            m2 = torch.where(live, m2 + (tq + wgt * (d * d)), m2)
            seen = torch.where(live, tot, seen)
        acc = acc + ts
    if one_pass:
        seen = valid.sum((1, 3)).float()[None, :, :, None, None]
    # the CTA's row
    red = acc.reshape(b, n, P, c)
    chan = torch.zeros(b, n, c)
    for q in range(P):
        chan = chan + red[:, :, q]
    npix = (torch.clamp(torch.arange(n) * per + per, max=hw) - torch.arange(n) * per).float()[None, :, None]
    pmean, pm2 = (t.reshape(b, n, P, G, pieces) for t in (mean, m2))
    lanes = seen.reshape(1, n, P)
    m = torch.zeros(b, n, G)
    for j in range(cg):
        m = m + chan.reshape(b, n, G, cg)[..., j]
    m = (m / npix) / cg
    M2 = torch.zeros(b, n, G)
    for q in range(P):
        wq = (lanes[:, :, q] * W)[..., None]
        for i in range(pieces):
            if one_pass:
                M2 = M2 + pm2[:, :, q, :, i]
            else:
                d = pmean[:, :, q, :, i] - m
                M2 = M2 + (pm2[:, :, q, :, i] + wq * (d * d))

    def combine(chan, m, M2, first, U, final):  # rows (b, k, ...) of units first.. of U pixels
        k = chan.shape[1]
        units = first + torch.arange(k)
        upix = (torch.clamp((units + 1) * U, max=hw) - torch.clamp(units * U, max=hw)).float()
        s = torch.zeros(b, c)
        for i in range(k):
            s = s + chan[:, i]
        mm = torch.zeros(b, G)
        for j in range(cg):
            mm = mm + (s.reshape(b, G, cg)[..., j] / float(hw) if final else s.reshape(b, G, cg)[..., j])
        mm = (mm if final else mm / float(min(hw, (first + k) * U) - first * U)) / cg
        q2 = torch.zeros(b, G)
        for i in range(k):
            if one_pass:
                q2 = q2 + M2[:, i]
            else:
                d = m[:, i] - mm
                q2 = q2 + (M2[:, i] + (upix[i] * cg) * (d * d))
        return s, mm, q2

    teams = -(-n // team)
    if teams > 1:
        parts = [combine(chan[:, j * team:(j + 1) * team], m[:, j * team:(j + 1) * team],
                         M2[:, j * team:(j + 1) * team], j * team, per, False) for j in range(teams)]
        chan, m, M2 = (torch.stack(t, 1) for t in zip(*parts))
        per = team * per
    _, mu, q2 = combine(chan, m, M2, 0, per, True)
    var = (q2 / float(hw)) / cg
    if one_pass:
        var = var - mu * mu
    rsig = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1)
    a = rsig * scale.float()[None]
    return a, bias.float()[None] - mu.repeat_interleave(cg, dim=-1) * a


def _jax_affine(x, scale, bias, groups=32):
    p = {"scale": jnp.asarray(scale.float().numpy()).astype(jnp.bfloat16),
         "bias": jnp.asarray(bias.float().numpy()).astype(jnp.bfloat16)}
    return jae.group_norm_affine(p, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), groups)


# (shape, CTAs a batch element or None: one an SM): C 128, 256, 384 and 512; ragged pixel counts and last tiles;
# batch 2; several tiles a CTA (the identity within a thread) and several teams (two merge levels)
MOMENTS_CASES = [((1, 40, 72, 128), None), ((2, 37, 91, 512), None), ((1, 48, 64, 256), 5), ((1, 33, 47, 256), 3),
                 ((2, 24, 40, 384), 4), ((1, 45, 50, 128), 1)]


def _case_id(v) -> str:
    return "x".join(map(str, v)) if isinstance(v, tuple) else f"{v}ctas" if v else "ctas_an_sm"


@pytest.mark.parametrize("shape, ctas", MOMENTS_CASES, ids=_case_id)
def test_moments_design_order_matches_jax(shape, ctas):
    """The emulated moments design on bf16 x, scale and bias against JAX's
    group_norm_affine on the same values: a and bb within 1e-5 of their
    largest magnitude (fp32 sums in another order, the moment pooled from
    tile-centred pieces)."""
    x, scale, bias = (torch.from_numpy(v).to(BF16) for v in _inputs(shape, sum(shape)))
    b, h, w, c = shape
    plan = moments_plan(b, h * w, c, 32, H100[0], ctas=ctas)
    assert plan.ctas * plan.per >= h * w > (plan.ctas - 1) * plan.per
    a, bb = emulate_moments_stats(x, scale, bias, 32, plan)
    wa, wbb = _jax_affine(x, scale, bias)
    _assert_rel(a, wa, 1e-5, "a")
    _assert_rel(bb, wbb, 1e-5, "bb")


@pytest.mark.parametrize("shape, ctas", [((1, 40, 72, 128), None), ((1, 48, 64, 256), 5), ((2, 37, 91, 512), None)],
                         ids=_case_id)
def test_moments_design_holds_a_large_offset_where_one_pass_fails(shape, ctas):
    """Groups whose mean lies 30 of their standard deviations from 0 (one
    offset and spread a group, bf16): the moments design's order stays
    within 1e-5 of JAX's largest a and bb, while E[x^2] - E[x]^2 over the
    same partition and order does not (5-14 times the bound), so the bound
    tells the two orders apart."""
    rng = np.random.default_rng(sum(shape))
    b, h, w, c = shape
    sd = np.repeat(rng.uniform(0.5, 2.0, 32), c // 32)
    x = torch.from_numpy((rng.standard_normal(shape) * sd + 30.0 * sd).astype(np.float32)).to(BF16)
    scale = torch.from_numpy((1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)).to(BF16)
    bias = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32)).to(BF16)
    plan = moments_plan(b, h * w, c, 32, H100[0], ctas=ctas)
    wa, wbb = _jax_affine(x, scale, bias)
    a, bb = emulate_moments_stats(x, scale, bias, 32, plan)
    _assert_rel(a, wa, 1e-5, "a")
    _assert_rel(bb, wbb, 1e-5, "bb")
    a1, _ = emulate_moments_stats(x, scale, bias, 32, plan, one_pass=True)
    err = float(np.abs(_f32(a1) - _f32(wa)).max())
    assert err > 1e-5 * float(np.abs(_f32(wa)).max()), err


def test_profile_step_classes_both_statistics_kernels_as_n():
    """The demangled symbols of kernel N's kernels, both statistics
    designs' templated ones and the folded launch's included, are class
    "group norm (kernel N)"; kernel B's and aten's are not."""
    for name in ("void (anonymous namespace)::group_norm_stats_resident<2>(__nv_bfloat16 const*, void const*, "
                 "void const*, int, float*, float*, int, int, int, int, int, float)",
                 "(anonymous namespace)::group_norm_stats_resident<32>(__nv_bfloat16 const*)",
                 "void (anonymous namespace)::group_norm_stats_moments_kernel<4>(__nv_bfloat16 const*, void const*)",
                 "void (anonymous namespace)::group_norm_apply_kernel<false>(__nv_bfloat16 const*)",
                 "void (anonymous namespace)::group_norm_fused_resident<8, true>(__nv_bfloat16 const*, void const*)"):
        assert GROUP_NORM_KERNEL.search(name) and vae_class(name) == "group norm (kernel N)", name
    for name in ("void (anonymous namespace)::conv3x3_kernel<true, true>(CUtensorMap_st, CUtensorMap_st)",
                 "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>(long, float)",
                 "void at::native::(anonymous namespace)::ComputeFusedParamsCUDAKernel<float>(long, long)"):
        assert vae_class(name) != "group norm (kernel N)", name


def _finite_bf16() -> tuple[torch.Tensor, np.ndarray]:
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = bits[torch.isfinite(bits)]
    return x, x.float().numpy()


def _to_bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(BF16).float().numpy()


def _ulps_each(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps at want's magnitude (the smallest normal's below it)."""
    mag = np.maximum(np.abs(want), np.float32(2.0 ** -126)).astype(np.float64)
    return np.abs(got.astype(np.float64) - want.astype(np.float64)) / np.exp2(np.floor(np.log2(mag)) - 7)


def swish_cu(h: np.ndarray, guard: bool = True, ex2_ulps: int = 0, rcp_ulps: int = 0) -> np.ndarray:
    """csrc/group_norm.cu's swish (`sigmoid`, `apply8`) of bf16 values h in
    its operation order, fp32, rounded to bf16:

        d = 2^(h * -log2 e) + 1;  s = (1 / (d * 2^-64)) * 2^-64
        y = h * bf16(s)      (a bf16x2 multiply: the product is exact in fp32)

    ex2.approx and rcp.approx emulated by the correctly rounded fp32 values
    (the card's differ from them by an ulp or two; ex2_ulps and rcp_ulps
    move them by that many fp32 ulps of 2^-24), the last multiply rounding
    a subnormal s as fp32 does. guard False: rcp.approx.ftz of d itself,
    which flushes the subnormal 1 / d to zero."""
    f32 = np.float32
    with np.errstate(all="ignore"):
        e = np.exp2((h * f32(-1.4426950408889634)).astype(np.float64)) * (1 + ex2_ulps * 2.0 ** -24)
        d = (e.astype(f32) + f32(1)).astype(f32)
        if guard:
            r = (1.0 / (d * f32(2.0 ** -64)).astype(np.float64) * (1 + rcp_ulps * 2.0 ** -24)).astype(f32)
            s = (r * f32(2.0 ** -64)).astype(f32)
        else:
            s = np.where(d >= f32(2.0 ** 126), f32(0), (1.0 / d.astype(np.float64)).astype(f32))
        return _to_bf16((h * _to_bf16(s)).astype(f32))


def test_swish_formula_is_within_one_bf16_ulp_of_the_plain_version_on_every_bf16():
    """Kernel N's short sigmoid (one ex2 and one reciprocal) emulated over
    every finite bf16 h (65,280 bit patterns) against the plain version,
    bf16 h * torch.sigmoid(h) on the CPU: each within one bf16 ulp, with
    the count that differ; so too with the emulated ex2 and reciprocal off
    by up to 3 and 2 fp32 ulps either way (the approximations' error)."""
    hb, h = _finite_bf16()
    assert h.size == 65280
    want = group_norm_apply_plain(hb.reshape(1, 1, -1, 8), torch.ones(1, 8), torch.zeros(1, 8), "swish")
    want = want.reshape(-1).float().numpy()
    got = swish_cu(h)
    print(f"swish emulated: {int((got != want).sum())} of {h.size} bf16 results differ from the plain version's")
    assert float(_ulps_each(got, want).max()) <= 1
    for ex2_ulps in (-3, 3):
        for rcp_ulps in (-2, 2):
            off = swish_cu(h, ex2_ulps=ex2_ulps, rcp_ulps=rcp_ulps)
            assert float(_ulps_each(off, want).max()) <= 1, (ex2_ulps, rcp_ulps)


def test_the_swish_guard_keeps_the_subnormal_sigmoids():
    """Why `sigmoid` takes the reciprocal of d 2^-64 and scales it back:
    rcp.approx.ftz of d would flush sigmoid(h) to zero at h = -87.5, -88
    and -88.5, where the plain version's h * sigmoid(h) is a normal number
    (about -5e-37), many ulps from -0; with the scaling they are exact."""
    hb, h = _finite_bf16()
    want = (hb * torch.sigmoid(hb)).float().numpy()
    far = _ulps_each(swish_cu(h, guard=False), want) > 1
    assert sorted(h[far].tolist()) == [-88.5, -88.0, -87.5]
    assert float(_ulps_each(swish_cu(h)[far], want[far]).max()) == 0
