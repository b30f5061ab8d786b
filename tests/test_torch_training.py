"""The port's trainer against the JAX package's: the loss, the time sampler,
LoRA linears, the tiny DiT with LoRA in the interleaved layout, batch
preparation, one accumulated train step (loss, grad norm, updated LoRA, EMA),
the remat policies, the reference-format LoRA export, and the CLI with
resume. Weights carry over with visualcloze_tpu_torch.convert; the random
draws JAX makes are handed to the port. Everything runs in fp32 on the CPU.
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visualcloze_tpu import transport as jtransport
from visualcloze_tpu.config import FluxConfig
from visualcloze_tpu.models import layers as jlayers
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu.models.lora import init_lora as jax_init_lora
from visualcloze_tpu.models.lora import randomize_lora_b
from visualcloze_tpu.pipeline.loader import random_components as jax_random_components
from visualcloze_tpu.training import checkpoint as jckpt
from visualcloze_tpu.training import step as jstep
from visualcloze_tpu.training.batch import prepare_train_batch as jax_prepare_train_batch
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch import transport as ttransport
from visualcloze_tpu_torch.models.conditioner import FallbackTokenizer, TextEncoder
from visualcloze_tpu_torch.models.layers import Linear
from visualcloze_tpu_torch.models.lora import init_lora, lora_param_count
from visualcloze_tpu_torch.ops import flash_attention as tfa
from visualcloze_tpu_torch.training import checkpoint as tckpt
from visualcloze_tpu_torch.training import step as tstep
from visualcloze_tpu_torch.training.batch import prepare_train_batch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close_trees(got, want, rtol, atol):
    flat_g, flat_w = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol, err_msg=jax.tree_util.keystr(path))


def test_training_losses_match_jax():
    """The masked velocity loss on the same t, noise and model (1e-6)."""
    rng = np.random.default_rng(0)
    b, L, c = 3, 40, 4
    x1, cond = rng.standard_normal((b, L, c)), rng.standard_normal((b, L, 6))
    noise, t = rng.standard_normal((b, L, c)), rng.uniform(0.05, 0.95, b)
    mask = np.ones((b, L), np.int32)
    mask[1, 30:] = 0
    w = rng.standard_normal((c + 6, c))

    def jmodel(img, timesteps, **kw):
        return img @ jnp.asarray(w, jnp.float32) * timesteps[:, None, None]

    def tmodel(img, timesteps, **kw):
        return img @ _t(w) * timesteps[:, None, None]

    jt = jtransport.create_transport("Linear", "velocity", snr_type="lognorm")
    want = jt.training_losses(jmodel, jax.random.PRNGKey(0), jnp.asarray(x1, jnp.float32),
                              cond=jnp.asarray(cond, jnp.float32), img_mask=jnp.asarray(mask),
                              t=jnp.asarray(t, jnp.float32), noise=jnp.asarray(noise, jnp.float32))
    tt = ttransport.create_transport("Linear", "velocity", snr_type="lognorm")
    got = tt.training_losses(tmodel, _t(x1), cond=_t(cond), img_mask=torch.from_numpy(mask), t=_t(t),
                             noise=_t(noise))
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=1e-6)


@pytest.mark.parametrize("snr_type, draw", [("lognorm", jax.random.normal), ("uniform", jax.random.uniform)])
def test_sample_t_matches_jax_given_the_base_draws(snr_type, draw):
    """sample_t's transform and resolution shift on JAX's own base draws (1e-6)."""
    key = jax.random.PRNGKey(4)
    jt = jtransport.create_transport("Linear", "velocity", snr_type=snr_type)
    want = jt.sample_t(key, 5, 4096 + 512)
    tt = ttransport.create_transport("Linear", "velocity", snr_type=snr_type)
    got = tt.sample_t(5, 4096 + 512, base=_t(draw(key, (5,))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_linear_with_lora_matches_jax():
    """linear + LoRA delta (x A B + B's bias) * scale (1e-5)."""
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((12, 20)).astype(np.float32), "b": rng.standard_normal(20).astype(np.float32)}
    lora = {"a": rng.standard_normal((12, 4)).astype(np.float32),
            "b": rng.standard_normal((4, 20)).astype(np.float32),
            "b_bias": rng.standard_normal(20).astype(np.float32)}
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    want = jlayers.linear(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jax.tree.map(jnp.asarray, lora), 0.5)
    lin = Linear(12, 20)
    with torch.no_grad():
        lin.weight.copy_(_t(p["w"].T))
        lin.bias.copy_(_t(p["b"]))
    got = lin(_t(x), {k: _t(v) for k, v in lora.items()}, 0.5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _flux_inputs(cfg, b, l_img, l_txt, seed, padded):
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(l_img))
    ids = np.zeros((b, l_img, 3), np.float32)
    ids[..., 0] = 1
    ids[..., 1] = (np.arange(l_img) // side)[None]
    ids[..., 2] = (np.arange(l_img) % side)[None]
    inp = dict(
        img=rng.standard_normal((b, l_img, cfg.in_channels)).astype(np.float32),
        img_ids=ids,
        txt=rng.standard_normal((b, l_txt, cfg.context_in_dim)).astype(np.float32),
        txt_ids=np.zeros((b, l_txt, 3), np.float32),
        timesteps=np.full((b,), 0.5, np.float32),
        y=rng.standard_normal((b, cfg.vec_in_dim)).astype(np.float32),
        guidance=np.full((b,), 3.5, np.float32),
    )
    if padded:
        img_mask = np.ones((b, l_img), np.int32)
        img_mask[:, l_img - l_img // 4:] = 0
        txt_mask = np.ones((b, l_txt), np.int32)
        txt_mask[-1, l_txt // 2:] = 0
        inp.update(img_mask=img_mask, txt_mask=txt_mask)
    return inp


def _tiny_lora(params, seed=1, scale=0.05):
    lora = jax_init_lora(jax.random.PRNGKey(seed), params, rank=4)
    return randomize_lora_b(lora, jax.random.PRNGKey(seed + 1), scale=scale)


@pytest.mark.parametrize("padded", [False, True])
def test_flux_tiny_with_lora_interleaved_matches_jax(padded):
    """flux_apply with a LoRA (random B) in the interleaved RoPE layout vs the
    port's Flux through kernel D's plain version; max|d| <= 1e-4 of the RMS."""
    cfg = FluxConfig().tiny()
    params = init_flux(jax.random.PRNGKey(1), cfg)
    lora = _tiny_lora(params)
    inp = _flux_inputs(cfg, 2, 64, 16, 3, padded)
    want = np.asarray(jax_flux_apply(cfg, params, **{k: jnp.asarray(v) for k, v in inp.items()},
                                     lora=lora, lora_scale=0.8, rope_layout="interleaved", attn_impl="xla"))
    model = convert.flux_from_jax(_np(params), cfg, device="cpu")
    tlora = convert.lora_from_jax(_np(lora), cfg, device="cpu")
    with torch.no_grad():
        got = model(**{k: _t(v) for k, v in inp.items()}, lora=tlora, lora_scale=0.8,
                    rope_layout="interleaved").numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.sqrt(np.mean(want ** 2))


def test_init_lora_mirrors_the_jax_tree():
    """Same entries, shapes (rank clamped to min(in, out)) and count; B zero."""
    cfg = FluxConfig().tiny()
    jl = _np(jax_init_lora(jax.random.PRNGKey(0), init_flux(jax.random.PRNGKey(1), cfg), rank=40))
    model = convert.flux_from_jax(_np(init_flux(jax.random.PRNGKey(1), cfg)), cfg, device="cpu")
    tl = init_lora(model, 40, generator=torch.Generator().manual_seed(0))
    got = convert.lora_to_jax(tl)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, jl)
    assert lora_param_count(tl) == sum(x.size for x in jax.tree.leaves(jl))
    assert all(not np.any(v) for k, v in jax.tree_util.tree_flatten_with_path(got)[0] if k[-1].key != "a")


def _text_encoders(jm):
    t5 = TextEncoder("t5", convert.t5_from_jax(_np(jm.t5.params), jm.t5.cfg, device="cpu"),
                     FallbackTokenizer(jm.t5.cfg.vocab_size), jm.t5.max_length)
    clip = TextEncoder("clip", convert.clip_from_jax(_np(jm.clip.params), jm.clip.cfg, device="cpu"),
                       FallbackTokenizer(jm.clip.cfg.vocab_size), jm.clip.max_length)
    return t5, clip


def test_prepare_train_batch_matches_jax():
    """Same numpy rng (query masks, caption dropout) and JAX's VAE noise handed
    in: masks, ids and packing exact; latents and text <= 1e-4."""
    jm = jax_random_components(jax.random.PRNGKey(0), tiny=True, dtype=jnp.float32, resolution=64)
    t5, clip = _text_encoders(jm)
    ae = convert.vae_from_jax(_np(jm.ae.params), jm.ae.cfg, device="cpu")
    r = np.random.default_rng(2)
    rows_batch = [[r.uniform(-1, 1, (64, 192, 3)).astype(np.float32) for _ in range(2)],
                  [r.uniform(-1, 1, (64, 128, 3)).astype(np.float32)],
                  [r.uniform(-1, 1, (64, 192, 3)).astype(np.float32) for _ in range(2)]]
    grid_shapes = [(3, 2), (2, 1), (3, 2)]
    prompts = ["a grid of edits", "two photos", "more photos here"]
    key = jax.random.PRNGKey(5)
    want = jax_prepare_train_batch(jm.ae, jm.t5, jm.clip, rows_batch, prompts, grid_shapes, key,
                                   np.random.default_rng(9), caption_dropout=0.5, bucket=128,
                                   compute_dtype=jnp.float32)
    noise = []  # JAX's draws: one split of the key per row shape, in order of first appearance
    for shape, n in (((64, 192), 4), ((64, 128), 1)):
        key, k1 = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k1, (2 * n, shape[0] // 8, shape[1] // 8, 4), jnp.float32)))
    got = prepare_train_batch(ae, t5, clip, rows_batch, prompts, grid_shapes, np.random.default_rng(9),
                              caption_dropout=0.5, bucket=128, compute_dtype=torch.float32, vae_noise=noise)
    for k in ("img_ids", "img_mask", "txt_ids", "txt_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("x1", "cond", "txt", "vec"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)


def _step_case(accum=2, L=48, Lt=16):
    cfg = FluxConfig().tiny()
    rng = np.random.default_rng(3)
    side = 8
    ids = np.zeros((accum, 1, L, 3), np.float32)
    ids[..., 0] = 1
    ids[..., 1] = np.arange(L) // side
    ids[..., 2] = np.arange(L) % side
    img_mask = np.ones((accum, 1, L), np.int32)
    img_mask[-1, 0, L - 8:] = 0
    batch = dict(
        x1=rng.standard_normal((accum, 1, L, cfg.out_channels)),
        cond=rng.standard_normal((accum, 1, L, cfg.in_channels - cfg.out_channels)),
        img_ids=ids, img_mask=img_mask,
        txt=rng.standard_normal((accum, 1, Lt, cfg.context_in_dim)),
        txt_ids=np.zeros((accum, 1, Lt, 3), np.float32), txt_mask=np.ones((accum, 1, Lt), np.int32),
        vec=rng.standard_normal((accum, 1, cfg.vec_in_dim)),
    )
    return cfg, {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step: tiny config, fp32, accum 2, LoRA with random B,
    EMA, the grad clip active (global norm above 2)."""
    cfg, batch = _step_case()
    params = init_flux(jax.random.PRNGKey(0), cfg)
    lora = _tiny_lora(params, seed=1, scale=0.05)
    jt = jtransport.create_transport("Linear", "velocity", snr_type="lognorm")
    opt = jstep.make_optimizer(lr=1e-3, grad_clip=2.0)
    state = jstep.init_train_state(params, lora, opt, "lora", use_ema=True)
    step = jax.jit(jstep.make_train_step(cfg, jt, opt, "lora", ema_decay=0.9, attn_impl="xla", remat=False,
                                         compute_dtype=jnp.float32))
    key = jax.random.PRNGKey(7)
    new, metrics = step(state, jax.tree.map(jnp.asarray, batch), key)
    draws = []  # what the step drew: a key per micro-batch, split into (t, noise)
    for i, k in enumerate(jax.random.split(key, 2)):
        k_t, k_n = jax.random.split(k)
        x1 = batch["x1"][i]
        draws.append({"t": _t(jt.sample_t(k_t, x1.shape[0], x1.shape[1])),
                      "noise": _t(jax.random.normal(k_n, x1.shape, jnp.float32))})
    return dict(cfg=cfg, batch=batch, params=_np(params), lora=_np(lora), new=new, metrics=metrics, draws=draws)


def _port_state(js):
    cfg = js["cfg"]
    model = convert.flux_from_jax(js["params"], cfg, device="cpu")
    lora = convert.lora_from_jax(js["lora"], cfg, device="cpu")
    opt = tstep.make_optimizer(lr=1e-3, grad_clip=2.0)
    return tstep.init_train_state(model, lora, opt, "lora", use_ema=True), opt


def _port_step(js, remat=False, remat_policy=None):
    state, opt = _port_state(js)
    tt = ttransport.create_transport("Linear", "velocity", snr_type="lognorm")
    step = tstep.make_train_step(tt, opt, "lora", ema_decay=0.9, remat=remat, remat_policy=remat_policy,
                                 compute_dtype=torch.float32, rope_layout="interleaved")
    metrics = step(state, _tbatch(js["batch"]), draws=js["draws"])
    return state, metrics


def _close_after_adam(got, want, before, lr, scale=1.0):
    """Trees after one AdamW step from `before`. Adam's first step moves each
    element by lr * g / (|g| + 1e-8): +-lr wherever |g| >> 1e-8, but anywhere
    in between for a gradient within float noise of zero, where the two
    frameworks' sums differ in sign or size. Elements that JAX moved by a full
    step (or not at all) must agree to 2e-6 (x scale); the others, at most 1%,
    only stay inside the +-lr bound."""
    flat = zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want), jax.tree.leaves(before))
    n_loose = n_all = 0
    for (path, g), w, b in flat:
        w, b = np.asarray(w), np.asarray(b)
        moved = np.abs(w - b) / scale
        loose = (moved > 1e-9) & (moved < 0.99 * lr)
        np.testing.assert_allclose(g[~loose], w[~loose], rtol=0, atol=2e-6 * scale,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.all(np.abs(g - b)[loose] <= lr * scale * (1 + 1e-4)), jax.tree_util.keystr(path)
        n_loose += int(loose.sum())
        n_all += loose.size
    assert n_loose <= 0.01 * n_all, (n_loose, n_all)


def test_train_step_matches_jax(jax_step):
    """Loss and grad_norm (1e-5), the updated LoRA and the EMA (2e-6 abs at
    lr 1e-3, see _close_after_adam) after one accumulated step against JAX's
    make_train_step."""
    state, metrics = _port_step(jax_step)
    assert float(jax_step["metrics"]["grad_norm"]) > 2.0  # the clip is exercised
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_step["metrics"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jax_step["metrics"]["grad_norm"]), rtol=1e-5)
    new = jax_step["new"]
    _close_after_adam(convert.lora_to_jax(state.lora), _np(new.lora), jax_step["lora"], lr=1e-3)
    ema = convert.lora_to_jax(tckpt.tree_replace(state.lora, state.ema))
    _close_after_adam(ema, _np(new.ema), jax_step["lora"], lr=1e-3, scale=0.1)  # decay 0.9
    assert state.step == 1


def _jax_leaf(tree, name):
    """The JAX parameter of a port parameter name (blocks stacked, "bias" -> "b"),
    in the port's layout."""
    parts = name.split(".")
    leaf = {"bias": "b", "weight": "w"}.get(parts[-1], parts[-1])
    if parts[0] in ("double_blocks", "single_blocks"):
        node = tree[parts[0]]
        for k in parts[2:-1]:
            node = node[k]
        out = np.asarray(node[leaf])[int(parts[1])]
    else:
        node = tree
        for k in parts[:-1]:
            node = node[k]
        out = np.asarray(node[leaf])
    return out.T if leaf == "w" else out  # linears: (in, out) in JAX, (out, in) in nn.Linear


_MASKED_LEAF = {"bias": lambda n: n.endswith("bias"),
                "norm": lambda n: n.split(".")[-1] in ("q_scale", "k_scale", "scale", "ln"),
                "double_block": lambda n: n.startswith("double_blocks.")}


@pytest.mark.parametrize("training_type", ["bias", "norm", "double_block"])
def test_masked_training_of_base_biases_matches_jax(jax_step, training_type):
    """The masked training types: the masked base parameters train as fp32
    masters (no LoRA), the rest stay frozen, the EMA covers the masked ones
    only; the loss, the logged grad_norm (the norm of every leaf's gradient,
    frozen ones included, as JAX differentiates the whole tree) and the
    updated leaves against JAX's step."""
    cfg, batch, draws = jax_step["cfg"], jax_step["batch"], jax_step["draws"]
    params = init_flux(jax.random.PRNGKey(0), cfg)
    jt = jtransport.create_transport("Linear", "velocity", snr_type="lognorm")
    mask = jstep.trainable_mask(params, training_type)
    opt = jstep.make_optimizer(lr=1e-3, grad_clip=2.0, mask=mask)
    state = jstep.init_train_state(params, None, opt, training_type, use_ema=True, mask=mask)
    step = jax.jit(jstep.make_train_step(cfg, jt, opt, training_type, ema_decay=0.9, attn_impl="xla",
                                         remat=False, compute_dtype=jnp.float32))
    new, metrics = step(state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(7))

    model = convert.flux_from_jax(_np(params), cfg, device="cpu")
    topt = tstep.make_optimizer(lr=1e-3, grad_clip=2.0)
    tstate = tstep.init_train_state(model, None, topt, training_type, use_ema=True,
                                    mask=tstep.trainable_mask(model, training_type))
    masked = _MASKED_LEAF[training_type]
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not masked(n)}
    tt = ttransport.create_transport("Linear", "velocity", snr_type="lognorm")
    got = tstep.make_train_step(tt, topt, training_type, ema_decay=0.9, remat=False,
                                compute_dtype=torch.float32, rope_layout="interleaved")(tstate, _tbatch(batch),
                                                                                        draws=draws)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-5)
    trained = tstate.trainable()
    assert trained and all(masked(n) for n in trained) and set(tstate.ema) == set(trained)
    assert all(p.grad is None for p in model.parameters())
    want = {n: _jax_leaf(_np(new.params), n) for n in trained}
    before = {n: _jax_leaf(_np(params), n) for n in trained}
    _close_after_adam({n: t.detach().numpy() for n, t in trained.items()}, want, before, lr=1e-3)
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n


def test_masked_training_casts_fp32_masters_to_the_compute_dtype():
    """Non-LoRA types keep fp32 masters and run the model on bf16 copies;
    only the masked leaves move and stay fp32."""
    cfg, batch = _step_case(accum=1, L=16, Lt=8)
    model = convert.flux_from_jax(_np(init_flux(jax.random.PRNGKey(0), cfg)), cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = tstep.make_optimizer(lr=1e-3)
    state = tstep.init_train_state(model, None, opt, "norm", mask=tstep.trainable_mask(model, "norm"))
    tt = ttransport.create_transport("Linear", "velocity", snr_type="lognorm")
    metrics = tstep.make_train_step(tt, opt, "norm", remat=False, compute_dtype=torch.bfloat16)(
        state, _tbatch(batch), generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p, before[n]) != n.endswith(("q_scale", "k_scale")), n


@pytest.mark.parametrize("policy, reruns", [(None, True), ("dots", True), ("dots_split", False)])
def test_train_step_is_the_same_under_every_remat_policy(jax_step, policy, reruns, monkeypatch):
    """Checkpointed blocks (full, selective "dots", two segments) give the
    step of the un-checkpointed model (1e-6). Kernel E (the attention
    forward) runs again in the backward under full and "dots" recompute,
    not under "dots_split", whose segments leave the attention outside."""
    base_state, base = _port_step(jax_step)
    calls = []
    lse_fwd = tfa.flash_attn_fwd_lse
    monkeypatch.setattr(tfa, "flash_attn_fwd_lse", lambda *a: calls.append(1) or lse_fwd(*a))
    state, metrics = _port_step(jax_step, remat=True, remat_policy=policy)
    cfg = jax_step["cfg"]
    blocks_run = 2 * (cfg.depth + cfg.depth_single_blocks)  # two micro-batches
    assert len(calls) == blocks_run * (2 if reruns else 1)
    np.testing.assert_allclose(float(metrics["loss"]), float(base["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(base["grad_norm"]), rtol=1e-6)
    _close_trees(convert.lora_to_jax(state.lora), convert.lora_to_jax(base_state.lora), rtol=0, atol=1e-7)


def test_lora_checkpoint_loads_in_jax(tmp_path, jax_step):
    """The port's consolidated .pth reads back through JAX's load_torch_lora
    into a tree equal to the port's LoRA; the port's own loader round-trips."""
    state, _ = _port_step(jax_step)
    cfg = jax_step["cfg"]
    path = tckpt.save_checkpoint(str(tmp_path), 1, state, model_args={"lr": 1e-3})
    assert tckpt.find_latest_checkpoint(str(tmp_path)) == path
    want = convert.lora_to_jax(state.lora)
    _close_trees(_np(jckpt.load_torch_lora(f"{path}/consolidated.00-of-01.pth", cfg)), want, rtol=0, atol=0)
    _close_trees(convert.lora_to_jax(tckpt.load_torch_lora(f"{path}/consolidated.00-of-01.pth", cfg)), want,
                 rtol=0, atol=0)
    ema_jax = _np(jckpt.load_torch_lora(f"{path}/consolidated_ema.00-of-01.pth", cfg))
    _close_trees(ema_jax, convert.lora_to_jax(tckpt.tree_replace(state.lora, state.ema)), rtol=0, atol=0)
    # the full state restores into a fresh one
    fresh, _ = _port_state(jax_step)
    tckpt.restore_into(fresh, tckpt.load_checkpoint(path))
    _close_trees(convert.lora_to_jax(fresh.lora), want, rtol=0, atol=0)
    assert fresh.step == 1 and fresh.opt_state.state_dict()["state"][0]["step"] == 1


def _dataset(tmp_path, n=6, size=64):
    records = []
    for i in range(n):
        img = Image.fromarray(np.random.default_rng(i).integers(0, 256, (size, size, 3), dtype=np.uint8))
        cond = {}
        for name in ("target", "reference", "foreground", "canny", "depth"):
            p = tmp_path / f"{i}_{name}.png"
            img.save(p)
            cond[name] = str(p)
        records.append({"condition": cond, "quality_assessment": {"objectConsistency": 5},
                        "description": {"item": f"item{i}", "description_0": "desc"}})
    (tmp_path / "data.json").write_text(json.dumps(records))
    config = tmp_path / "config.yaml"
    config.write_text(f"META:\n- path: {tmp_path / 'data.json'}\n  type: image_grid_graph200k\n")
    return str(config)


def test_trainer_cli_runs_and_resumes_on_the_cpu(tmp_path):
    """3 steps of the port's CLI (tiny, fp32, CPU, EMA, dots remat), then
    --auto_resume for 2 more; the same files as tests/test_trainer.py checks."""
    from visualcloze_tpu_torch.training.train import main

    random.seed(0)
    config = _dataset(tmp_path)
    base = ["--data_path", config, "--results_dir", str(tmp_path / "results"), "--device", "cpu",
            "--tiny", "--init_random", "--global_bsz", "2", "--micro_bsz", "1", "--grid_resolution", "64",
            "--lora_rank", "4", "--log_every", "1", "--num_workers", "2", "--max_seq_bucket", "128",
            "--use_model_ema", "--precision", "fp32", "--checkpointing"]
    out = main(base + ["--max_steps", "3", "--ckpt_every", "3"])
    assert [r["step"] for r in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in out["history"])
    ckpt_dir = tmp_path / "results" / "checkpoints" / "0000003"
    for name in ("consolidated.00-of-01.pth", "consolidated_ema.00-of-01.pth", "model_args.json", "state.pt"):
        assert (ckpt_dir / name).exists(), name
    assert (ckpt_dir / "resume_step.txt").read_text() == "3"
    out = main(base + ["--max_steps", "5", "--ckpt_every", "2", "--auto_resume"])
    assert [r["step"] for r in out["history"]] == [3, 4]
    assert (tmp_path / "results" / "checkpoints" / "0000005" / "resume_step.txt").read_text() == "5"


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """The mesh flags and MoE-LoRA train (tests/test_torch_parallel.py,
    test_torch_moe.py); what the trainer still refuses is JAX's own list:
    --cp with --pp, --pp with remat dots_split, --init_from with
    --moe_experts, and a mesh larger than the ranks (JAX's device check),
    here --fsdp 2 in one process no launcher started."""
    from visualcloze_tpu_torch.training.train import main

    base = ["--data_path", "unused.yaml", "--device", "cpu", "--tiny", "--init_random"]
    for extra, match in ((["--cp", "2", "--pp", "2"], "--cp and --pp cannot be combined"),
                         (["--pp", "2", "--checkpointing", "--remat_policy", "dots_split"], "dots_split"),
                         (["--moe_experts", "4", "--init_from", "x.pth"], "--init_from"),
                         ):
        with pytest.raises(SystemExit, match=match):
            main(base + extra)
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        main(base + ["--fsdp", "2"])
    with pytest.raises(SystemExit, match="--init_random"):
        main(["--data_path", "unused.yaml", "--device", "cpu"])
