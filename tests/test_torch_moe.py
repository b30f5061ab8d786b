"""MoE-LoRA of the port (models/layers._moe_lora_delta, models/lora.init_moe_lora,
the trainer's --moe_experts / --ep) against the JAX package's
(tests/test_moe_lora.py). fp32 on the CPU; the expert-parallel case on two
gloo ranks (tests/torch_parallel_jobs.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_training import _close_after_adam, _step_case, _tbatch
from torch_parallel_jobs import RankGroup
from visualcloze_tpu import transport as jtransport
from visualcloze_tpu.config import FluxConfig as JFluxConfig
from visualcloze_tpu.models import layers as jlayers
from visualcloze_tpu.models.flux import flux_apply as jflux_apply
from visualcloze_tpu.models.flux import init_flux as jinit_flux
from visualcloze_tpu.models.lora import init_moe_lora as jinit_moe_lora
from visualcloze_tpu.models.lora import randomize_lora_b
from visualcloze_tpu.training import step as jstep
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch import transport as ttransport
from visualcloze_tpu_torch.config import FluxConfig
from visualcloze_tpu_torch.models.layers import MOE_TOP_K, _moe_lora_delta
from visualcloze_tpu_torch.models.lora import fold_lora, init_moe_lora, is_moe_lora, tree_items
from visualcloze_tpu_torch.training import step as tstep

CFG = FluxConfig().tiny()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _entry(rng, d_in=32, d_out=24, r=4, e=4):
    f = lambda *s, sc=0.3: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return dict(shared_a=f(d_in, r), shared_b=f(r, d_out), expert_a=f(e, d_in, r), expert_b=f(e, r, d_out),
                gate_w=f(d_in, e, sc=1.0), gate_b=f(e, sc=0.1))


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_moe_lora_delta_matches_jax(scale):
    """The shared pair plus the dense expert pairs combined with the fp32,
    top-2 renormalised softmax gate, against JAX's _moe_lora_delta: 1e-6."""
    rng = np.random.default_rng(0)
    entry, x = _entry(rng), rng.standard_normal((2, 7, 32)).astype(np.float32)
    want = np.asarray(jlayers._moe_lora_delta({k: jnp.asarray(v) for k, v in entry.items()}, jnp.asarray(x), scale))
    got = _moe_lora_delta({k: torch.from_numpy(v) for k, v in entry.items()}, torch.from_numpy(x), scale).numpy()
    assert MOE_TOP_K == jlayers.MOE_TOP_K == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def moe_case():
    """JAX's tiny DiT and a MoE-LoRA tree with its zero leaves moved (+0.05),
    converted to the port."""
    jcfg = JFluxConfig().tiny()
    params = jinit_flux(jax.random.PRNGKey(0), jcfg)
    moe = jax.tree.map(lambda v: v + 0.05, jinit_moe_lora(jax.random.PRNGKey(1), params, rank=4, num_experts=4))
    return jcfg, params, moe


def _inputs(b=2, seed=1):
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, 16, 3), np.float32)
    ids[..., 1], ids[..., 2] = np.arange(16) // 4, np.arange(16) % 4
    return dict(img=rng.standard_normal((b, 16, CFG.in_channels)).astype(np.float32), img_ids=ids,
                txt=rng.standard_normal((b, 8, CFG.context_in_dim)).astype(np.float32),
                txt_ids=np.zeros((b, 8, 3), np.float32), timesteps=np.full((b,), 0.5, np.float32),
                y=rng.standard_normal((b, CFG.vec_in_dim)).astype(np.float32), guidance=np.full((b,), 3.5, np.float32))


def test_moe_dit_matches_jax_and_its_tree_converts_both_ways(moe_case):
    """flux_apply with the MoE tree against the port's Flux with the
    converted tree (1e-4 of the output RMS, the DiT tests' bound); the tree
    round-trips through lora_from_jax / lora_to_jax exactly, each block
    entry's expert axis leading (E, in, r); folding it is refused."""
    jcfg, params, moe = moe_case
    inp = _inputs()
    want = np.asarray(jflux_apply(jcfg, params, **{k: jnp.asarray(v) for k, v in inp.items()}, lora=moe,
                                  rope_layout="half", attn_impl="xla"))
    flux = convert.flux_from_jax(_np(params), CFG, device="cpu")
    tmoe = convert.lora_from_jax(_np(moe), CFG, device="cpu")
    assert is_moe_lora(tmoe) and tmoe["double_blocks"][0]["img_attn"]["qkv"]["expert_a"].shape == (4, 64, 4)
    got = flux(**{k: torch.from_numpy(v) for k, v in inp.items()}, lora=tmoe, rope_layout="half").detach().numpy()
    assert np.abs(got - want).max() <= 1e-4 * float(np.sqrt(np.mean(want ** 2)))
    back = convert.lora_to_jax(tmoe)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(_np(moe))[0], jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="MoE"):
        fold_lora(flux, tmoe)


def test_init_moe_lora_matches_jax_and_adds_nothing_at_init(moe_case):
    """init_moe_lora: JAX's shapes for every leaf, shared_a and expert_a
    uniform within +-in^-0.5, gate_w std 0.01, shared_b, expert_b and gate_b
    zero -- so the DiT's output is unchanged at init (exactly)."""
    jcfg, params, _ = moe_case
    flux = convert.flux_from_jax(_np(params), CFG, device="cpu")
    tmoe = init_moe_lora(flux, 4, 4, generator=torch.Generator().manual_seed(0))
    jtree = jinit_moe_lora(jax.random.PRNGKey(1), params, rank=4, num_experts=4)
    mine = convert.lora_to_jax(tmoe)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(_np(jtree))
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jtree)):
        assert a.shape == b.shape
    gates = []
    for path, t in tree_items(tmoe):
        leaf = path.rsplit(".", 1)[-1]
        if leaf in ("shared_b", "expert_b", "gate_b"):
            assert not t.any(), path
        elif leaf in ("shared_a", "expert_a"):
            assert t.abs().max() <= t.shape[-2] ** -0.5, path
        else:
            gates.append(t.flatten())
    assert abs(float(torch.cat(gates).std()) - 0.01) < 0.002
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with torch.no_grad():
        assert torch.equal(flux(**inp, lora=tmoe, rope_layout="half"), flux(**inp, rope_layout="half"))


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    g = RankGroup(2, tmp_path_factory.mktemp("moe"))
    yield g
    g.close()


def test_moe_experts_split_over_ep_equal_replicated(group2):
    """One MoE-LoRA linear with its 4 experts split over ep = 2 (each rank
    its 2, one sum over ep for the combine): the delta, dx and every leaf's
    gradient (each rank its experts') equal the replicated linear's, 1e-6."""
    from visualcloze_tpu_torch.models.layers import Linear

    rng = np.random.default_rng(5)
    entry, x = _entry(rng), rng.standard_normal((2, 5, 32)).astype(np.float32)
    lin = Linear(32, 24)
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.zero_()
    e = {k: torch.from_numpy(v).requires_grad_() for k, v in entry.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = lin(xt, e, 0.7)
    y.square().sum().backward()
    for rank, r in enumerate(group2.run("job_moe_ep", x=x, entry=entry, scale=0.7, timeout=60)):
        np.testing.assert_allclose(r["y"], y.detach().numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["dx"], xt.grad.numpy(), rtol=0, atol=1e-6)
        for k, t in e.items():
            want = t.grad.numpy()
            if k.startswith("expert"):
                want = np.split(want, 2, axis=0)[rank]
            np.testing.assert_allclose(r["grads"][k], want, rtol=0, atol=1e-6, err_msg=k)


def test_moe_train_step_matches_jax():
    """One accumulated train step with a MoE-LoRA tree (tests/test_moe_lora.py's
    step, unsharded; the B factors drawn, so that the experts differ and the
    gate has gradients well above float noise) against JAX's
    make_train_step: loss and grad norm 1e-5, the updated tree as
    _close_after_adam bounds it (lr 1e-3), the gate's leaves where JAX
    moved them a full step."""
    cfg, batch = _step_case()
    params = jinit_flux(jax.random.PRNGKey(0), cfg)
    moe = randomize_lora_b(jinit_moe_lora(jax.random.PRNGKey(1), params, rank=4, num_experts=4),
                           jax.random.PRNGKey(2), scale=0.05)
    jt = jtransport.create_transport("Linear", "velocity", snr_type="lognorm")
    opt = jstep.make_optimizer(lr=1e-3, grad_clip=2.0)
    state = jstep.init_train_state(params, moe, opt, "lora")
    step = jax.jit(jstep.make_train_step(cfg, jt, opt, "lora", attn_impl="xla", remat=False,
                                         compute_dtype=jnp.float32))
    key = jax.random.PRNGKey(7)
    new, metrics = step(state, jax.tree.map(jnp.asarray, batch), key)
    draws = []
    for i, k in enumerate(jax.random.split(key, batch["x1"].shape[0])):
        k_t, k_n = jax.random.split(k)
        x1 = batch["x1"][i]
        draws.append({"t": torch.from_numpy(np.array(jt.sample_t(k_t, x1.shape[0], x1.shape[1]))),
                      "noise": torch.from_numpy(np.array(jax.random.normal(k_n, x1.shape, jnp.float32)))})
    flux = convert.flux_from_jax(_np(params), CFG, device="cpu")
    tmoe = convert.lora_from_jax(_np(moe), CFG, device="cpu")
    topt = tstep.make_optimizer(lr=1e-3, grad_clip=2.0)
    tstate = tstep.init_train_state(flux, tmoe, topt, "lora")
    tstep_fn = tstep.make_train_step(ttransport.create_transport("Linear", "velocity", snr_type="lognorm"), topt,
                                     "lora", remat=False, compute_dtype=torch.float32, rope_layout="interleaved")
    got = tstep_fn(tstate, _tbatch(batch), draws=draws)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-5)
    got_tree, want_tree, before = convert.lora_to_jax(tstate.lora), _np(new.lora), _np(moe)
    gate = ("gate_w", "gate_b")
    split = lambda t, keep: {k: split(v, keep) if isinstance(v, dict) else v  # noqa: E731
                             for k, v in t.items() if isinstance(v, dict) or (k in gate) == keep}
    _close_after_adam(split(got_tree, False), split(want_tree, False), split(before, False), lr=1e-3)
    # the gate's renormalised top-2 weights do not depend on the other experts' logits, so much of
    # the gate's gradient is zero analytically and float residue numerically, which Adam's first
    # step turns into anything within +-lr: hold only what JAX moved a full step
    for (path, g), w, b in zip(jax.tree_util.tree_flatten_with_path(split(got_tree, True))[0],
                               jax.tree.leaves(split(want_tree, True)), jax.tree.leaves(split(before, True))):
        full = np.abs(w - b) >= 0.99e-3
        np.testing.assert_allclose(g[full], w[full], rtol=0, atol=2e-6, err_msg=jax.tree_util.keystr(path))
        assert np.all(np.abs(g - b) <= 1e-3 * (1 + 1e-4)), jax.tree_util.keystr(path)


def test_trainer_cli_trains_moe_lora_on_the_cpu(tmp_path):
    """--moe_experts 2 through the trainer's CLI (tiny, fp32): finite losses,
    the zero-init expert_b and shared_b move, and (as in JAX) no
    consolidated reference-format .pth is written for a MoE tree."""
    from visualcloze_tpu_torch.training.train import main

    config = chip_smoke.write_dataset(tmp_path / "data", n=4, size=64)
    out = main(["--data_path", config, "--results_dir", str(tmp_path / "results"), "--device", "cpu", "--tiny",
                "--init_random", "--precision", "fp32", "--grid_resolution", "64", "--lora_rank", "4",
                "--moe_experts", "2", "--global_bsz", "2", "--micro_bsz", "1", "--max_seq_bucket", "128",
                "--max_steps", "2", "--log_every", "1", "--num_workers", "0"])
    assert all(np.isfinite(r["loss"]) for r in out["history"]) and len(out["history"]) == 2
    lora = dict(tree_items(out["state"].lora))
    assert max(float(t.detach().abs().max()) for p, t in lora.items() if p.endswith(("expert_b", "shared_b"))) > 0
    files = {p.name for p in (tmp_path / "results" / "checkpoints" / "0000002").iterdir()}
    assert "state.pt" in files and "consolidated.00-of-01.pth" not in files
