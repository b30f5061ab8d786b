"""Multi-card parallelism of the port (visualcloze_tpu_torch/parallel/) on
gloo groups of CPU ranks (tests/torch_parallel_jobs.py), against the port's
own single-process result and the JAX package.

A tiny DiT (FluxConfig().tiny(), fp32) with a LoRA whose B is drawn: its
forward and LoRA gradients (loss = mean(out * w), averaged over the ranks
as the trainer averages them) under fsdp 2, tp 2, dp 2 x fsdp 2, tp 2 x
fsdp 2, cp 2 (ring attention), pp 2 (GPipe, M = 2 and 4, and with dp 2)
and sdp equal the single-process port within 1e-5 (outputs) and 1e-4 of
each gradient's largest magnitude; the single-process port equals JAX's
flux_apply within the DiT tests' 1e-4 of the output RMS at guidance 3.5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from torch_parallel_jobs import RankGroup, _tensor_tree
from visualcloze_tpu.config import FluxConfig as JFluxConfig
from visualcloze_tpu.models.flux import flux_apply as jflux_apply
from visualcloze_tpu.models.flux import init_flux as jinit_flux
from visualcloze_tpu.models.lora import init_lora as jinit_lora
from visualcloze_tpu.models.lora import init_moe_lora as jinit_moe_lora
from visualcloze_tpu.parallel import create_mesh as jcreate_mesh
from visualcloze_tpu.parallel.sharding import flux_param_spec as jflux_param_spec
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.config import FluxConfig
from visualcloze_tpu_torch.models.lora import tree_items, tree_map
from visualcloze_tpu_torch.models.quant import quantize_flux_int8
from visualcloze_tpu_torch.parallel import mesh as tmesh
from visualcloze_tpu_torch.parallel.pipeline import PipelineSpec, pipeline_single_trunk
from visualcloze_tpu_torch.parallel.sharding import flux_param_spec, tp_index

CFG = FluxConfig().tiny()
B, L_IMG, L_TXT = 4, 16, 8


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    g = RankGroup(2, tmp_path_factory.mktemp("g2"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    g = RankGroup(4, tmp_path_factory.mktemp("g4"))
    yield g
    g.close()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, L_IMG, 3), np.float32)
    ids[..., 1], ids[..., 2] = np.arange(L_IMG) // 4, np.arange(L_IMG) % 4
    img_mask = np.ones((B, L_IMG), np.int32)
    img_mask[:, -4:] = 0
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(img=f32(B, L_IMG, CFG.in_channels), img_ids=ids, txt=f32(B, L_TXT, CFG.context_in_dim),
                txt_ids=np.zeros((B, L_TXT, 3), np.float32), timesteps=np.full((B,), 0.5, np.float32),
                y=f32(B, CFG.vec_in_dim), guidance=np.full((B,), 3.5, np.float32), img_mask=img_mask)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}.{k}" if prefix else k).items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}.{i}").items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def dit_case():
    """JAX's tiny DiT and LoRA (B drawn), converted to the port; the port's
    single-process output and LoRA gradients, checked against JAX's
    flux_apply (1e-4 of the output RMS)."""
    params = jinit_flux(jax.random.PRNGKey(0), JFluxConfig().tiny())
    lora = jinit_lora(jax.random.PRNGKey(1), params, rank=4)
    rng = np.random.default_rng(2)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: x if p[-1].key == "a" else jnp.asarray(0.05 * rng.standard_normal(x.shape), x.dtype), lora)
    inp = _inputs()
    want = np.asarray(jflux_apply(JFluxConfig().tiny(), params, **{k: jnp.asarray(v) for k, v in inp.items()},
                                  lora=lora, rope_layout="half", attn_impl="xla"))
    flux = convert.flux_from_jax(jax.tree.map(np.asarray, params), CFG, device="cpu")
    tl = convert.lora_from_jax(jax.tree.map(np.asarray, lora), CFG, device="cpu")
    leaves = tree_map(lambda t: t.requires_grad_(), tl)
    weight = np.random.default_rng(3).standard_normal((B, L_IMG, CFG.out_channels)).astype(np.float32)
    out = flux(**{k: torch.from_numpy(v) for k, v in inp.items()}, lora=leaves, rope_layout="half")
    (out * torch.from_numpy(weight)).mean().backward()
    got = out.detach().numpy()
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert np.abs(got - want).max() <= 1e-4 * rms
    return dict(state={k: v.numpy() for k, v in flux.state_dict().items()}, inputs=inp, weight=weight,
                lora=tree_map(lambda t: t.detach().numpy(), tl), out=got,
                grads={k: v.grad.numpy() for k, v in tree_items(leaves)}, flux=flux)


def _share(axes, coord, n=B):
    """The rows of the batch a rank holds: (dp, fsdp) blocks, then pp blocks."""
    nd = axes.get("dp", 1) * axes.get("fsdp", 1)
    pp = axes.get("pp", 1)
    per = n // nd
    lo = (coord["dp"] * axes.get("fsdp", 1) + coord["fsdp"]) * per
    per //= pp
    lo += coord["pp"] * per
    return slice(lo, lo + per)


def _check_dit(results, case, axes, experts=None):
    for r in results:
        np.testing.assert_allclose(r["out"], case["out"][_share(axes, r["coord"])], rtol=0, atol=1e-5)
        grads = _flat(r["grads"])
        for k, want in case["grads"].items():
            np.testing.assert_allclose(grads[k], want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=k)


CASES2 = [({"fsdp": 2}, {}), ({"tp": 2}, {}), ({"cp": 2}, {"ring": True}), ({"pp": 2}, {"pp_microbatches": 2}),
          ({"pp": 2}, {"pp_microbatches": 4}), ({"fsdp": 2}, {"mode": "sdp"})]
CASES4 = [({"dp": 2, "fsdp": 2}, {}), ({"tp": 2, "fsdp": 2}, {}), ({"pp": 2, "dp": 2}, {"pp_microbatches": 2})]


@pytest.mark.parametrize("axes, kw", CASES2, ids=["fsdp2", "tp2", "cp2-ring", "pp2-M2", "pp2-M4", "sdp2"])
def test_sharded_dit_matches_single_process_and_jax(group2, dit_case, axes, kw):
    res = group2.run("job_dit", state=dit_case["state"], cfg=CFG, inputs=dit_case["inputs"], lora=dit_case["lora"],
                     weight=dit_case["weight"], axes=axes, timeout=90, **kw)
    _check_dit(res, dit_case, axes)


@pytest.mark.parametrize("axes, kw", CASES4, ids=["dp2-fsdp2", "tp2-fsdp2", "pp2-dp2"])
def test_sharded_dit_on_four_ranks_matches_single_process(group4, dit_case, axes, kw):
    res = group4.run("job_dit", state=dit_case["state"], cfg=CFG, inputs=dit_case["inputs"], lora=dit_case["lora"],
                     weight=dit_case["weight"], axes=axes, timeout=90, **kw)
    _check_dit(res, dit_case, axes)


@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"tp": 2}], ids=["fsdp2", "tp2"])
def test_int8_dit_sharded_over_the_mesh(group2, dit_case, axes):
    """The int8 DiT (quantize_flux_int8: codes and scales are buffers, made
    FSDP2 parameters under fsdp; cut by column / row under tp) against the
    single-process int8 DiT: G's plain version rounds each product to bf16,
    so another batch share (fsdp: other GEMM blocking) or a row-parallel sum
    of two rounded halves (tp) moves an output by a bf16 ulp here and there:
    max |Δ| <= 4 bf16 ulps of the largest output (kernel G's bound)."""
    qflux = quantize_flux_int8(dit_case["flux"])
    inp = {k: torch.from_numpy(v) for k, v in dit_case["inputs"].items()}
    with torch.no_grad():
        want = qflux(**inp, rope_layout="half").float().numpy()
    state = {k: v.numpy() for k, v in qflux.state_dict().items()}
    res = group2.run("job_dit", state=state, cfg=CFG, inputs=dit_case["inputs"], lora=_zero_b(dit_case["lora"]),
                     weight=dit_case["weight"], axes=axes, quant="int8", timeout=90)
    tol = 4 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    for r in res:
        assert np.abs(r["out"] - want[_share(axes, r["coord"])]).max() <= tol


# wide enough that every tp = 2 row shard of the int4 linears is whole groups of 128 input rows
QCFG = dataclasses.replace(CFG, hidden_size=256, axes_dim=(16, 24, 24), depth=1, depth_single_blocks=1)


@pytest.mark.parametrize("quant, axes", [("int4", {"tp": 2}), ("w8a8_smooth", {"tp": 2}), ("int4", {"fsdp": 2}),
                                         ("w8a8_smooth", {"fsdp": 2})],
                         ids=["int4-tp2", "w8a8-smooth-tp2", "int4-fsdp2", "w8a8-smooth-fsdp2"])
def test_int4_and_w8a8_dits_sharded_over_the_mesh(group2, quant, axes):
    """The int4 DiT (packed codes and group scales, cut by column / by whole
    row groups under tp) and the SmoothQuant w8a8 DiT (a row shard
    quantizes the tp group's gathered inputs with a_sinv in gather order
    and multiplies its own codes) on 2 ranks against the single-process
    DiT at QCFG's widths: max |Δ| <= 4 bf16 ulps of the largest output, as
    for int8 (G4's and H's plain versions round each product to bf16)."""
    from visualcloze_tpu_torch.models.flux import Flux
    from visualcloze_tpu_torch.models.lora import init_lora
    from visualcloze_tpu_torch.models.quant import quantize_flux_int4, quantize_flux_w8a8_smooth

    flux = Flux(QCFG).init_random_(torch.Generator().manual_seed(5))
    inp = {k: torch.from_numpy(v) for k, v in _inputs(6).items()}
    with torch.no_grad():
        if quant == "int4":
            qflux = quantize_flux_int4(flux)
        else:
            qflux = quantize_flux_w8a8_smooth(flux, flux(**inp, rope_layout="half", collect_a8_stats=True)[1])
        want = qflux(**inp, rope_layout="half").float().numpy()
    lora = tree_map(lambda t: t.detach().numpy(), init_lora(qflux, 4, generator=torch.Generator().manual_seed(7)))
    res = group2.run("job_dit", state={k: v.numpy() for k, v in qflux.state_dict().items()}, cfg=QCFG,
                     inputs={k: v.numpy() for k, v in inp.items()}, lora=lora,
                     weight=np.ones((B, L_IMG, QCFG.out_channels), np.float32), axes=axes, quant=quant, timeout=90)
    tol = 4 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    for r in res:
        assert np.abs(r["out"] - want[_share(axes, r["coord"])]).max() <= tol


def _zero_b(tree):
    """The LoRA tree with its B factors and B's bias zeroed (a delta of 0)."""
    if isinstance(tree, list):
        return [_zero_b(v) for v in tree]
    return {k: v * 0 if k in ("b", "b_bias") else _zero_b(v) if isinstance(v, (dict, list)) else v
            for k, v in tree.items()}


def test_shard_large_params_keeps_the_frozen_encoders_outputs(group2):
    """shard_large_params over fsdp 2 on the tiny T5, CLIP and VAE encoder
    (every tensor of at least 1000 values under FSDP2, as the trainer does
    with 2^20 at full width): the text features and the VAE's moments equal
    the unsharded ones exactly."""
    from torch_parallel_jobs import _tiny_model

    m = _tiny_model()
    prompts = ["a cat", "A grid layout with 2 rows and 2 columns."]
    rows = np.random.default_rng(0).uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    with torch.no_grad():
        want = {"t5": m.t5(prompts).numpy(), "clip": m.clip(prompts).numpy(),
                "z": m.ae.encode_moments(torch.from_numpy(rows)).numpy()}
    for r in group2.run("job_encoders_sharded", prompts=prompts, rows=rows, min_size=1000, timeout=90):
        for k, w in want.items():
            np.testing.assert_array_equal(r[k], w, err_msg=k)


def test_sdp_equals_fsdp_over_two_steps_and_keeps_weights_replicated(group2, dit_case):
    """Two trainer steps (make_train_step, fp32, AdamW at lr 1e-3) under fsdp
    2 and under sdp 2 (ZeRO-2: the AdamW state sharded, the LoRA gathered
    back): the same losses (1e-6) and LoRA (1e-6) on both ranks; under sdp
    every base weight is still a plain replicated tensor, equal on both
    ranks, after the steps."""
    batch, draws = _train_case()
    out = {}
    for mode in ("fsdp", "sdp"):
        out[mode] = group2.run("job_train", state=dit_case["state"], cfg=CFG, batch=batch, lora=dit_case["lora"],
                               axes={"fsdp": 2}, mode=mode, steps=2, draws=draws, timeout=90)
    for r_f, r_s in zip(out["fsdp"], out["sdp"]):
        np.testing.assert_allclose(r_s["losses"], r_f["losses"], rtol=1e-6)
        for k, v in r_f["lora"].items():
            np.testing.assert_allclose(r_s["lora"][k], v, rtol=0, atol=1e-6, err_msg=k)
        assert r_s["params_plain"] and not r_f["params_plain"]
    assert out["sdp"][0]["digest"] == out["sdp"][1]["digest"]
    assert out["sdp"][0]["losses"] == out["sdp"][1]["losses"]


def _train_case():
    """A tiny trainer batch of 2 (one micro-batch) and two steps' draws."""
    rng = np.random.default_rng(3)
    accum, b, l = 1, 2, 16
    ids = np.zeros((accum, b, l, 3), np.float32)
    ids[..., 1], ids[..., 2] = np.arange(l) // 4, np.arange(l) % 4
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    batch = dict(x1=f32(accum, b, l, CFG.out_channels), cond=f32(accum, b, l, CFG.in_channels - CFG.out_channels),
                 img_ids=ids, img_mask=np.ones((accum, b, l), np.int32), txt=f32(accum, b, 8, CFG.context_in_dim),
                 txt_ids=np.zeros((accum, b, 8, 3), np.float32), txt_mask=np.ones((accum, b, 8), np.int32),
                 vec=f32(accum, b, CFG.vec_in_dim))
    draws = [[{"t": rng.uniform(0, 1, (b,)).astype(np.float32), "noise": f32(b, l, CFG.out_channels)}]
             for _ in range(2)]
    return batch, draws


@pytest.mark.parametrize("training_type, mode, axes, moe", [
    ("full_model", "fsdp", {"pp": 2}, False), ("full_model", "sdp", {"pp": 2}, False),
    ("lora", "sdp", {"pp": 2}, False), ("full_model", "fsdp", {"tp": 2}, False),
    ("full_model", "sdp", {"tp": 2}, False), ("lora", "fsdp", {"ep": 2}, True), ("lora", "sdp", {"ep": 2}, True),
    ("lora", "fsdp", {"cp": 2}, False), ("full_model", "sdp", {"cp": 2}, False)],
    ids=["full-pp2", "full-pp2-sdp", "lora-pp2-sdp", "full-tp2", "full-tp2-sdp", "moe-ep2", "moe-ep2-sdp", "lora-cp2",
         "full-cp2-sdp"])
def test_training_across_ranks_matches_one_process(group2, dit_case, training_type, mode, axes, moe):
    """Two trainer steps across two ranks against the same steps in one
    process: the single trunk pipelined over pp 2 (each stage training its
    own trunk weights in the full-model type), tensor-parallel weights,
    MoE-LoRA experts split over ep 2, and the tokens split over cp 2 (each
    rank's gradients its tokens' part, summed over cp), with ZeRO-2's slices
    beside them under sdp; the global norm sums each shard once, so the clip
    and the logged norm are the one-process ones: losses and grad norms
    within 1e-5 (relative)."""
    _check_training(group2, dit_case, training_type, mode, axes, moe)


@pytest.mark.parametrize("training_type, axes", [("full_model", {"cp": 2, "fsdp": 2}), ("lora", {"cp": 2, "dp": 2})],
                         ids=["full-cp2-fsdp2", "lora-cp2-dp2"])
def test_training_on_four_ranks_with_cp_matches_one_process(group4, dit_case, training_type, axes):
    """The tokens split over cp 2 beside FSDP2 (its sharded gradients summed
    over cp as well) and beside dp 2, two trainer steps on four ranks
    against one process: losses and grad norms within 1e-5 (relative)."""
    _check_training(group4, dit_case, training_type, "fsdp", axes, False)


def _check_training(group, dit_case, training_type, mode, axes, moe):
    from visualcloze_tpu_torch.models.flux import build_flux
    from visualcloze_tpu_torch.training.step import init_train_state, make_optimizer, make_train_step
    from visualcloze_tpu_torch.transport import create_transport

    from visualcloze_tpu_torch.models.lora import init_moe_lora, randomize_lora_b

    batch, draws = _train_case()
    flux = build_flux(CFG, "cpu", torch.float32)
    flux.load_state_dict({k: torch.from_numpy(v) for k, v in dit_case["state"].items()})
    tree = dit_case["lora"]
    if moe:
        g = torch.Generator().manual_seed(4)
        tree = tree_map(lambda t: t.numpy(), randomize_lora_b(init_moe_lora(flux, 4, 4, generator=g), g, 0.05))
    lora = _tensor_tree(tree) if training_type == "lora" else None
    opt = make_optimizer(1e-3, 0.0, 2.0)
    st = init_train_state(flux, lora, opt, training_type)
    step = make_train_step(create_transport("Linear", "velocity", snr_type="uniform"), opt, training_type,
                           remat=False, compute_dtype=torch.float32)
    want = [step(st, {k: torch.from_numpy(v) for k, v in batch.items()},
                 draws=[{k: torch.from_numpy(v) for k, v in d.items()} for d in draws[i]]) for i in range(2)]
    res = group.run("job_train", state=dit_case["state"], cfg=CFG, batch=batch, lora=tree, axes=axes, mode=mode,
                    steps=2, draws=draws, training_type=training_type, timeout=90)
    for r in res:
        np.testing.assert_allclose(r["losses"], [float(m["loss"]) for m in want], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], [float(m["grad_norm"]) for m in want], rtol=1e-5)


def test_pipeline_validation_errors(dit_case):
    """JAX's errors (tests/test_pipeline_parallel.py): M not a multiple of
    pp or not dividing the batch, a depth pp does not divide, a RingSpec
    inside the trunk, dots_split remat."""
    from visualcloze_tpu_torch.ops.attention import RingSpec

    flux = dit_case["flux"]
    mesh = types.SimpleNamespace(shape={"pp": 2}, coord={"pp": 0}, group=lambda axes: None)
    x, vec = torch.zeros(4, 24, 64), torch.zeros(4, 64)
    pe = (torch.zeros(4, 24, 8), torch.zeros(4, 24, 8))
    with pytest.raises(ValueError, match="microbatch|M"):
        pipeline_single_trunk(flux, PipelineSpec(mesh, 3), x, vec, pe, None, None)
    with pytest.raises(ValueError, match="RingSpec"):
        pipeline_single_trunk(flux, PipelineSpec(mesh, 2), x, vec, pe, None, None, attn_impl=RingSpec(mesh))
    with pytest.raises(ValueError, match="dots_split"):
        pipeline_single_trunk(flux, PipelineSpec(mesh, 2), x, vec, pe, None, None, remat=True,
                              remat_policy="dots_split")
    odd = types.SimpleNamespace(single_blocks=[None] * 3)
    with pytest.raises(ValueError, match="divisible"):
        pipeline_single_trunk(odd, PipelineSpec(mesh, 2), x, vec, pe, None, None)
    one = types.SimpleNamespace(shape={"pp": 1}, coord={"pp": 0})
    with pytest.raises(ValueError, match="pp>1"):
        pipeline_single_trunk(flux, PipelineSpec(one, 2), x, vec, pe, None, None)


@pytest.mark.parametrize("axes", [{"fsdp": 2, "tp": 2, "ep": 2}, {"pp": 2, "fsdp": 2, "tp": 2}], ids=["ep", "pp"])
def test_flux_param_spec_matches_jax(axes):
    """The port's copy of JAX's sharding table: the same PartitionSpec for
    every leaf of the tiny DiT, its LoRA and a MoE-LoRA tree."""
    jcfg = JFluxConfig().tiny()
    params = jinit_flux(jax.random.PRNGKey(0), jcfg)
    trees = [params, jinit_lora(jax.random.PRNGKey(1), params, 4), jinit_moe_lora(jax.random.PRNGKey(2), params, 4, 4)]
    jmesh = jcreate_mesh(**axes)
    fake = types.SimpleNamespace(shape={a: axes.get(a, 1) for a in tmesh.AXES})
    n = 0
    for tree in trees:
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
            want = tuple(jflux_param_spec(path, leaf, jmesh))
            want = want + (None,) * (leaf.ndim - len(want))
            assert flux_param_spec(keys, leaf.shape, fake) == want, keys
            n += 1
    assert n > 200


def test_tp_index_keeps_whole_heads():
    """tp_index: a rank's features of a fused qkv are its heads of q, of k and
    of v; of linear1 those and its slice of the mlp; of linear2 the matching
    input rows; the ranks partition the features."""
    cfg = FluxConfig()
    h, mh, d = cfg.hidden_size, cfg.mlp_hidden_dim, cfg.head_dim
    idx = [tp_index(("single_blocks", "0", "linear1"), cfg, r, 2) for r in range(2)]
    assert sorted(torch.cat(idx).tolist()) == list(range(3 * h + mh))
    q0 = idx[0][: h // 2]
    assert q0.tolist() == list(range(h // 2)) and q0.numel() % d == 0
    assert idx[1][h // 2: h].tolist() == list(range(h + h // 2, 2 * h))
    assert idx[1][3 * h // 2:].tolist() == list(range(3 * h + mh // 2, 3 * h + mh))
    l2 = tp_index(("single_blocks", "0", "linear2"), cfg, 1, 2)
    assert l2[: h // 2].tolist() == list(range(h // 2, h)) and l2[h // 2:].tolist() == list(range(h + mh // 2, h + mh))


def test_initialize_distributed_reads_the_launchers_environment(monkeypatch):
    """launch_env: torchrun's RANK / WORLD_SIZE / LOCAL_RANK, SLURM's
    SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID (only with more than one
    task), else None; initialize_distributed does nothing without a
    launcher, and with one starts gloo for the CPU, NCCL (with the local
    card) for CUDA, never the one for the other."""
    assert tmesh.launch_env({}) is None
    assert tmesh.launch_env({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1"}) == (3, 8, 1)
    assert tmesh.launch_env({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}) is None
    assert tmesh.launch_env({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0"}) == (2, 4, 0)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    assert tmesh.initialize_distributed("cpu") == (0, 1, 0) and calls == []
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tmesh.initialize_distributed("cpu") == (1, 2, 1)
    assert calls[-1][0] == "gloo" and calls[-1][1]["world_size"] == 2 and calls[-1][1]["rank"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    tmesh.initialize_distributed("cuda")
    assert calls[-2] == ("set_device", 1) and calls[-1][0] == "nccl"
    assert calls[-1][1]["device_id"] == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.initialize_distributed("cuda")
    mesh = tmesh.create_mesh(device="cpu")  # one rank, no process group
    assert mesh.device_mesh is None and mesh.group("tp") is None and mesh.size(tmesh.AXES) == 1
    assert repr(tmesh.auto_mesh(mode="training", device="cpu")) == repr(mesh)  # all-fsdp over one rank
    assert [type(p).__name__ for p in tmesh.batch_sharding(mesh)] == ["Replicate", "Shard", "Shard", "Replicate",
                                                                         "Replicate", "Replicate"]
    assert all(type(p).__name__ == "Replicate" for p in tmesh.replicated(mesh))
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        tmesh.create_mesh(tp=2, device="cpu")


@pytest.fixture(scope="module")
def query():
    cell = Image.new("RGB", (64, 64), (120, 180, 90))
    other = Image.new("RGB", (64, 64), (30, 60, 200))
    return [[cell, other], [cell, None]], ["A grid layout with 2 rows and 2 columns.", "task", "content"]


@pytest.fixture(scope="module")
def single_images(query):
    from torch_parallel_jobs import _tiny_model

    model = _tiny_model()
    model.set_grid_size(2, 2)
    return [np.asarray(im) for im in model.process_images(*query, seed=1, steps=2, is_upsampling=False)]


@pytest.mark.parametrize("axes, ring", [({"tp": 2}, False), ({"cp": 2}, True)], ids=["tp2", "cp2"])
def test_process_images_across_ranks_equals_one_rank(group2, query, single_images, axes, ring):
    """The tiny pipeline's process_images with its DiT under tp 2, or ring
    attention over cp 2, on two ranks: each rank's image equals the
    one-rank image within 2/255."""
    for r in group2.run("job_serve", axes=axes, ring=ring, grid=query[0], prompts=query[1], steps=2, timeout=90):
        for got, want in zip(r, single_images):
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_random_seed_and_runtime_adapters_agree_across_ranks(group2, query):
    """Under tp 2: a query with seed 0 (a random seed, drawn on rank 0 and
    shared) gives every rank the same image; a runtime adapter made and
    added after the DiT was sharded (the CLI's --lora NAME=random: a LoRA
    entry is the whole linear's, replicated) gives the one-rank image within
    2/255."""
    from torch_parallel_jobs import _tiny_model, add_random_adapter

    r = group2.run("job_serve", axes={"tp": 2}, ring=False, grid=query[0], prompts=query[1], steps=2, seed=0,
                   timeout=90)
    assert all(np.array_equal(a, b) for a, b in zip(r[0], r[1]))
    model = _tiny_model()
    add_random_adapter(model)
    model.set_grid_size(2, 2)
    want = [np.asarray(im) for im in model.process_images(*query, seed=1, steps=2, is_upsampling=False, adapter="a")]
    for r in group2.run("job_serve", axes={"tp": 2}, ring=False, grid=query[0], prompts=query[1], steps=2,
                        adapter="a", timeout=90):
        for got, w in zip(r, want):
            assert np.abs(got.astype(int) - w.astype(int)).max() <= 2


def test_mesh_leader_serves_a_query_every_rank_runs(group2, query, single_images):
    """serve.py's mesh serving without HTTP: rank 0's MeshLeader broadcasts
    each query, rank 1 runs it in step (follow_mesh). A query that raises on
    every rank (an unknown adapter) reaches rank 0's caller as its error and
    leaves rank 1 following; the next query's image on rank 0 equals the
    one-rank image within 2/255."""
    res = group2.run("job_mesh_leader", axes={"tp": 2}, grid=query[0], prompts=query[1], steps=2, timeout=90)
    assert res[1] == {"followed": 2, "failed": 1}
    assert res[0]["error"] is not None
    for got, want in zip(res[0]["images"], single_images):
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_pipelined_server_moves_queries_between_two_devices(monkeypatch, query, single_images):
    """PipelinedServer's disaggregated path with the CPU on both sides (the
    device comparison patched to say they differ): the DiT's query crosses
    with `_to` and its samples come back; the images equal
    process_images' bit for bit."""
    from torch_parallel_jobs import _tiny_model
    from visualcloze_tpu_torch.pipeline import PipelinedServer, orchestrator

    monkeypatch.setattr(orchestrator, "same_device", lambda a, b: False)
    moved = []
    to = orchestrator.PipelinedServer._to
    monkeypatch.setattr(orchestrator.PipelinedServer, "_to",
                        staticmethod(lambda q, d: moved.append(d) or to(q, d)))
    m = _tiny_model()
    with PipelinedServer(m, encoder_device="cpu", dit_device="cpu") as ps:
        assert ps.dit_device == torch.device("cpu") and m.dit_device == torch.device("cpu")
        images = ps.submit(*query, grid_size=(2, 2), seed=1, steps=2, is_upsampling=False).result()
    assert moved == [torch.device("cpu")]
    for got, want in zip(images, single_images):
        assert np.array_equal(np.asarray(got), want)


TRAIN_ARGV = ["--device", "cpu", "--tiny", "--init_random", "--precision", "fp32", "--grid_resolution", "64",
              "--lora_rank", "4", "--global_bsz", "2", "--micro_bsz", "1", "--max_seq_bucket", "128",
              "--max_steps", "2", "--log_every", "1", "--num_workers", "0"]


def test_trainer_cli_trains_on_two_ranks(group2, tmp_path):
    """The trainer's CLI under --fsdp 2 and under --sdp on two gloo ranks:
    finite losses, the same on both ranks (averaged over them), the LoRA's
    B moves, each rank writes its state file and rank 0 the consolidated
    LoRA."""
    for extra in (["--fsdp", "2"], ["--fsdp", "2", "--sdp"]):
        res = group2.run("job_trainer_cli", argv=TRAIN_ARGV + extra, root=str(tmp_path / extra[-1]), timeout=120)
        assert res[0]["losses"] == res[1]["losses"] and all(np.isfinite(res[0]["losses"]))
        assert res[0]["b_absmax"][-1] > 0 and "fsdp=2" in res[0]["mesh"]
        assert {"state.rank0.pt", "state.rank1.pt", "consolidated.00-of-01.pth", "resume_step.txt"} <= set(res[0]["files"])


def test_trainer_one_rank_group_matches_the_single_process_trainer(tmp_path, monkeypatch):
    """chip_smoke.py's dist_one_rank on the CPU: the trainer as torchrun
    starts it with WORLD_SIZE 1 (a gloo group, the mesh, FSDP2 over the
    DiT) against the trainer with no process group, same seed: the first
    loss equal bit for bit, the first grad norm within 1e-4, the second
    step's loss and grad norm within 1e-3 (relative). Only the LoRA leaves upstream of the modulation
    vector could see another gradient: vec's gradient sums every block's,
    and FSDP2's per-block hooks sum each block's own contributions first
    (each block takes vec through one silu, so the grouping is the same
    without them). So after each step every other leaf is equal bit for
    bit, and each upstream leaf's change is within 1e-5 of the one-process
    change (relative, fp32)."""
    from visualcloze_tpu_torch.training.train import main as train_main

    config = chip_smoke.write_dataset(tmp_path / "data", n=4, size=64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the rank's process runs: the same GEMM blocking on both sides
    try:
        with chip_smoke.lora_steps() as snaps:
            single = train_main(TRAIN_ARGV + ["--data_path", config, "--results_dir", str(tmp_path / "single")])
    finally:
        torch.set_num_threads(threads)
    g = RankGroup(1, tmp_path / "g1")
    try:
        (dist,) = g.run("job_trainer_cli", argv=TRAIN_ARGV, root=str(tmp_path / "one"), timeout=120)
    finally:
        g.close()
    losses = [r["loss"] for r in single["history"]]
    norms = [r["grad_norm"] for r in single["history"]]
    assert "fsdp=1" in dist["mesh"] and dist["losses"][0] == losses[0]
    np.testing.assert_allclose(dist["grad_norms"][0], norms[0], rtol=1e-4)
    np.testing.assert_allclose(dist["grad_norms"] + dist["losses"], norms + losses, rtol=1e-3)
    assert all(torch.equal(dist["leaves"][0][p], t) for p, t in snaps[0].items())
    diffs = chip_smoke.lora_step_diffs(dist["leaves"], snaps)
    assert len(diffs) == 2
    for row in diffs:
        for p, d in row.items():
            assert d <= (1e-5 if p.startswith(chip_smoke.UPSTREAM_OF_VEC) else 0.0), (p, d)
