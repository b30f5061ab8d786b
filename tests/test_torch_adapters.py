"""Runtime LoRA adapters, the diffusers-style API, the kernel directory
(enable_aot), the eval CLI and its metrics of the port, against the JAX
package where it has the counterpart, on the CPU at the tiny configs.

The JAX `random_components(tiny=True, fp32, resolution=64)` model and its
adapters (init_lora + randomize_lora_b, rank 4) are carried over by
visualcloze_tpu_torch.convert, and JAX's noise is replayed into the port
(tests/test_torch_pipeline.py's harness). Bounds:
- the fp32 base: those of tests/test_torch_pipeline.py (<= 2% of the final
  latent elements differ, mean |Δ| <= 1e-4, max |Δ| <= 1/64; images within
  2/255), with the adapter at lora_scale 1 and 0.5, at guidance 3.5 (ROADMAP
  §3: at the pipeline's 30 the two frameworks' timestep embeddings differ
  by ~1e-3, and with the adapter at 0.5 the bf16 latents then differ in
  10.5% of the elements, mean 2.7e-4; at 3.5, 0.1% and 1.4e-6; at scale 1,
  0.6% and 2.9e-5);
- the int8 base: JAX's tiny single-card int8 stack (synthetic_full_components:
  int8 DiT, int4 T5, int8 CLIP, bf16 VAE) carried over as in
  tests/test_torch_quant.py::test_quantized_pipeline_matches_jax, whose
  bounds apply: <= 50% of the latent elements differ (the bf16 stack flips
  roundings), mean |Δ| <= 1e-4, max |Δ| <= 1/64, and no image bound (its
  bf16 VAE alone moves pixels by up to 5/255 without an adapter). Reading
  with the adapter, guidance 3.5: 43.4% / 5.4e-5 / 1/128 at scale 1,
  46.1% / 3.5e-5 / 1/128 at 0.5 (without it: 36.6% / 4.2e-5 / 1/64); the
  adapter itself moves the latents by 7.2e-3 (scale 1) on average.
Inside the port, the adapter's factors kept in their linears' compute dtype
give the same bits as the per-call cast, and a runtime adapter against the
same adapter folded into the weights is JAX's criterion
(tests/test_adapters.py): mean |Δ| under 1/255, and the adapter moves the
image more than twice that.
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_pipeline import PROMPTS, SEED, STEPS, UP_STEPS, _grid, _jax_noise, _models, _np

from visualcloze_tpu.models import lora as jlora
from visualcloze_tpu.pipeline.loader import synthetic_full_components as jax_synthetic
from visualcloze_tpu.models.weights import lora_to_torch_state as jax_lora_to_torch_state
from visualcloze_tpu.utils import metrics as jmetrics
from visualcloze_tpu_torch import config as tconfig
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.models import lora as tlora
from visualcloze_tpu_torch.models.flux import build_flux
from visualcloze_tpu_torch.models.conditioner import FallbackTokenizer, TextEncoder
from visualcloze_tpu_torch.models.layers import Int8Linear
from visualcloze_tpu_torch.models.quant import quantize_flux_int8
from visualcloze_tpu_torch.ops import cuda_build
from visualcloze_tpu_torch.pipeline import VisualClozePipeline, random_components
from visualcloze_tpu_torch.pipeline.diffusers_api import _as_image, default_layout_prompt
from visualcloze_tpu_torch.pipeline.visualcloze import NoiseSource, VisualClozeModel
from visualcloze_tpu_torch.utils import metrics as tmetrics


CFG = 3.5

@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny model's ops are too small to split across threads: under
    several test workers on a few cores, torch's intra-op threads only wait
    on each other (10-100x slower). One thread here, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_lora(params, seed, rank=4):
    return jlora.randomize_lora_b(jlora.init_lora(jax.random.PRNGKey(seed), params, rank=rank),
                                  jax.random.PRNGKey(seed + 50))


@pytest.fixture(scope="module")
def pair():
    """JAX's tiny model and the port's, the same adapter "task" on both."""
    jm, pm = _models("half")
    lora = _jax_lora(jm.params, 3)
    jm.add_adapter("task", lora)
    pm.add_adapter("task", convert.lora_from_jax(_np(lora), jm.cfg, device="cpu"))
    return jm, pm


def _compare(jm, pm, frac: float, upsampling: bool = False, images: bool = True):
    """prepare -> denoise -> finalize with adapter "task" in both: the
    packed tokens exactly, the latents and the images within the bounds."""
    grid = _grid()
    noise = _jax_noise((1, 8, 16, 4), (1, 8, 8, 4))
    qj = jm.prepare_query(grid, PROMPTS, seed=SEED, steps=STEPS, adapter="task", cfg=CFG)
    qp = pm.prepare_query(grid, PROMPTS, seed=SEED, steps=STEPS, noise=noise, adapter="task", cfg=CFG)
    np.testing.assert_array_equal(qp["x"].float().numpy(), np.asarray(qj["x"], np.float32))
    sj = np.asarray(jm.denoise_query(qj), np.float32)
    sp = pm.denoise_query(qp)
    got = sp.float().numpy()
    assert np.isfinite(got).all() and got.shape == sj.shape
    diff = np.abs(got - sj)
    assert (diff > 0).mean() <= frac, (diff > 0).mean()
    assert diff.mean() <= 1e-4, diff.mean()
    assert diff.max() <= 1 / 64, diff.max()
    if not images:
        return got
    kw = dict(upsampling_steps=UP_STEPS, upsampling_noise=0.4, is_upsampling=upsampling)
    out_j = jm.finalize_query(qj, jnp.asarray(sj, jnp.bfloat16), **kw)
    out_p = pm.finalize_query(qp, sp, **kw)
    assert len(out_j) == len(out_p) == 1 and out_j[0].size == out_p[0].size
    pix = np.abs(np.asarray(out_j[0], np.int32) - np.asarray(out_p[0], np.int32))
    assert pix.max() <= 2, pix.max()
    return got


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_adapter_query_matches_jax(pair, scale):
    jm, pm = pair
    jm.lora_scale = pm.lora_scale = scale
    try:
        with_adapter = _compare(jm, pm, frac=0.02)
    finally:
        jm.lora_scale = pm.lora_scale = 1.0
    qp = pm.prepare_query(_grid(), PROMPTS, seed=SEED, steps=STEPS, noise=_jax_noise((1, 8, 16, 4), (1, 8, 8, 4)),
                          cfg=CFG)
    base = pm.denoise_query(qp).float().numpy()
    assert np.abs(with_adapter - base).mean() > 1e-3  # the adapter acts


def test_adapter_through_the_sdedit_stage_matches_jax(pair):
    _compare(*pair, frac=0.02, upsampling=True)


@pytest.fixture(scope="module")
def int8_pair():
    """JAX's tiny single-card int8 stack and its port, adapter "task" on both."""
    jm = jax_synthetic(jax.random.PRNGKey(0), resolution=64, tiny=True)
    bf = torch.bfloat16
    t5 = TextEncoder("t5", convert.t5_from_jax(_np(jm.t5.params), jm.t5.cfg, device="cpu", dtype=bf),
                     FallbackTokenizer(jm.t5.cfg.vocab_size), jm.t5.max_length)
    clip = TextEncoder("clip", convert.clip_from_jax(_np(jm.clip.params), jm.clip.cfg, device="cpu", dtype=bf),
                       FallbackTokenizer(jm.clip.cfg.vocab_size), jm.clip.max_length)
    pm = VisualClozeModel(convert.config_from(jm.cfg, tconfig.FluxConfig),
                          convert.flux_from_jax(_np(jm.params), jm.cfg, device="cpu", dtype=bf),
                          convert.vae_from_jax(_np(jm.ae.params), jm.ae.cfg, device="cpu", dtype=bf),
                          t5, clip, resolution=64, device="cpu", permute_params=False)
    for m in (jm, pm):
        m.set_grid_size(2, 2)
    lora = _jax_lora(jm.params, 13)  # init_lora recognizes the int8 linears in both
    jm.add_adapter("task", lora)
    pm.add_adapter("task", convert.lora_from_jax(_np(lora), jm.cfg, device="cpu"))
    return jm, pm


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_adapter_on_an_int8_base_matches_jax(int8_pair, scale):
    jm, pm = int8_pair
    assert isinstance(pm.flux.single_blocks[0].linear1, Int8Linear)
    # the int8 linears compute the delta in bf16: the factors are kept in bf16
    assert pm.adapters["task"]["single_blocks"][0]["linear1"]["a"].dtype == torch.bfloat16
    jm.lora_scale = pm.lora_scale = scale
    try:
        _compare(jm, pm, frac=0.5, images=False)
    finally:
        jm.lora_scale = pm.lora_scale = 1.0


def test_adapter_warm_set_matches_jax(pair):
    jm, pm = pair  # "task" (rank 4) is registered first
    names = ("a_r4", "b_r8", "c_r8")
    try:
        for name, seed in zip(names, (1, 2, 3)):
            lora = jlora.init_lora(jax.random.PRNGKey(seed), jm.params, rank=int(name[-1]))
            jm.add_adapter(name, lora)
            pm.add_adapter(name, convert.lora_from_jax(_np(lora), jm.cfg, device="cpu"))
        assert pm.adapter_warm_set() == jm.adapter_warm_set() == [None, "task", "b_r8"]
    finally:
        for m in (jm, pm):
            for name in names:
                m.adapters.pop(name, None)


def test_unknown_adapter_raises_before_any_work(monkeypatch):
    m = random_components(tiny=True, device="cpu", resolution=64)
    m.set_grid_size(1, 2)
    img = Image.new("RGB", (64, 64))

    def no_work(*a, **k):
        raise AssertionError("work done before the adapter was checked")

    monkeypatch.setattr(m, "encode_row", no_work)
    with pytest.raises(ValueError, match="unknown adapter"):
        m.process_images([[img, None]], ["l", "t", "c"], adapter="nope")
    with pytest.raises(ValueError, match="unknown adapter"):
        m.prepare_upsampling(img, (64, 64), 30.0, upsampling_steps=2, upsampling_noise=0.4,
                             noise=NoiseSource(m.device, 1), content_prompt="", adapter="nope")
    with pytest.raises(ValueError, match="unknown adapter"):
        m.denoise_query({"adapter": "nope"})


def _tiny_flux(dtype, int8=False):
    cfg = tconfig.FluxConfig().tiny()
    flux = build_flux(cfg, torch.device("cpu"), torch.float32).init_random_(torch.Generator().manual_seed(0))
    flux = quantize_flux_int8(flux) if int8 else flux.to(dtype)
    return cfg, flux


@pytest.mark.parametrize("base", ["bf16", "int8"])
def test_factors_kept_in_the_compute_dtype_give_the_same_bits(base):
    """add_adapter keeps each entry in its linear's compute dtype (bf16
    here), once; the DiT with those factors gives the bits of the DiT with
    the fp32 factors, cast at every call."""
    from test_torch_models import _flux_inputs

    cfg, flux = _tiny_flux(torch.bfloat16, int8=base == "int8")
    m = random_components(tiny=True, device="cpu", resolution=64)
    m.cfg, m.flux = cfg, flux
    lora = tlora.randomize_lora_b(tlora.init_lora(flux, 4, generator=torch.Generator().manual_seed(1)),
                                  torch.Generator().manual_seed(2))
    m.add_adapter("task", lora)
    kept = m.adapters["task"]
    assert {t.dtype for t in tlora.tree_leaves(kept)} == {torch.bfloat16}
    inp = {k: torch.from_numpy(v) for k, v in _flux_inputs(cfg, 1, 64, 16, 0, padded=True).items()}
    with torch.no_grad():
        # the same tree in the half layout, its leaves left in fp32
        from visualcloze_tpu_torch.models.weights import permute_rope_layout_lora

        want = flux(**inp, lora=permute_rope_layout_lora(lora, cfg), lora_scale=0.5)
        got = flux(**inp, lora=kept, lora_scale=0.5)
    assert torch.equal(got, want)


def test_runtime_adapter_matches_the_folded_one_and_acts():
    mA = random_components(tiny=True, device="cpu", resolution=64)
    mB = random_components(tiny=True, device="cpu", resolution=64)
    lora = tlora.randomize_lora_b(tlora.init_lora(mA.flux, 4, generator=torch.Generator().manual_seed(7)),
                                  torch.Generator().manual_seed(57))
    mA.add_adapter("task", lora)  # permuted into mA's half layout
    tlora.fold_lora(mB.flux, mA.adapters["task"], scale=1.0)
    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8))
    grid = [[img, img], [img, None]]
    kw = dict(seed=5, steps=2, is_upsampling=False, grid_size=(2, 2))
    a = np.asarray(mA.process_images(grid, ["layout", "task", "content"], adapter="task", **kw)[0], np.float32)
    f = np.asarray(mB.process_images(grid, ["layout", "task", "content"], **kw)[0], np.float32)
    b = np.asarray(mA.process_images(grid, ["layout", "task", "content"], **kw)[0], np.float32)
    assert np.mean(np.abs(a - f)) < 1.0, np.mean(np.abs(a - f))
    assert np.mean(np.abs(a - b)) > 2.0 * max(np.mean(np.abs(a - f)), 0.1)


def test_add_adapter_refuses_an_entry_without_a_linear():
    m = random_components(tiny=True, device="cpu", resolution=64)
    lora = tlora.init_lora(m.flux, 2, generator=torch.Generator().manual_seed(0))
    lora["nowhere"] = lora["img_in"]
    with pytest.raises(ValueError, match="no linear"):
        m.add_adapter("bad", lora)
    assert "bad" not in m.adapters


def test_randomize_lora_b_draws_b_only_from_the_generator():
    m = random_components(tiny=True, device="cpu", resolution=64)
    lora = tlora.init_lora(m.flux, 3, generator=torch.Generator().manual_seed(0))
    one = tlora.randomize_lora_b(lora, torch.Generator().manual_seed(4))
    two = tlora.randomize_lora_b(lora, torch.Generator().manual_seed(4))
    for (path, x), (_, y), (_, z) in zip(tlora.tree_items(lora), tlora.tree_items(one), tlora.tree_items(two)):
        assert torch.equal(y, z), path
        if path.endswith(".b"):
            assert not torch.equal(x, y) and abs(float(y.std()) - 0.02) < 0.01, path
        else:
            assert torch.equal(x, y), path


def test_init_lora_attaches_only_to_linears_that_take_a_delta():
    """Dense and kernel-backed quantized linears get an entry; another module
    with in_features / out_features (the T5's int4, CLIP's int8) does not."""
    from visualcloze_tpu_torch.models.layers import W8A8Linear
    from visualcloze_tpu_torch.models.quant import DequantInt8Linear, Int4Linear

    net = torch.nn.Module()
    net.dense, net.i8, net.a8 = torch.nn.Linear(8, 4), Int8Linear(8, 4), W8A8Linear(8, 4)
    net.i4, net.clip8 = Int4Linear(64, 4, group=32), DequantInt8Linear(8, 4)
    lora = tlora.init_lora(net, 2, generator=torch.Generator().manual_seed(0))
    assert sorted(lora) == ["a8", "dense", "i8"]


def test_init_lora_attaches_to_quantized_linears():
    """As JAX's init_lora on an int8 tree: the same entries and shapes as on
    the dense DiT, and a random adapter on the int8 DiT acts."""
    from test_torch_models import _flux_inputs

    cfg, dense = _tiny_flux(torch.float32)
    q = quantize_flux_int8(_tiny_flux(torch.float32)[1])
    lq = tlora.init_lora(q, 2, generator=torch.Generator().manual_seed(5))
    lf = tlora.init_lora(dense, 2, generator=torch.Generator().manual_seed(5))
    assert [(p, x.shape) for p, x in tlora.tree_items(lq)] == [(p, x.shape) for p, x in tlora.tree_items(lf)]
    inp = {k: torch.from_numpy(v) for k, v in _flux_inputs(cfg, 1, 64, 16, 1, padded=False).items()}
    with torch.no_grad():
        base = q(**inp).float()
        got = q(**inp, lora=tlora.randomize_lora_b(lq, torch.Generator().manual_seed(55))).float()
    assert (got - base).abs().max() > 1e-4


def test_warmup_runs_one_pass_per_adapter_signature(monkeypatch):
    m = random_components(tiny=True, device="cpu", resolution=32)
    for name, seed, rank in (("a_r2", 1, 2), ("b_r2", 2, 2), ("c_r4", 3, 4)):
        m.add_adapter(name, tlora.init_lora(m.flux, rank, generator=torch.Generator().manual_seed(seed)))
    grid_calls = []
    monkeypatch.setattr(m, "process_images", lambda grid, prompts, **k: grid_calls.append(
        (k["adapter"], k["grid_size"], grid[0][0].size, grid[-1][-1])))
    m.warmup([(1, 2)], steps=1, upsampling_steps=1, upsampling_sizes=[(64, 48)])
    # one blank grid per query-cell size (the resolution's, then the SDEdit size) and adapter signature
    assert grid_calls == [(a, (1, 2), size, None) for size in ((32, 32), (64, 48)) for a in (None, "a_r2", "c_r4")]
    assert (m.grid_h, m.grid_w) == (None, None)  # the warmup left set_grid_size's state alone


def test_warmup_goes_through_the_given_submit_path(monkeypatch):
    m = random_components(tiny=True, device="cpu", resolution=32)
    m.add_adapter("a", tlora.init_lora(m.flux, 2, generator=torch.Generator().manual_seed(1)))
    monkeypatch.setattr(m, "process_images", lambda *a, **k: pytest.fail("warmup bypassed submit"))
    submitted = []
    m.warmup([(2, 2), (1, 3)], steps=2, submit=lambda grid, prompts, **k: submitted.append(
        (k["adapter"], k["grid_size"], k["steps"], k["is_upsampling"])))
    assert submitted == [(a, g, 2, True) for g in ((2, 2), (1, 3)) for a in (None, "a")]


# ----------------------------- the diffusers-style API -----------------------------


@pytest.fixture(scope="module")
def model():
    return random_components(tiny=True, device="cpu", resolution=64)


def _img(seed, size=64):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8))


def _cells():
    return [[_img(1), _img(2)], [_img(3), None]]


def test_diffusers_call_matches_process_images(model):
    """upsampling_strength s is process_images' upsampling_noise 1 - s."""
    out = VisualClozePipeline(model)(
        task_prompt="each row maps a photo to itself", content_prompt="a colorful square", image=_cells(),
        upsampling_strength=0.6, upsampling_steps=2, num_inference_steps=2, guidance_scale=30.0, seed=7)
    assert isinstance(out.images, list) and len(out.images) == 1 and len(out.images[0]) == 1
    want = model.process_images(
        _cells(), [default_layout_prompt(2, 2), "each row maps a photo to itself", "a colorful square"],
        seed=7, cfg=30.0, steps=2, upsampling_steps=2, upsampling_noise=0.4, is_upsampling=True, grid_size=(2, 2))
    np.testing.assert_array_equal(np.asarray(out.images[0][0]), np.asarray(want[0]))


def test_diffusers_upsampling_size_and_strength(model):
    pipe = VisualClozePipeline(model)
    kw = dict(task_prompt="t", image=_cells(), num_inference_steps=2, upsampling_steps=2, upsampling_width=96,
              upsampling_height=64, seed=3)
    plain = pipe(upsampling_strength=0.0, **kw).images[0][0]
    assert plain.size == (96, 64)
    base = model.process_images(_cells(), [default_layout_prompt(2, 2), "t", ""], seed=3, cfg=30.0, steps=2,
                                is_upsampling=False, grid_size=(2, 2))[0]
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(base.resize((96, 64))))
    full = pipe(upsampling_strength=1.0, **kw).images[0][0]
    assert full.size == (96, 64) and np.abs(np.asarray(full, np.float32) - np.asarray(plain, np.float32)).max() > 0
    with pytest.raises(ValueError, match="upsampling_strength"):
        pipe(upsampling_strength=1.5, **kw)
    with pytest.raises(ValueError, match="both upsampling_width"):
        pipe(task_prompt="t", image=_cells(), num_inference_steps=2, upsampling_width=96)


def test_diffusers_as_image_and_generator(model):
    for cell in (Image.new("RGBA", (8, 8)), Image.new("L", (8, 8), 77), np.full((8, 8), 9, np.uint8),
                 np.zeros((8, 8, 4), np.uint8)):
        img = _as_image(cell)
        assert img.mode == "RGB" and img.size == (8, 8)
    assert _as_image(None) is None
    pipe = VisualClozePipeline(model)
    kw = dict(task_prompt="t", content_prompt="c", image=_cells(), num_inference_steps=2, upsampling_strength=0.0)
    a = pipe(generator=torch.Generator().manual_seed(11), **kw).images[0][0]
    b = pipe(seed=11, **kw).images[0][0]
    c = pipe(generator=11, **kw).images[0][0]
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_diffusers_load_lora_weights_as_adapter_and_folded(pair, tmp_path):
    """A reference .pth written by JAX's exporter: as a runtime adapter it
    moves the image; folded, it gives the adapter's image within JAX's
    criterion (adapter vs folded under half of adapter vs base)."""
    jm, _ = pair
    lora = _jax_lora(jm.params, 5, rank=2)
    state = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jax_lora_to_torch_state(lora, jm.cfg).items()}
    torch.save(state, tmp_path / "task_lora.pth")
    m = random_components(tiny=True, device="cpu", resolution=64)
    pipe = VisualClozePipeline(m)
    assert pipe.load_lora_weights(tmp_path, weight_name="task_lora.pth", adapter_name="task") is pipe
    kw = dict(task_prompt="t", content_prompt="c", image=_cells(), num_inference_steps=2, upsampling_strength=0.0,
              seed=9)
    base = np.asarray(pipe(**kw).images[0][0], np.float32)
    adapted = np.asarray(pipe(adapter="task", **kw).images[0][0], np.float32)
    pipe.load_lora_weights(tmp_path / "task_lora.pth")
    folded = np.asarray(pipe(**kw).images[0][0], np.float32)
    assert np.abs(adapted - folded).mean() < 0.5 * np.abs(adapted - base).mean()


def test_diffusers_input_validation_and_device(model, tmp_path):
    pipe = VisualClozePipeline(model)
    with pytest.raises(ValueError, match="same length"):
        pipe(task_prompt="t", image=[[_img(0), None], [_img(1)]], num_inference_steps=2)
    assert model.t5.max_length != 77
    with pytest.raises(ValueError, match="max_sequence_length"):
        pipe(task_prompt="t", image=_cells(), max_sequence_length=77, num_inference_steps=2)
    with pytest.raises(ValueError, match="image"):
        pipe(task_prompt="t")
    p = tmp_path / "a.png"
    _img(1).save(p)
    out = pipe(task_prompt="t", image=[[str(p), np.asarray(_img(2))], [_img(3), None]], num_inference_steps=2,
               upsampling_strength=0.0, seed=1, max_sequence_length=model.t5.max_length)
    assert isinstance(out.images[0][0], Image.Image)
    assert pipe.to("cpu") is pipe and pipe.to() is pipe
    with pytest.raises(ValueError, match="lives on cpu"):
        pipe.to("meta")


# ----------------------------- the kernel directory (enable_aot) -----------------------------


def test_enable_aot_points_the_kernel_build_at_the_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    ran = []
    monkeypatch.setattr(cuda_build.subprocess, "Popen", lambda *a, **k: ran.append(a))
    m = random_components(tiny=True, device="cpu", resolution=64)
    monkeypatch.delenv("VISUALCLOZE_AOT_DIR", raising=False)
    assert m.enable_aot() == str(cuda_build.DEFAULT_BUILD_DIR)
    monkeypatch.setenv("VISUALCLOZE_AOT_DIR", str(tmp_path / "env"))
    assert m.enable_aot() == str(tmp_path / "env")
    assert m.enable_aot(str(tmp_path / "mine")) == str(tmp_path / "mine") == str(cuda_build.BUILD_DIR)
    m.set_grid_size(1, 2)
    m.process_images([[_img(0), None]], ["l", "t", "c"], seed=1, steps=2, is_upsampling=False)
    assert ran == [] and not (tmp_path / "mine").exists()  # on the CPU no kernel is built
    monkeypatch.setitem(cuda_build._LIBS, "flash_attn_rope", object())  # a library loaded from "mine"
    with pytest.raises(RuntimeError, match="already loaded"):
        m.enable_aot(str(tmp_path / "other"))
    assert m.enable_aot(str(tmp_path / "mine")) == str(tmp_path / "mine")


# ----------------------------- the eval CLI and its metrics -----------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (32, 32, 3)).astype(np.float64)
    b = a + rng.normal(0, 2.0, a.shape)
    for fn in ("psnr", "mae", "ssim"):
        assert getattr(tmetrics, fn)(a, b) == getattr(jmetrics, fn)(a, b), fn
    assert tmetrics.psnr(a, a) == float("inf") and tmetrics.ssim(a, a) == 1.0


def test_sample_cli_sweeps_a_synthetic_graph200k_set(tmp_path):
    from visualcloze_tpu_torch import sample

    random.seed(0)
    items = []
    for i in range(2):
        img = _img(i)
        cond = {}
        for name in ("target", "reference", "foreground", "canny", "depth", "openpose", "uniformer"):
            p = tmp_path / f"{i}_{name}.png"
            img.save(p)
            cond[name] = str(p)
        items.append({"condition": cond, "quality_assessment": {"objectConsistency": 5},
                      "description": {"item": f"i{i}", "description_0": "d"}})
    test_json = tmp_path / "test.json"
    test_json.write_text(json.dumps(items))
    out_dir = tmp_path / "out"
    argv = ["--test_json", str(test_json), "--output_dir", str(out_dir), "--demo", "--device", "cpu", "--steps", "2",
            "--max_items", "1"]
    sample.main(argv)
    manifest = json.loads((out_dir / "data.json").read_text())
    assert len(manifest) >= 3
    assert all((out_dir / f"{m['id']}.jpg").exists() for m in manifest)
    assert Image.open(manifest[0]["image"]).size[0] >= 128  # the composite: a row of at least two cells
    sample.main(argv)  # a rerun resumes: every id is already collected
    assert json.loads((out_dir / "data.json").read_text()) == manifest


@pytest.mark.parametrize("error, propagates", [(ValueError("grid too wide"), False),
                                               (RuntimeError("CUDA error: unspecified launch failure"), True)])
def test_sample_cli_skips_refused_queries_and_raises_device_faults(tmp_path, monkeypatch, error, propagates):
    from visualcloze_tpu_torch import sample
    from visualcloze_tpu_torch.pipeline.visualcloze import VisualClozeModel

    img = _img(0)
    cond = {}
    for name in ("target", "reference", "foreground", "canny", "depth", "openpose", "uniformer"):
        img.save(tmp_path / f"{name}.png")
        cond[name] = str(tmp_path / f"{name}.png")
    item = {"condition": cond, "quality_assessment": {"objectConsistency": 5},
            "description": {"item": "i", "description_0": "d"}}
    (tmp_path / "test.json").write_text(json.dumps([item, item]))

    def refuse(self, *a, **k):
        raise error

    monkeypatch.setattr(VisualClozeModel, "process_images", refuse)
    argv = ["--test_json", str(tmp_path / "test.json"), "--output_dir", str(tmp_path / "out"), "--demo",
            "--device", "cpu", "--steps", "1"]
    if propagates:
        with pytest.raises(RuntimeError, match="launch failure"):
            sample.main(argv)
    else:
        sample.main(argv)
        assert not (tmp_path / "out" / "data.json").exists() or json.loads(
            (tmp_path / "out" / "data.json").read_text()) == []
