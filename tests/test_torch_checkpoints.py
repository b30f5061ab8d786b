"""Checkpoint files through the port against the JAX package, at the tiny configs.

- safetensors: the port's reader and writer against the `safetensors`
  package, bit for bit in both directions (and byte for byte as files).
- Converters: files written by the JAX exporters (BFL and diffusers FLUX,
  reference and diffusers LoRA, the VAE in BFL and diffusers naming) and HF
  T5/CLIP state dicts from `transformers` are read by both packages; the
  port's modules hold exactly what the JAX trees carried over by
  visualcloze_tpu_torch.convert hold. The port's exporters write JAX's keys
  and values.
- The RoPE-layout permutations are bit-identical (dense, int8 and LoRA);
  fold_lora is within 1e-6 of the largest magnitude of each tensor (fp32;
  the two frameworks' products sum in other orders); folding then permuting
  equals permuting then folding with the permuted LoRA.
- End to end: build_visualcloze on BFL + LoRA files and on a diffusers
  snapshot directory gives JAX's tiny query under the tiny pipeline's bounds
  (tests/test_torch_pipeline.py: <= 2% of latent elements differ, mean
  |Δ| <= 1e-4, max <= 1/64; images within 2/255), at the pipeline's
  guidance 30, with Euler, and with heun and ab2 on JAX's timestep
  embedding (see the test).
Both packages' build_visualcloze read the published widths only, so their
config classes, model registry entries and tokenizers are patched to the
tiny ones.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file
from test_torch_guards import patch_loader_tiny

from visualcloze_tpu import config as jconfig
from visualcloze_tpu.models import lora as jlora_mod
from visualcloze_tpu.models import quant as jquant
from visualcloze_tpu.models import weights as JW
from visualcloze_tpu.models.autoencoder import init_autoencoder
from visualcloze_tpu.models.conditioner import FallbackTokenizer as JFallback
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu.ops.schedule import timestep_embedding as jtimestep_embedding
from visualcloze_tpu.pipeline import loader as jloader
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.models import flux as tflux
from visualcloze_tpu_torch.models import lora as tlora
from visualcloze_tpu_torch.models import weights as TW
from visualcloze_tpu_torch.models.quant import quantize_flux_int8
from visualcloze_tpu_torch.pipeline import loader as tloader

FLUX_T, AE_T, T5_T, CLIP_T = tloader._configs(True)
JFLUX = convert.config_from(FLUX_T, jconfig.FluxConfig)
JAE = convert.config_from(AE_T, jconfig.AutoEncoderConfig)
JT5 = convert.config_from(T5_T, jconfig.T5Config)
JCLIP = convert.config_from(CLIP_T, jconfig.CLIPTextConfig)
RANK = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _shapes(fn, *args):
    """The tree `fn` would return (traced, not run: the JAX inits run op by op
    on the CPU and take seconds)."""
    return jax.eval_shape(fn, *args)


def _random(shapes, seed, init_scale=False):
    """numpy leaves of the shapes of `shapes`: N(0, 0.1) (so that no leaf is a
    constant), or with init_scale the JAX inits' scales (weights N(0, 1/fan_in),
    biases 0, norm scales 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if not init_scale:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        name = path[-1].key
        if name in ("scale", "q_scale", "k_scale"):
            return np.ones(s.shape, np.float32)
        if name in ("b", "bias"):
            return np.zeros(s.shape, np.float32)
        fan_in = int(np.prod(s.shape[-4:-1])) if len(s.shape) >= 4 and name == "w" else s.shape[-2]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


FLUX_SHAPES = _shapes(lambda k: init_flux(k, JFLUX), jax.random.PRNGKey(0))
LORA_SHAPES = _shapes(lambda p: jlora_mod.init_lora(jax.random.PRNGKey(1), p, rank=RANK), FLUX_SHAPES)
AE_SHAPES = _shapes(lambda k: init_autoencoder(k, JAE), jax.random.PRNGKey(2))


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(w), k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


def _module_state(m):
    return {k: v.detach().numpy() for k, v in TW.module_state(m).items()}


@pytest.fixture(scope="module")
def jflux():
    return _random(FLUX_SHAPES, 1)


@pytest.fixture(scope="module")
def jlora():
    return _random(LORA_SHAPES, 2)


@pytest.fixture(scope="module")
def jae():
    return _random(AE_SHAPES, 3)


def _transformers():
    """transformers, imported without its TensorFlow and Flax back ends (their
    import alone takes seconds)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        mp.setenv("USE_FLAX", "0")
        import transformers
    return transformers


@pytest.fixture(scope="module")
def hf_t5_state():
    tf = _transformers()
    HFT5Config, T5EncoderModel = tf.T5Config, tf.T5EncoderModel

    torch.manual_seed(0)
    model = T5EncoderModel(HFT5Config(
        vocab_size=T5_T.vocab_size, d_model=T5_T.d_model, d_kv=T5_T.d_kv, d_ff=T5_T.d_ff,
        num_layers=T5_T.num_layers, num_heads=T5_T.num_heads,
        relative_attention_num_buckets=T5_T.relative_attention_num_buckets,
        relative_attention_max_distance=T5_T.relative_attention_max_distance,
        feed_forward_proj="gated-gelu", dropout_rate=0.0))
    return {k: v.detach().clone().contiguous() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def hf_clip_state():
    tf = _transformers()
    HFCLIPTextConfig, CLIPTextModel = tf.CLIPTextConfig, tf.CLIPTextModel

    torch.manual_seed(1)
    model = CLIPTextModel(HFCLIPTextConfig(
        vocab_size=CLIP_T.vocab_size, hidden_size=CLIP_T.hidden_size, intermediate_size=CLIP_T.intermediate_size,
        num_hidden_layers=CLIP_T.num_layers, num_attention_heads=CLIP_T.num_heads,
        max_position_embeddings=CLIP_T.max_length, hidden_act="quick_gelu", eos_token_id=2,
        attention_dropout=0.0))
    return {k: v.detach().clone().contiguous() for k, v in model.state_dict().items()}


def _port_flux(state):
    return TW.assign_state(tloader.build_flux(FLUX_T, torch.device("cpu"), torch.float32), state)


# ----------------------------- safetensors -----------------------------


def _st_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "w.bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
        "a.f32": torch.randn((4, 2, 3), generator=g),
        "codes.i8": torch.randint(-128, 128, (7, 3), generator=g, dtype=torch.int8),
        "packed.u8": torch.randint(0, 256, (9,), generator=g, dtype=torch.uint8),
        "h.f16": torch.randn((2, 2), generator=g).to(torch.float16),
        "ids.i64": torch.arange(6).reshape(2, 3),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros((0, 4)),
    }


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("metadata", [None, {}, {"format": "pt"}])
def test_safetensors_round_trips_with_the_package(tmp_path, metadata):
    tensors = _st_tensors()
    ours, theirs = tmp_path / "port.safetensors", tmp_path / "package.safetensors"
    TW.save_safetensors(tensors, str(ours), metadata=metadata)
    st_save_file(tensors, str(theirs), metadata=metadata)
    assert ours.read_bytes() == theirs.read_bytes()
    for got in (st_load_file(str(ours)), TW.load_safetensors(str(theirs))):
        assert sorted(got) == sorted(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert _bits(got[k]) == _bits(t), k
    header, _ = TW.read_safetensors_header(str(theirs))
    assert header.get("__metadata__") == metadata


# ----------------------------- converters -----------------------------


def test_flux_bfl_file_converts_bit_for_bit(tmp_path, jflux):
    path = tmp_path / "flux.safetensors"
    np_save_file(JW.flux_to_torch_state(jflux, JFLUX), str(path))
    want = convert.flux_from_jax(JW.convert_flux(JW.load_safetensors(str(path)), JFLUX), JFLUX, device="cpu")
    got = _port_flux(TW.convert_flux(TW.load_safetensors(str(path)), FLUX_T))
    _assert_same(_module_state(got), _module_state(want))
    # the port's exporter writes JAX's keys and values
    _assert_same(TW.flux_to_torch_state(got, FLUX_T), JW.flux_to_torch_state(jflux, JFLUX))
    _assert_same(TW.flux_to_diffusers_state(got, FLUX_T), JW.flux_to_diffusers_state(jflux, JFLUX))


def test_img_in_zero_expansion_matches_jax(jflux):
    state = JW.flux_to_torch_state(jflux, JFLUX)
    state["img_in.weight"] = np.ascontiguousarray(state["img_in.weight"][:, :40])
    jt = JW.convert_flux(state, JFLUX)
    assert jt["img_in"]["w"].shape == (JFLUX.in_channels, JFLUX.hidden_size)
    got = TW.convert_flux({k: torch.from_numpy(v) for k, v in state.items()}, FLUX_T)
    np.testing.assert_array_equal(got["img_in.weight"].numpy(), np.asarray(jt["img_in"]["w"]).T)
    assert not got["img_in.weight"][:, 40:].any()


def test_diffusers_snapshot_converts_bit_for_bit(tmp_path, jflux):
    dif = JW.flux_to_diffusers_state(jflux, JFLUX)
    sub = tmp_path / "snap" / "transformer"
    sub.mkdir(parents=True)
    (tmp_path / "snap" / "model_index.json").write_text("{}")
    items = sorted(dif.items())
    np_save_file(dict(items[: len(items) // 2]), str(sub / "diffusion_pytorch_model-00001-of-00002.safetensors"))
    np_save_file(dict(items[len(items) // 2:]), str(sub / "diffusion_pytorch_model-00002-of-00002.safetensors"))
    snap = str(tmp_path / "snap")
    assert tloader.is_diffusers_snapshot(snap) and not tloader.is_diffusers_snapshot(str(tmp_path / "none"))
    want = convert.flux_from_jax(jloader.convert_flux_any(jloader.load_flux_state(snap), JFLUX), JFLUX, device="cpu")
    state = tloader.load_flux_state(snap)
    assert TW.is_diffusers_flux_state(state)
    got = _port_flux(tloader.convert_flux_any(state, FLUX_T))
    _assert_same(_module_state(got), _module_state(want))
    _assert_same(_module_state(got), _module_state(convert.flux_from_jax(jflux, JFLUX, device="cpu")))


def _lora_state(lora):
    return {k: v.detach().numpy() for k, v in tlora.tree_items(lora)}


def test_reference_lora_file_converts_bit_for_bit(tmp_path, jlora):
    path = tmp_path / "lora.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in JW.lora_to_torch_state(jlora, JFLUX).items()}, path)
    want = convert.lora_from_jax(jloader.convert_lora_any(jloader.load_torch_checkpoint(str(path)), JFLUX),
                                 JFLUX, device="cpu")
    got = tloader.convert_lora_any(tloader.load_torch_checkpoint(str(path)), FLUX_T)
    _assert_same(_lora_state(got), _lora_state(want))
    _assert_same(TW.lora_to_torch_state(got), JW.lora_to_torch_state(jlora, JFLUX))
    _assert_same(TW.lora_to_diffusers_state(got, FLUX_T), JW.lora_to_diffusers_state(jlora, JFLUX))


def test_diffusers_lora_file_converts_bit_for_bit(tmp_path, jlora):
    """Split q/k/v adapters fused, the final modulation swapped back, a
    kohya alpha scaled in, and a partial (to_q only) adapter fused."""
    state = JW.lora_to_diffusers_state(jlora, JFLUX)
    h = JFLUX.hidden_size
    state["transformer.x_embedder.alpha"] = np.asarray(2.0, np.float32)
    for k in [k for k in state if k.startswith("transformer.transformer_blocks.")
              and (".attn.to_k." in k or ".attn.to_v." in k)]:
        del state[k]  # the image stream's qkv: q only (JAX stacks blocks, so in every block)
    path = tmp_path / "lora.safetensors"
    np_save_file(state, str(path))
    want = convert.lora_from_jax(jloader.convert_lora_any(jloader.load_torch_checkpoint(str(path)), JFLUX),
                                 JFLUX, device="cpu")
    loaded = tloader.load_torch_checkpoint(str(path))
    assert TW.is_diffusers_lora_state(loaded)
    got = tloader.convert_lora_any(loaded, FLUX_T)
    _assert_same(_lora_state(got), _lora_state(want))
    qkv = got["double_blocks"][1]["img_attn"]["qkv"]["b"]
    assert qkv[:, :h].abs().max() > 0 and qkv[:, h:].abs().max() == 0


def _diffusers_vae_names(state: dict, n_levels: int) -> dict:
    """BFL VAE names -> diffusers AutoencoderKL names (attention projections as Linear)."""
    out = {}
    for k, v in state.items():
        nk = k
        if nk.startswith("decoder.up."):
            parts = nk.split(".")
            parts[2] = str(n_levels - 1 - int(parts[2]))
            nk = ".".join(["decoder", "up_blocks"] + parts[2:])
        for a, b in (("down.", "down_blocks."), (".block.", ".resnets."), ("downsample.conv", "downsamplers.0.conv"),
                     ("upsample.conv", "upsamplers.0.conv"), ("mid.block_1", "mid_block.resnets.0"),
                     ("mid.block_2", "mid_block.resnets.1"), ("mid.attn_1.norm", "mid_block.attentions.0.group_norm"),
                     ("mid.attn_1.proj_out", "mid_block.attentions.0.to_out.0"), ("norm_out", "conv_norm_out"),
                     ("nin_shortcut", "conv_shortcut")):
            nk = nk.replace(a, b)
        for q in ("q", "k", "v"):
            if f"mid.attn_1.{q}." in nk:
                nk = nk.replace(f"mid.attn_1.{q}.", f"mid_block.attentions.0.to_{q}.")
        if "attentions.0.to_" in nk and nk.endswith(".weight"):
            v = np.ascontiguousarray(v[:, :, 0, 0])
        out[nk] = v
    return out


@pytest.mark.parametrize("naming", ["bfl", "diffusers"])
def test_vae_file_converts_bit_for_bit(tmp_path, jae, naming):
    state = JW.vae_to_torch_state(jae, JAE)
    if naming == "diffusers":
        state = _diffusers_vae_names(state, len(JAE.ch_mult))
        assert any("mid_block" in k for k in state)
    path = tmp_path / "ae.safetensors"
    np_save_file(state, str(path))
    want = convert.vae_from_jax(JW.convert_vae(JW.load_safetensors(str(path)), JAE), JAE, device="cpu")
    got = TW.assign_state(tloader.build_autoencoder(AE_T, torch.device("cpu"), torch.float32),
                          TW.convert_vae(TW.load_safetensors(str(path)), AE_T))
    _assert_same(_module_state(got), _module_state(want))
    if naming == "bfl":
        _assert_same(TW.vae_to_torch_state(got), JW.vae_to_torch_state(jae, JAE))


def test_t5_and_clip_shards_convert_bit_for_bit(tmp_path, hf_t5_state, hf_clip_state):
    for name, state, jconv, tconv, jcfg, tcfg, carry, build in (
        ("t5", hf_t5_state, JW.convert_t5, TW.convert_t5, JT5, T5_T, convert.t5_from_jax, tloader.build_t5),
        ("clip", hf_clip_state, JW.convert_clip, TW.convert_clip, JCLIP, CLIP_T, convert.clip_from_jax,
         tloader.build_clip),
    ):
        d = tmp_path / name
        d.mkdir()
        items = sorted(state.items())
        st_save_file(dict(items[: len(items) // 2]), str(d / "model-00001-of-00002.safetensors"))
        st_save_file(dict(items[len(items) // 2:]), str(d / "model-00002-of-00002.safetensors"))
        want = carry(jconv(jloader.load_sharded_safetensors(str(d)), jcfg), jcfg, device="cpu")
        got = TW.assign_state(build(tcfg, torch.device("cpu"), torch.float32),
                              tconv(tloader.load_sharded_safetensors(str(d)), tcfg))
        _assert_same(_module_state(got), _module_state(want))
        keys = TW.t5_keys(tcfg) if name == "t5" else TW.clip_keys(tcfg)
        assert set(keys) <= set(state) and len(set(keys.values())) == len(keys)


# ----------------------------- permutations and folding -----------------------------


def test_rope_permutations_are_bit_identical(jflux, jlora):
    got = TW.permute_rope_layout(convert.flux_from_jax(jflux, JFLUX, device="cpu"), FLUX_T)
    want = convert.flux_from_jax(_np(JW.permute_rope_layout(jflux, JFLUX)), JFLUX, device="cpu")
    _assert_same(_module_state(got), _module_state(want))
    # int8 linears: codes and scales gathered alike
    jq = _np(jax.jit(jquant.quantize_flux_int8)(jflux))
    got = TW.permute_rope_layout(convert.flux_from_jax(jq, JFLUX, device="cpu"), FLUX_T)
    want = convert.flux_from_jax(_np(JW.permute_rope_layout(jq, JFLUX)), JFLUX, device="cpu")
    _assert_same(_module_state(got), _module_state(want))
    got = TW.permute_rope_layout_lora(convert.lora_from_jax(jlora, JFLUX, device="cpu"), FLUX_T)
    want = convert.lora_from_jax(_np(JW.permute_rope_layout_lora(jlora, JFLUX)), JFLUX, device="cpu")
    _assert_same(_lora_state(got), _lora_state(want))


def _assert_close_rel(got: dict, want: dict, rel=1e-6):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        err = np.abs(np.asarray(got[k], np.float64) - w).max()
        assert err <= rel * np.abs(w).max(), (k, err, np.abs(w).max())


def test_fold_lora_matches_jax(jflux, jlora):
    got = tlora.fold_lora(convert.flux_from_jax(jflux, JFLUX, device="cpu"),
                          convert.lora_from_jax(jlora, JFLUX, device="cpu"), scale=0.5)
    want = convert.flux_from_jax(_np(jlora_mod.fold_lora(jflux, jlora, scale=0.5)), JFLUX, device="cpu")
    _assert_close_rel(_module_state(got), _module_state(want))
    assert _module_state(got)["double_blocks.0.img_attn.qkv.weight"].tolist() != \
        _module_state(convert.flux_from_jax(jflux, JFLUX, device="cpu"))["double_blocks.0.img_attn.qkv.weight"].tolist()


def test_fold_then_permute_equals_permute_then_fold(jflux, jlora):
    lora = convert.lora_from_jax(jlora, JFLUX, device="cpu")
    a = TW.permute_rope_layout(tlora.fold_lora(convert.flux_from_jax(jflux, JFLUX, device="cpu"), lora), FLUX_T)
    b = tlora.fold_lora(TW.permute_rope_layout(convert.flux_from_jax(jflux, JFLUX, device="cpu"), FLUX_T),
                        TW.permute_rope_layout_lora(lora, FLUX_T))
    _assert_close_rel(_module_state(a), _module_state(b))
    np.testing.assert_array_equal(a.single_blocks[1].norm.q_scale.numpy(), b.single_blocks[1].norm.q_scale.numpy())


def test_fold_refuses_moe_and_int8_entries(jflux, jlora):
    lora = convert.lora_from_jax(jlora, JFLUX, device="cpu")
    flux = convert.flux_from_jax(jflux, JFLUX, device="cpu")
    moe = {"img_in": {"expert_a": torch.zeros(1), "shared_a": torch.zeros(1)}}
    with pytest.raises(ValueError, match="MoE-LoRA"):
        tlora.fold_lora(flux, moe)
    with pytest.raises(ValueError, match="int8-quantized"):
        tlora.fold_lora(quantize_flux_int8(flux), lora)
    with pytest.raises(ValueError, match="int8-quantized"):
        jlora_mod.fold_lora(_np(jax.jit(jquant.quantize_flux_int8)(jflux)), jlora)


# ----------------------------- build_visualcloze end to end -----------------------------


def _write_stack(root, jflux, jlora, jae, t5_state, clip_state):
    """BFL DiT, reference LoRA .pth, VAE, T5 and CLIP shard directories, and a
    diffusers snapshot (transformer/ with the LoRA folded, vae/, text_encoder*/)."""
    paths = {"flux": root / "flux.safetensors", "lora": root / "lora.pth", "ae": root / "ae.safetensors",
             "t5": root / "t5", "clip": root / "clip", "snap": root / "snapshot"}
    np_save_file(JW.flux_to_torch_state(jflux, JFLUX), str(paths["flux"]))
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in JW.lora_to_torch_state(jlora, JFLUX).items()},
               paths["lora"])
    np_save_file(JW.vae_to_torch_state(jae, JAE), str(paths["ae"]))
    snap = paths["snap"]
    for sub in ("transformer", "vae", "text_encoder", "text_encoder_2"):
        (snap / sub).mkdir(parents=True)
    (snap / "model_index.json").write_text(json.dumps({"_class_name": "VisualClozePipeline"}))
    folded = _np(jlora_mod.fold_lora(jflux, jlora))
    np_save_file(JW.flux_to_diffusers_state(folded, JFLUX), str(snap / "transformer" / "model.safetensors"))
    np_save_file(JW.vae_to_torch_state(jae, JAE), str(snap / "vae" / "model.safetensors"))
    for key, state, sub in (("t5", t5_state, "text_encoder_2"), ("clip", clip_state, "text_encoder")):
        paths[key].mkdir()
        st_save_file(state, str(paths[key] / "model.safetensors"))
        st_save_file(state, str(snap / sub / "model.safetensors"))
    return paths


@pytest.fixture(scope="module")
def stack_files(tmp_path_factory, hf_t5_state, hf_clip_state):
    """The stack at the JAX package's init scales, as test_torch_pipeline's
    model (the bounds are one bf16 ulp at its latents' magnitudes); the
    LoRA's B and B's bias, zero at init, N(0, 0.02) as JAX's randomize_lora_b."""
    flux, ae = _random(FLUX_SHAPES, 5, init_scale=True), _random(AE_SHAPES, 6, init_scale=True)
    rng = np.random.default_rng(7)

    def lora_leaf(path, s):
        if path[-1].key == "a":  # init_lora's torch-default uniform
            bound = s.shape[-2] ** -0.5
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)  # randomize_lora_b's scale

    lora = jax.tree_util.tree_map_with_path(lora_leaf, LORA_SHAPES)
    return _write_stack(tmp_path_factory.mktemp("ckpt"), flux, lora, ae, hf_t5_state, hf_clip_state)


@pytest.fixture(scope="module")
def tiny_jax_loader(stack_files):
    """Both packages' loaders at the tiny configs, and their environment."""
    with pytest.MonkeyPatch.context() as mp:
        patch_loader_tiny(mp)
        spec = jconfig.configs["flux-dev-fill-lora"]
        mp.setitem(jconfig.configs, "flux-dev-fill-lora", dataclasses.replace(spec, flux=JFLUX))
        mp.setattr(jloader, "AutoEncoderConfig", lambda: JAE)
        mp.setattr(jloader, "T5Config", lambda max_length=512: JT5)
        mp.setattr(jloader, "CLIPTextConfig", lambda: JCLIP)
        mp.setattr(jloader, "default_tokenizer",
                   lambda kind, path=None: JFallback(JT5.vocab_size if kind == "t5" else JCLIP.vocab_size))
        for var, key in (("FLUX_DEV_FILL", "flux"), ("AE", "ae"), ("T5_PATH", "t5"), ("CLIP_PATH", "clip")):
            mp.setenv(var, str(stack_files[key]))
        yield


def test_load_flux_params_folds_as_jax(tiny_jax_loader, stack_files):
    _, jparams = jloader.load_flux_params("flux-dev-fill-lora", lora_path=str(stack_files["lora"]),
                                          dtype=jnp.float32)
    want = _module_state(convert.flux_from_jax(_np(jparams), JFLUX, device="cpu"))
    _, flux = tloader.load_flux_params("flux-dev-fill-lora", lora_path=str(stack_files["lora"]),
                                       dtype=torch.float32, device="cpu")
    got = _module_state(flux)
    _assert_close_rel(got, want)
    for k in want:  # norm scales carry no LoRA: exact
        if k.endswith(("q_scale", "k_scale")):
            np.testing.assert_array_equal(got[k], want[k])


SEED, STEPS = 7, 3
PROMPTS = ["A grid with 2 rows", "map each photo", "The content of the last image in the final row is: a cat"]


def _grid():
    from PIL import Image

    rng = np.random.default_rng(0)

    def img():
        return Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))

    return [[img(), img()], [img(), None]]


def _jax_timestep_embedding(t, dim):
    """JAX's sinusoidal embedding of the port's timesteps, as a torch tensor."""
    return torch.from_numpy(np.array(jtimestep_embedding(jnp.asarray(t.float().cpu().numpy()), dim))).to(t.device)


def _jax_noise(row_shape, up_shape):
    """The JAX pipeline's draws in the port's order of use (as test_torch_pipeline)."""
    key = jax.random.PRNGKey(SEED)
    vae, latent = [], []
    for _ in range(2):
        key, ek, nk = jax.random.split(key, 3)
        vae.append(np.asarray(jax.random.normal(ek, row_shape, jnp.float32)))
        latent.append(np.asarray(jax.random.normal(nk, row_shape, jnp.float32)))
    key, uk = jax.random.split(key)
    _, ek, bk, nk = jax.random.split(uk, 4)
    vae += [np.asarray(jax.random.normal(k, up_shape, jnp.float32)) for k in (ek, bk)]
    latent.append(np.asarray(jax.random.normal(nk, up_shape, jnp.float32)))
    return {"vae": vae, "latent": latent}


@pytest.mark.parametrize("source,solver", [("files", "euler"), ("files", "heun"), ("files", "ab2"),
                                           ("snapshot", "euler")])
def test_build_visualcloze_query_matches_jax(tiny_jax_loader, stack_files, source, solver, monkeypatch):
    """At the pipeline's guidance 30. Euler runs the port as it is. The
    multi-evaluation solvers (heun: two roundings of the bf16 latent a step;
    ab2: an fp32 carry rounded once at the end) run with the port's
    sinusoidal timestep embedding replaced by JAX's values: the two differ
    by up to 2e-3 at t = 30 (test_torch_ops.test_timestep_embedding holds
    that difference to its own bound; XLA's fp32 exp of the frequencies is
    not correctly rounded), which flips more final bf16 roundings than the
    Euler-derived 2% allows. The solvers themselves round as JAX's bit for
    bit (test_torch_solvers); with the embedding held apart the loader and
    solver path is held to the same bounds as Euler."""
    if solver != "euler":
        monkeypatch.setattr(tflux, "timestep_embedding", _jax_timestep_embedding)
    cfg = 30.0
    model_path = str(stack_files["lora" if source == "files" else "snap"])
    jm = jloader.build_visualcloze(model_path=model_path, solver=solver, resolution=64, dtype=jnp.float32)
    pm = tloader.build_visualcloze(model_path=model_path, solver=solver, resolution=64, dtype=torch.float32,
                                   device="cpu")
    assert pm.rope_layout == "half" and pm.solver == solver
    for m in (jm, pm):
        m.set_grid_size(2, 2)
    grid = _grid()
    qj = jm.prepare_query(grid, PROMPTS, seed=SEED, cfg=cfg, steps=STEPS)
    qp = pm.prepare_query(grid, PROMPTS, seed=SEED, cfg=cfg, steps=STEPS,
                          noise=_jax_noise((1, 8, 16, 4), (1, 8, 8, 4)))
    np.testing.assert_array_equal(qp["x"].float().numpy(), np.asarray(qj["x"], np.float32))
    sj = np.asarray(jm.denoise_query(qj), np.float32)
    sp = pm.denoise_query(qp)
    got = sp.float().numpy()
    assert np.isfinite(got).all() and got.shape == sj.shape
    diff = np.abs(got - sj)
    assert (diff > 0).mean() <= 0.02, (diff > 0).sum()
    assert diff.mean() <= 1e-4, diff.mean()
    assert diff.max() <= 1 / 64, diff.max()
    # the SDEdit pass is the pipeline's own (test_torch_pipeline): decode and crop only
    out_j = jm.finalize_query(qj, jnp.asarray(sj, jnp.bfloat16), is_upsampling=False)
    out_p = pm.finalize_query(qp, sp, is_upsampling=False)
    assert len(out_j) == len(out_p) == 1 and out_j[0].size == out_p[0].size
    pix = np.abs(np.asarray(out_j[0], np.int32) - np.asarray(out_p[0], np.int32))
    assert pix.max() <= 2, pix.max()


def test_build_visualcloze_refuses_unported_modes(stack_files):
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tloader.build_visualcloze(model_path=str(stack_files["lora"]), quantize="int4", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        tloader.build_visualcloze(model_path=str(stack_files["lora"]), mesh=object(), device="cpu")
