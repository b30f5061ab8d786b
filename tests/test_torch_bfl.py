"""The BFL tools route of the port (models/sampling.py's prepare packers,
models/vision_towers.py, models/image_embedders.py, models/postprocess.py,
models/api.py and convert.py's *_from_jax) against the JAX package's, on
the CPU at tiny sizes.

The towers' HF-layout state dicts are built here from a numpy seed with the
key names the converters read (no transformers model); both packages'
converters read the same dict. Bounds: fp32, rtol 1e-4 / atol 1e-5 for the
towers (the same arithmetic, summed in another order); the packers' tokens
exactly where they only move data, within 1e-5 of the largest value where
the VAE runs (an fp32 conv stack).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from visualcloze_tpu.config import AutoEncoderConfig
from visualcloze_tpu.models import api as japi
from visualcloze_tpu.models import image_embedders as jie
from visualcloze_tpu.models import postprocess as jpost
from visualcloze_tpu.models import sampling as jsam
from visualcloze_tpu.models import vision_towers as jvt
from visualcloze_tpu.models.autoencoder import AutoEncoder as JaxAutoEncoder
from visualcloze_tpu.models.autoencoder import init_autoencoder
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.models import api as tapi
from visualcloze_tpu_torch.models import image_embedders as tie
from visualcloze_tpu_torch.models import postprocess as tpost
from visualcloze_tpu_torch.models import sampling as tsam
from visualcloze_tpu_torch.models import vision_towers as tvt

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Tiny ops: one intra-op thread under several test workers, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------- HF-layout state dicts -----------------------------


class _State(dict):
    """A state dict filled from one numpy seed: weights N(0, 1/fan_in),
    biases and norms around their identity."""

    def __init__(self, seed: int):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def _r(self, shape, std):
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def lin(self, key, din, dout):
        self[f"{key}.weight"] = self._r((dout, din), din ** -0.5)
        self[f"{key}.bias"] = self._r((dout,), 0.1)

    def ln(self, key, d):
        self[f"{key}.weight"] = 1.0 + self._r((d,), 0.1)
        self[f"{key}.bias"] = self._r((d,), 0.1)

    def conv(self, key, cin, cout, k, bias=True):
        self[f"{key}.weight"] = self._r((cout, cin, k, k), (cin * k * k) ** -0.5)
        if bias:
            self[f"{key}.bias"] = self._r((cout,), 0.1)

    def conv_t(self, key, c, k):
        self[f"{key}.weight"] = self._r((c, c, k, k), c ** -0.5)
        self[f"{key}.bias"] = self._r((c,), 0.1)

    def vit_layer(self, p, d, ff, names):
        ln1, q, k, v, o, ln2, fc1, fc2 = names
        self.ln(f"{p}.{ln1}", d)
        for n in (q, k, v, o):
            self.lin(f"{p}.{n}", d, d)
        self.ln(f"{p}.{ln2}", d)
        self.lin(f"{p}.{fc1}", d, ff)
        self.lin(f"{p}.{fc2}", ff, d)


def siglip_state(cfg, seed=0):
    s, d = _State(seed), cfg.hidden_size
    pre = "vision_model."
    s.conv(pre + "embeddings.patch_embedding", 3, d, cfg.patch_size)
    s[pre + "embeddings.position_embedding.weight"] = s._r(((cfg.image_size // cfg.patch_size) ** 2, d), 0.5)
    for i in range(cfg.num_layers):
        s.vit_layer(f"{pre}encoder.layers.{i}", d, cfg.intermediate_size,
                    ("layer_norm1", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj",
                     "layer_norm2", "mlp.fc1", "mlp.fc2"))
    s.ln(pre + "post_layernorm", d)
    return dict(s)


def depth_state(cfg, seed=0):
    s, d = _State(seed), cfg.hidden_size
    grid = cfg.image_size // cfg.patch_size
    s.conv("backbone.embeddings.patch_embeddings.projection", 3, d, cfg.patch_size)
    s["backbone.embeddings.cls_token"] = s._r((1, 1, d), 0.5)
    s["backbone.embeddings.position_embeddings"] = s._r((1, 1 + grid * grid, d), 0.5)
    for i in range(cfg.num_layers):
        p = f"backbone.encoder.layer.{i}"
        s.vit_layer(p, d, cfg.intermediate_size, ("norm1", "attention.attention.query", "attention.attention.key",
                                                  "attention.attention.value", "attention.output.dense", "norm2",
                                                  "mlp.fc1", "mlp.fc2"))
        s[f"{p}.layer_scale1.lambda1"] = 0.5 + s._r((d,), 0.1)
        s[f"{p}.layer_scale2.lambda1"] = 0.5 + s._r((d,), 0.1)
    s.ln("backbone.layernorm", d)
    fh = cfg.fusion_hidden_size
    for i, (c, f) in enumerate(zip(cfg.neck_hidden_sizes, cfg.reassemble_factors)):
        s.conv(f"neck.reassemble_stage.layers.{i}.projection", d, c, 1)
        if f > 1:
            s.conv_t(f"neck.reassemble_stage.layers.{i}.resize", c, int(f))
        elif f < 1:
            s.conv(f"neck.reassemble_stage.layers.{i}.resize", c, c, 3)
        s.conv(f"neck.convs.{i}", c, fh, 3, bias=False)
        p = f"neck.fusion_stage.layers.{i}"
        s.conv(f"{p}.projection", fh, fh, 1)
        for r in ("residual_layer1", "residual_layer2"):
            s.conv(f"{p}.{r}.convolution1", fh, fh, 3)
            s.conv(f"{p}.{r}.convolution2", fh, fh, 3)
    s.conv("head.conv1", fh, fh // 2, 3)
    s.conv("head.conv2", fh // 2, cfg.head_hidden_size, 3)
    s.conv("head.conv3", cfg.head_hidden_size, 1, 1)
    s["head.conv3.bias"] = np.full((1,), 0.5, np.float32)  # keep the final ReLU's output alive
    return dict(s)


def vit_state(cfg, seed=0):
    s, d = _State(seed), cfg.hidden_size
    grid = cfg.image_size // cfg.patch_size
    s.conv("vit.embeddings.patch_embeddings.projection", 3, d, cfg.patch_size)
    s["vit.embeddings.cls_token"] = s._r((1, 1, d), 0.5)
    s["vit.embeddings.position_embeddings"] = s._r((1, 1 + grid * grid, d), 0.5)
    for i in range(cfg.num_layers):
        s.vit_layer(f"vit.encoder.layer.{i}", d, cfg.intermediate_size,
                    ("layernorm_before", "attention.attention.query", "attention.attention.key",
                     "attention.attention.value", "attention.output.dense", "layernorm_after",
                     "intermediate.dense", "output.dense"))
    s.ln("vit.layernorm", d)
    s.lin("classifier", d, cfg.num_labels)
    return dict(s)


def _pixels(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _image(seed, w, h):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8))


def _photo(seed, w, h):
    """A smooth image (random 8 x 6 pixels upsampled): few of its blocks clip
    at 0 or 255 when marked, as in a photograph."""
    return _image(seed, 8, 6).resize((w, h), Image.BILINEAR)


# ----------------------------- towers -----------------------------


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(14, 10), (3, 7), (16, 16)])
def test_interpolate_bilinear_matches_jax(align_corners, size):
    x = _pixels(0, (2, 8, 6, 3))
    want = np.asarray(jvt.interpolate_bilinear(jnp.asarray(x), size, align_corners))
    got = tvt.interpolate_bilinear(torch.from_numpy(x), size, align_corners).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", [(6, 9), (3, 2), (5, 5)])
def test_resize_bicubic_matches_jax_image_resize(size):
    """Up, down (antialiased) and mixed, as the pos-embed grid and the depth map use it."""
    x = _pixels(1, (1, 5, 5, 4))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *size, 4), method="bicubic"))
    np.testing.assert_allclose(tvt.resize_bicubic(torch.from_numpy(x), size).numpy(), want, **TOL)


def test_siglip_matches_jax():
    cfg = jvt.SigLIPVisionConfig().tiny()
    state = siglip_state(cfg)
    x = _pixels(2, (2, cfg.image_size, cfg.image_size, 3))
    params = jvt.convert_siglip_vision(state, cfg)
    want = np.asarray(jvt.siglip_encode(cfg, params, jnp.asarray(x)))
    for model in (tvt.convert_siglip_vision(state, convert.config_from(cfg, tvt.SigLIPVisionConfig), "cpu"),
                  convert.siglip_from_jax(_np(params), cfg, "cpu")):
        np.testing.assert_allclose(tvt.siglip_encode(model, torch.from_numpy(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("hw", [(56, 56), (42, 70)])
def test_depth_anything_matches_jax(hw):
    """(42, 70): a 3x5 patch grid against the 4x4 position grid, so the
    pos-embed interpolation runs."""
    cfg = jvt.DepthAnythingTowerConfig().tiny()
    state = depth_state(cfg)
    x = _pixels(3, (1, *hw, 3))
    params = jvt.convert_depth_anything(state, cfg)
    want = np.asarray(jvt.depth_anything_apply(cfg, params, jnp.asarray(x)))
    assert want.shape == (1, *hw) and np.abs(want).max() > 0
    tcfg = convert.config_from(cfg, tvt.DepthAnythingTowerConfig)
    for model in (tvt.convert_depth_anything(state, tcfg, "cpu"),
                  convert.depth_anything_from_jax(_np(params), cfg, "cpu")):
        np.testing.assert_allclose(tvt.depth_anything_apply(model, torch.from_numpy(x)).numpy(), want, **TOL)


def test_vit_classifier_matches_jax():
    cfg = jvt.ViTClassifierConfig().tiny()
    state = vit_state(cfg)
    x = _pixels(4, (3, cfg.image_size, cfg.image_size, 3))
    params = jvt.convert_vit_classifier(state, cfg)
    want = np.asarray(jvt.vit_classify(cfg, params, jnp.asarray(x)))
    tcfg = convert.config_from(cfg, tvt.ViTClassifierConfig)
    for model in (tvt.convert_vit_classifier(state, tcfg, "cpu"),
                  convert.vit_classifier_from_jax(_np(params), cfg, "cpu")):
        np.testing.assert_allclose(tvt.vit_classify(model, torch.from_numpy(x)).numpy(), want, **TOL)


def test_preprocessors_match_jax():
    img = _image(5, 61, 43)
    for jfn, tfn, kw in ((jvt.siglip_preprocess, tvt.siglip_preprocess, {"image_size": 28}),
                         (jvt.vit_preprocess, tvt.vit_preprocess, {"image_size": 28}),
                         (jvt.depth_anything_preprocess, tvt.depth_anything_preprocess, {"target": 56})):
        np.testing.assert_array_equal(tfn(img, **kw).numpy(), np.asarray(jfn(img, **kw)))


# ----------------------------- encoders -----------------------------


def test_canny_encoder_matches_jax():
    img = _image(6, 40, 32)
    np.testing.assert_array_equal(tie.CannyImageEncoder()(img).numpy(), np.asarray(jie.CannyImageEncoder()(img)))


def test_depth_encoder_matches_jax():
    """The tower at 56 on a 40 x 30 image: the depth map resized back
    (bicubic, antialiased down one axis), clipped and normalized."""
    cfg = jvt.DepthAnythingTowerConfig().tiny()
    state = depth_state(cfg, seed=1)
    img = _image(7, 40, 30)
    want = np.asarray(jie.DepthImageEncoder(params=jvt.convert_depth_anything(state, cfg), cfg=cfg)(img))
    model = tvt.convert_depth_anything(state, convert.config_from(cfg, tvt.DepthAnythingTowerConfig), "cpu")
    got = tie.DepthImageEncoder(model=model)(img).numpy()
    assert got.shape == (1, 30, 40, 3)
    np.testing.assert_allclose(got, want, **TOL)
    depth = np.linspace(0, 2, 30 * 40, dtype=np.float32).reshape(30, 40)  # the callable route
    np.testing.assert_allclose(tie.DepthImageEncoder(depth_fn=lambda _: depth)(img).numpy(),
                               np.asarray(jie.DepthImageEncoder(depth_fn=lambda _: depth)(img)), **TOL)


def test_redux_projector_and_encoder_match_jax():
    params = jie.init_redux_projector(jax.random.PRNGKey(0), redux_dim=32, txt_dim=16)
    feats = _pixels(8, (1, 5, 32))
    want = np.asarray(jie.redux_project(params, jnp.asarray(feats)))
    proj = convert.redux_from_jax(_np(params), "cpu")
    np.testing.assert_allclose(tie.redux_project(proj, torch.from_numpy(feats)).numpy(), want, **TOL)
    state = {f"{k}.{leaf}": np.asarray(params[k][j]).T if j == "w" else np.asarray(params[k][j])
             for k in ("redux_up", "redux_down") for leaf, j in (("weight", "w"), ("bias", "b"))}
    conv = tie.convert_redux(state, "cpu")
    np.testing.assert_allclose(tie.redux_project(conv, torch.from_numpy(feats)).numpy(),
                               np.asarray(jie.redux_project(jie.convert_redux(state), jnp.asarray(feats))), **TOL)
    # the encoder: a tiny SigLIP tower (redux_dim = its width) on a PIL image, and on features
    cfg = jvt.SigLIPVisionConfig().tiny()
    sstate = siglip_state(cfg, seed=2)
    img = _image(9, 33, 30)
    want = np.asarray(jie.ReduxImageEncoder(params, siglip_params=jvt.convert_siglip_vision(sstate, cfg),
                                            siglip_cfg=cfg)(img))
    siglip = tvt.convert_siglip_vision(sstate, convert.config_from(cfg, tvt.SigLIPVisionConfig), "cpu")
    enc = tie.ReduxImageEncoder(proj, siglip_model=siglip)
    np.testing.assert_allclose(enc(img).numpy(), want, **TOL)
    want = np.asarray(jie.ReduxImageEncoder(params, siglip_fn=lambda _: 0)(feats))
    np.testing.assert_allclose(enc(feats).numpy(), want, **TOL)


def test_encoders_load_local_checkpoints(tmp_path, monkeypatch):
    """DEPTH_ANYTHING_PATH, SIGLIP_PATH and FLUX_REDUX through the port's own
    safetensors reader (a directory of shards, a single file)."""
    from visualcloze_tpu_torch.models.weights import save_safetensors

    dcfg = tvt.DepthAnythingTowerConfig().tiny()
    scfg = tvt.SigLIPVisionConfig().tiny()
    (tmp_path / "depth").mkdir()
    (tmp_path / "siglip").mkdir()
    save_safetensors({k: torch.from_numpy(v) for k, v in depth_state(dcfg).items()},
                     str(tmp_path / "depth" / "model.safetensors"))
    save_safetensors({k: torch.from_numpy(v) for k, v in siglip_state(scfg).items()},
                     str(tmp_path / "siglip" / "model.safetensors"))
    proj = tie.init_redux_projector(torch.Generator().manual_seed(0), redux_dim=32, txt_dim=16, device="cpu")
    save_safetensors({k: v.contiguous() for k, v in proj.state_dict().items()}, str(tmp_path / "redux.safetensors"))
    monkeypatch.setenv("DEPTH_ANYTHING_PATH", str(tmp_path / "depth"))
    monkeypatch.setenv("SIGLIP_PATH", str(tmp_path / "siglip"))
    monkeypatch.setenv("FLUX_REDUX", str(tmp_path / "redux.safetensors"))
    img = _image(10, 28, 28)
    depth = tie.DepthImageEncoder(cfg=dcfg, device="cpu")
    assert depth(img).shape == (1, 28, 28, 3)
    redux = tie.ReduxImageEncoder(siglip_cfg=scfg, device="cpu")
    for a, b in zip(redux.projector.state_dict().values(), proj.state_dict().values()):
        assert torch.equal(a, b)
    assert redux(img).shape == (1, (28 // 14) ** 2, 16)


# ----------------------------- the packers -----------------------------

AE_CFG = AutoEncoderConfig().tiny()


class _Text:
    """Stub encoders, the same numbers in both packages: T5 (B, 8, 16) and
    CLIP (B, 12) features from the prompts' lengths."""

    def __init__(self, to):
        self.to = to

    def t5(self, prompts):
        return self.to(np.stack([np.full((8, 16), len(p), np.float32) + np.arange(16, dtype=np.float32)
                                 for p in prompts]))

    def clip(self, prompts):
        return self.to(np.stack([np.full((12,), 0.5 * len(p), np.float32) for p in prompts]))


JT, TT = _Text(jnp.asarray), _Text(torch.from_numpy)


def _vae():
    params = init_autoencoder(jax.random.PRNGKey(3), AE_CFG)
    return JaxAutoEncoder(AE_CFG, params), convert.vae_from_jax(_np(params), AE_CFG, device="cpu")


def _eps(key, hw):
    """JAX's posterior noise for ae.encode(key=...) at (H, W) pixels."""
    return torch.from_numpy(np.asarray(jax.random.normal(key, (1, hw[0] // 8, hw[1] // 8, AE_CFG.z_channels))))


def _close(got: dict, want: dict, exact=("img", "img_ids", "txt", "txt_ids", "vec")):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, k
        if k in exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), k


@pytest.mark.parametrize("prompt", ["a cat", ["a cat", "two dogs"]])
def test_prepare_and_unpack_match_jax(prompt):
    noise = np.asarray(jsam.get_noise(jax.random.PRNGKey(0), 1, 4, 6, jnp.float32))
    assert tsam.get_noise(1, 4, 6, torch.float32, torch.Generator().manual_seed(0)).shape == noise.shape
    want = jsam.prepare(JT.t5, JT.clip, jnp.asarray(noise), prompt)
    got = tsam.prepare(TT.t5, TT.clip, torch.from_numpy(noise), prompt)
    _close(got, want)
    np.testing.assert_array_equal(tsam.unpack(got["img"], 32, 48).numpy(), np.asarray(jsam.unpack(want["img"], 32, 48)))


def test_prepare_fill_matches_jax():
    jae, tae = _vae()
    rng = np.random.default_rng(11)
    img_cond = rng.uniform(-1, 1, (32, 48, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (32, 48)) > 0.5).astype(np.float32)
    noise = np.asarray(jsam.get_noise(jax.random.PRNGKey(1), 2, 4, 6, jnp.float32))
    key = jax.random.PRNGKey(2)
    want = jsam.prepare_fill(JT.t5, JT.clip, jnp.asarray(noise), ["a", "bb"], jae, img_cond, mask, key)
    got = tsam.prepare_fill(TT.t5, TT.clip, torch.from_numpy(noise), ["a", "bb"], tae, img_cond, mask,
                            eps=_eps(key, (32, 48)))
    assert got["img_cond"].shape[-1] == 4 * AE_CFG.z_channels + 256
    _close(got, want)


def test_prepare_control_matches_jax():
    jae, tae = _vae()
    img = _image(12, 48, 32)
    noise = np.asarray(jsam.get_noise(jax.random.PRNGKey(4), 1, 4, 6, jnp.float32))
    key = jax.random.PRNGKey(5)
    want = jsam.prepare_control(JT.t5, JT.clip, jnp.asarray(noise), "edges", jae, jie.CannyImageEncoder(), img, key)
    got = tsam.prepare_control(TT.t5, TT.clip, torch.from_numpy(noise), "edges", tae, tie.CannyImageEncoder(), img,
                               eps=_eps(key, (32, 48)))
    _close(got, want)


def test_prepare_redux_matches_jax():
    params = jie.init_redux_projector(jax.random.PRNGKey(6), redux_dim=32, txt_dim=16)
    feats = _pixels(13, (1, 5, 32))
    noise = np.asarray(jsam.get_noise(jax.random.PRNGKey(7), 1, 4, 6, jnp.float32))
    want = jsam.prepare_redux(JT.t5, JT.clip, jnp.asarray(noise), "style", jie.ReduxImageEncoder(params, siglip_fn=0),
                              feats)
    enc = tie.ReduxImageEncoder(convert.redux_from_jax(_np(params), "cpu"), siglip_fn=0)
    got = tsam.prepare_redux(TT.t5, TT.clip, torch.from_numpy(noise), "style", enc, feats)
    assert got["txt"].shape[1] == 8 + 5
    _close(got, want, exact=("img", "img_ids", "txt_ids", "vec"))


# ----------------------------- postprocess and the API client -----------------------------


def test_watermark_round_trip_and_payload_match_jax():
    assert tpost.WATERMARK_BITS == jpost.WATERMARK_BITS and tpost.WATERMARK_MESSAGE == jpost.WATERMARK_MESSAGE
    img = np.asarray(_photo(14, 64, 48))
    marked = tpost.embed_watermark(img)
    np.testing.assert_array_equal(marked, jpost.embed_watermark(img))
    assert tpost.extract_watermark_score(marked) > 0.95
    assert tpost.extract_watermark_score(marked) == jpost.extract_watermark_score(marked)
    assert tpost.extract_watermark_score(img) < 0.8


def test_save_image_gate_and_watermark(tmp_path):
    img = _photo(15, 64, 48)
    assert tpost.save_image(img, str(tmp_path / "no.png"), nsfw_classifier=lambda _: 0.9) is None
    assert not (tmp_path / "no.png").exists()
    path = tpost.save_image(img, str(tmp_path / "yes.png"), nsfw_classifier=lambda _: 0.1, metadata={"seed": 1})
    saved = Image.open(path)
    assert saved.getexif()[0x0131] == "visualcloze-tpu" and "seed" in saved.getexif()[0x010E]
    assert tpost.extract_watermark_score(np.asarray(saved.convert("RGB"))) > 0.95


def test_nsfw_classifier_matches_jax(monkeypatch):
    cfg = jvt.ViTClassifierConfig().tiny()
    state = vit_state(cfg, seed=3)
    img = _image(16, 30, 30)
    want = jpost.build_nsfw_classifier(params=jvt.convert_vit_classifier(state, cfg), cfg=cfg)(img)
    model = tvt.convert_vit_classifier(state, convert.config_from(cfg, tvt.ViTClassifierConfig), "cpu")
    assert tpost.build_nsfw_classifier(model=model)(img) == pytest.approx(want, rel=1e-4, abs=1e-6)
    monkeypatch.delenv("NSFW_MODEL_PATH", raising=False)
    assert tpost.build_nsfw_classifier() is None


@pytest.mark.parametrize("payload,model", [
    ({"width": 512, "height": 512, "steps": 30, "guidance": 3.0}, "flux.1-pro"),
    ({"width": 500}, "flux.1-dev"),
    ({"height": 2048}, "flux.1-dev"),
    ({"steps": 0}, "flux.1.1-pro"),
    ({"interval": 2.0}, "flux.1-dev"),
    ({"interval": 2.0}, "flux.1-pro"),
    ({"safety_tolerance": 7}, "flux.1-pro"),
    ({}, "flux.2"),
])
def test_validate_request_matches_jax(payload, model):
    def outcome(mod):
        try:
            mod.validate_request(payload, model)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(tapi) == outcome(japi)


def test_api_client_with_stubbed_http(monkeypatch):
    calls = []

    def fake_http(method, url, api_key, **kw):
        calls.append((method, url))
        if method == "post":
            return {"id": "r1"}
        return {"status": "Ready", "result": {"sample": "https://example.invalid/img.png"}}

    monkeypatch.setattr(tapi, "_http", fake_http)
    monkeypatch.setattr(tapi, "fetch_bytes", lambda url: b"png")
    req = tapi.ImageRequest("a cat", name="flux.1-dev", width=512, height=512, api_key="k")
    assert req.request_id == "r1" and req.url.endswith("img.png") and req.bytes == b"png"
    assert [m for m, _ in calls] == ["post", "get"]
    with pytest.raises(ValueError):
        tapi.ImageRequest("a cat", name="flux.1-dev", width=100, launch=False)
    for detail in ("bad key", [{"msg": "too long"}, {"msg": "no"}], None):
        assert str(tapi.ApiException(422, detail)) == str(japi.ApiException(422, detail))
