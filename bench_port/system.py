"""The system under test: the measured package's serving pipeline
(visualcloze_tpu_torch.pipeline.VisualClozeModel), built from a configuration
file with the benchmark's weights, and what the benchmark records around it
from outside: the work each query does (for the operation counts), the
inputs and outputs of a few calls per query (for the reference), and, in a
traced run, profiler ranges around the stages, the DiT's linears and its
attention. Nothing here changes what the program computes.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .reference import weights as W

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SPAN = "bench::"  # the prefix of every profiler range the benchmark opens
EULER_SPAN = 8  # Euler steps checked together: the update grows with them faster than the bf16 state's rounding


def _flux_config(c: dict):
    from visualcloze_tpu_torch.config import FluxConfig

    return FluxConfig(**dict(c, axes_dim=tuple(c["axes_dim"])))


@torch.no_grad()
def fill(module: torch.nn.Module, kind: str, cfg: dict, seed: int) -> None:
    """Every parameter of `module` from reference/weights' groups of `kind`;
    raises unless the names and shapes are exactly the groups'."""
    params = dict(module.named_parameters())
    seen = set()
    device, dtype = next(iter(params.values())).device, next(iter(params.values())).dtype
    for group, entries in W.GROUPS[kind](cfg):
        for name, t in W.draw_group(seed, group, entries, device, dtype).items():
            if name not in params or tuple(params[name].shape) != tuple(t.shape):
                raise ValueError(f"{kind}: the benchmark's tensor {name} {tuple(t.shape)} is not in the module")
            params[name].copy_(t)
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise ValueError(f"{kind}: the benchmark draws no values for {missing[:5]}")


def build(config: dict, seed: int, device: torch.device):
    """The served pipeline of `config` on `device`, its weights from `seed`."""
    from visualcloze_tpu_torch.config import AutoEncoderConfig, CLIPTextConfig, T5Config
    from visualcloze_tpu_torch.models.autoencoder import build_autoencoder
    from visualcloze_tpu_torch.models.clip import build_clip
    from visualcloze_tpu_torch.models.conditioner import FallbackTokenizer, TextEncoder
    from visualcloze_tpu_torch.models.flux import build_flux
    from visualcloze_tpu_torch.models.quant import quantize_flux_w8a8
    from visualcloze_tpu_torch.models.t5 import build_t5
    from visualcloze_tpu_torch.pipeline.visualcloze import VisualClozeModel

    dtype = DTYPES[config["dtype"]]
    flux_cfg = _flux_config(config["flux"])
    flux = build_flux(flux_cfg, device, dtype)
    fill(flux, "flux", config["flux"], seed)
    if config.get("dit_quant") == "w8a8":
        flux = quantize_flux_w8a8(flux)  # the dense DiT is freed as this returns
    elif config.get("dit_quant") is not None:
        raise ValueError(f"unknown dit_quant {config['dit_quant']!r}")
    ae = build_autoencoder(AutoEncoderConfig(**dict(config["vae"], ch_mult=tuple(config["vae"]["ch_mult"]))),
                           device, dtype)
    fill(ae, "ae", config["vae"], seed)
    t5_cfg, clip_cfg = T5Config(**config["t5"]), CLIPTextConfig(**config["clip"])
    t5 = build_t5(t5_cfg, device, dtype)
    fill(t5, "t5", config["t5"], seed)
    clip = build_clip(clip_cfg, device, dtype)
    fill(clip, "clip", config["clip"], seed)
    tok = config["tokenizers"]
    return VisualClozeModel(
        flux_cfg, flux, ae,
        TextEncoder("t5", t5, FallbackTokenizer(**tok["t5"]), t5_cfg.max_length),
        TextEncoder("clip", clip, FallbackTokenizer(**tok["clip"]), clip_cfg.max_length),
        resolution=config["assumed"]["resolution"], device=device, rope_layout="half", permute_params=False)


def to_device(v, device):
    """A captured value (a tensor, a list of them, or anything else) on `device`."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return [to_device(t, device) for t in v] if isinstance(v, list) else v


def _clone(t):
    return t.detach().clone() if isinstance(t, torch.Tensor) else t


_ACTIVE: list = [None]  # the Recorder the latent-noise draws are logged to


def _log_latent_noise() -> None:
    """Wraps NoiseSource.normal (once per process) to copy each "latent"
    draw, the noise a denoise loop starts from, into the active Recorder's
    captures; what is drawn is unchanged."""
    from visualcloze_tpu_torch.pipeline.visualcloze import NoiseSource

    normal = NoiseSource.normal
    if getattr(normal, "_bench_port", False):
        return

    def drawing(src, kind, shape):
        out = normal(src, kind, shape)
        rec = _ACTIVE[0]
        if kind == "latent" and rec is not None and "noise" in rec.captures:
            rec.captures["noise"].append(dict(x=_clone(out)))
        return out

    drawing._bench_port = True
    NoiseSource.normal = drawing


class Recorder:
    """Wraps the model's stage clock, denoise loop, DiT, VAE and text
    encoders (instance attributes, the classes untouched, but for the
    latent-noise log of _log_latent_noise) to log each query's work units
    and to copy the inputs and outputs of the calls the query's plan names:
    plan {"denoise": k, "sdedit_denoise": k} captures evaluation k of that
    loop whole, and the state x of evaluations k to k + EULER_SPAN with the
    velocities of k to k + EULER_SPAN - 1 (the Euler steps between them).
    Every VAE and text-encoder call is captured, every latent-noise draw,
    and each denoise loop's hand-offs: its time grid, start state, packed
    condition, guidance and result. Captures stay on the device until
    `take` moves them."""

    def __init__(self, model):
        self.model = model
        self.work: list[tuple] = []
        self.captures: dict = {}
        self.plan: dict | None = None
        self.loop: dict | None = None
        self.trace = False
        self._wrap()
        _ACTIVE[0] = self
        _log_latent_noise()

    def begin(self, plan: dict | None, trace: bool = False) -> None:
        self.work, self.plan, self.trace = [], plan, trace
        self.captures = {"dit": [], "vae": [], "text": [], "loops": [], "noise": []}

    def take(self, to_host: bool) -> dict:
        out = self.captures
        if to_host:
            out = {k: [{n: to_device(v, "cpu") for n, v in c.items()} for c in vals] for k, vals in out.items()}
        self.captures = {}
        return out

    def _wrap(self) -> None:
        m = self.model
        stage, denoise = m._stage, m.denoise_query
        flux_fwd, enc, dec = m.flux.forward, m.ae.encode, m.ae.decode
        rec = self

        @contextlib.contextmanager
        def staged(name, seconds):
            span = torch.profiler.record_function(SPAN + "stage::" + name) if rec.trace else contextlib.nullcontext()
            with span, stage(name, seconds):
                yield

        def denoising(q, stage="denoise"):
            n_img = q.get("true_len") or sum(h * w // 256 for h, w in q["sizes"])
            rec.loop = dict(stage=stage, n_img=int(n_img), n_txt=int(q["txt"].shape[1]), i=0, ts=q["ts"])
            try:
                out = denoise(q, stage)
            finally:
                rec.loop = None
            rec.captures["loops"].append(dict(stage=stage, n_img=int(n_img), ts=[float(t) for t in q["ts"]],
                                              x0=_clone(q["x"]), cond=_clone(q["img_cond"]),
                                              guidance=_clone(q["guidance"]), out=_clone(out)))
            return out

        def dit(**kw):
            out = flux_fwd(**kw)
            lp = rec.loop
            if lp is None:  # a call outside the denoise loops (none in process_images)
                return out
            rec.work.append(("dit", lp["n_img"], lp["n_txt"]))
            i, k = lp["i"], (rec.plan or {}).get(lp["stage"])
            lp["i"] += 1
            if k is None or not k <= i <= k + EULER_SPAN:
                return out
            if i == k:
                keys = ("img", "img_ids", "txt", "txt_ids", "timesteps", "y", "guidance")
                rec.captures["dit"].append(dict({n: _clone(kw.get(n)) for n in keys}, out=_clone(out),
                                                stage=lp["stage"], step=k, n_img=lp["n_img"], n_txt=lp["n_txt"],
                                                xs=[], vs=[], ts=[float(t) for t in lp["ts"][k:k + EULER_SPAN + 1]]))
            c = rec.captures["dit"][-1]
            c["xs"].append(_clone(kw["img"][0, :, : out.shape[-1]]))
            if i < k + EULER_SPAN:
                c["vs"].append(_clone(out[0]))
            return out

        def encode(x, eps):
            out = enc(x, eps)
            rec.work.append(("vae_encode", int(x.shape[1]), int(x.shape[2])))
            rec.captures["vae"].append(dict(part="encode", x=_clone(x), eps=_clone(eps), out=_clone(out)))
            return out

        def decode(z):
            out = dec(z)
            rec.work.append(("vae_decode", int(out.shape[1]), int(out.shape[2])))
            rec.captures["vae"].append(dict(part="decode", z=_clone(z), out=_clone(out)))
            return out

        def text(kind, fwd):
            def call(ids):
                out = fwd(ids)
                rec.work.append((kind, int(ids.shape[1])))
                rec.captures["text"].append(dict(kind=kind, ids=_clone(ids),
                                                 out=_clone(out if kind == "t5" else out[1])))
                return out
            return call

        m._stage, m.denoise_query, m.flux.forward = staged, denoising, dit
        m.ae.encode, m.ae.decode = encode, decode
        m.t5.model.forward = text("t5", m.t5.model.forward)
        m.clip.model.forward = text("clip", m.clip.model.forward)


@contextlib.contextmanager
def layer_spans():
    """Profiler ranges around every call of the DiT's linears (bench::linear:
    the dense, int8 and w8a8 linears' forward and the w8a8 linear's
    forward_codes) and of its attention (bench::attention: ops.attention.mha,
    the attention proper, without the head merge), while the block runs."""
    from visualcloze_tpu_torch.models import layers
    from visualcloze_tpu_torch.ops import attention as att

    targets = [(layers.Linear, "forward", "linear"), (layers.Int8Linear, "forward", "linear"),
               (layers.W8A8Linear, "forward", "linear"), (layers.W8A8Linear, "forward_codes", "linear"),
               (att, "mha", "attention")]
    saved = []
    for owner, attr, span in targets:
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def spanned(*args, _fn=fn, _span=SPAN + span, **kwargs):
            with torch.profiler.record_function(_span):
                return _fn(*args, **kwargs)

        saved.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, spanned)
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
