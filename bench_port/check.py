"""Whether what the timed path produced is correct: the sampled queries'
captured calls, each held against the plain reference (bench_port/reference)
computed again from the same inputs, in float32 with TF32 off.

The reference follows the program step by step: each DiT evaluation, VAE
call and text-encoder call is recomputed from the inputs the program gave
it (the denoise state is the program's own), and the start of the chain is
checked apart: the grid rows the preprocessing made against the reference's
own resize of the benchmark's photos, and the T5 and CLIP token ids against
the reference's own tokenization of the prompt. What one stage hands the
next is rebuilt from the stage before it (reference/pipeline.py), so the
code between the checked calls is checked too. Numbers (each a relative
L2 error unless said otherwise):
  preprocess_max_abs  largest |row pixel - reference pixel| of the first stage's VAE inputs
  token_mismatches    token ids of the first stage's prompt that differ from the reference's
  handoff_max_abs     largest |program - reference| over the hand-offs between stages: each
                      loop's time grid (the shift, SDEdit's strength), the DiT's timesteps and
                      guidance, the packed condition (latents and mask), the start state (the
                      packed latent noise; SDEdit's noise mix), the decoder's latents from the
                      loop's result, SDEdit's input pixels (the crop and resize of the first
                      stage's picture), its blank input, and the answer's pixels
  t5_rel_err          T5 last hidden state
  clip_rel_err        CLIP pooled output
  vae_encode_rel_err  the scaled latent of each encode (the program's posterior noise)
  vae_decode_rel_err  the pixels of each decode
  dit_rel_err         the velocity of each captured evaluation, over its real image tokens
  euler_rel_err       x_(k+m) - (x_k + sum dt_j v_j) over |sum dt_j v_j|, m = EULER_SPAN
                      Euler steps from a captured evaluation, the program's own velocities,
                      the reference's time grid
Each is the worst over the sample; the limits are limits/<config>.json's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .reference import flux as ref_flux
from .reference import grid_rows
from .reference import pipeline as ref_pipe
from .reference import text as ref_text
from .reference import vae as ref_vae
from .reference import weights as W
from .system import DTYPES, EULER_SPAN, to_device

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
# the control of each configuration's DiT arithmetic: the next precision below it (the text
# encoders and the VAE, bf16 in every configuration, take float8)
CONTROL = {"fp32": "fp8", "w8a8": "w4a8"}
NUMBERS = ("preprocess_max_abs", "token_mismatches", "handoff_max_abs", "t5_rel_err", "clip_rel_err", "vae_encode_rel_err",
           "vae_decode_rel_err", "dit_rel_err", "euler_rel_err")


def load_limits(config_name: str) -> dict[str, float]:
    with open(LIMITS_DIR / f"{config_name}.json") as f:
        return json.load(f)["limits"]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().reshape(-1), want.float().reshape(-1).to(got.device)
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


class Weights:
    """reference/weights' groups of one seed, drawn again on `device` in
    float32 (from the served dtype's bits); the VAE's two groups are kept."""

    def __init__(self, config: dict, seed: int, device):
        self.seed, self.device = seed, device
        self.dtype = DTYPES[config["dtype"]]
        self.entries = {}
        for kind, cfg in (("flux", config["flux"]), ("t5", config["t5"]), ("clip", config["clip"]),
                          ("ae", config["vae"])):
            self.entries.update(dict(W.GROUPS[kind](cfg)))
        self._kept: dict = {}

    def __call__(self, group: str) -> dict[str, torch.Tensor]:
        if group in self._kept:
            return self._kept[group]
        out = {n: t.float() for n, t in W.draw_group(self.seed, group, self.entries[group], self.device,
                                                      self.dtype).items()}
        if group.startswith("ae."):
            self._kept[group] = out
        return out

    def vae(self) -> dict[str, torch.Tensor]:
        return {**self("ae.encoder"), **self("ae.decoder")}


@torch.no_grad()
def handoffs(q: dict, caps: dict, answer, resolution: int) -> float:
    """handoff_max_abs of one query (its traffic entry, its captures and the
    answer's pixels), each hand-off rebuilt from the captured output of the
    stage before it. Sets each captured evaluation's "ts" to the reference's
    time grid from its step on, which the Euler check then uses."""
    bf16 = torch.bfloat16
    worst = [0.0]

    def same(got, want) -> None:
        if got is None:
            worst[0] = float("inf")
            return
        got, want = (x.cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x)) for x in (got, want))
        if tuple(got.shape) != tuple(want.shape):
            worst[0] = float("inf")
        elif got.numel():
            worst[0] = max(worst[0], float((got.double() - want.double()).abs().max()))

    rows = grid_rows(q["grid"], resolution)
    rows_n, cols = q["shape"]
    side = resolution // 16 * 16
    encodes = [c for c in caps["vae"] if c["part"] == "encode"]
    decodes = [c for c in caps["vae"] if c["part"] == "decode"]
    loops = {c["stage"]: c for c in caps["loops"]}
    up = bool(q["upsampling"])
    if (len(rows) != rows_n or len(encodes) != rows_n + 2 * up or len(decodes) != rows_n + up
            or len(caps["noise"]) != rows_n + up or set(loops) != {"denoise"} | ({"sdedit_denoise"} if up else set())
            or answer is None):
        return float("inf")
    guidance = torch.full((1,), q["cfg"], dtype=bf16)

    def loop(stage: str, x0, cond, grid: np.ndarray, latents: list[tuple[int, int]]) -> None:
        lp = loops[stage]
        length = lp["x0"].shape[1]
        same(lp["ts"], grid)
        same(lp["x0"][0], ref_pipe.pad_tokens(x0, length))
        same(lp["cond"][0], ref_pipe.pad_tokens(cond, length))
        same(lp["guidance"], guidance)
        for c in caps["dit"]:
            if c["stage"] == stage:
                same(c["timesteps"], torch.full(c["timesteps"].shape, float(grid[c["step"]]), dtype=bf16))
                same(c["guidance"], guidance)
                same(c["img"][0][:, lp["x0"].shape[-1]:], ref_pipe.pad_tokens(cond, length))
                c["ts"] = [float(t) for t in grid[c["step"]:c["step"] + EULER_SPAN + 1]]
        start = 0
        for (h, w), dec in latents:
            end = start + h * w // 4
            same(dec["z"][0], ref_pipe.unpatchify(lp["out"][0][start:end], h, w))
            start = end

    # the first stage: rows of latents and masks, its latent noise, the shifted grid
    masks = []
    for r in range(rows_n):
        m = torch.zeros((side, side * cols), dtype=bf16)
        for j in range(cols):
            if r == rows_n - 1 and q["grid"][r][j] is None:
                m[:, j * side:(j + 1) * side] = 1
        masks.append(ref_pipe.pack_mask(m))
    latent_tokens = torch.cat([ref_pipe.patchify(e["out"][0].to(bf16)) for e in encodes[:rows_n]])
    noise_tokens = torch.cat([ref_pipe.patchify(n["x"][0].to(bf16)) for n in caps["noise"][:rows_n]])
    true_len = latent_tokens.shape[0]
    loop("denoise", noise_tokens, torch.cat([latent_tokens, torch.cat(masks)], dim=-1),
         ref_pipe.time_grid(q["steps"], true_len, shift=True),
         [((side // 8, side * cols // 8), d) for d in decodes[:rows_n]])
    col = next(j for j in range(cols) if q["grid"][-1][j] is None)
    cell = ref_pipe.crop_cell(ref_pipe.to_picture(decodes[rows_n - 1]["out"][0]), col, cols)
    if not up:
        same(answer, np.asarray(cell))
        return worst[0]
    # SDEdit: the cell cropped and resized, encoded with a blank beside it, its noise mix, the unshifted grid
    size = ref_pipe.sdedit_size(next(img for img in q["grid"][-1] if img is not None).size)
    same(encodes[rows_n]["x"][0], ref_pipe.to_pixels(cell.resize(size)))
    same(encodes[rows_n + 1]["x"][0], torch.zeros_like(encodes[rows_n + 1]["x"][0]))
    h, w = size[1] // 8, size[0] // 8
    lat = ref_pipe.patchify(encodes[rows_n]["out"][0].to(bf16))
    blank = ref_pipe.patchify(encodes[rows_n + 1]["out"][0].to(bf16))
    mask = ref_pipe.pack_mask(torch.ones((size[1], size[0]), dtype=bf16))
    length = loops["sdedit_denoise"]["x0"].shape[1]
    noise = ref_pipe.patchify(caps["noise"][rows_n]["x"][0].to(bf16))
    x0 = ref_pipe.sdedit_start(ref_pipe.pad_tokens(noise, length), ref_pipe.pad_tokens(lat, length),
                               q["upsampling_noise"])
    loop("sdedit_denoise", x0, torch.cat([blank, mask], dim=-1),
         ref_pipe.time_grid(q["upsampling_steps"], length, shift=False, strength=q["upsampling_noise"]),
         [((h, w), decodes[rows_n])])
    same(answer, ref_pipe.to_picture(decodes[rows_n]["out"][0]))
    return worst[0]


@torch.no_grad()
def compare(config: dict, seed: int, queries: list[dict], device, control: bool = False,
            readings: dict | None = None) -> dict[str, float]:
    """The numbers of NUMBERS over `queries` (each {"query": the traffic's
    query, "captures": Recorder.take's}). control: the reference in the next
    precision below the configuration's stands in the program's place (the
    DiT in CONTROL's, the bf16 text encoders and VAE in float8). readings:
    a dict that receives every reading of each number, in the sample's order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = "w8a8" if config.get("dit_quant") == "w8a8" else "fp32"
    weights = Weights(config, seed, device)
    out = {n: 0.0 for n in NUMBERS}
    readings = {} if readings is None else readings

    def note(name: str, value: float) -> None:
        readings.setdefault(name, []).append(value)
        out[name] = max(out[name], value)

    tok = config["tokenizers"]
    vae_w = weights.vae()
    for item in queries:
        q, caps = item["query"], item["captures"]
        rows = grid_rows(q["grid"], config["assumed"]["resolution"])
        encodes = [c for c in caps["vae"] if c["part"] == "encode"]
        # a call the query owes and did not make reads as infinitely wrong
        up = int(q["upsampling"])
        owed = {"vae_encode_rel_err": (len(encodes), len(rows) + 2 * up),
                "vae_decode_rel_err": (len(caps["vae"]) - len(encodes), len(rows) + up),
                "t5_rel_err": (len(caps["text"]), 2 + 2 * up), "dit_rel_err": (len(caps["dit"]), 1 + up)}
        for name, (made, due) in owed.items():
            if made != due:
                note(name, float("inf"))
        note("handoff_max_abs", handoffs(q, caps, item.get("answer"), config["assumed"]["resolution"]))
        for row, c in zip(rows, encodes):
            got = c["x"][0].float().cpu().numpy()
            diff = float(np.abs(got - row).max()) if got.shape == row.shape else float("inf")
            note("preprocess_max_abs", diff)
        text = " ".join(q["prompts"])
        for c in caps["text"]:
            if c is caps["text"][0] or c is caps["text"][1]:  # the first stage's T5 and CLIP calls
                want = ref_text.hash_ids(text, c["ids"].shape[1], **tok[c["kind"]])
                readings.setdefault("token_mismatches", []).append(float((c["ids"][0].cpu().numpy() != want).sum()))
                out["token_mismatches"] += readings["token_mismatches"][-1]
        for kind, enc, cfg in (("t5", ref_text.t5_encode, config["t5"]), ("clip", ref_text.clip_pooled,
                                                                            config["clip"])):
            calls = [c for c in caps["text"] if c["kind"] == kind]
            ids = [c["ids"][0].to(device) for c in calls]
            refs = enc(weights, cfg, ids)
            got = enc(weights, cfg, ids, "fp8") if control else [c["out"][0] for c in calls]
            for g, r in zip(got, refs):
                note(f"{kind}_rel_err", rel_err(g.to(device), r))
        for c in caps["vae"]:
            if c["part"] == "encode":
                args = (vae_w, config["vae"], c["x"].to(device), c["eps"].to(device))
                r, key = ref_vae.encode(*args), "vae_encode_rel_err"
                g = ref_vae.encode(*args, mode="fp8") if control else c["out"]
            else:
                args = (vae_w, config["vae"], c["z"].to(device))
                r, key = ref_vae.decode(*args), "vae_decode_rel_err"
                g = ref_vae.decode(*args, mode="fp8") if control else c["out"]
            note(key, rel_err(g.to(device), r))
    evals = [{k: to_device(v, device) for k, v in c.items()} for item in queries for c in item["captures"]["dit"]]
    for e in evals:
        for k in ("img", "img_ids", "txt", "txt_ids"):
            e[k] = e[k][0]
    refs = ref_flux.evaluate(evals, config["flux"], weights, mode)
    if control:
        got = ref_flux.evaluate(evals, config["flux"], weights, CONTROL[mode])
    else:
        got = [e["out"][0, : e["n_img"]].float() for e in evals]
    for e, r, g in zip(evals, refs, got):
        note("dit_rel_err", rel_err(g, r))
        n = e["n_img"]
        if len(e["xs"]) != EULER_SPAN + 1 or len(e["vs"]) != EULER_SPAN:
            note("euler_rel_err", float("inf"))
            continue
        step = sum((t1 - t0) * v[:n].float() for t0, t1, v in zip(e["ts"], e["ts"][1:], e["vs"]))
        x0, x1 = e["xs"][0][:n].float(), e["xs"][-1][:n].float()
        note("euler_rel_err", float((x1 - (x0 + step)).norm() / step.norm()))
    return out
