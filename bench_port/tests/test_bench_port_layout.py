"""BENCHMARK.json resolves, by name, to the files of each cell, and the
benchmark's weights name every parameter of the measured modules."""

from __future__ import annotations

import json
import re

import pytest
import torch

from bench_port import run
from bench_port.reference import weights as W
from bench_port.tests.tiny import tiny_config

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench() -> dict:
    with open(run.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    b = bench()
    spec = run.resolve(b, cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert set(spec["limits"]) >= {"dit_rel_err", "euler_rel_err"}
    assert spec["mix"]["cycle"]
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(run.reader(m["name"]))
    for entry in b["configs"]:
        assert entry["file"].startswith(b["paths"][0] + "/")


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]] + [w["traffic"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for group in (b["workloads"], b["configs"], b["end_to_end"] + b["per_layer"]):
        assert len({e["name"] for e in group}) == len(group)
    units = [m["unit"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", u) for u in units)
    cells = {w["name"] for w in b["workloads"]}
    e2e = {e["name"]: set(e.get("workloads", cells)) for e in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= e2e[m["moves"]]  # each of its cells reports the metric it moves
    layers = {}
    for m in b["per_layer"]:
        assert layers.setdefault(m["name"].split(".")[0], m["layer"]) == m["layer"]


def _port_modules(config: dict, device):
    from visualcloze_tpu_torch.config import AutoEncoderConfig, CLIPTextConfig, T5Config
    from visualcloze_tpu_torch.models.autoencoder import build_autoencoder
    from visualcloze_tpu_torch.models.clip import build_clip
    from visualcloze_tpu_torch.models.flux import build_flux
    from visualcloze_tpu_torch.models.t5 import build_t5

    from bench_port.system import _flux_config

    vae = AutoEncoderConfig(**dict(config["vae"], ch_mult=tuple(config["vae"]["ch_mult"])))
    return {"flux": (build_flux(_flux_config(config["flux"]), device, torch.bfloat16), config["flux"]),
            "ae": (build_autoencoder(vae, device, torch.bfloat16), config["vae"]),
            "t5": (build_t5(T5Config(**config["t5"]), device, torch.bfloat16), config["t5"]),
            "clip": (build_clip(CLIPTextConfig(**config["clip"]), device, torch.bfloat16), config["clip"])}


@pytest.mark.parametrize("size", ["published", "tiny"])
def test_the_weights_name_every_parameter_of_the_served_modules(size):
    config = run.resolve(bench(), "bf16.default_query")["config"]
    if size == "tiny":
        config = tiny_config(config)
    for kind, (module, cfg) in _port_modules(config, torch.device("meta")).items():
        want = {n: tuple(p.shape) for n, p in module.named_parameters()}
        got = {n: tuple(shape) for _, entries in W.GROUPS[kind](cfg) for n, shape, _, _ in entries}
        assert got == want, kind


def test_a_group_draws_the_same_bits_again_and_alone():
    entries = W.flux_groups(tiny_config(run.resolve(bench(), "bf16.default_query")["config"])["flux"])
    name, group = entries[3]
    a = W.draw_group(2 ** 40 + 3, name, group, "cpu", torch.bfloat16)
    b = W.draw_group(2 ** 40 + 3, name, group, "cpu", torch.bfloat16)
    c = W.draw_group(2 ** 40 + 4, name, group, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(torch.equal(a[k], c[k]) for k in a if a[k].numel() > 8)
