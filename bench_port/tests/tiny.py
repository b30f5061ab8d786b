"""A cell of BENCHMARK.json at the tiny widths the CPU tests run: the same
wiring (a 2 + 2 block DiT 64 wide, a 64-channel VAE, 2-layer T5 and CLIP,
64-pixel cells, 4 Euler points), the configuration's own limits."""

from __future__ import annotations

import copy
import json

from bench_port import run

Z = 4


def tiny_config(config: dict) -> dict:
    cfg = copy.deepcopy(config)
    cfg["flux"].update(in_channels=4 * Z + 256 + 4 * Z, out_channels=4 * Z, vec_in_dim=32, context_in_dim=32,
                       hidden_size=64, num_heads=4, depth=2, depth_single_blocks=2, axes_dim=[4, 6, 6])
    cfg["vae"].update(ch=64, ch_mult=[1, 1, 1, 1], num_res_blocks=1, z_channels=Z)
    cfg["t5"].update(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4, max_length=16)
    cfg["clip"].update(vocab_size=256, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
                       max_length=16)
    tok = {"vocab_size": 256, "pad_id": 0, "eos_id": 1, "bos_id": None}
    cfg["tokenizers"] = {"t5": dict(tok), "clip": dict(tok)}
    cfg["assumed"]["resolution"] = 64
    return cfg


def tiny_spec(workload: str = "bf16.default_query") -> dict:
    with open(run.ROOT / "BENCHMARK.json") as f:
        spec = run.resolve(json.load(f), workload)
    spec["config"] = tiny_config(spec["config"])
    spec["mix"].update(image_size=128, steps=10, upsampling_steps=10)
    return spec
