"""The benchmark's operation counts equal what PyTorch's FLOP counter
counts on the measured package's tiny modules (their plain CPU path: every
linear, attention product and convolution is an aten op it counts)."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import flops
from bench_port.tests.tiny import tiny_spec


def _model():
    from bench_port import system

    cfg = tiny_spec()["config"]
    cfg = dict(cfg, dtype="float32")
    return cfg, system.build(cfg, 11, torch.device("cpu"))


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@torch.no_grad()
def test_dit_operations_match_the_flop_counter():
    cfg, model = _model()
    c = cfg["flux"]
    n_img, n_txt = 48, 16
    g = torch.Generator().manual_seed(0)
    ids = torch.zeros(1, n_img, 3)
    ids[0, :, 1] = torch.arange(n_img) // 8
    ids[0, :, 2] = torch.arange(n_img) % 8
    kw = dict(img=torch.randn(1, n_img, c["in_channels"], generator=g), img_ids=ids,
              txt=torch.randn(1, n_txt, c["context_in_dim"], generator=g), txt_ids=torch.zeros(1, n_txt, 3),
              timesteps=torch.full((1,), 0.5), y=torch.randn(1, c["vec_in_dim"], generator=g),
              guidance=torch.full((1,), 30.0))
    counted = _counted(lambda: model.flux(**kw))
    cost = flops.dit_cost(c, n_img, n_txt, None)
    assert counted == sum(ops for ops, _ in cost.values())


@torch.no_grad()
def test_vae_and_text_operations_match_the_flop_counter():
    cfg, model = _model()
    x = torch.rand(1, 64, 128, 3) * 2 - 1
    eps = torch.randn(1, 8, 16, cfg["vae"]["z_channels"])
    assert _counted(lambda: model.ae.encode(x, eps)) == flops.vae_ops(cfg["vae"], "vae_encode", 64, 128)
    z = torch.randn(1, 8, 16, cfg["vae"]["z_channels"])
    assert _counted(lambda: model.ae.decode(z)) == flops.vae_ops(cfg["vae"], "vae_decode", 64, 128)
    L = cfg["t5"]["max_length"]
    assert _counted(lambda: model.t5(["a prompt"])) == flops.t5_ops(cfg["t5"], L)
    L = cfg["clip"]["max_length"]
    assert _counted(lambda: model.clip(["a prompt"])) == flops.clip_ops(cfg["clip"], L)


def test_a_w8a8_dit_counts_its_token_linears_at_the_int8_peak():
    c = tiny_spec()["config"]["flux"]
    bf16, w8a8 = flops.dit_cost(c, 48, 16, None), flops.dit_cost(c, 48, 16, "w8a8")
    total = sum(ops for ops, _ in bf16.values())
    assert sum(ops for ops, _ in w8a8.values()) == total
    a8 = sum(2.0 * m * k * n for name, m, k, n in flops.dit_linears(c, 48, 16) if name in flops.A8)
    assert np.isclose(w8a8["linear.int8"][0], a8)
    assert flops.seconds_at_peak(w8a8) < flops.seconds_at_peak(bf16)
