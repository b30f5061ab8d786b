"""Peak device memory of one full-width LoRA train step under each remat
policy, at the longest sequence the trainer can draw.

    python -m visualcloze_tpu_torch.training.remat_probe [--out probe.json]

The largest Graph200K grid at --grid_resolution 384 is 3 rows of 4 cells
(a reference, a condition and a two-column style pair): 12 x 576 = 6912 image
tokens, bucketed to 7168, plus 512 T5 tokens. The probe builds the trainer's
state as train.py does (random FLUX.1-Fill / T5-XXL / CLIP-L / VAE in bf16,
a rank-128 LoRA, AdamW), then runs one step of one micro-batch of random
tokens per policy. A policy that runs out of memory is reported as such.
Prints one JSON line; needs the GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..models.lora import init_lora
from ..pipeline.loader import random_components
from ..transport import create_transport
from .step import init_train_state, make_optimizer, make_train_step

POLICIES = {"full": None, "dots_split": "dots_split", "dots": "dots"}
IMG_TOKENS, TXT_TOKENS, LORA_RANK = 7168, 512, 128


def synthetic_batch(cfg, img_tokens: int, txt_tokens: int, device, generator) -> dict:
    """One micro-batch (accum 1, batch 1) of random tokens in a 64-wide grid."""
    bf = torch.bfloat16
    side = 64
    ids = torch.zeros((1, 1, img_tokens, 3), device=device)
    ids[..., 0] = 1
    ids[..., 1] = (torch.arange(img_tokens, device=device) // side).float()
    ids[..., 2] = (torch.arange(img_tokens, device=device) % side).float()

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device).to(bf)

    return dict(
        x1=randn(1, 1, img_tokens, cfg.out_channels),
        cond=randn(1, 1, img_tokens, cfg.in_channels - cfg.out_channels),
        img_ids=ids, img_mask=torch.ones((1, 1, img_tokens), dtype=torch.int32, device=device),
        txt=randn(1, 1, txt_tokens, cfg.context_in_dim),
        txt_ids=torch.zeros((1, 1, txt_tokens, 3), device=device),
        txt_mask=torch.ones((1, 1, txt_tokens), dtype=torch.int32, device=device),
        vec=randn(1, 1, cfg.vec_in_dim),
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    bundle = random_components(tiny=False, dtype=torch.bfloat16, device=device, generator=gen,
                               rope_layout="interleaved")
    lora = init_lora(bundle.flux, LORA_RANK, generator=gen)
    opt = make_optimizer()
    state = init_train_state(bundle.flux, lora, opt, "lora")
    transport = create_transport("Linear", "velocity", snr_type="lognorm")
    batch = synthetic_batch(bundle.cfg, IMG_TOKENS, TXT_TOKENS, device, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, tokens=IMG_TOKENS + TXT_TOKENS,
               resident_gib=torch.cuda.memory_allocated() / 2 ** 30, policies={})
    for name, policy in POLICIES.items():
        step = make_train_step(transport, opt, "lora", ema_decay=None, remat=True,
                               remat_policy=policy, compute_dtype=torch.bfloat16, rope_layout="interleaved")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            metrics = step(state, batch, torch.Generator(device=device).manual_seed(1))
            torch.cuda.synchronize()
            out["policies"][name] = dict(loss=float(metrics["loss"]),
                                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        except torch.OutOfMemoryError as e:
            out["policies"][name] = dict(oom=str(e).splitlines()[0],
                                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            for p_ in state.trainable().values():
                p_.grad = None
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
