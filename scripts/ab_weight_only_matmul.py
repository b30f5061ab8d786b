"""Time kernels G, G4 and H of another checkout against this one, in turns.

    python scripts/ab_weight_only_matmul.py OTHER_CHECKOUT [--reps 20]

Each turn is a fresh process in one checkout, in the order other, this,
this, other. It builds that checkout's kernels (its `build/torch_kernels/`)
and times that checkout's wrappers (`ops.int8_matmul`, `ops.int4_matmul`,
`ops.w8a8_matmul`) with the timer below, as a replayed CUDA graph of `reps`
launches after one warm-up, on inputs drawn on the card from a fixed seed:
both checkouts are timed by this file's code, whatever their own
`chip_smoke.py` does. The shapes are `chip_smoke.py`'s for G, G4 and H
(the DiT's linears at 3968 and 3456 rows, the 512-row text stream, a ragged
M, the M = 1 GEMV, N = 64) and the edges of a 2-CTA cluster along M (17,
129, 257 rows).

One JSON line per kernel, shape and turn: ms; `digest`, a hash of the
output's bytes (the same inputs in every turn, so equal digests say that
the two checkouts computed the same bits); `tma_bytes`, the bytes the
CTAs' TMA loads bring into shared memory, computed from the checkout's
grid (a multicast or a tile a pair shares counted once; the M <= 16 GEMV
loads no TMA tiles: null), and `tma_tbps`, that over the time; `paired`,
whether the checkout ran the shape's CTAs in pairs. Then the
card's name and power limit. Needs a CUDA card; compare two checkouts only
within one run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = (  # kind, M, K, N, what (H: with a bias unless the name says otherwise)
    ("int8", 3968, 3072, 21504, "linear1"),
    ("int8", 3968, 15360, 3072, "linear2"),
    ("int8", 3456, 3072, 9216, "img_attn.qkv"),
    ("int8", 1, 3072, 18432, "double-block modulation"),
    ("int8", 3456, 3072, 64, "final_layer.linear"),
    ("int8", 4097, 3072, 3072, "ragged M (proj)"),
    ("int8", 512, 3072, 3072, "text stream proj"),
    ("int8", 512, 12288, 3072, "text stream linear2"),
    ("int4", 3968, 3072, 21504, "linear1"),
    ("int4", 3968, 15360, 3072, "linear2"),
    ("int4", 3456, 3072, 9216, "img_attn.qkv"),
    ("int4", 1, 3072, 18432, "double-block modulation"),
    ("int4", 3456, 3072, 64, "final_layer.linear"),
    ("int4", 4097, 3072, 3072, "ragged M (proj)"),
    ("int4", 512, 3072, 3072, "text stream proj"),
    ("int4", 512, 12288, 3072, "text stream linear2"),
    ("int4", 17, 3072, 3072, "cluster edge: M 17"),
    ("int4", 129, 3072, 3072, "cluster edge: M 129"),
    ("int4", 257, 3072, 3072, "cluster edge: M 257"),
    ("w8a8", 3968, 3072, 21504, "linear1"),
    ("w8a8", 3968, 15360, 3072, "linear2"),
    ("w8a8", 3968, 3072, 9216, "qkv"),
    ("w8a8", 3968, 3072, 3072, "proj"),
    ("w8a8", 3968, 3072, 12288, "mlp.0"),
    ("w8a8", 3968, 12288, 3072, "mlp.2"),
    ("w8a8", 3456, 3072, 9216, "img_attn.qkv"),
    ("w8a8", 512, 3072, 9216, "text stream qkv"),
    ("w8a8", 512, 12288, 3072, "text stream mlp.2"),
    ("w8a8", 4097, 3072, 3072, "ragged M (proj)"),
    ("w8a8", 3968, 3072, 21504, "linear1 without a bias"),
    ("w8a8", 129, 12288, 3072, "cluster edge: M 129"),
    ("w8a8", 257, 3072, 9216, "cluster edge: M 257"),
)

TURN = r'''
import hashlib, json, sys
from importlib import import_module

import torch

shapes, reps = json.loads(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda")
g4, g8, h = (import_module(f"visualcloze_tpu_torch.ops.{m}") for m in ("int4_matmul", "int8_matmul", "w8a8_matmul"))
h_pairs = hasattr(h, "tile_plan")  # H's persistent pairs; else one CTA a 128 x 256 tile


def wide_paired(kind, m, n):
    """Whether this checkout's wide body pairs its CTAs at (m, n)."""
    if not hasattr(g8, "wide_pairs"):
        return False
    return g8.wide_pairs(m, n, g8.sm_count(dev), (g8 if kind == "int8" else g4).PAIR_TIME)


def cdiv(a, b):
    return -(-a // b)


def graph_ms(fn):
    """ms a call: `reps` calls captured into a CUDA graph after one warm-up, replayed once."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wide_bytes(m, k, n, kind):
    """G / G4's wide body: 128 x 256 tiles, 64 K a stage, x bf16 and the stored w."""
    if m <= 16:
        return None
    mt, nt, nk = cdiv(m, 128), cdiv(n, 256), k // 64
    xbox, wpitch, wrows = min(m, 128) * 64 * 2, min(n, 256), 64 // (2 if kind == "int4" else 1)
    if wide_paired(kind, m, n):  # every CTA with rows loads its x; each CTA of a pair half of the stored tile
        return nt * nk * (mt * xbox + 2 * cdiv(mt, 2) * (wrows // 2) * wpitch)
    return nt * nk * mt * (xbox + wrows * wpitch)


def h_plan(m, n):
    """(tile_n, paired) of this checkout's H at (m, n)."""
    if not h_pairs:
        return 256, False
    bn, paired, _ = h.tile_plan(m, n, h._resident_clusters())
    return bn, paired


def h_bytes(m, k, n):
    """H: 128-row tiles, 128 K bytes a stage, the weight tile as two halves;
    paired, each half multicast once for both CTAs."""
    mt, nk, abox = cdiv(m, 128), k // 128, min(m, 128) * 128
    if not h_pairs:
        return cdiv(n, 256) * nk * mt * (abox + min(n, 256) * 128)
    bn, paired = h_plan(m, n)
    half, total = bn // 2, 0
    for n0 in range(0, n, bn):
        halves = 1 + (n0 + half < n)
        total += nk * (mt * abox + (cdiv(mt, 2) if paired else mt) * halves * min(n, half) * 128)
    return total


for kind, m, k, n, what in shapes:
    g = torch.Generator(device=dev).manual_seed(1000 * m + n + k)
    if kind == "w8a8":
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand((m,), generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.full((n,), k ** -0.5 / 127, device=dev)
        bias = (None if "without a bias" in what
                else (torch.randn((n,), generator=g, device=dev) * 0.1).to(torch.bfloat16))
        fn, nbytes = (lambda: h.w8a8_matmul(a, w, xs, ws, bias)), h_bytes(m, k, n)
    elif kind == "int8":
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        sc = torch.full((n,), k ** -0.5 / 127, device=dev)
        fn, nbytes = (lambda: g8.int8_matmul(x, w, sc)), wide_bytes(m, k, n, kind)
    else:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
        sc = (torch.rand((k // 128, n), generator=g, device=dev) * 0.5 + 0.75) * (k ** -0.5 / 7)
        fn, nbytes = (lambda: g4.int4_matmul(x, w, sc)), wide_bytes(m, k, n, kind)
    digest = hashlib.sha1(fn().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
    ms = graph_ms(fn)
    print(json.dumps(dict(name={"int8": "int8_matmul", "int4": "int4_matmul", "w8a8": "w8a8_matmul"}[kind],
                          what=what, shape=[m, k, n], ms=ms, digest=digest, tma_bytes=nbytes,
                          paired=h_plan(m, n)[1] if kind == "w8a8" else wide_paired(kind, m, n),
                          tma_tbps=None if nbytes is None else nbytes / ms / 1e9)), flush=True)
    torch.cuda.empty_cache()
'''


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout to compare with (it builds its own kernels)")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": HERE}
    for turn in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", TURN, json.dumps(SHAPES), str(args.reps)], cwd=trees[turn],
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            print(json.dumps({"tree": turn, **json.loads(line)}), flush=True)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
