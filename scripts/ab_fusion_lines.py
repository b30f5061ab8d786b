"""chip_smoke.py's kernel lines of J, J', K, the w8a8 codes kernels and N, another checkout against this one, in turns.

    python scripts/ab_fusion_lines.py OTHER_CHECKOUT [--kernels layernorm_modulate_quant merge_heads_quant ...]

Runs, as a fresh process in each checkout in the order other, this, this,
other, that checkout's own `chip_smoke` check functions at the main path's
shapes (`check_layernorm_modulate_bwd`, `check_layernorm_modulate`,
`check_gated_residual`; J and M writing codes, `check_layernorm_modulate_quant`
and `check_merge_heads_quant`; kernel O, `check_gelu_act_quant`; kernel M,
`check_merge_heads`; kernel N, `check_group_norm_stats`,
`check_group_norm_apply` and `check_group_norm_fused`), with the arguments
older checkouts' functions take too. `group_norm` is the folded launch at
the two latent shapes; a checkout without it (no `check_group_norm_fused`)
times the two launches it replaces, group_norm_apply(x,
*group_norm_stats(x)), by the same graph-replayed timer (the script's own
code, calling the checkout's wrappers). `swish` runs every finite bf16
value through each checkout's kernel N apply (a = 1, bb = 0) and counts the
results that differ from the plain version's on the card.
`gelu` runs every finite bf16 value through each checkout's kernel M and
counts the results that differ from F.gelu(approximate="tanh") on the card
(the script's own code, calling the checkout's `merge_heads`). Each
checkout builds its own kernels and times them by its own graph-replayed
timer. While a turn runs, nvidia-smi samples the SM clock and power draw
(as scripts/ab_profile_step.py does).

One JSON line per turn and kernel line: the tree, the kernel, the line's
shape, what it stands for, ms, bound ms, share of the bound, plain ms,
library ms or the unfused kernels' ms where the checkout times them, ok,
and the turn's clock and power samples. Then, per checkout, one line of
ptxas' report (-Xptxas -v: registers, shared memory, spills) for the
sources of the kernels run; then the card's name and power limit. Compare
two checkouts only within one run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ab_profile_step import run_turn  # noqa: E402

HERE = Path(__file__).resolve().parents[1]
# (check function, positional arguments, keyword arguments)
LINES = {
    "layernorm_modulate_bwd": [
        ("check_layernorm_modulate_bwd", (3968, True, "single block, 3968 tokens", 50), {}),
        ("check_layernorm_modulate_bwd", (3456, True, "double block img stream", 50), {}),
        ("check_layernorm_modulate_bwd", (512, True, "double block txt stream", 50), {}),
        ("check_layernorm_modulate_bwd", (3968, True, "single block, batch 2", 50), {"b": 2}),
        ("check_layernorm_modulate_bwd", (3456, True, "final layer: img rows after 512 txt rows, batch 2", 50),
         {"b": 2, "skip": 512}),
        ("check_layernorm_modulate_bwd", (3968, False, "fp32 dy (a J stored in fp32)", 50), {}),
        ("check_layernorm_modulate_bwd", (7, True, "a ragged 7 rows", 50), {}),
    ],
    "layernorm_modulate": [
        ("check_layernorm_modulate", (3968, True, "single block, the default query's 3968 tokens", 50), {}),
        ("check_layernorm_modulate", (3456, True, "double block img stream before a bf16 qkv", 50), {}),
    ],
    "gated_residual": [
        ("check_gated_residual", (3968, "single block, 3968 tokens", 50), {}),
        ("check_gated_residual", (3456, "double block img stream", 50), {}),
    ],
    "layernorm_modulate_quant": [
        ("check_layernorm_modulate_quant", (3968, True, False, "single block before linear1 (bf16 first)", 50), {}),
        ("check_layernorm_modulate_quant", (3456, False, False, "double block img stream before qkv / mlp.0", 50),
         {}),
        ("check_layernorm_modulate_quant", (512, False, True, "double block txt stream, a_sinv", 50), {}),
    ],
    "merge_heads_quant": [
        ("check_merge_heads_quant", (3968, "single block's linear2 input, 64 padded rows", 50, False),
         {"gelu_cols": 12288, "cols": 21504, "padded": 64}),
        ("check_merge_heads_quant", (3968, "double block: txt proj's 512 rows, img proj's 3456", 50, False),
         {"split": 512}),
    ],
    "gelu_act_quant": [
        ("check_gelu_act_quant", (3456, 12288, False, "double block img stream's mlp.0 output", 50), {}),
    ],
    "merge_heads": [
        ("check_merge_heads", (3968, "single block, 64 padded query rows", 50), {"gelu_cols": 12288, "cols": 21504,
                                                                                  "padded": 64}),
    ],
    "gelu": [("gelu_exhaustive", (), {})],
    # kernel N at the default query's GroupNorm shapes: the statistics at all 16 (chip_smoke.group_norm_shapes),
    # smallest first; the apply at the two latent shapes
    "group_norm_stats": [("check_group_norm_stats", (s, r), {}) for s, r in (
        ((1, 48, 144, 512), 50), ((1, 96, 288, 256), 50), ((1, 128, 128, 512), 50), ((1, 192, 576, 128), 20),
        ((1, 96, 288, 512), 50), ((1, 256, 256, 256), 20), ((1, 192, 576, 256), 20), ((1, 512, 512, 128), 20),
        ((1, 256, 256, 512), 20), ((1, 384, 1152, 128), 20), ((1, 192, 576, 512), 20), ((1, 512, 512, 256), 20),
        ((1, 384, 1152, 256), 10), ((1, 1024, 1024, 128), 20), ((1, 512, 512, 512), 10), ((1, 1024, 1024, 256), 10))],
    "group_norm_apply": [("check_group_norm_apply", (s, act, r), {}) for s, r in (
        ((1, 48, 144, 512), 50), ((1, 128, 128, 512), 50), ((1, 384, 1152, 128), 20), ((1, 1024, 1024, 128), 20))
        for act in ("none", "swish")],
    "group_norm": [("group_norm_fused", (s, act, 50), {}) for s in ((1, 48, 144, 512), (1, 128, 128, 512))
                   for act in ("none", "swish")],
    "swish": [("swish_exhaustive", (), {})],
}
SOURCES = {"layernorm_modulate_bwd": "layernorm_modulate_bwd", "layernorm_modulate": "layernorm_modulate",
           "gated_residual": "gated_residual", "layernorm_modulate_quant": "layernorm_modulate",
           "merge_heads_quant": "merge_heads", "gelu_act_quant": "gelu_act_quant", "merge_heads": "merge_heads",
           "gelu": "merge_heads", "group_norm_stats": "group_norm", "group_norm_apply": "group_norm",
           "group_norm": "group_norm", "swish": "group_norm"}
CHILD = r"""
import json, re, sys

import torch

import chip_smoke as cs
from visualcloze_tpu_torch.ops import cuda_build


def gelu_exhaustive():
    import torch.nn.functional as F
    from visualcloze_tpu_torch.ops.block_fusions import merge_heads

    bits = torch.arange(-32768, 32768, dtype=torch.int32, device="cuda").to(torch.int16).view(torch.bfloat16)
    x = bits[torch.isfinite(bits)].reshape(1, 255, 256)
    got = merge_heads(torch.zeros((1, 1, 255, 8), dtype=torch.bfloat16, device="cuda"), None, x)[..., 8:]
    want = F.gelu(x, approximate="tanh")
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - 7)
    err = ((got.float() - want.float()).abs() / ulp).max().item()
    differ = int((got.view(torch.int16) != want.view(torch.int16)).sum().item())
    return dict(name="gelu_tanh", what="every finite bf16 value through kernel M vs F.gelu", shape=[x.numel()],
                max_ulps=err, differ=differ, ok=err <= 1.0)


def swish_exhaustive():
    from visualcloze_tpu_torch.ops import group_norm as gn

    bits = torch.arange(-32768, 32768, dtype=torch.int32, device="cuda").to(torch.int16).view(torch.bfloat16)
    x = bits[torch.isfinite(bits)].reshape(1, 1, -1, 8)
    a, bb = torch.ones((1, 8), device="cuda"), torch.zeros((1, 8), device="cuda")
    got = gn.group_norm_apply(x, a, bb, "swish")
    want = gn.group_norm_apply_plain(x, a, bb, "swish")
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - 7)
    err = ((got.float() - want.float()).abs() / ulp).max().item()
    differ = int((got.view(torch.int16) != want.view(torch.int16)).sum().item())
    return dict(name="swish", what="every finite bf16 value through kernel N's apply vs the plain version",
                shape=[x.numel()], max_ulps=err, differ=differ, ok=err <= 1.0)


def group_norm_fused(shape, act, reps):
    if hasattr(cs, "check_group_norm_fused"):
        return cs.check_group_norm_fused(shape, act, reps)
    from visualcloze_tpu_torch.ops import group_norm as gn

    x, scale, bias = cs.group_norm_inputs(shape)
    ms = cs.cuda_ms(lambda: gn.group_norm_apply(x, *gn.group_norm_stats(x, scale, bias, 32), act), reps, graph=True)
    bms, by = cs.bound((8.0 if act == "swish" else 6.0) * x.numel(), 4 * x.numel(), cs.PEAK_FP32)
    return dict(name="group_norm", what="the two launches (statistics, then apply)", shape=list(shape), act=act,
                ms=ms, unfused_ms=ms, bound_ms=bms, share_of_bound=bms / ms, ok=True)


LOCAL = {"gelu_exhaustive": gelu_exhaustive, "swish_exhaustive": swish_exhaustive, "group_norm_fused": group_norm_fused}
for fn, args, kwargs in json.loads(sys.argv[1]):
    r = (LOCAL[fn] if fn in LOCAL else getattr(cs, fn))(*args, **kwargs)
    torch.cuda.synchronize()
    print("LINE " + json.dumps(r), flush=True)
keep = ("entry function", "registers", "spill")
print("PTXAS " + json.dumps({n: [re.sub(r"\s+", " ", ln.strip()) for ln in log.splitlines() if any(k in ln for k in keep)]
                             for n, log in cuda_build.BUILD_LOG.items() if n in sys.argv[2].split(",")}), flush=True)
"""
KEEP = ("name", "what", "shape", "act", "design", "cluster", "ctas", "stages", "team", "ms", "eager_ms", "unfused_ms",
        "bound_ms",
        "share_of_bound", "plain_ms", "library_ms", "unfused_kernels_ms", "max_abs_err", "b_after_n_max_abs_err",
        "deterministic", "max_ulps", "differ", "ok")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout to compare with (it builds its own kernels)")
    p.add_argument("--kernels", nargs="+", default=list(LINES), choices=list(LINES))
    args = p.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": HERE}
    todo = json.dumps([line for k in args.kernels for line in LINES[k]])
    sources = ",".join(sorted({SOURCES[k] for k in args.kernels}))
    ptxas = {}
    for turn in ("other", "this", "this", "other"):
        out, card = run_turn([sys.executable, "-c", CHILD, todo, sources], trees[turn])
        lines = [json.loads(ln[5:]) for ln in out.stdout.splitlines() if ln.startswith("LINE ")]
        if out.returncode or not lines:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode or 1
        for r in lines:
            print(json.dumps(dict(tree=turn, **{k: r.get(k) for k in KEEP}, card=card)), flush=True)
        for ln in out.stdout.splitlines():
            if ln.startswith("PTXAS ") and json.loads(ln[6:]):
                ptxas.setdefault(turn, json.loads(ln[6:]))  # the turn that built the tree's kernels
    for turn, report in ptxas.items():
        print(json.dumps(dict(tree=turn, ptxas=report)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
