"""chip_smoke.py's kernel lines of J, J' and K, another checkout against this one, in turns.

    python scripts/ab_fusion_lines.py OTHER_CHECKOUT [--kernels layernorm_modulate_bwd ...]

Runs, as a fresh process in each checkout in the order other, this, this,
other, that checkout's own `chip_smoke.check_layernorm_modulate_bwd`,
`check_layernorm_modulate` and `check_gated_residual` at the main path's
shapes, with the arguments older checkouts' functions take too. Each
checkout builds its own kernels and times them by its own graph-replayed
timer. While a turn runs, nvidia-smi samples the SM clock and power draw
(as scripts/ab_profile_step.py does).

One JSON line per turn and kernel line: the tree, the kernel, the line's
shape, what it stands for, ms, bound ms, share of the bound, plain ms,
library ms where the checkout times one, ok, and the turn's clock and power
samples. Then the card's name and power limit. Compare two checkouts only
within one run.
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
}
CHILD = r"""
import json, sys

import torch

import chip_smoke as cs

for fn, args, kwargs in json.loads(sys.argv[1]):
    r = getattr(cs, fn)(*args, **kwargs)
    torch.cuda.synchronize()
    print("LINE " + json.dumps(r), flush=True)
"""
KEEP = ("name", "what", "shape", "ms", "bound_ms", "share_of_bound", "plain_ms", "library_ms", "ok")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout to compare with (it builds its own kernels)")
    p.add_argument("--kernels", nargs="+", default=list(LINES), choices=list(LINES))
    args = p.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": HERE}
    todo = json.dumps([line for k in args.kernels for line in LINES[k]])
    for turn in ("other", "this", "this", "other"):
        out, card = run_turn([sys.executable, "-c", CHILD, todo], trees[turn])
        lines = [json.loads(ln[5:]) for ln in out.stdout.splitlines() if ln.startswith("LINE ")]
        if out.returncode or not lines:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode or 1
        for r in lines:
            print(json.dumps(dict(tree=turn, **{k: r.get(k) for k in KEEP}, card=card)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
