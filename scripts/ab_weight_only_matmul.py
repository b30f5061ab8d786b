"""Time kernels G and G4 of another checkout against this one, in turns.

    python scripts/ab_weight_only_matmul.py OTHER_CHECKOUT [--reps 20]

Runs `chip_smoke.check_int8_matmul` / `check_int4_matmul` at chip_smoke's
wide-body shapes in a fresh process per turn, in the order other, this, this,
other, each checkout building its own kernels (its `build/torch_kernels/`).
Prints one JSON line per kernel and turn, then the card's name and power
limit. Needs a CUDA card; compare two versions only within one run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = (
    ("int8", 3968, 3072, 21504, "linear1"),
    ("int8", 3968, 15360, 3072, "linear2"),
    ("int8", 3456, 3072, 64, "final_layer.linear"),
    ("int4", 3968, 3072, 21504, "linear1"),
    ("int4", 3968, 15360, 3072, "linear2"),
    ("int4", 3456, 3072, 9216, "img_attn.qkv"),
    ("int4", 3456, 3072, 64, "final_layer.linear"),
    ("int4", 4097, 3072, 3072, "ragged M (proj)"),
)
TURN = """
import json, sys
import chip_smoke as c
for kind, m, k, n, what in json.loads(sys.argv[1]):
    r = (c.check_int8_matmul if kind == "int8" else c.check_int4_matmul)(m, k, n, what, int(sys.argv[2]))
    print(json.dumps({key: r[key] for key in ("name", "what", "shape", "ms", "ok", "max_abs_err", "tol")}), flush=True)
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout to compare with (its own chip_smoke.py and kernels)")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": HERE}
    for turn in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", TURN, json.dumps(SHAPES), str(args.reps)], cwd=trees[turn],
                             capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            print(json.dumps({"tree": turn, **json.loads(line)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
