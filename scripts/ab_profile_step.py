"""profile_step's denoise step on every serving stack, another checkout against this one, in turns.

    python scripts/ab_profile_step.py OTHER_CHECKOUT [--modes none int8 w8a8 int4] [--steps 3]

For each stack (`--quantize` none: the bf16 DiT; int8: the single-card int8
stack; w8a8 and int4: the bf16 stack with its DiT quantized) runs
`python -m visualcloze_tpu_torch.profile_step` as a fresh process in each
checkout, in the order other, this, this, other, so that both checkouts see
the same card in the same state. Each checkout builds its own kernels and
classes the kernels by its own profile_step (a class the other checkout
does not know falls into its "other").

One JSON line per stack and turn: the tree, the stack, and profile_step's
result (the step's CUDA-event ms, device ms per kernel class, idle share).
Then the card's name and power limit. Compare two checkouts only within one
run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
MODES = ("none", "int8", "w8a8", "int4")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout to compare with (it builds its own kernels)")
    p.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": HERE}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in args.modes:
            for turn in ("other", "this", "this", "other"):
                cmd = [sys.executable, "-m", "visualcloze_tpu_torch.profile_step", "--steps", str(args.steps),
                       "--out", str(Path(tmp) / f"{mode}_{turn}.json")]
                if mode != "none":
                    cmd += ["--quantize", mode]
                out = subprocess.run(cmd, cwd=trees[turn], capture_output=True, text=True)
                lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
                if out.returncode or not lines:
                    sys.stderr.write(out.stderr[-4000:])
                    return out.returncode or 1
                print(json.dumps({"tree": turn, "stack": mode, **json.loads(lines[-1])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
