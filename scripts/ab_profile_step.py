"""profile_step's denoise step on every serving stack, or its LoRA train step, another checkout against this one,
in turns.

    python scripts/ab_profile_step.py OTHER_CHECKOUT [--modes none int8 w8a8 int4 train vae] [--steps 3] [--rounds 1]

For each stack (`--quantize` none: the bf16 DiT; int8: the single-card int8
stack; w8a8 and int4: the bf16 stack with its DiT quantized; train:
`profile_step --train`, the full-width trainer's LoRA step; vae:
`profile_step --vae`, the default query's VAE work) runs
`python -m visualcloze_tpu_torch.profile_step` as a fresh process in each
checkout, in the order other, this, this, other (--rounds times), so that
both checkouts see the same card in the same state. Each checkout builds its own kernels and
classes the kernels by its own profile_step (a class the other checkout
does not know falls into its "other"). While each turn runs, nvidia-smi
samples the card's SM clock and power draw every 200 ms, so that a turn on
a card that ran slower (a lower clock under its power limit) shows.

One JSON line per stack and turn: the tree, the stack, profile_step's
result (the step's CUDA-event ms, device ms and kernel launches per kernel
class, idle share) and the turn's clock and power samples (median, min,
max). Then the card's name and power limit. Compare two checkouts only
within one run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
MODES = ("none", "int8", "w8a8", "int4", "train", "vae")
SMI_QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits", "-lms", "200"]


def _summary(values: list[float]) -> dict:
    if not values:
        return {"samples": 0}
    return {"samples": len(values), "median": statistics.median(values), "min": min(values), "max": max(values)}


def run_turn(cmd: list[str], cwd: Path):
    """Run cmd in cwd while nvidia-smi samples the card: (CompletedProcess, {"sm_clock_mhz", "power_w"})."""
    smi = subprocess.Popen(SMI_QUERY, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    finally:
        smi.terminate()
        samples, _ = smi.communicate(timeout=30)
    clocks, power = [], []
    for line in samples.splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            clocks.append(float(parts[0]))
            power.append(float(parts[1]))
        except (IndexError, ValueError):
            continue
    return out, {"sm_clock_mhz": _summary(clocks), "power_w": _summary(power)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout to compare with (it builds its own kernels)")
    p.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES[:4]))
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--rounds", type=int, default=1, help="the turns other, this, this, other, this many times a stack")
    args = p.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": HERE}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in args.modes:
            for turn in ("other", "this", "this", "other") * args.rounds:
                cmd = [sys.executable, "-m", "visualcloze_tpu_torch.profile_step", "--steps", str(args.steps),
                       "--out", str(Path(tmp) / f"{mode}_{turn}.json")]
                if mode in ("train", "vae"):
                    cmd.append(f"--{mode}")
                elif mode != "none":
                    cmd += ["--quantize", mode]
                out, card = run_turn(cmd, trees[turn])
                lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
                if out.returncode or not lines:
                    sys.stderr.write(out.stderr[-4000:])
                    return out.returncode or 1
                print(json.dumps({"tree": turn, "stack": mode, **json.loads(lines[-1]), "card": card}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
