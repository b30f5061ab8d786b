"""chip_smoke.py's train and likelihood phases, another checkout against this one, in turns.

    python scripts/ab_train_phases.py OTHER_CHECKOUT

Runs, as a fresh process in each checkout in the order other, this, this,
other, that checkout's own `chip_smoke.run_training` (the trainer's main at
full width: rank-128 LoRA, grid 384, 3 steps of 2 micro-batches, remat
"full", on a synthetic Graph200K set) and `chip_smoke.likelihood`
(sample_ode_likelihood on a 2x2 grid at 256, 3 steps, on the full-width
random bf16 stack, seed 0). Each checkout builds its own kernels. While a
turn runs, nvidia-smi samples the SM clock and power draw (as
scripts/ab_profile_step.py does).

One JSON line per turn: the tree, each step's TrainSecs, EncodeSecs and
DataloadSecs (the trainer's history), the train phase's seconds, peak
memory and kernel launches, the likelihood's seconds, peak memory and
launches, and the turn's clock and power samples. Then the card's name and
power limit. Compare two checkouts only within one run.
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
CHILD = r"""
import json, tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from visualcloze_tpu_torch.pipeline import random_components

with tempfile.TemporaryDirectory() as tmp:
    train, result = cs.run_training(Path(tmp), "full")
del result
cs.free()
model = random_components(tiny=False, dtype=torch.bfloat16, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0), resolution=384)
lik = cs.likelihood(model)
print(json.dumps(dict(train=train, likelihood=lik)))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout to compare with (it builds its own kernels)")
    args = p.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": HERE}
    for turn in ("other", "this", "this", "other"):
        out, card = run_turn([sys.executable, "-c", CHILD], trees[turn])
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"train"')]
        if out.returncode or not lines:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode or 1
        res = json.loads(lines[-1])
        train, lik = res["train"], res["likelihood"]
        steps = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith('{"phase": "train_step"')]
        print(json.dumps(dict(
            tree=turn, train_steps=[{k: s["seconds"].get(k) for k in ("TrainSecs", "EncodeSecs", "DataloadSecs")}
                                    for s in steps],
            train_seconds=train["seconds"], train_peak_mem_gib=train["peak_mem_gib"], train_ok=train["ok"],
            train_launches={k: v for k, v in train["launches"].items() if v},
            likelihood_seconds=lik["seconds"], likelihood_peak_mem_gib=lik["peak_mem_gib"], likelihood_ok=lik["ok"],
            likelihood_launches={k: v for k, v in lik["launches"].items() if v}, card=card)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
