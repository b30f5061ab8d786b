"""The control of each cell's comparison, and the program's readings beside
it, over many seeds in one process (on the card, at the cell's own size):

    python3 -m bench_port.control --workload <name> --seeds <n> [<n> ...] [--seconds 1]

For each seed: one short run of the cell (run.run_cell: weights from the
seed, warm-up, a window of one cycle of the mix, the reference), its
numbers, and the same sample compared once more with the control (the
reference in the next precision below the configuration's, check.CONTROL,
standing in the program's place for the DiT). Prints one JSON line a seed,
then the largest program reading and the smallest control reading of each
number: the two readings a limit is set between (limits/<config>.json).
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from .run import ROOT, resolve, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_port.control: no CUDA device", file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        spec = resolve(json.load(f), args.workload)
    program, control = {}, {}
    for seed in args.seeds:
        res = run_cell(spec, seed, args.seconds, False, torch.device("cuda", 0), control=True)
        got = {n: c["value"] for n, c in res["checks"].items()}
        print(json.dumps(dict(seed=seed, correct=res["correct"], program=got, control=res["control"])), flush=True)
        for n, v in got.items():
            program[n] = max(program.get(n, 0.0), v)
            control[n] = min(control.get(n, float("inf")), res["control"][n])
    print(json.dumps(dict(workload=args.workload, seeds=args.seeds, program_max=program, control_min=control)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
