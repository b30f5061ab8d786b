"""Kernel N's statistics under every plan the card takes, at the default query's GroupNorm shapes.

    python scripts/group_norm_plans.py [--reps 20] [--out chiprun_out/group_norm_plans.jsonl]

For each shape (every statistics shape of a default query, and a 16-pixel
one at C = 512 that gives each design's fixed cost), times (a replayed CUDA
graph of `reps` calls, chip_smoke's `cuda_ms`) the moments design at
several ring depths and grid sizes (one CTA an SM with 2, 3, 4 or 6 stages
of 32 KB; half or a quarter of the SMs; two CTAs an SM with 3 stages) and the cluster
design at every group block (neighbouring groups of 8 K channels, K a power
of two up to 32) and cluster size (1, 2, 4, 8) whose CTA fits the card's
shared memory, through `ops.group_norm.launch_stats_plan`, and checks
each against the plain version (a and bb within 1e-5 of their largest, as
chip_smoke does) and for the same bits twice. A line per plan: the shape,
x's MB, design, cluster, groups a block, the block's bytes a pixel (a row),
CTAs, stages, team, a CTA's shared memory, the clusters the card runs at
once, ms, the one-read bound's ms and share, the L2 requests the cluster
design's loads make (a row a pixel and block) and their rate, and whether
`stats_plan` picks this plan. A cluster plan's line also times kernel N's
folded launch under it (`launch_fused_plan`, the statistics and the apply
in one launch; act none and swish) and checks its y, a and bb for the same
bits as the statistics under the plan followed by the apply. Then the
card's name and power limit. These are the measurements behind
`stats_plan`'s constants.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = ((1, 1, 16, 512), (1, 48, 144, 512), (1, 96, 288, 256), (1, 128, 128, 512), (1, 192, 576, 128),
          (1, 96, 288, 512), (1, 256, 256, 256), (1, 192, 576, 256), (1, 512, 512, 128), (1, 256, 256, 512),
          (1, 384, 1152, 128), (1, 192, 576, 512), (1, 512, 512, 256), (1, 384, 1152, 256), (1, 1024, 1024, 128),
          (1, 512, 512, 512), (1, 1024, 1024, 256))


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from visualcloze_tpu_torch.ops import group_norm as gn

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", type=Path, default=Path("chiprun_out/group_norm_plans.jsonl"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("group_norm_plans: no CUDA device", file=sys.stderr)
        return 2
    limits = gn.device_limits(0)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    groups = 32
    with args.out.open("w") as out:
        for shape in SHAPES:
            b, h, w, c = shape
            hw, cg = h * w, c // groups
            x, scale, bias = cs.group_norm_inputs(shape)
            wa, wbb = gn.group_norm_stats_plain(x, scale, bias, groups)
            chosen = gn.stats_plan(b, h, w, c, groups, *limits)
            sms = limits[0]
            plans = [gn.moments_plan(b, hw, c, groups, sms, stages=s) for s in (2, 3, 4, 6)]
            plans += [gn.moments_plan(b, hw, c, groups, sms, ctas=sms // 2),
                      gn.moments_plan(b, hw, c, groups, sms, ctas=sms // 4),
                      gn.moments_plan(b, hw, c, groups, sms, ctas=2 * sms, stages=3)]
            for bg in range(1, groups + 1):
                k = bg * cg // 8
                if groups % bg or bg * cg % 8 or k & (k - 1) or k > gn.MAX_BLOCK_CHUNKS:
                    continue
                for cluster in (1, 2, 4, 8):
                    per = -(-hw // cluster)
                    need = gn.cluster_smem(per, bg * cg)
                    if need <= limits[1]:
                        plans.append(gn.StatsPlan("cluster", cluster, bg, groups // bg * cluster, per, need))
            if chosen not in plans:
                plans.append(chosen)
            bound = x.numel() * 2 / cs.PEAK_BYTES * 1e3
            for plan in dict.fromkeys(plans):
                a, bb = gn.launch_stats_plan(x, scale, bias, groups, 1e-6, plan)
                a2, bb2 = gn.launch_stats_plan(x, scale, bias, groups, 1e-6, plan)
                torch.cuda.synchronize()
                ok = ((a - wa).abs().max().item() <= 1e-5 * wa.abs().max().item()
                      and (bb - wbb).abs().max().item() <= 1e-5 * wbb.abs().max().item()
                      and torch.equal(a, a2) and torch.equal(bb, bb2))
                ms = cs.cuda_ms(lambda plan=plan: gn.launch_stats_plan(x, scale, bias, groups, 1e-6, plan), args.reps,
                                graph=True)
                line = dict(shape=list(shape), mb=x.numel() * 2 / 1e6, design=plan.design, cluster=plan.cluster,
                            ms=ms, bound_ms=bound, share_of_bound=bound / ms, ok=ok, chosen=plan == chosen)
                if plan.design == "cluster":
                    for act in ("none", "swish"):
                        y, fa, fbb = gn.launch_fused_plan(x, scale, bias, groups, 1e-6, act, plan)
                        line[f"fused_{act}_equal"] = (torch.equal(fa, a) and torch.equal(fbb, bb)
                                                      and torch.equal(y, gn.group_norm_apply(x, a, bb, act)))
                        line[f"fused_{act}_ms"] = cs.cuda_ms(
                            lambda plan=plan, act=act: gn.launch_fused_plan(x, scale, bias, groups, 1e-6, act, plan),
                            args.reps, graph=True)
                        del y
                    line["ok"] = line["ok"] and line["fused_none_equal"] and line["fused_swish_equal"]
                    requests = b * hw * (groups // plan.block_groups)
                    line.update(block_groups=plan.block_groups, row_bytes=plan.block_groups * cg * 2,
                                ctas=b * plan.ctas, cta_bytes=plan.cta_bytes,
                                max_active_clusters=gn.cluster_occupancy(h, w, c, groups, plan),
                                l2_requests=requests, g_requests_per_s=requests / ms / 1e6)
                else:
                    line.update(ctas=b * plan.ctas, per=plan.per, stages=plan.stages, team=plan.team,
                                cta_bytes=plan.cta_bytes)
                out.write(json.dumps(line) + "\n")
                print(json.dumps(line), flush=True)
            del x, scale, bias, wa, wbb
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
