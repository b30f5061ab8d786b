"""Serving daemon of the port: the HTTP API of pipeline/server.py over the
pipelined server (counterpart of the root serve.py).

  python -m visualcloze_tpu_torch.serve --demo --port 8000
      the full-width bf16 stack with random weights on the GPU (with
      --device cpu: the tiny fp32 model on the CPU);
  python -m visualcloze_tpu_torch.serve --model_path visualcloze-384.pth --port 8000
      checkpoint files, as the inference CLI reads them;
  curl -s localhost:8000/healthz
  curl -s -X POST localhost:8000/v1/generate -d @query.json

--lora NAME=PATH registers runtime adapters, which a request selects by its
JSON "adapter" field. --replicas N builds N models behind a ReplicaPool, all
on the one card. Requests beyond --max_inflight + --max_queue get 429. Before
it listens, the server runs one blank query per --warmup_grids grid and
adapter signature (and per --warmup_upsampling cell size) through the same
submit path the requests take.

Placement (JAX's serve.py): with two or more cards and no mesh, replica r
puts its encoders on card 2r and its DiT on card 2r + 1 (PipelinedServer's
disaggregated placement) where the cards suffice; --no_disaggregate keeps
everything on one card. Under torchrun, --tp / --fsdp / --cp shard the DiT
over the ranks (inference.serving_mesh): rank 0 serves HTTP and broadcasts
each query to the other ranks, which run it in step (MeshLeader,
follow_mesh).
"""

from __future__ import annotations

import argparse

import torch

import torch.distributed as dist

from .inference import (add_adapter_args, add_adapters, add_aot_args, add_mesh_args, build_model, kernel_cache,
                        load_model, serving_attn_impl, serving_device, serving_mesh)
from .pipeline import PipelinedServer, ReplicaPool, synthetic_full_components
from .pipeline.loader import place_model
from .pipeline.orchestrator import MeshLeader, follow_mesh
from .pipeline.server import run_frontend
from .transport.sampling import solver_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None,
                   help="VisualCloze LoRA checkpoint, or a diffusers pipeline snapshot directory")
    p.add_argument("--model_name", default="flux-dev-fill-lora")
    p.add_argument("--resolution", type=int, default=384)
    p.add_argument("--solver", default="euler", type=solver_arg, help="euler, heun, ab2, dopri5 or cached[:K]")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "w8a8", "w8a8_smooth"])
    p.add_argument("--t5_int4", action="store_true", help="int4 weight-only T5-XXL")
    add_mesh_args(p)
    add_adapter_args(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--replicas", type=int, default=1,
                   help="N models behind least-loaded dispatch and failover (all on the one card)")
    p.add_argument("--max_inflight", type=int, default=1,
                   help="queries in flight on a replica (more than 1 interleaves queries on the one card's "
                        "stream: later first answers, no more throughput)")
    p.add_argument("--max_queue", type=int, default=8, help="admitted requests waiting beyond max_inflight")
    p.add_argument("--result_timeout", type=float, default=900.0,
                   help="seconds a request may wait before a 504; 0 disables")
    p.add_argument("--no_disaggregate", action="store_true",
                   help="keep the encoders and the DiT on one card even when two or more are present")
    add_aot_args(p)
    p.add_argument("--warmup_grids", default="2x3", help="comma list of HxW grids to warm up ('' skips)")
    p.add_argument("--warmup_upsampling", default="",
                   help="comma list of WxH query-cell sizes whose SDEdit pass to warm up, e.g. 1024x1024")
    p.add_argument("--demo", action="store_true", help="random weights, no checkpoint files")
    p.add_argument("--synthetic_full", action="store_true",
                   help="the single-card int8 stack with random weights: int8 DiT (kernel G), int4 T5-XXL, "
                        "int8 CLIP-L, bf16 VAE (tiny widths with --device cpu)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def _sizes(spec: str) -> list[tuple[int, int]]:
    return [tuple(int(v) for v in s.split("x")) for s in spec.split(",") if s] if spec else []


def build_serving_model(args, device: torch.device, mesh=None):
    """The model one replica serves, its DiT on `mesh`, with the --lora
    adapters registered."""
    if args.synthetic_full:
        tiny = device.type == "cpu"
        model = synthetic_full_components(tiny=tiny, device=device, resolution=64 if tiny else args.resolution)
        model.solver = args.solver
        model = place_model(model, mesh, serving_attn_impl(args, mesh))
    elif args.demo:
        model = place_model(build_model(args, device), mesh, serving_attn_impl(args, mesh))
    else:
        model = load_model(args, device, mesh)
    add_adapters(model, args)
    return model


def placement(args, device: torch.device, mesh, replica: int):
    """(encoder_device, dit_device) of a replica: cards 2r and 2r + 1 when
    there are two or more cards, no mesh and enough cards (JAX's rule)."""
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if mesh is not None or args.no_disaggregate or n < 2 or 2 * args.replicas > n:
        return None, None
    return torch.device("cuda", 2 * replica), torch.device("cuda", 2 * replica + 1)


def main(argv=None):
    args = parse_args(argv)
    device = serving_device(args)
    print(f"kernel directory: {kernel_cache(args, device)}")
    mesh = serving_mesh(args, device)
    leader = mesh is None or mesh.device_mesh is None or dist.get_rank() == 0
    replicas = []
    for r in range(args.replicas):
        enc_dev, dit_dev = placement(args, device, mesh, r)
        model = build_serving_model(args, enc_dev or device, mesh)
        ps = PipelinedServer(model, encoder_device=enc_dev, dit_device=dit_dev, max_inflight=args.max_inflight)
        model.warmup(_sizes(args.warmup_grids), steps=4 if args.demo else 30,
                     upsampling_sizes=_sizes(args.warmup_upsampling),
                     submit=lambda *a, **k: ps.submit(*a, **k).result())
        replicas.append(ps)
    server = replicas[0] if args.replicas == 1 else ReplicaPool(replicas)
    if not leader:  # the other ranks of a mesh run rank 0's queries in step
        print(f"rank {dist.get_rank()}: following rank 0's queries", flush=True)
        follow_mesh(server)
        server.close()
        return
    if mesh is not None and mesh.device_mesh is not None:
        server = MeshLeader(server)
    print(f"serving on {args.host}:{args.port} (replicas={args.replicas}, device={device})", flush=True)
    run_frontend(server, host=args.host, port=args.port, max_inflight=args.max_inflight * args.replicas,
                 max_queue=args.max_queue, block=True, result_timeout_s=args.result_timeout or None)


if __name__ == "__main__":
    main()
