"""A persistent group of CPU ranks (gloo) for the port's multi-rank tests,
and the jobs they run. No JAX here: the workers import only torch and the
port; the tests compute the JAX side in their own process and pass numbers.

`RankGroup(n, tmp)` starts n worker processes (this file as a script) that
join one gloo group through a FileStore under `tmp`, with one intra-op
thread each, and then take jobs from their stdin: run(job, **kwargs) calls
job(mesh_env, **kwargs) on every rank and returns the list of results, each
wait bounded by its own timeout, so that a hang fails one test.
"""

from __future__ import annotations

import os
import pickle
import queue
import struct
import subprocess
import sys
import threading
import traceback
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _send(f, obj) -> None:
    data = pickle.dumps(obj)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _recv(f):
    head = f.read(8)
    if len(head) < 8:
        raise EOFError("worker closed its pipe")
    (n,) = struct.unpack("<Q", head)
    return pickle.loads(f.read(n))


class RankGroup:
    def __init__(self, n: int, tmp: str, timeout: float = 120.0):
        self.n = n
        os.makedirs(str(tmp), exist_ok=True)
        store = os.path.join(str(tmp), f"store{n}")
        if os.path.exists(store):
            os.remove(store)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([ROOT, HERE]))
        self.procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(n), store],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, cwd=ROOT)
            for r in range(n)
        ]
        self.out: list[queue.Queue] = []
        for p in self.procs:
            q: queue.Queue = queue.Queue()
            threading.Thread(target=self._pump, args=(p, q), daemon=True).start()
            self.out.append(q)
        self._collect(timeout, "start")

    @staticmethod
    def _pump(proc, q):
        try:
            while True:
                q.put(_recv(proc.stdout))
        except Exception as e:  # the worker ended
            q.put(("dead", repr(e)))

    def _collect(self, timeout: float, what: str) -> list:
        res = []
        for r, q in enumerate(self.out):
            try:
                status, value = q.get(timeout=timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"rank {r} of {self.n}: no answer to {what} within {timeout} s")
            if status != "ok":
                self.close()
                raise RuntimeError(f"rank {r} of {self.n} failed {what}:\n{value}")
            res.append(value)
        return res

    def run(self, job: str, timeout: float = 120.0, **kwargs) -> list:
        for p in self.procs:
            _send(p.stdin, (job, kwargs))
        return self._collect(timeout, job)

    def close(self) -> None:
        for p in self.procs:
            try:
                _send(p.stdin, None)
                p.stdin.close()
            except Exception:
                pass
        for p in self.procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()


# ----------------------------- jobs (run on every rank) -----------------------------


def _t(a, requires_grad=False):
    import torch

    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(requires_grad)


def _mesh(axes: dict):
    from visualcloze_tpu_torch.parallel import create_mesh

    return create_mesh(device="cpu", **axes)


def _np(t):
    return t.detach().to("cpu").float().numpy()


def job_ring(q, k, v, bias, do, axes):
    """Ring attention on this rank's batch share (dp) and sequence block (cp)
    of the global inputs; returns the block's o, dq, dk, dv and the rank's
    mesh coordinates."""
    from visualcloze_tpu_torch.ops.attention import RingSpec, mha
    from visualcloze_tpu_torch.parallel import constrain_batch
    from visualcloze_tpu_torch.parallel.collectives import own_block

    mesh = _mesh(axes)
    spec = RingSpec(mesh, "cp")
    share = lambda a, dim=2: own_block(constrain_batch(_t(a), mesh), mesh.group("cp"), dim)  # noqa: E731
    qt, kt, vt = (share(a).requires_grad_() for a in (q, k, v))
    b = None if bias is None else share(bias, 1)
    o = mha(qt, kt, vt, b, spec)
    o.backward(share(do))
    return {"coord": mesh.coord, "o": _np(o), "dq": _np(qt.grad), "dk": _np(kt.grad), "dv": _np(vt.grad)}


def _flux(state, cfg, quant=None):
    """The DiT of `state`; quant None, "int8", "int4", "w8a8" or "w8a8_smooth"."""
    import torch

    from visualcloze_tpu_torch.models.flux import build_flux

    flux = build_flux(cfg, "cpu", torch.float32, int8=quant == "int8", int4=quant == "int4",
                      w8a8=quant in ("w8a8", "w8a8_smooth"), smooth=quant == "w8a8_smooth")
    flux.load_state_dict({k: _t(v) for k, v in state.items()})
    return flux


def _lora(tree, requires_grad=True):
    from visualcloze_tpu_torch.models.lora import tree_map

    return tree_map(lambda a: a.requires_grad_(requires_grad), _tensor_tree(tree))


def _tensor_tree(tree):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensor_tree(v) for v in tree]
    return _t(tree)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return None if tree.grad is None else _np(tree.grad)


def job_dit(state, cfg, inputs, lora, weight, axes, mode="fsdp", ring=False, pp_microbatches=None, quant=None):
    """A tiny DiT's forward on this rank's batch share and the LoRA gradients
    of loss = mean(out * weight), averaged as the trainer averages them."""
    import torch

    from visualcloze_tpu_torch.ops.attention import RingSpec
    from visualcloze_tpu_torch.parallel import constrain_batch, shard_lora, shard_params
    from visualcloze_tpu_torch.parallel.pipeline import PipelineSpec
    from visualcloze_tpu_torch.models.lora import tree_leaves
    from visualcloze_tpu_torch.training.step import _sync_grads

    mesh = _mesh(axes)
    flux = shard_params(_flux(state, cfg, quant), mesh, mode=mode)
    tree = shard_lora(_lora(lora, requires_grad=False), mesh)
    for t in tree_leaves(tree):
        t.requires_grad_()
    pp = mesh.shape["pp"]

    def share(a):
        x = constrain_batch(_t(a), mesh)
        return x.chunk(pp)[mesh.coord["pp"]] if pp > 1 else x

    kw = {k: share(v) for k, v in inputs.items()}
    out = flux(**kw, lora=tree, rope_layout="half", attn_impl=RingSpec(mesh) if ring else None,
               pipeline=PipelineSpec(mesh, pp_microbatches) if pp > 1 else None)
    (out * share(weight)).mean().backward()
    leaves = tree_leaves(tree)
    for t in leaves:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    _sync_grads({f"{i}": t.grad for i, t in enumerate(leaves)}, types.SimpleNamespace(mesh=mesh, lora=tree))
    return {"coord": mesh.coord, "out": _np(out), "grads": _grads(tree)}


def job_moe_ep(x, entry, scale):
    """One MoE-LoRA linear's delta and its gradients with the experts split over ep = world."""
    import torch

    from visualcloze_tpu_torch.models.layers import Linear
    from visualcloze_tpu_torch.parallel import create_mesh, shard_lora

    mesh = create_mesh(ep=int(__import__("torch").distributed.get_world_size()), device="cpu")
    e = shard_lora({"lin": _lora(entry, requires_grad=False)}, mesh)["lin"]
    for t in e.values():
        t.requires_grad_()
    d_in, d_out = entry["shared_a"].shape[0], entry["shared_b"].shape[1]
    lin = Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.zero_()
    lin.ep_group = mesh.group("ep")
    xt = _t(x, True)
    y = lin(xt, e, scale)
    y.square().sum().backward()
    return {"y": _np(y), "dx": _np(xt.grad), "grads": _grads(e)}


def job_train(state, cfg, batch, lora, axes, mode, steps, draws, training_type="lora"):
    """`steps` trainer steps (make_train_step) on this rank's batch share;
    returns the losses, the LoRA after them and a digest of the base weights."""
    import torch

    from visualcloze_tpu_torch.models.lora import tree_items
    from visualcloze_tpu_torch.ops.attention import RingSpec
    from visualcloze_tpu_torch.parallel import shard_lora, shard_micro_batches, shard_params
    from visualcloze_tpu_torch.training.step import init_train_state, make_optimizer, make_train_step
    from visualcloze_tpu_torch.transport import create_transport

    mesh = _mesh(axes)
    flux = shard_params(_flux(state, cfg), mesh, mode="sdp" if mode == "sdp" else "fsdp")
    tree = shard_lora(_lora(lora, requires_grad=False), mesh) if training_type == "lora" else None
    opt = make_optimizer(1e-3, 0.0, 2.0)
    st = init_train_state(flux, tree, opt, training_type, mesh=mesh, sdp=mode == "sdp")
    step = make_train_step(create_transport("Linear", "velocity", snr_type="uniform"), opt, training_type,
                           remat=False, compute_dtype=torch.float32, mesh=mesh,
                           attn_impl=RingSpec(mesh) if mesh.shape["cp"] > 1 else None)
    local = shard_micro_batches({k: _t(v) for k, v in batch.items()}, mesh)
    n = mesh.size(("dp", "fsdp", "pp"))
    r = mesh.rank(("dp", "fsdp", "pp"))
    losses, norms = [], []
    for i in range(steps):
        d = [{k: _t(v).chunk(n)[r] for k, v in dr.items()} for dr in draws[i]]
        metrics = step(st, local, draws=d)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    digest = float(sum(p.detach().double().sum() for p in flux.parameters() if not hasattr(p, "to_local")))
    lora_out = {k: _np(v) for k, v in tree_items(st.lora)} if st.lora is not None else None
    return {"losses": losses, "grad_norms": norms, "lora": lora_out, "digest": digest,
            "params_plain": all(not hasattr(p, "to_local") for p in flux.parameters())}


def _tiny_model(mesh=None, ring=False):
    import torch

    from visualcloze_tpu_torch.ops.attention import RingSpec
    from visualcloze_tpu_torch.pipeline import random_components

    return random_components(tiny=True, device="cpu", resolution=64, generator=torch.Generator().manual_seed(0),
                             mesh=mesh, attn_impl=RingSpec(mesh) if ring else None)


def add_random_adapter(model, name="a"):
    """The CLI's --lora NAME=random adapter (rank 4, B drawn), from the same
    seeds on every rank."""
    import torch

    from visualcloze_tpu_torch.models.lora import init_lora, randomize_lora_b

    tree = init_lora(model.flux, 4, generator=torch.Generator().manual_seed(100))
    model.add_adapter(name, randomize_lora_b(tree, torch.Generator().manual_seed(200)))


def job_serve(axes, ring, grid, prompts, steps, adapter=None, seed=1):
    """The tiny pipeline's process_images with its DiT on the mesh (every
    rank runs the query), with a random runtime adapter added after the
    DiT was sharded when `adapter` names it; seed 0 draws a random seed."""
    model = _tiny_model(_mesh(axes), ring)
    if adapter:
        add_random_adapter(model, adapter)
    model.set_grid_size(len(grid), len(grid[0]))
    images = model.process_images(grid, prompts, seed=seed, steps=steps, is_upsampling=False, adapter=adapter)
    return [np.asarray(im) for im in images]


def job_mesh_leader(axes, grid, prompts, steps):
    """serve.py's mesh serving without HTTP: rank 0 submits a query that
    raises on every rank (an adapter no rank holds), then a good one,
    through MeshLeader; the other ranks follow_mesh until rank 0 closes."""
    import torch.distributed as dist

    from visualcloze_tpu_torch.pipeline import PipelinedServer
    from visualcloze_tpu_torch.pipeline.orchestrator import MeshLeader, follow_mesh

    model = _tiny_model(_mesh(axes))
    server = PipelinedServer(model)
    if dist.get_rank() != 0:
        n, failed = follow_mesh(server)
        server.close()
        return {"followed": n, "failed": failed}
    leader = MeshLeader(server)
    kw = dict(grid_size=(len(grid), len(grid[0])), seed=1, steps=steps, is_upsampling=False)
    try:
        leader.submit(grid, prompts, adapter="no-such-adapter", **kw).result()
        error = None
    except Exception as e:  # the frontend answers the client with it
        error = type(e).__name__
    images = leader.submit(grid, prompts, **kw).result()
    leader.close()
    return {"error": error, "images": [np.asarray(im) for im in images]}


def job_encoders_sharded(prompts, rows, min_size):
    """The tiny pipeline's T5, CLIP and VAE with shard_large_params over
    fsdp = world (every tensor of at least min_size values under FSDP2):
    their text features and the VAE's encoding of `rows`."""
    import torch
    import torch.distributed as dist

    from visualcloze_tpu_torch.parallel import shard_large_params

    model = _tiny_model()
    mesh = _mesh({"fsdp": dist.get_world_size()})
    for module in (model.t5.model, model.clip.model, model.ae.encoder):
        shard_large_params(module, mesh, min_size=min_size)
    with torch.no_grad():
        t5 = model.t5(prompts)
        clip = model.clip(prompts)
        z = model.ae.encode_moments(torch.from_numpy(rows))
    return {"t5": _np(t5), "clip": _np(clip), "z": _np(z)}


def job_trainer_cli(argv, root):
    """The trainer CLI's main on this rank (its own copy of the dataset):
    the logged losses and grad norms, the checkpoint's files and the LoRA
    leaves before and after each step (chip_smoke.lora_steps)."""
    from pathlib import Path

    import torch.distributed as dist

    import chip_smoke
    from visualcloze_tpu_torch.training.train import main as train_main

    rank = dist.get_rank()
    config = chip_smoke.write_dataset(Path(root) / f"data{rank}", n=4, size=64)
    with chip_smoke.lora_steps() as snaps:
        out = train_main(argv + ["--data_path", config, "--results_dir", str(Path(root) / "results")])
    ckpt = sorted(Path(out["ckpt_root"]).iterdir())[-1]
    return {"losses": [r["loss"] for r in out["history"]], "grad_norms": [r["grad_norm"] for r in out["history"]],
            "files": sorted(p.name for p in ckpt.iterdir()), "mesh": repr(out["state"].mesh),
            "b_absmax": [r["lora_b_absmax"] for r in out["history"]], "leaves": snaps}


def main() -> None:
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # keep the result pipe clean
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
        _send(stdout, ("ok", rank))
    except Exception:
        _send(stdout, ("err", traceback.format_exc()))
        return
    jobs = {k: v for k, v in globals().items() if k.startswith("job_")}
    while True:
        try:
            msg = _recv(stdin)
        except EOFError:
            break
        if msg is None:
            break
        name, kwargs = msg
        try:
            _send(stdout, ("ok", jobs[name](**kwargs)))
        except Exception:
            _send(stdout, ("err", traceback.format_exc()))
        finally:
            # a job's groups and meshes end with it
            pass
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
