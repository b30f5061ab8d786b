"""The device mesh of the port (counterpart of visualcloze_tpu/parallel/mesh.py).

One mesh with the JAX package's axes (pp, dp, fsdp, tp, cp, ep), built on
torch.distributed: a `DeviceMesh` (init_device_mesh with those dim names),
which FSDP2 takes for the fsdp (and dp x fsdp) axes, plus a process group for
every axis and for the two axis sets the trainer reduces gradients over. Ranks are laid
out row-major over AXES, tp, cp and ep innermost, pp outermost, as JAX lays
out its devices.

  - dp: pure data parallelism (the batch is split, weights replicated);
  - fsdp: the batch is split and the DiT's weights are sharded (FSDP2);
  - tp: tensor parallelism, explicit local shards (parallel/sharding.py);
  - cp: the DiT's tokens split over ranks, ring attention between them
    (models/flux.py, ops/ring_attention.py);
  - ep: MoE-LoRA experts split over ranks (models/layers.py);
  - pp: GPipe over the single-block trunk (parallel/pipeline.py).

The process group's backend is NCCL for CUDA devices, gloo only when the
caller asks for the CPU; the one never stands in for the other. A mesh of
size 1 needs no process group (every collective is then the identity).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

AXES = ("pp", "dp", "fsdp", "tp", "cp", "ep")
DATA_AXES = ("dp", "fsdp")  # the axes that split the batch (JAX batch_sharding)
SYNC_AXES = ("pp", "dp", "fsdp")  # the axes trainable gradients are averaged over


def _device_type(device) -> str:
    return torch.device(device).type if device is not None else ("cuda" if torch.cuda.is_available() else "cpu")


class Mesh:
    """A (pp, dp, fsdp, tp, cp, ep) mesh over the ranks of the default group.

    shape: {axis: size}; coord: {axis: this rank's index}; group(axes): the
    process group of the ranks that differ from this one only along `axes`
    (one axis, DATA_AXES or SYNC_AXES; None when they are this rank alone);
    device_mesh: the DeviceMesh, or None for a one-rank mesh."""

    def __init__(self, sizes: dict[str, int], device_type: str):
        self.shape = {a: int(sizes.get(a, 1)) for a in AXES}
        self.device_type = device_type
        n = self.size(AXES)
        self.device_mesh = None
        self._groups: dict[tuple[str, ...], object] = {}
        if n == 1 and not dist.is_initialized():
            self.coord = {a: 0 for a in AXES}
            return
        from torch.distributed.device_mesh import init_device_mesh

        self.device_mesh = init_device_mesh(device_type, tuple(self.shape[a] for a in AXES), mesh_dim_names=AXES)
        grid = np.arange(n).reshape([self.shape[a] for a in AXES])
        rank = dist.get_rank()
        self.coord = dict(zip(AXES, (int(i) for i in np.argwhere(grid == rank)[0])))
        for a in AXES:
            self._groups[(a,)] = self.device_mesh.get_group(a) if self.shape[a] > 1 else None
        for axes in (DATA_AXES, SYNC_AXES):
            self._groups[axes] = self._new_groups(grid, axes)

    def _new_groups(self, grid: np.ndarray, axes: tuple[str, ...]):
        """Create (collectively, on every rank) the groups spanning `axes`;
        return this rank's (None when it spans one rank)."""
        if self.size(axes) == 1:
            return None
        keep = [AXES.index(a) for a in axes]
        rest = [i for i in range(len(AXES)) if i not in keep]
        blocks = np.transpose(grid, rest + keep).reshape(-1, self.size(axes))
        mine = None
        for ranks in blocks:
            g = dist.new_group(sorted(int(r) for r in ranks))
            if dist.get_rank() in ranks:
                mine = g
        return mine

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))

    def rank(self, axes) -> int:
        """This rank's index along `axes` (row-major, the group's rank order)."""
        axes = (axes,) if isinstance(axes, str) else axes
        r = 0
        for a in axes:
            r = r * self.shape[a] + self.coord[a]
        return r

    def group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.size(axes) == 1:
            return None
        if axes not in self._groups:
            raise KeyError(f"no process group for {axes}: the mesh holds one per axis, {DATA_AXES} and {SYNC_AXES}")
        return self._groups[axes]

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(f"{a}={self.shape[a]}" for a in AXES) + f", {self.device_type})"


def create_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, cp: int = 1, ep: int = 1, pp: int = 1,
                device=None) -> Mesh:
    """A (pp, dp, fsdp, tp, cp, ep) mesh over the process group's ranks
    (initialize_distributed first). Its product must not exceed the world
    size (JAX's check), and it must equal it: a rank outside the mesh would
    have no place in it. device: the devices' type (default cuda when
    present); a CUDA mesh needs the NCCL backend."""
    sizes = dict(pp=pp, dp=dp, fsdp=fsdp, tp=tp, cp=cp, ep=ep)
    n = int(np.prod(list(sizes.values())))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"mesh {pp}x{dp}x{fsdp}x{tp}x{cp}x{ep}={n} exceeds {world} devices")
    if n < world:
        raise ValueError(f"mesh {pp}x{dp}x{fsdp}x{tp}x{cp}x{ep}={n} leaves ranks of the {world} without a place")
    device_type = _device_type(device)
    if dist.is_initialized():
        backend = dist.get_backend()
        want = "nccl" if device_type == "cuda" else "gloo"
        if backend != want:
            raise ValueError(f"a {device_type} mesh needs the {want} backend, the process group runs {backend}")
    return Mesh(sizes, device_type)


def auto_mesh(n_devices: int | None = None, mode: str = "inference", device=None) -> Mesh:
    """JAX's defaults: inference all-tp, training all-fsdp, over the world."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if mode == "inference":
        return create_mesh(tp=n, device=device)
    return create_mesh(fsdp=n, device=device)


def launch_env(env=None) -> tuple[int, int, int] | None:
    """(rank, world size, local rank) from torchrun's RANK / WORLD_SIZE /
    LOCAL_RANK or SLURM's SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID, or None
    when neither launched this process."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0))
    if int(env.get("SLURM_NTASKS", "1")) > 1 and "SLURM_PROCID" in env:
        return int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]), int(env.get("SLURM_LOCALID", 0))
    return None


def initialize_distributed(device=None) -> tuple[int, int, int]:
    """Join the launcher's process group; returns (rank, world, local rank).

    Does nothing (and returns (0, 1, 0)) in a process no launcher started.
    Under torchrun (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) or SLURM
    (SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID; MASTER_ADDR/PORT default to
    localhost:29500) it initialises the default group -- NCCL on CUDA, gloo
    only for device "cpu" -- and, on CUDA, selects the local rank's card."""
    if dist.is_initialized():
        env = launch_env()
        return dist.get_rank(), dist.get_world_size(), env[2] if env else 0
    env = launch_env()
    if env is None:
        return 0, 1, 0
    rank, world, local = env
    device_type = _device_type(device)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu for a gloo group on the CPU")
        torch.cuda.set_device(local)
    os.environ.setdefault("MASTER_ADDR", "localhost")
    os.environ.setdefault("MASTER_PORT", "29500")
    kwargs = {}
    if device_type == "cuda":
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://",
                            rank=rank, world_size=world, **kwargs)
    return rank, world, local


def replicated(mesh: Mesh):
    """Placements of a tensor replicated over every axis (DTensor's spelling
    of JAX's NamedSharding(mesh, P()))."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in AXES)


def batch_sharding(mesh: Mesh):
    """Placements of a batch split over dp and fsdp (dim 0), replicated over
    the other axes (JAX's P(("dp", "fsdp")))."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if a in DATA_AXES else Replicate() for a in AXES)
