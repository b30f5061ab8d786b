"""Sharding of the DiT, its LoRA and the trainer's batches over a Mesh
(counterpart of visualcloze_tpu/parallel/sharding.py).

JAX annotates every leaf with a PartitionSpec and GSPMD inserts the
collectives. The port shards explicitly, so that the kernels (A, G, G4, H
read raw pointers) only ever see plain local tensors:

  - tp: Megatron tensor parallelism by the JAX package's classification --
    column-parallel qkv, linear1 and mlp "0"; row-parallel proj, linear2 and
    mlp "2"; the rest replicated. Each rank keeps whole heads: its shard of
    a fused qkv is its heads of q, of k and of v, of linear1 those plus its
    slice of the mlp, of linear2 the matching input rows (`tp_index`); a
    contiguous split would not do that. Weights, int8 / int4 / w8a8 codes,
    scales and biases are cut accordingly; models/layers.py runs the
    collectives. The layout is the port's own; parity is judged on outputs.
  - fsdp: FSDP2 `fully_shard` per block and over the root, on the fsdp axis
    (HSDP on dp x fsdp): its unsharded forward parameters are plain tensors.
    The quantized linears' codes and scales are buffers, which FSDP2 does
    not shard; they become frozen parameters first, so that it does.
  - sdp (ZeRO-2): the weights stay replicated over the data axes; the
    trainer shards gradients and optimizer state (training/step.py).
  - ep: a MoE-LoRA tree keeps only this rank's experts (`shard_lora`).
  - pp: a rank keeps only its stage's single blocks (parallel/pipeline.py).

`flux_param_spec` is JAX's table (the same PartitionSpec tuples, on JAX
paths and layouts), kept to document and test the classification.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .mesh import AXES, DATA_AXES, Mesh

_COLUMN_KEYS = ("qkv", "linear1")
_ROW_KEYS = ("proj", "linear2")


def linear_class(path) -> str:
    """'column' | 'row' | 'other' for a linear's path (module names)."""
    for key in path:
        if key in _COLUMN_KEYS:
            return "column"
        if key in _ROW_KEYS:
            return "row"
    for a, b in zip(path, path[1:]):
        if a in ("img_mlp", "txt_mlp"):
            return "column" if b == "0" else "row"
    return "other"


def _divisible(dim: int, mesh: Mesh, axis: str) -> bool:
    return mesh.shape[axis] > 0 and dim % mesh.shape[axis] == 0


def flux_param_spec(path, shape, mesh: Mesh, no_fsdp: bool = False) -> tuple:
    """JAX's PartitionSpec (as a tuple of axis names or None) for the JAX
    leaf at `path` (keys, the leaf name last) of `shape` (JAX layout: w
    (in, out), stacked blocks with a leading depth axis)."""
    path = tuple(str(k) for k in path)
    kind, leaf = linear_class(path), path[-1]
    fsdp = "fsdp" if mesh.shape["fsdp"] > 1 and not no_fsdp else None
    tp = "tp" if mesh.shape["tp"] > 1 else None
    pp = ("pp" if mesh.shape["pp"] > 1 and path[0] == "single_blocks" and shape
          and shape[0] % mesh.shape["pp"] == 0 else None)
    spec: list = [None] * len(shape)
    if leaf in ("w", "w_int8"):
        in_dim, out_dim = shape[-2], shape[-1]
        if pp:
            spec[0] = pp
        if kind == "column":
            if tp and _divisible(out_dim, mesh, "tp"):
                spec[-1] = tp
            if fsdp and _divisible(in_dim, mesh, "fsdp"):
                spec[-2] = fsdp
        elif kind == "row":
            if tp and _divisible(in_dim, mesh, "tp"):
                spec[-2] = tp
            if fsdp and _divisible(out_dim, mesh, "fsdp"):
                spec[-1] = fsdp
        elif fsdp and _divisible(in_dim, mesh, "fsdp"):
            spec[-2] = fsdp
        elif fsdp and _divisible(out_dim, mesh, "fsdp"):
            spec[-1] = fsdp
        return tuple(spec)
    if leaf in ("b", "b_bias", "w_scale"):
        if kind == "column" and tp and _divisible(shape[-1], mesh, "tp"):
            spec[-1] = tp
        if pp and len(shape) > 1:
            spec[0] = pp
        return tuple(spec)
    if leaf in ("a", "shared_a"):
        if fsdp and _divisible(shape[-2], mesh, "fsdp"):
            spec[-2] = fsdp
        if pp and len(shape) > 2:
            spec[0] = pp
        return tuple(spec)
    if leaf in ("expert_a", "expert_b"):
        if mesh.shape["ep"] > 1 and _divisible(shape[-3], mesh, "ep"):
            spec[-3] = "ep"
        if pp and len(shape) > 3:
            spec[0] = pp
        return tuple(spec)
    if pp and len(shape) > 1:
        spec[0] = pp
    return tuple(spec)


_JAX_LEAF = {"weight": "w", "bias": "b"}


def make_flux_shardings(flux: nn.Module, mesh: Mesh, no_fsdp: bool = False) -> dict[str, tuple]:
    """{parameter or buffer name of `flux`: JAX's spec of the JAX leaf it
    converts to} (block leaves stacked over depth, dense weights (in, out))."""
    out = {}
    depth = {"double_blocks": len(flux.double_blocks), "single_blocks": len(flux.single_blocks)}
    for name, t in [*flux.named_parameters(), *flux.named_buffers()]:
        keys = name.split(".")
        shape = tuple(t.shape)
        if keys[-1] == "weight" and t.dim() == 2:
            shape = shape[::-1]
        if keys[-1] == "w_int8" and t.dim() == 2 and shape[0] != shape[1] and _is_kmajor(flux, keys):
            shape = shape[::-1]
        keys[-1] = _JAX_LEAF.get(keys[-1], keys[-1])
        if keys[0] in depth:
            keys.pop(1)
            shape = (depth[keys[0]],) + shape
        out[name] = flux_param_spec(keys, shape, mesh, no_fsdp)
    return out


def _is_kmajor(flux, keys) -> bool:
    from ..models.layers import W8A8Linear

    return isinstance(flux.get_submodule(".".join(keys[:-1])), W8A8Linear)


# ----------------------------- tensor parallelism -----------------------------


def _segments(path, cfg) -> list[int]:
    """The feature segments of a tp linear's sharded side, each cut into tp
    equal parts: q, k, v (and the mlp) of a fused projection."""
    h, mh = cfg.hidden_size, cfg.mlp_hidden_dim
    leaf = path[-1]
    if leaf == "qkv":
        return [h, h, h]
    if leaf == "linear1":
        return [h, h, h, mh]
    if leaf == "linear2":
        return [h, mh]
    if leaf == "proj":
        return [h]
    return [mh]  # mlp "0" / "2"


def tp_index(path, cfg, rank: int, tp: int) -> torch.Tensor:
    """The sharded-side features rank `rank` of `tp` holds (whole heads)."""
    idx, start = [], 0
    for size in _segments(path, cfg):
        if size % tp:
            raise ValueError(f"{'.'.join(path)}: a segment of {size} features does not split over tp={tp}")
        part = size // tp
        idx.append(torch.arange(start + rank * part, start + (rank + 1) * part))
        start += size
    return torch.cat(idx)


def _take(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(dim, idx.to(t.device)).contiguous()


def _set(module: nn.Module, name: str, value: torch.Tensor) -> None:
    old = getattr(module, name)
    if isinstance(old, nn.Parameter):
        setattr(module, name, nn.Parameter(value, requires_grad=old.requires_grad))
    else:
        module._buffers[name] = value


def _shard_linear(lin: nn.Module, kind: str, idx: torch.Tensor, perm: torch.Tensor, group, rank: int) -> None:
    """Cut lin's tensors to tp rank `rank`'s columns (kind "column") or input
    rows `idx`; perm: every rank's rows in rank order (the order the group's
    all-gather concatenates them in), which a w8a8 row shard's a_sinv takes."""
    from ..models.layers import Int4DiTLinear, Int8Linear, Linear, TPShard, W8A8Linear

    col = kind == "column"
    if isinstance(lin, Linear):
        _set(lin, "weight", _take(lin.weight.data, 0 if col else 1, idx))
    elif isinstance(lin, Int8Linear):
        _set(lin, "w_int8", _take(lin.w_int8, 1 if col else 0, idx))
        if col:
            _set(lin, "w_scale", _take(lin.w_scale, 0, idx))
    elif isinstance(lin, W8A8Linear):
        _set(lin, "w_int8", _take(lin.w_int8, 0 if col else 1, idx))
        if col:
            _set(lin, "w_scale", _take(lin.w_scale, 0, idx))
        elif lin.a_sinv is not None:  # the row shard quantizes the gathered inputs, in gather order
            _set(lin, "a_sinv", _take(lin.a_sinv, 0, perm))
    elif isinstance(lin, Int4DiTLinear):
        if col:
            _set(lin, "w_int4", _take(lin.w_int4, 1, idx))
            _set(lin, "w_scale", _take(lin.w_scale, 1, idx))
        else:
            g = lin.group
            groups = idx.reshape(-1, g) if len(idx) % g == 0 else None  # each a run of g rows from a multiple of g
            if groups is None or bool((groups != groups[:, :1] + torch.arange(g)).any() or (groups[:, 0] % g).any()):
                raise ValueError(f"int4 row shard: the rows {int(idx[0])}.. are not whole groups of {g}")
            _set(lin, "w_int4", _take(lin.w_int4, 0, idx[0::2] // 2))
            _set(lin, "w_scale", _take(lin.w_scale, 0, idx[0::g] // g))
    else:
        raise TypeError(f"no tensor-parallel rule for {type(lin).__name__}")
    if col and lin.bias is not None:
        _set(lin, "bias", _take(lin.bias.data, 0, idx))
    full = lin.out_features if col else lin.in_features
    if col:
        lin.out_features = len(idx)
    else:
        lin.in_features = len(idx)
    lin.tp = TPShard(kind, group, idx, full, rank)


def shard_tp(flux: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut every column- and row-parallel linear of the blocks to this tp
    rank's shard and give the blocks their local head counts."""
    from ..models.layers import DoubleBlock, QKNorm, SingleBlock
    from ..models.lora import _is_linear

    tp = mesh.shape["tp"]
    if tp == 1:
        return flux
    cfg, rank, group = flux.cfg, mesh.coord["tp"], mesh.group("tp")
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads={cfg.num_heads} does not split over tp={tp}")
    sharded = set()
    for name, module in list(flux.named_modules()):
        path = tuple(name.split("."))
        if isinstance(module, (DoubleBlock, SingleBlock)):
            module.num_heads = cfg.num_heads // tp
            if isinstance(module, SingleBlock):
                module.hidden_size = cfg.hidden_size // tp
        elif isinstance(module, QKNorm):
            module.tp_group = group
        elif _is_linear(module) and path[0] in ("double_blocks", "single_blocks"):
            kind = linear_class(path)
            if kind != "other":
                idx = tp_index(path, cfg, rank, tp)
                perm = torch.cat([tp_index(path, cfg, r, tp) for r in range(tp)])
                _shard_linear(module, kind, idx, perm, group, rank)
                sharded |= {f"{name}.{leaf}" for leaf in ("weight", "bias") if leaf == "weight" or kind == "column"}
    flux.tp_sharded = sharded  # the parameters that hold this rank's shard only (the clip's norm sums them)
    return flux


# ----------------------------- fsdp / sdp / ep / pp -----------------------------


def _buffers_to_params(module: nn.Module) -> None:
    """Quantized codes and scales (buffers) become frozen parameters, which
    FSDP2 shards."""
    for sub in module.modules():
        for name in list(sub._buffers):
            t = sub._buffers[name]
            if t is not None and name in ("w_int8", "w_int4", "w_scale", "a_sinv"):
                del sub._buffers[name]
                sub.register_parameter(name, nn.Parameter(t, requires_grad=False))


def _fsdp_mesh(mesh: Mesh):
    if mesh.shape["dp"] > 1:
        return mesh.device_mesh["dp", "fsdp"]  # HSDP: replicate over dp, shard over fsdp
    return mesh.device_mesh["fsdp"]


def shard_params(flux: nn.Module, mesh: Mesh, mode: str = "fsdp", param_dtype: torch.dtype | None = None,
                 ep: bool = True) -> nn.Module:
    """Place the DiT on the mesh, in place: tp shards, this pp stage's single
    blocks, then (mode "fsdp", fsdp > 1) FSDP2 over every block and the
    root -- also on a one-rank process group, where it holds the whole
    model, so that one card runs the code path of many. mode "sdp" (ZeRO-2) leaves the weights replicated over the data
    axes; the trainer shards gradients and optimizer state. param_dtype:
    FSDP2's compute dtype for fp32 masters. ep: give every LoRA target the
    ep group (MoE entries then hold this rank's experts)."""
    if mode not in ("fsdp", "sdp"):
        raise ValueError(f"unknown shard_params mode {mode!r}")
    from ..models.lora import _is_linear
    from .pipeline import keep_stage_blocks

    shard_tp(flux, mesh)
    if mesh.shape["pp"] > 1:
        keep_stage_blocks(flux, mesh)
    if ep and mesh.shape["ep"] > 1:
        for module in flux.modules():
            if _is_linear(module):
                module.ep_group = mesh.group("ep")
    one_rank = mesh.device_mesh is not None and mesh.size(AXES) == 1
    if mode == "fsdp" and (mesh.shape["fsdp"] > 1 or one_rank):
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

        _buffers_to_params(flux)
        kw = {"mesh": _fsdp_mesh(mesh)}
        if param_dtype is not None:
            kw["mp_policy"] = MixedPrecisionPolicy(param_dtype=param_dtype, reduce_dtype=torch.float32)
        for block in [*flux.double_blocks, *flux.single_blocks]:
            if any(True for _ in block.parameters()):
                fully_shard(block, **kw)
        fully_shard(flux, **kw)
    return flux


def is_fsdp(module: nn.Module) -> bool:
    """True when FSDP2 manages `module`'s parameters."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in module.parameters())


def shard_lora(lora, mesh: Mesh):
    """A LoRA tree on the mesh: replicated (JAX replicate_tree), except MoE
    expert leaves, which keep this ep rank's experts (axis -3)."""
    ep = mesh.shape["ep"]
    if ep == 1:
        return lora
    rank = mesh.coord["ep"]

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in ("expert_a", "expert_b") and isinstance(v, torch.Tensor):
                    if v.shape[-3] % ep:
                        raise ValueError(f"{v.shape[-3]} experts do not split over ep={ep}")
                    v = v.chunk(ep, dim=-3)[rank].contiguous()
                out[k] = v if isinstance(v, torch.Tensor) else walk(v)
            return out
        return [walk(v) for v in node]

    return walk(lora)


def shard_large_params(module: nn.Module, mesh: Mesh, min_size: int = 1 << 20) -> nn.Module:
    """JAX's FSDP-style sharding of an auxiliary model (the trainer's frozen
    T5, CLIP and VAE): every tensor of at least min_size values is sharded
    over the fsdp axis at rest, the small ones stay replicated. One FSDP2
    group over `module`, so `module` must be what its caller calls (a
    TextEncoder's .model, the VAE's .encoder / .decoder): its forward
    gathers the large tensors, since those models read their children's
    weights directly rather than through the children's forward."""
    if mesh.shape["fsdp"] <= 1:
        return module
    from torch.distributed.fsdp import fully_shard

    _buffers_to_params(module)
    params = list(module.parameters())
    small = {t for t in params if t.numel() < min_size}
    if len(small) < len(params):
        fully_shard(module, mesh=mesh.device_mesh["fsdp"], ignored_params=small)
    return module


def replicate_tree(tree, mesh: Mesh):
    """Make every rank hold rank 0's leaves (in place; returns the tree)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    from ..models.lora import tree_leaves

    with torch.no_grad():
        for t in tree_leaves(tree):
            dist.broadcast(t, src=0)
    return tree


def _batch_axes(mesh: Mesh, b: int, axes=DATA_AXES) -> list[str]:
    """The data axes whose running product divides b (JAX's rule)."""
    out, prod = [], 1
    for a in axes:
        if mesh.shape[a] > 1 and b % (prod * mesh.shape[a]) == 0:
            out.append(a)
            prod *= mesh.shape[a]
    return out


def constrain_batch(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's share of a global batch x over (dp, fsdp), where they divide it."""
    axes = _batch_axes(mesh, x.shape[dim])
    n = mesh.size(axes) if axes else 1
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[mesh.rank(tuple(axes))].contiguous()


def shard_micro_batches(batch: dict, mesh: Mesh) -> dict:
    """An (accum, B, ...) micro-batch dict cut to this rank's share of B:
    over (dp, fsdp), then over pp (the pipeline gathers the pp shares)."""
    out = {}
    for k, v in batch.items():
        v = constrain_batch(v, mesh, dim=1)
        pp = mesh.shape["pp"]
        if pp > 1:
            if v.shape[1] % pp:
                raise ValueError(f"micro-batch {v.shape[1]} does not split over pp={pp}")
            v = v.chunk(pp, dim=1)[mesh.coord["pp"]].contiguous()
        out[k] = v
    return out


__all__ = ["AXES", "constrain_batch", "flux_param_spec", "is_fsdp", "linear_class", "make_flux_shardings",
           "replicate_tree", "shard_large_params", "shard_lora", "shard_micro_batches", "shard_params",
           "shard_tp", "tp_index"]
