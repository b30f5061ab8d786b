"""The FLUX flow-matching DiT (counterpart of visualcloze_tpu/models/flux.py).

The 19 double and 38 single blocks are modules in nn.ModuleLists (the JAX
package stacks their parameters and scans). LoRA is an optional tree passed
to `forward` (models/lora.py), its block entries one per block. Under
training each block can be checkpointed (`remat`), as JAX's jax.checkpoint
around the scanned block body:
  - remat_policy None: recompute the whole block in the backward;
  - "dots": keep the matmul outputs (aten mm/addmm, JAX's
    dots_with_no_batch_dims_saveable) and recompute the rest, with
    torch.utils.checkpoint's selective checkpointing;
  - "dots_split": two checkpointed segments per block with the attention
    call between them, so the attention's own saved tensors (rotated q, k,
    v, o, lse) are kept and its forward is not rerun.
`attn_impl` (None: the kernels; or an ops.attention.RingSpec: ring
attention over the cp axis) reaches every block. Under a RingSpec each cp
rank keeps its block of the txt tokens and of the img tokens (with their
ids and masks) from the input embedding to the final layer, so every
linear, norm and modulation runs on L / cp tokens; the velocity is gathered
whole at the end (its gradient: this rank's block), and the parameters'
gradients are this rank's tokens' share, which the trainer sums over cp
(training/step.py). `pipeline` (a
parallel.pipeline.PipelineSpec) runs the single-block trunk as a GPipe
pipeline over the pp axis (JAX flux_apply_pp); the embedders, the double
blocks and the final layer then run on this rank's share of the batch.
`collect_a8_stats` (no remat) also returns the SmoothQuant calibration
statistics: the per-input-channel absmax of every w8a8 linear's input, one
tree per block (layers.py). No activation capture.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..config import FluxConfig
from ..ops.attention import RingSpec
from ..ops.rope import embed_nd
from ..ops.schedule import timestep_embedding
from ..parallel.collectives import all_reduce_, gather_cat, group_size, own_block
from ..utils import tracing
from .init import init_linears_, materialize, swap_modules
from .lora import tree_map
from .layers import (DoubleBlock, Int4DiTLinear, Int8Linear, LastLayer, Linear, MLPEmbedder, SingleBlock,
                     W8A8Linear)

REMAT_POLICIES = (None, "dots", "dots_split")
# the token-dim linears of the blocks, which w8a8 quantizes (JAX quant._A8_KEYS):
# qkv and proj of each stream, its mlp's "0" and "2", linear1 and linear2;
# the modulation, embedder and final-layer linears stay weight-only int8
A8_KEYS = frozenset({"qkv", "proj", "0", "2", "linear1", "linear2"})
_dots_context = functools.partial(
    create_selective_checkpoint_contexts, [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
)


def _cp_group(attn_impl):
    """The process group a RingSpec splits the sequence over, else None."""
    return attn_impl.mesh.group(attn_impl.axis) if isinstance(attn_impl, RingSpec) else None


def _checkpointed(fn, policy: str | None):
    """fn run under a non-reentrant checkpoint; "dots" keeps matmul outputs."""
    kwargs = {"context_fn": _dots_context} if policy is not None else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kwargs)


class Flux(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.img_in = Linear(cfg.in_channels, h)
        self.txt_in = Linear(cfg.context_in_dim, h)
        self.time_in = MLPEmbedder(256, h)
        self.vector_in = MLPEmbedder(cfg.vec_in_dim, h)
        self.guidance_in = MLPEmbedder(256, h) if cfg.guidance_embed else None
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg) for _ in range(cfg.depth))
        self.single_blocks = nn.ModuleList(SingleBlock(cfg) for _ in range(cfg.depth_single_blocks))
        self.final_layer = LastLayer(cfg)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "Flux":
        """Random weights as the JAX package's init_flux draws them (other numbers)."""
        init_linears_(self, generator)
        for name, p in self.named_parameters():
            if name.endswith(("q_scale", "k_scale")):
                p.fill_(1.0)
        return self

    def rope_tables(self, img_ids, txt_ids, attn_impl=None):
        """The RoPE tables (cos, sin) of the joint sequence's ids: fixed over
        a query's denoise loop, so the serving loop builds them once and
        passes them to forward as `pe`. Under a RingSpec, this rank's block
        of the txt and of the img tokens, as forward keeps them."""
        seq = _cp_group(attn_impl)
        if group_size(seq) > 1:
            img_ids, txt_ids = own_block(img_ids, seq, 1), own_block(txt_ids, seq, 1)
        return embed_nd(torch.cat([txt_ids, img_ids], dim=1), self.cfg.axes_dim, self.cfg.theta)

    def embed_inputs(self, img, img_ids, txt, txt_ids, timesteps, y, txt_mask, img_mask, guidance,
                     lora=None, lora_scale: float = 1.0, pe=None):
        """Token embeddings, the modulation vector, RoPE tables (`pe` when
        given) and the joint attention mask (None when nothing is padded)."""
        cfg = self.cfg
        l = lora or {}
        img = self.img_in(img, l.get("img_in"), lora_scale)
        vec = self.time_in(timestep_embedding(timesteps, 256), l.get("time_in"), lora_scale)
        if cfg.guidance_embed:
            if guidance is None:
                raise ValueError("guidance_embed model needs a guidance vector")
            vec = vec + self.guidance_in(timestep_embedding(guidance, 256), l.get("guidance_in"), lora_scale)
        vec = vec + self.vector_in(y, l.get("vector_in"), lora_scale)
        txt = self.txt_in(txt, l.get("txt_in"), lora_scale)
        if pe is None:
            pe = embed_nd(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dim, cfg.theta)
        b, txt_len = txt.shape[:2]
        if txt_mask is None and img_mask is None:
            attn_mask = None
        else:
            if txt_mask is None:
                txt_mask = torch.ones((b, txt_len), dtype=torch.int32, device=txt.device)
            if img_mask is None:
                img_mask = torch.ones((b, img.shape[1]), dtype=torch.int32, device=img.device)
            attn_mask = torch.cat([txt_mask, img_mask], dim=1)
        return img, txt, vec, pe, attn_mask

    def forward(self, *, img, img_ids, txt, txt_ids, timesteps, y, txt_mask=None, img_mask=None,
                guidance=None, lora=None, lora_scale: float = 1.0, remat: bool = False,
                remat_policy: str | None = None, rope_layout: str = "half", collect_a8_stats: bool = False,
                attn_impl=None, pipeline=None, pe=None):
        """(B, L_img, in_channels) tokens -> (B, L_img, out_channels) velocity.
        txt/img masks are (B, L) int {1 real, 0 pad}; timesteps (B,) flux time;
        rope_layout "half" (the serving layout) or "interleaved"
        (the reference's, which the trainer keeps). collect_a8_stats: returns
        (velocity, {"double_blocks": [per-block stats], "single_blocks": [...]}).
        pe: the RoPE tables from rope_tables(img_ids, txt_ids, attn_impl),
        built here from the ids when None. Traced as the spans "dit.embed",
        "dit.double_blocks", "dit.single_blocks" and "dit.final"."""
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat_policy!r}")
        if collect_a8_stats and remat:
            raise ValueError("collect_a8_stats is a calibration (no-remat) mode")
        if pipeline is not None and collect_a8_stats:
            raise ValueError("collect_a8_stats does not run through the pipelined trunk")
        l = lora or {}
        seq = _cp_group(attn_impl)
        if group_size(seq) > 1:
            n = group_size(seq)
            if img.shape[1] % n or txt.shape[1] % n:
                raise ValueError(f"{img.shape[1]} img and {txt.shape[1]} txt tokens do not split over cp={n}")
            img, img_ids, img_mask, txt, txt_ids, txt_mask = (
                None if t is None else own_block(t, seq, 1)
                for t in (img, img_ids, img_mask, txt, txt_ids, txt_mask))
        with tracing.span("dit.embed"):
            img, txt, vec, pe, attn_mask = self.embed_inputs(
                img, img_ids, txt, txt_ids, timesteps, y, txt_mask, img_mask, guidance, l, lora_scale, pe
            )
        txt_len = txt.shape[1]
        seg = None
        if remat and remat_policy == "dots_split":
            seg = functools.partial(_checkpointed, policy="dots")

        stats = {"double_blocks": [], "single_blocks": []}

        def run(block, stack, *args):
            fn = functools.partial(block, lora_scale=lora_scale, rope_layout=rope_layout, seg=seg,
                                   attn_impl=attn_impl)
            if collect_a8_stats:
                out, st = fn(*args, collect_stats=True)
                stats[stack].append(st)
                return out
            if remat and seg is None:
                fn = _checkpointed(fn, remat_policy)
            return fn(*args)

        d_lora = l.get("double_blocks") or [None] * len(self.double_blocks)
        s_lora = l.get("single_blocks") or [None] * len(self.single_blocks)
        with tracing.span("dit.double_blocks"):
            for block, bl in zip(self.double_blocks, d_lora):
                img, txt = run(block, "double_blocks", img, txt, vec, pe, attn_mask, bl)
        with tracing.span("dit.single_blocks"):
            x = torch.cat([txt, img], dim=1)
            if pipeline is not None:
                from ..parallel.pipeline import pipeline_single_trunk

                x = pipeline_single_trunk(self, pipeline, x, vec, pe, attn_mask, l.get("single_blocks"),
                                          lora_scale=lora_scale, attn_impl=attn_impl, remat=remat,
                                          remat_policy=remat_policy, rope_layout=rope_layout)
            else:
                for block, bl in zip(self.single_blocks, s_lora):
                    x = run(block, "single_blocks", x, vec, pe, attn_mask, bl)
        with tracing.span("dit.final"):
            out = gather_cat(self.final_layer(x[:, txt_len:], vec, l.get("final_layer"), lora_scale,
                                              collect_stats=collect_a8_stats), seq, 1, backward="slice")
        if collect_a8_stats and group_size(seq) > 1:  # the absmax over every rank's tokens
            tree_map(lambda t: all_reduce_(t, seq, torch.distributed.ReduceOp.MAX), stats)
        return (out, stats) if collect_a8_stats else out

    def forward_cfg(self, *, cfg_scale: float, **kwargs) -> torch.Tensor:
        """Classifier-free-guidance forward (JAX flux_apply_cfg): the batch is
        [cond | uncond] halves, run as one forward(**kwargs); returns
        [uncond + cfg_scale * (cond - uncond) | uncond]."""
        cond, uncond = self(**kwargs).chunk(2, dim=0)
        return torch.cat([uncond + cfg_scale * (cond - uncond), uncond], dim=0)


def a8_linears(flux: Flux):
    """(parent module, child name, linear) of every w8a8 linear position:
    the A8_KEYS children inside the double and single blocks."""
    for block in [*flux.double_blocks, *flux.single_blocks]:
        for parent in list(block.modules()):
            for name, child in list(parent.named_children()):
                if name in A8_KEYS and isinstance(child, (Linear, Int8Linear, W8A8Linear)):
                    yield parent, name, child


def build_flux(cfg: FluxConfig, device, dtype, int8: bool = False, w8a8: bool = False,
               smooth: bool = False, int4: bool = False) -> Flux:
    """A Flux with uninitialized weights of `dtype` allocated on `device`.
    int8: every linear an Int8Linear (the JAX package's quantize_flux_int8
    tree: int8 codes, fp32 scales, biases and norm scales in `dtype`).
    w8a8: the quantize_flux_w8a8 tree, the same with a W8A8Linear at every
    a8_linears position (with an a_sinv buffer if smooth:
    quantize_flux_w8a8_smooth's). int4: every linear an Int4DiTLinear (the
    quantize_flux_int4 tree: packed codes, fp32 scales per INT4_GROUP input
    rows, the group shrunk to divide small input dims)."""

    def ctor():
        flux = Flux(cfg)
        if int4:
            swap_modules(flux, Linear, lambda m: Int4DiTLinear(m.in_features, m.out_features, m.bias is not None))
        if int8 or w8a8:
            swap_modules(flux, Linear, lambda m: Int8Linear(m.in_features, m.out_features, m.bias is not None))
        if w8a8:
            for parent, name, m in list(a8_linears(flux)):
                setattr(parent, name, W8A8Linear(m.in_features, m.out_features, m.bias is not None, smooth))
        return flux

    return materialize(ctor, device, dtype)
