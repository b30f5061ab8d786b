#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each followed by one flushed JSON line on stdout:
  env        the card (nvidia-smi name and power limit), torch and CUDA versions;
  build      the CUDA kernels of visualcloze_tpu_torch/csrc, one nvcc per source
             in parallel, with ptxas' register/spill report (a spill fails);
  kernel     each kernel against its plain PyTorch version at main-path shapes
             (bf16 N(0,1) inputs, on the card): max |err| beside the tolerance
             (attention forward and backward: 4 bf16 ulps at the largest
             output; E's LSE: 2^-13 of its largest magnitude; padded keys
             against fp32 attention that never sees them; conv: 1% of the
             largest output; the int8 matmul G: 4 bf16 ulps of the largest
             output, at the int8 DiT's linear1, linear2, qkv, modulation
             (M = 1), final_layer.linear (N = 64), a ragged M and the
             512-token text stream's proj and linear2; G's launches timed
             as a replayed CUDA graph, as the GEMV is shorter than its
             wrapper's host-side launch; the int4 matmul G4 likewise, at
             the same shapes, group 128, and at the edges of its 2-CTA
             clusters (M 17 and 129: a pair with an empty or nearly empty
             peer; M 257: an odd count of tiles, also at N 64), with the
             library calls torch._weight_int4pack_mm and F.linear on a
             dequantized copy; the w8a8 matmul H and the
             activation quantize I bit for bit (tolerance 0): H at the w8a8
             DiT's six linear shapes at M = 3968, the 3456-token image
             stream's and the 512-token text stream's qkv, the text
             stream's mlp.2, a ragged M and its clusters' edges (M 7 at N
             64, 129, 257 and 333), timed as a replayed CUDA graph, I at K
             = 3072, 12288 and 15360
             in fp32 and bf16, with and without a_sinv, an all-zero row in
             each, and at 7 rows; H's library call torch._int_mm, also
             followed by the plain rescale, both graph-timed too, int8
             dense peak 1,979 TOP/s), the
             kernel's, the plain version's and a PyTorch library call's ms
             (CUDA events; the backward's library call is SDPA's backward,
             timed as forward + backward minus forward; G's is
             torch._weight_int8pack_mm where it runs, else F.linear on a
             dequantized bf16 copy), and the bound from the H100 SXM data
             sheet (989 TFLOP/s bf16 dense, 3.35 TB/s); every kernel also
             reports share_of_bound and whether two launches gave the
             same bits (deterministic, required); C runs at 6912 and 16384
             (a 384x1152 row, the 1024^2 image), 2 x 1100 and 17 (shorter
             than a tile); B at the VAE's level shapes, its 512->256 and
             256->128 transitions and a ragged 37x91 image with a large b0
             (the border zeroed after swish); D/E and F run at 3968, 5760
             padded and 7680 (the trainer's longest sequence) with a bias,
             D/E also with 300 queries against 1000 keys; A and D/E also
             with keys masked inside a sequence 32 key tiles long (a block
             of a third of the keys in the middle, every third key); the
             DiT blocks' fused passes, each timed as a replayed CUDA graph
             with no library call: J (LayerNorm + modulate) with bf16 and
             fp32 output at 3968, 3456, 512 and 4608 tokens, the final
             layer's image rows of a batch of 2 and 7 rows (2 bf16 ulps of
             the largest output; fp32: 2^-16 of it), K (gated residual) bit
             for bit, L (head split + q/k RMSNorm) from linear1's 21504-
             column rows, the double block's streams into a joint 3968-token
             buffer at offsets 512 and 0, 4608 tokens, a tp = 2 shard's 12
             heads and 7 rows at an offset (q, k within 2 ulps, v bit for
             bit, the rest of the buffer untouched), M (head merge, padded
             rows zeroed, + gelu of linear1's last 12288 columns) at 3968
             with 64 padded rows, the merge alone, 4608, 5760 with 512
             padded rows and 7 rows (the merge bit for bit, the gelu within
             one bf16 ulp of each element); their backward kernels, graph-
             timed, each against its plain backward and against
             torch.autograd.grad of the plain forward, deterministic: J'
             at 3968, 3456, 512 tokens, 3968 at batch 2 (the column sums
             per batch element), the final layer's strided image rows at
             batch 2, an fp32 dy and 7 rows (dx within 2 bf16 ulps, dshift
             and dscale within 2^-16 of the largest sum of |terms|), K' at
             3968, 3456, 512, 3968 batch 2 and 7 rows batch 2 (dy bit for
             bit, dgate as J''s sums), L' into linear1's 21504-column
             gradient buffer (its other columns untouched), from the joint
             3968-token dq, dk, dv at offsets 512 and 0, at batch 2, a tp =
             2 shard and 7 rows (q and k's columns within 2 ulps, v's bit
             for bit, the q/k scales' sums as J''s), M' with gelu and 64
             padded rows, the merge alone, batch 2, 5760 with 512 padded
             rows and 7 rows (dx bit for bit, dg within one ulp of each
             element, floored at 2^-16 of the largest, written into
             linear1's gradient buffer);
  ring_chunks  the ring attention's own schedule (ops/ring_attention.py) in
             one process over P = 2 and 4 chunks of the full-width (1, 24,
             L, 128) bf16 sequence at L = 3968 (the default query) and 5760
             (the 3x3 grid), keys padded, rotated by indexing: o, dq, dk, dv
             against whole-sequence E and F within their 4 bf16 ulps, E,
             F-dq and F-dkv P^2 launches each and no other kernel; one
             chunk pair at cp = 4 (992 and 1440 tokens) timed beside the
             plain versions, SDPA and the bound;
  tp_shards  the port's tensor-parallel int8, int4 and SmoothQuant w8a8
             linears (G, G4, H) at the tp = 2 shard shapes of linear1 and
             qkv (column halves: whole heads of q, k and v, the mlp's
             slice) and linear2 (row halves), 3968 tokens: each rank's copy
             cut by parallel.sharding._shard_linear and run in turn, the
             collectives done by indexing, against the unsharded module
             (column scattered back within 4 bf16 ulps, row summed within 8);
  grad_reference  one full-width double block and one single block with a
             rank-128 LoRA: the LoRA gradients through kernels E, J-M forward
             and F, J'-M' backward (J-M and J'-M' 5, 5, 3, 2 each) against
             the all-plain route (E and F's plain versions, the blocks'
             plain code under autograd: no launch) (relative RMS);
  reference  the full-width DiT and VAE through the kernels against the same
             modules through the plain versions, on a small input;
  cfg_forward  Flux.forward_cfg at batch 2 ([cond | uncond], 3456 image +
             512 text tokens, full width and depth, no grad: A 57, J-M 115 /
             114 / 76 / 57 launches) against the plain route and against two
             batch-1 forwards combined (relative RMS);
  request    full-width random weights (FLUX.1-Fill 19+38 blocks at hidden
             3072, T5-XXL, CLIP-L, VAE) in bf16; two queries through
             VisualClozeModel.process_images: a 2x3 grid at 384 with SDEdit
             (30 + 10 steps, the default query) and a 3x3 grid at 384 without
             (5760 tokens with padding, so kernel A's bias path runs);
  serve      two random runtime adapters on that stack (init_lora +
             randomize_lora_b: r64 rank 64, r128 rank 128, fixed seeds), the
             HTTP frontend over PipelinedServer(max_inflight=2) on 127.0.0.1;
             the default query POSTed by four client threads at once (no
             adapter, r64, r128, no adapter), the same four again through a
             server of depth 1 (arrival order), then the r64 query through
             process_images: the adapter-free answers equal request 1's
             images bit for bit, the HTTP r64 answer the sequential one, the
             depth-1 answers the depth-2 ones, each adapter moves the image;
             A, B and C launch nine times request 1's count, no other kernel;
             each request's latency at both depths, the wall seconds and mean
             latency of the four, the /metrics counters, the adapters' bytes
             and the resident memory with them;
  quant_reference  the bf16 DiT quantized beside itself (quantize_flux_int8):
             the int8 DiT through G vs through G's plain version, and vs the
             bf16 DiT (correlation, as the JAX package's int8 test);
  quant_reference_w8a8  the same for the w8a8 DiT (I, H and G vs their
             plain versions) and for the SmoothQuant w8a8 DiT calibrated on
             the default query (30 steps, statistics every 5th);
  samplers_sde  a 2x2 query at 384 through Sampler.sample_sde (Euler-Maruyama
             and Heun, 10 points), each twice from one generator seed: DiT
             evaluations 9 and 17 (A's launches / 57), bit-equal runs;
  likelihood sample_ode_likelihood on a 2x2 grid at 256, 3 steps: the
             divergence by one vjp, so E and F (57 x 3 each), no A, J-M
             115 / 114 / 76 / 57 x 3 and J'-M' 114 / 114 / 75 / 57 x 3 (the
             vjp is over the latent: the first double block's text stream
             carries no gradient);
  quant_reference_int4  the bf16 DiT quantized beside itself to int4
             (quantize_flux_int4): G4 vs its plain version (5% RMS),
             correlation with the bf16 DiT > 0.5; the copy parked in host
             memory;
  bfl_route  (Fill part) prepare_fill on the bf16 Fill DiT at 512^2, 10
             Euler steps, decoded and saved through the ViT-base NSFW gate
             and the watermark;
  request_w8a8  the bf16 DiT swapped for its w8a8 copy (bf16 T5, CLIP-L and
             VAE) serving request 1's query: I and H 228 times per DiT
             evaluation, G 86; stage seconds beside request 1's;
  request_int4  the w8a8 DiT swapped for the int4 copy, request 1's query:
             G4 314 x 38 times, no G, H or I, A, B and C as in request 1;
             resident and peak memory;
  bfl_route  the serving DiT freed: Canny and Depth queries (the full-width
             DepthAnything-large tower at 518) on a flux-dev-depth DiT
             (in_channels 128, seed 2), then a Redux query (SigLIP so400m
             at 384: 729 tokens after the 512 text tokens) on a flux-dev
             DiT (seed 3), each as the Fill one; one line with the Fill
             part: finite outputs, A, B and C in each query, the towers'
             seconds, the watermark's score read back;
  request_int8  the bf16 model freed, the single-card int8 stack
             (synthetic_full_components: int8 DiT through G, int4 T5-XXL,
             int8 CLIP-L, bf16 VAE) serving request 1's query, seed 1;
             resident and peak memory, stage seconds beside request 1's;
  train      the serving model freed, the trainer's main at full width
             (rank-128 LoRA, grid 384, 3 steps of 2 micro-batches, per-block
             remat) on a synthetic Graph200K dataset written from seed 0; one
             line per step (loss, grad norm, tokens, Dataload/Encode/Train
             seconds, peak memory), then the checkpoint's files;
  query_interleaved  the trainer's base components (optimizer state freed)
             serving a 2x2 grid at 384 in the interleaved layout (kernel D);
  moe_train  the trainer's main at full width and depth with MoE-LoRA (4
             experts of rank 32 and the shared pair on every linear, the
             top-2 gate), 2 steps: finite losses, every expert and gate leaf
             moved, E and F launches, seconds per step, peak memory;
  dist_one_rank  the trainer as torchrun starts it on one card (RANK 0 of
             WORLD_SIZE 1): an NCCL group, the mesh over it, the DiT under
             FSDP2 (shard_params mode "fsdp"), 2 steps, then the same 2
             steps with no process group: the first loss equal bit for
             bit, every LoRA leaf's first gradient but those upstream of
             vec equal bit for bit (its norm); the grad norms, the second
             loss and each LoRA leaf's change per step (those upstream of
             vec apart) within DIST_BOUNDS; J-M and J'-M' at their
             counts; the DiT's depth cut to 4 + 8 blocks (printed), its
             width kept;
  checkpoint_write  the seed-0 bf16 stack (the `init` phase's) written as the
             reference checkpoint files under build/ckpt_roundtrip/: the DiT
             put back in the reference channel order as one BFL safetensors
             file (read back bit for bit), a rank-256 reference-trainer LoRA
             .pth (B and its bias N(0, 0.02)), the VAE, T5-XXL and CLIP-L as
             HF shards; bytes, seconds, disk usage before and after;
  load_checkpoint  build_visualcloze on those files (FLUX_DEV_FILL, AE,
             T5_PATH, CLIP_PATH): the LoRA folded on the card, the DiT
             permuted to the half layout; every tensor without LoRA bit-
             identical to the file's, every folded one within 1 bf16 ulp of
             the float64 fold; load seconds, resident and peak memory, the
             host's resident set before the load and its peak (sampled);
  request_loaded  request 1's query on the loaded stack: A, B and C launch as
             often as in request 1, no other kernel;
  solvers    a 2x2 query at 384 without SDEdit on 10 grid points with heun,
             ab2, cached:3 and dopri5: DiT evaluations (A's launches / 57)
             as each solver's schedule says (dopri5: its own count);
  load_checkpoint_int8  the same files with quantize="int8" and an int4 T5,
             the default query: G 314 times per DiT evaluation;
  load_checkpoint_w8a8_smooth  the same files with quantize="w8a8_smooth":
             the folded bf16 DiT calibrated at load (a blank 2x2 grid, 30
             steps: 29 evaluations through A, no quantized kernel), then the
             default query: I and H 228 times per evaluation, G 86;
  load_snapshot  the BFL file removed, the seed-0 DiT written as a diffusers
             snapshot (transformer/ shards, model_index.json) and loaded:
             every tensor bit-identical to the seed-0 DiT it was written
             from (rebuilt after the load); a 2x2 Euler query;
  diffusers_api  VisualClozePipeline over that model: the reference LoRA
             .pth as the runtime adapter "ref" (load_lora_weights with
             adapter_name), a 2x2 call at 10 steps with
             upsampling_strength=0 with and without it, then the file folded
             (load_lora_weights without a name) and the call again: the
             adapter's image is closer to the folded one than half its
             distance to the base image (mean |Δ|, 0-255).
The checkpoint files are removed after the last of them, also on failure.
Launch counters are zeroed just before each main-path phase (ring_chunks'
two ring schedules at each length, moe_train, dist_one_rank's NCCL run, request,
serve, samplers_sde, likelihood, request_w8a8, request_int4, each query of
bfl_route, request_int8, train, query_interleaved, request_loaded,
solvers, load_checkpoint_int8, the calibrating load and the query of
load_checkpoint_w8a8_smooth, load_snapshot, diffusers_api) and read just after; G runs in
the int8 and w8a8 phases only, H and I in the w8a8 ones only, G4 in
request_int4 only; J, K, L and M in every serving phase, 115, 114, 76 and
57 times per DiT evaluation (A's or D's launches / 57); under autograd
(grad_reference, likelihood, train, moe_train, dist_one_rank) J-M as often
per pass over the blocks (twice an evaluation under the trainer's remat
"full", the final layer's J once) and J'-M' as often per backward
(autograd_expected: exactly); never in the calibration evaluations that
collect statistics (counted apart by wrapping Flux.forward in
load_checkpoint_w8a8_smooth). reference and cfg_forward swap A, B, C and
J-M for their plain versions for their plain runs. Then the kernels
line, the nvidia-smi
line, and {"ok": true, "device": ...} last. Exits non-zero, with no result
line, without a CUDA device, outside a checkout of the repository, or when
any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
import traceback

T0 = time.perf_counter()
TIME_LIMIT_S = 1200
PEAK_FLOPS = 989e12  # H100 SXM, bf16 dense
PEAK_INT8_OPS = 1979e12  # H100 SXM, int8 dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# the trainer's per-block remat: "full" (recompute each block) keeps the
# peak far under 80 GB at the largest Graph200K grid at 384 (see PERF.md)
REMAT_POLICY = "full"
REPLACES = {
    "flash_attn_rope": "visualcloze_tpu/ops/flash_attention.py:487",
    "conv3x3_gn_swish": "visualcloze_tpu/ops/conv2d.py:147",
    "flash_attn_d512": "visualcloze_tpu/ops/flash_attention.py:575",
    "flash_attn_fwd": "visualcloze_tpu/ops/flash_attention.py:838",
    "flash_attn_fwd_lse": "visualcloze_tpu/ops/flash_attention.py:800",
    "flash_attn_bwd_dq": "visualcloze_tpu/ops/flash_attention.py:699",
    "flash_attn_bwd_dkv": "visualcloze_tpu/ops/flash_attention.py:730",
    "int8_matmul": "visualcloze_tpu/ops/int8_matmul.py:52",
    "w8a8_matmul": "visualcloze_tpu/models/layers.py:85",  # linear's w8a8 branch: an XLA fusion, no Pallas kernel
    "act_quant_int8": "visualcloze_tpu/models/quant.py:181",  # likewise
    "int4_matmul": "visualcloze_tpu/models/layers.py:124",  # linear's w_int4 branch (dequant_weight_int4 :358), XLA
    # none: XLA fusions inside double_block :207 and single_block :302, no Pallas kernel
    "layernorm_modulate": "visualcloze_tpu/models/layers.py:145",  # layer_norm + the modulate :247, :273, :330
    "gated_residual": "visualcloze_tpu/models/layers.py:280",  # the gated residuals :280-288, :346
    "qk_norm_split": "visualcloze_tpu/models/layers.py:195",  # _split_heads + qk_norm :161 / rms_norm :153
    "merge_heads": "visualcloze_tpu/ops/attention.py:176",  # the head merge + concatenate with gelu, layers.py:342
    # their transposes under jax.grad: XLA fusions of the same chains
    "layernorm_modulate_bwd": "visualcloze_tpu/models/layers.py:145",
    "gated_residual_bwd": "visualcloze_tpu/models/layers.py:280",
    "qk_norm_split_bwd": "visualcloze_tpu/models/layers.py:195",
    "merge_heads_bwd": "visualcloze_tpu/ops/attention.py:176",
}
SOURCES = {
    "flash_attn_rope": "visualcloze_tpu_torch/csrc/flash_attn_rope.cu",
    "conv3x3_gn_swish": "visualcloze_tpu_torch/csrc/conv3x3_gn_swish.cu",
    "flash_attn_d512": "visualcloze_tpu_torch/csrc/flash_attn_d512.cu",
    "flash_attn_fwd": "visualcloze_tpu_torch/csrc/flash_attn_rope.cu",
    "flash_attn_fwd_lse": "visualcloze_tpu_torch/csrc/flash_attn_rope.cu",
    "flash_attn_bwd_dq": "visualcloze_tpu_torch/csrc/flash_attn_bwd.cu",
    "flash_attn_bwd_dkv": "visualcloze_tpu_torch/csrc/flash_attn_bwd.cu",
    "int8_matmul": "visualcloze_tpu_torch/csrc/int8_matmul.cu",
    "w8a8_matmul": "visualcloze_tpu_torch/csrc/w8a8_matmul.cu",
    "act_quant_int8": "visualcloze_tpu_torch/csrc/act_quant_int8.cu",
    "int4_matmul": "visualcloze_tpu_torch/csrc/int4_matmul.cu",
    "layernorm_modulate": "visualcloze_tpu_torch/csrc/layernorm_modulate.cu",
    "gated_residual": "visualcloze_tpu_torch/csrc/gated_residual.cu",
    "qk_norm_split": "visualcloze_tpu_torch/csrc/qk_norm_split.cu",
    "merge_heads": "visualcloze_tpu_torch/csrc/merge_heads.cu",
    "layernorm_modulate_bwd": "visualcloze_tpu_torch/csrc/layernorm_modulate_bwd.cu",
    "gated_residual_bwd": "visualcloze_tpu_torch/csrc/gated_residual_bwd.cu",
    "qk_norm_split_bwd": "visualcloze_tpu_torch/csrc/qk_norm_split_bwd.cu",
    "merge_heads_bwd": "visualcloze_tpu_torch/csrc/merge_heads_bwd.cu",
}
# kernel G per DiT evaluation: every linear of the int8 DiT once (19 double
# blocks x 10, 38 single blocks x 3, 8 embedder and 2 final-layer linears);
# kernel A once per block (19 + 38); in the w8a8 DiT kernels I and H each
# once per token-dim block linear (19 x 8 + 38 x 2) and G the other 86
INT8_LINEARS, ATTENTION_CALLS = 314, 57
W8A8_LINEARS = 19 * 8 + 38 * 2
W8A8_KERNELS = ("w8a8_matmul", "act_quant_int8")
# kernels J, K, L and M per DiT evaluation (models/layers.py): J before a double block's qkv and mlp.0 of
# each stream, a single block's linear1 and the final layer's linear; K at a double block's four gated
# residuals and a single block's one; L twice a double block (txt, then img into the joint buffer) and once a
# single block; M once a block. Under autograd the same launches forward and, in the backward, J', K', L' and
# M' as often (autograd_expected). In calibration (the evaluations that collect statistics) the blocks run
# their plain versions: 0.
FUSIONS = ("layernorm_modulate", "gated_residual", "qk_norm_split", "merge_heads")
BACKWARDS = tuple(f"{n}_bwd" for n in FUSIONS)


def fusion_calls(depth: int = 19, depth_single: int = 38) -> dict:
    """J-M's launches in one pass over the blocks (the final layer's J apart)."""
    return {"layernorm_modulate": 4 * depth + depth_single, "gated_residual": 4 * depth + depth_single,
            "qk_norm_split": 2 * depth + depth_single, "merge_heads": depth + depth_single}


FUSION_CALLS = dict(fusion_calls(), layernorm_modulate=fusion_calls()["layernorm_modulate"] + 1)
# the blocks run twice a training evaluation under remat "full" (the forward and its recomputation)
REMAT_PASSES = 2


def autograd_expected(passes: int, evals: int, depth: int = 19, depth_single: int = 38,
                      txt_grad: bool = True) -> dict:
    """J-M's and J'-M''s launches of `evals` DiT evaluations under autograd,
    each differentiated once, whose blocks ran `passes` times in all (the
    final layer runs once an evaluation: its J forward, its J' backward).
    txt_grad False: the text tokens carry no gradient (a vjp over the image
    latent alone), so the first double block's txt stream has none before
    its attention: its qkv's J has no J' and its L' is skipped."""
    per = fusion_calls(depth, depth_single)
    out = {n: per[n] * passes for n in FUSIONS}
    out.update({f"{n}_bwd": per[n] * evals for n in FUSIONS})
    out["layernorm_modulate"] += evals
    out["layernorm_modulate_bwd"] += evals
    if not txt_grad:
        out["layernorm_modulate_bwd"] -= evals
        out["qk_norm_split_bwd"] -= evals
    return out


def autograd_launches(launches: dict) -> dict:
    return {n: launches[n] for n in FUSIONS + BACKWARDS}


def fusions_expected(evals: int) -> dict:
    """J-M's launches for `evals` no-grad DiT evaluations."""
    return {n: FUSION_CALLS[n] * evals for n in FUSIONS}


def fusion_launches(launches: dict) -> dict:
    return {n: launches[n] for n in FUSIONS}


@contextlib.contextmanager
def plain_block_route():
    """The blocks' fused passes as their plain versions, on the no-grad
    forward and under autograd alike (the calibration route without the
    statistics): the entry points the blocks and attention() call swapped,
    so no J-M or J'-M' launches and autograd differentiates the plain code."""
    import torch

    from visualcloze_tpu_torch.models import layers
    from visualcloze_tpu_torch.ops import attention as att
    from visualcloze_tpu_torch.ops import block_fusions as bfu

    def split(streams, heads, cols):
        parts = [bfu.qk_norm_split_plain(x[..., :cols], qs, ks, heads) for x, qs, ks in streams]
        rest = streams[0][0][..., cols:] if len(streams) == 1 and streams[0][0].shape[-1] > cols else None
        return (*(torch.cat(ts, dim=2) for ts in zip(*parts)), rest)

    swaps = [(layers, "apply_layernorm_modulate", bfu.layernorm_modulate_plain),
             (layers, "apply_gated_residual", bfu.gated_residual_plain), (layers, "apply_qk_norm_split", split),
             (att, "apply_merge_heads", bfu.merge_heads_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def elapsed() -> float:
    return time.perf_counter() - T0


def cuda_ms(fn, reps: int, graph: bool = False) -> float:
    """ms per call of fn, by CUDA events around `reps` calls after one more.
    graph: the calls are captured into a CUDA graph and replayed, so a kernel
    shorter than its wrapper's host-side launch is timed on the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    run, calls = fn, reps
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        captured.replay()
        torch.cuda.synchronize()
        run, calls = captured.replay, 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak_ops: float = PEAK_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_ulps_tol(want, ulps: int = 4) -> float:
    """`ulps` bf16 ulps at the output's largest magnitude (8 significant bits):
    the attention kernels round q, k, P and the output to bf16 and sum in
    another order, measured at 1-2 ulps."""
    import math

    top = want.abs().max().item()
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def attention_over_keys(q, k, v, cos, sin, n: int):
    """fp32 softmax(rot(q) rot(k)[:n]^T / sqrt(D)) v[:n]: attention that never
    sees the keys from n on, to hold the padding bias against."""
    import torch

    from visualcloze_tpu_torch.ops import flash_attention as fa

    q32, k32 = fa._rot_half(q.float(), cos, sin), fa._rot_half(k.float(), cos, sin)[..., :n, :]
    s = torch.matmul(q32, k32.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v[..., :n, :].float())


def holes_mask(b: int, L: int):
    """A (b, L) key mask with masked keys inside the sequence, many key tiles
    apart: batch 0 loses the middle third of its keys (a padded image between
    real tokens), batch 1 every third key."""
    import torch

    mask = torch.ones((b, L), dtype=torch.int32, device="cuda")
    mask[0, L // 3: 2 * L // 3] = 0
    mask[1, ::3] = 0
    return mask


def kept_keys_err(got, q, k, v, bias) -> float:
    """max |got - fp32 attention over each batch's unmasked keys only| (q, k
    as the kernel multiplies them)."""
    err = 0.0
    for i in range(q.shape[0]):
        keep = bias[i] > -1.0
        s = (q[i].float() @ k[i][:, keep].float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        want = s.softmax(dim=-1) @ v[i][:, keep].float()
        err = max(err, (got[i].float() - want).abs().max().item())
    return err


# ----------------------------- kernel checks -----------------------------


def check_attention_rope(L: int, padded: bool, reps: int, holes: bool = False) -> dict:
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops import flash_attention as fa
    from visualcloze_tpu_torch.ops.attention import mask_to_bias
    from visualcloze_tpu_torch.ops.rope import apply_rope_half

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(L)
    b, h, d = (2 if padded or holes else 1), 24, 128
    q, k, v = (torch.randn((b, h, L, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    ang = torch.rand((b, L, d // 2), generator=g, device=dev) * 40.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    bias = None
    valid = [L] * b
    if padded:  # batch 0: the last 64 keys are padding; batch 1: every key masked
        mask = torch.ones((b, L), dtype=torch.int32, device=dev)
        mask[0, L - 64:] = 0
        mask[1] = 0
        bias = mask_to_bias(mask)
        valid = [L - 64, 0]
    if holes:
        mask = holes_mask(b, L)
        bias = mask_to_bias(mask)
        valid = mask.sum(dim=1).tolist()
    got = fa.flash_attn_rope(q, k, v, bias, cos, sin)
    deterministic = torch.equal(got, fa.flash_attn_rope(q, k, v, bias, cos, sin))
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, bias, cos, sin)
    err = (got.float() - want.float()).abs().max().item()
    tol = bf16_ulps_tol(want)
    rms = want.float().pow(2).mean().sqrt().item()
    del want
    masked_zero, pad_err = True, None
    if padded:  # batch 0 against attention over its first L - 64 keys only
        masked_zero = bool((got[1] == 0).all().item())
        want0 = attention_over_keys(q[:1], k[:1], v[:1], cos[:1], sin[:1], L - 64)
        pad_err = (got[:1].float() - want0).abs().max().item()
        del want0
    if holes:  # every batch against attention over its unmasked keys only
        pad_err = kept_keys_err(got, fa._rot_half(q.float(), cos, sin), fa._rot_half(k.float(), cos, sin), v, bias)
    ms = cuda_ms(lambda: fa.flash_attn_rope(q, k, v, bias, cos, sin), reps)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias, cos, sin), 2)
    qr, kr = apply_rope_half(q, cos[:, None], sin[:, None]), apply_rope_half(k, cos[:, None], sin[:, None])
    amask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=amask), reps)
    flops = sum(4.0 * h * L * n * d for n in valid)
    nbytes = 4 * b * h * L * d * 2 + 2 * b * L * (d // 2) * 4 + (b * L * 4 if bias is not None else 0)
    bms, by = bound(flops, nbytes)
    return dict(name="flash_attn_rope", shape=[b, h, L, d], bias=bias is not None, holes=holes, max_abs_err=err,
                tol=tol, rms_plain=rms, padded_keys_err=pad_err,
                ok=err <= tol and masked_zero and (pad_err is None or pad_err <= tol) and deterministic,
                masked_batch_zero=masked_zero, deterministic=deterministic, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library="F.scaled_dot_product_attention on pre-rotated q, k",
                bound_ms=bms, bound_by=by, share_of_bound=bms / ms)


def check_attention_d512(L: int, reps: int, b: int = 1) -> dict:
    """Kernel C against its plain version at (b, 1, L, 512): 4 bf16 ulps at
    the largest output; a second launch gives the same bits (deterministic)."""
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(L)
    q, k, v = (torch.randn((b, 1, L, 512), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    got = fa.flash_attn_d512(q, k, v)
    deterministic = torch.equal(got, fa.flash_attn_d512(q, k, v))
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    tol = bf16_ulps_tol(want)
    rms = want.float().pow(2).mean().sqrt().item()
    del want
    ms = cuda_ms(lambda: fa.flash_attn_d512(q, k, v), reps)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 2)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps)
    bms, by = bound(4.0 * b * L * L * 512, 4 * b * L * 512 * 2)
    return dict(name="flash_attn_d512", shape=[b, 1, L, 512], max_abs_err=err, tol=tol, rms_plain=rms,
                ok=err <= tol and deterministic, deterministic=deterministic,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, library="F.scaled_dot_product_attention",
                bound_ms=bms, bound_by=by, share_of_bound=bms / ms)


def check_conv(shape, pre: bool, reps: int, b0_scale: float = 1.0) -> dict:
    """Kernel B against its plain version: 1% of the largest output; a
    second launch gives the same bits (deterministic). b0_scale widens b0,
    so that swish(b0) on the image border (zeroed after the activation) is
    far from 0."""
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops import conv2d as cv

    B, H, W, C, Co = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(H * W + C)
    x = torch.randn((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, C, Co), generator=g, device=dev) * (9 * C) ** -0.5).to(torch.bfloat16)
    b = torch.randn((Co,), generator=g, device=dev) * 0.1
    aff = None
    if pre:
        aff = (torch.rand((B, C), generator=g, device=dev) + 0.5,
               torch.randn((B, C), generator=g, device=dev) * b0_scale)
    act = "swish" if pre else "none"
    got = cv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act=act)
    deterministic = torch.equal(got, cv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act=act))
    torch.cuda.synchronize()
    want = cv.conv3x3_plain(x, w, b, aff, act)
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-2 * want.abs().max().item()  # bf16 in, fp32 sums of 9*C terms in another order
    del want
    ms = cuda_ms(lambda: cv.conv3x3_gn_swish(x, w, b, pre_affine=aff, act=act), reps)
    plain_ms = cuda_ms(lambda: cv.conv3x3_plain(x, w, b, aff, act), 2)
    x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC tensor
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b16 = b.to(torch.bfloat16)
    if pre:
        a4, o4 = aff[0].to(torch.bfloat16)[:, :, None, None], aff[1].to(torch.bfloat16)[:, :, None, None]
        lib = lambda: F.conv2d(F.silu(x_nchw * a4 + o4), w_oihw, b16, padding=1)  # noqa: E731
    else:
        lib = lambda: F.conv2d(x_nchw, w_oihw, b16, padding=1)  # noqa: E731
    library_ms = cuda_ms(lib, reps)
    bms, by = bound(2.0 * B * H * W * C * Co * 9, (B * H * W * (C + Co) + 9 * C * Co) * 2 + Co * 4)
    return dict(name="conv3x3_gn_swish", shape=[B, H, W, C, Co], act=act, b0_scale=b0_scale, max_abs_err=err,
                tol=tol, ok=err <= tol and deterministic, deterministic=deterministic, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                library="F.conv2d(F.silu(x * a + b0)) bf16 channels_last" if pre else "F.conv2d bf16",
                bound_ms=bms, bound_by=by, share_of_bound=bms / ms)


def attention_case(b: int, L: int, padded: bool, seed: int, holes: bool = False):
    """N(0,1) bf16 q, k, v, dO of (b, 24, L, 128); padded: batch 0's last 64
    keys are padding (and their query rows' dO is 0, as attention() zeroes
    those outputs); holes (b = 2): holes_mask's keys are masked. Returns the
    tensors, the bias and each batch's count of real keys."""
    import torch

    from visualcloze_tpu_torch.ops.attention import mask_to_bias

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((b, 24, L, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
    bias, valid = None, [L] * b
    if padded:
        mask = torch.ones((b, L), dtype=torch.int32, device=dev)
        mask[0, L - 64:] = 0
        bias = mask_to_bias(mask)
        valid[0] = L - 64
        do = do * mask[:, None, :, None].to(do.dtype)
    if holes:
        mask = holes_mask(b, L)
        bias = mask_to_bias(mask)
        valid = mask.sum(dim=1).tolist()
    return q, k, v, do, bias, valid


def sdpa_mask(bias):
    import torch

    return None if bias is None else bias[:, None, None, :].to(torch.bfloat16)


def check_attention_fwd(b: int, L: int, padded: bool, reps: int, lk: int | None = None,
                        holes: bool = False) -> list[dict]:
    """Kernels D and E against their plain version; E's LSE too; for the
    padded batch, batch 0 against fp32 attention over its real keys only;
    lk: that many keys against the L queries (no padding); holes: keys
    masked inside the sequence (holes_mask), every batch against attention
    over its unmasked keys; a second launch of each gives the same bits
    (deterministic)."""
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops import flash_attention as fa

    q, k, v, _, bias, valid = attention_case(b, L, padded, L + 1, holes)
    if lk is not None:
        _, k, v, _, _, _ = attention_case(b, lk, False, lk + 1)
        valid = [lk] * b
    got_d = fa.flash_attn_fwd(q, k, v, bias)
    got_e, got_lse = fa.flash_attn_fwd_lse(q, k, v, bias)
    again_e, again_lse = fa.flash_attn_fwd_lse(q, k, v, bias)
    deterministic = (torch.equal(got_d, fa.flash_attn_fwd(q, k, v, bias)) and torch.equal(got_e, again_e)
                     and torch.equal(got_lse, again_lse))
    del again_e, again_lse
    torch.cuda.synchronize()
    want, want_lse = fa.flash_fwd_lse_plain(q, k, v, bias)
    tol = bf16_ulps_tol(want)
    err_d = (got_d.float() - want.float()).abs().max().item()
    err_e = (got_e.float() - want.float()).abs().max().item()
    lse_err = (got_lse - want_lse).abs().max().item()
    lse_tol = 2.0 ** -13 * want_lse.abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    del want, want_lse
    pad_err = None
    if padded:
        n = valid[0]
        s = torch.matmul(q[:1].float(), k[:1, :, :n].float().transpose(-1, -2)) * 128 ** -0.5
        want0 = torch.matmul(torch.softmax(s, dim=-1), v[:1, :, :n].float())
        del s
        pad_err = max((got_d[:1].float() - want0).abs().max().item(), (got_e[:1].float() - want0).abs().max().item())
        del want0
    if holes:
        pad_err = max(kept_keys_err(got_d, q, k, v, bias), kept_keys_err(got_e, q, k, v, bias))
    ms_d = cuda_ms(lambda: fa.flash_attn_fwd(q, k, v, bias), reps)
    ms_e = cuda_ms(lambda: fa.flash_attn_fwd_lse(q, k, v, bias), reps)
    plain_d = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias), 2)
    plain_e = cuda_ms(lambda: fa.flash_fwd_lse_plain(q, k, v, bias), 2)
    amask = sdpa_mask(bias)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask), reps)
    lk = k.shape[2]
    flops = sum(4.0 * 24 * L * n * 128 for n in valid)
    nbytes = 2 * b * 24 * (L + lk) * 128 * 2 + (b * lk * 4 if bias is not None else 0)
    common = dict(shape=[b, 24, L, 128], keys=lk, bias=bias is not None, holes=holes, tol=tol, rms_plain=rms,
                  padded_keys_err=pad_err, deterministic=deterministic, library_ms=library_ms, library="F.scaled_dot_product_attention")
    ok_pad = (pad_err is None or pad_err <= tol) and deterministic
    bms, by = bound(flops, nbytes)
    d = dict(name="flash_attn_fwd", max_abs_err=err_d, ok=err_d <= tol and ok_pad, ms=ms_d, plain_ms=plain_d,
             bound_ms=bms, bound_by=by, share_of_bound=bms / ms_d, **common)
    bms, by = bound(flops, nbytes + b * 24 * L * 4)
    e = dict(name="flash_attn_fwd_lse", max_abs_err=err_e, lse_err=lse_err, lse_tol=lse_tol,
             ok=err_e <= tol and lse_err <= lse_tol and ok_pad, ms=ms_e, plain_ms=plain_e, bound_ms=bms,
             bound_by=by, share_of_bound=bms / ms_e, **common)
    return [d, e]


def check_attention_bwd(b: int, L: int, padded: bool, reps: int) -> list[dict]:
    """Kernels F-dq and F-dkv against their plain versions, fed the plain
    forward's lse and delta = rowsum(dO * O); masked keys get no gradient;
    a second launch of each gives the same bits (deterministic)."""
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops import flash_attention as fa

    q, k, v, do, bias, valid = attention_case(b, L, padded, L + 2)
    o, lse = fa.flash_fwd_lse_plain(q, k, v, bias)
    delta = (do.float() * o.float()).sum(-1)
    del o
    args = (q, k, v, bias, do, lse, delta)
    dq = fa.flash_attn_bwd_dq(*args)
    dk, dv = fa.flash_attn_bwd_dkv(*args)
    again = (fa.flash_attn_bwd_dq(*args),) + fa.flash_attn_bwd_dkv(*args)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    del again
    errs, tols = {}, {}
    for name, got, want_fn in (("dq", dq, lambda: fa.flash_bwd_dq_plain(*args)),
                               ("dkv", (dk, dv), lambda: fa.flash_bwd_dkv_plain(*args))):
        want = want_fn()
        pairs = zip(got, want) if name == "dkv" else [(got, want)]
        for part, (g_, w_) in zip(("dk", "dv") if name == "dkv" else ("dq",), pairs):
            errs[part] = (g_.float() - w_.float()).abs().max().item()
            tols[part] = bf16_ulps_tol(w_)
        del want
    masked_zero = True
    if padded:
        masked_zero = bool((dk[0, :, valid[0]:] == 0).all().item() and (dv[0, :, valid[0]:] == 0).all().item())
    ms_dq = cuda_ms(lambda: fa.flash_attn_bwd_dq(*args), reps)
    ms_dkv = cuda_ms(lambda: fa.flash_attn_bwd_dkv(*args), reps)
    plain_dq = cuda_ms(lambda: fa.flash_bwd_dq_plain(*args), 1)
    plain_dkv = cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args), 1)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    amask = sdpa_mask(bias)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*leaves, attn_mask=amask)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), leaves, do)

    library_ms = cuda_ms(sdpa_fwd_bwd, reps) - cuda_ms(sdpa_fwd, reps)
    common = dict(shape=[b, 24, L, 128], bias=padded, masked_keys_zero=masked_zero, deterministic=deterministic,
                  library_ms=library_ms,
                  library="F.scaled_dot_product_attention backward (fwd+bwd - fwd; dq, dk and dv together)")
    io = b * 24 * L * (128 * 2 * 4 + 4 * 2) + (b * L * 4 if padded else 0)  # q, k, v, dO; lse, delta; bias
    bms, by = bound(sum(6.0 * 24 * L * n * 128 for n in valid), io + b * 24 * L * 128 * 2)
    rows = [dict(name="flash_attn_bwd_dq", max_abs_err=errs["dq"], tol=tols["dq"],
                 ok=errs["dq"] <= tols["dq"] and deterministic, ms=ms_dq, plain_ms=plain_dq, bound_ms=bms,
                 bound_by=by, share_of_bound=bms / ms_dq, **common)]
    bms, by = bound(sum(8.0 * 24 * L * n * 128 for n in valid), io + 2 * b * 24 * L * 128 * 2)
    rows.append(dict(name="flash_attn_bwd_dkv", max_abs_err=max(errs["dk"], errs["dv"]),
                     err_dk=errs["dk"], tol_dk=tols["dk"], err_dv=errs["dv"], tol_dv=tols["dv"],
                     ok=errs["dk"] <= tols["dk"] and errs["dv"] <= tols["dv"] and masked_zero and deterministic,
                     ms=ms_dkv, plain_ms=plain_dkv, bound_ms=bms, bound_by=by, share_of_bound=bms / ms_dkv,
                     **common))
    return rows


def int8pack_ms(x, w, scale) -> float | None:
    """torch._weight_int8pack_mm (w (N, K) int8, bf16 scales) where it runs on
    the card, else None: G's library yardstick, never called by the port."""
    import torch

    w_nk, s16 = w.t().contiguous(), scale.to(torch.bfloat16)
    try:
        torch._weight_int8pack_mm(x, w_nk, s16)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError):
        return None
    return cuda_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s16), 2)  # slow: 2 launches are enough


def check_int8_matmul(m: int, k: int, n: int, what: str, reps: int) -> dict:
    """Kernel G against its plain version: N(0,1) bf16 x, uniform int8 w,
    scale d_in^-0.5 / 127; 4 bf16 ulps of the largest output; a second
    launch gives the same bits (deterministic). Beside the library call,
    F.linear (cuBLAS bf16) on a copy dequantized beforehand."""
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7 * m + n)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    scale = torch.full((n,), k ** -0.5 / 127, device=dev)
    got = int8_matmul(x, w, scale)
    deterministic = torch.equal(got, int8_matmul(x, w, scale))
    torch.cuda.synchronize()
    want = int8_matmul_plain(x, w, scale, torch.float32)
    err = (got.float() - want).abs().max().item()
    tol = bf16_ulps_tol(want)
    rms = want.pow(2).mean().sqrt().item()
    del want
    ms = cuda_ms(lambda: int8_matmul(x, w, scale), reps, graph=True)
    plain_ms = cuda_ms(lambda: int8_matmul_plain(x, w, scale), 2)
    w16 = (w.t().float() * scale[:, None]).to(torch.bfloat16)  # (N, K), dequantized beforehand
    dequant_ms = cuda_ms(lambda: F.linear(x, w16), reps)
    del w16
    library_ms, library = int8pack_ms(x, w, scale), "torch._weight_int8pack_mm"
    if library_ms is None:
        library_ms, library = dequant_ms, "F.linear on a bf16 copy dequantized beforehand"
    bms, by = bound(2.0 * m * n * k, 2 * m * k + k * n + 4 * n + 2 * m * n)
    return dict(name="int8_matmul", what=what, shape=[m, k, n], max_abs_err=err, tol=tol, rms_plain=rms,
                ok=err <= tol and deterministic, deterministic=deterministic, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library=library, dequant_f_linear_ms=dequant_ms, bound_ms=bms, bound_by=by,
                share_of_bound=bms / ms, tflops=2.0 * m * n * k / ms / 1e9,
                weight_gbps=k * n / ms / 1e6)


def int4pack_ms(x, w_int4, scale, group: int) -> float | None:
    """torch._weight_int4pack_mm (tinygemm: unsigned codes q + 8, bf16 scales
    and zeros (K/g, N, 2), zero 0) where it runs on the card, else None: a
    library yardstick of G4, never called by the port."""
    import torch

    lo, hi = (w_int4 & 0xF) ^ 8, (w_int4 >> 4) ^ 8  # q + 8 of rows 2i and 2i + 1
    codes = torch.stack([lo, hi], dim=1).reshape(-1, w_int4.shape[1]).t()  # (N, K) in [0, 15]
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()  # (K/g, N, 2)
    try:
        packed = torch._convert_weight_to_int4pack((codes[:, 0::2] << 4 | codes[:, 1::2]).contiguous(), 8)
        torch._weight_int4pack_mm(x, packed, group, sz)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError, TypeError):
        return None
    return cuda_ms(lambda: torch._weight_int4pack_mm(x, packed, group, sz), 5)


def check_int4_matmul(m: int, k: int, n: int, what: str, reps: int, group: int = 128) -> dict:
    """Kernel G4 against its plain version: N(0,1) bf16 x, uniform packed
    bytes (every nibble), one scale per (group, column) uniform over
    [0.75, 1.25] x d_in^-0.5 / 7 (so the scale varies along K); 4 bf16 ulps
    of the largest output; a second launch gives the same bits
    (deterministic). Yardsticks: torch._weight_int4pack_mm where it runs
    (library_ms), F.linear on a bf16 copy dequantized beforehand."""
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch.ops.int4_matmul import dequant_int4_plain, int4_matmul, int4_matmul_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5 * m + n)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    scale = (torch.rand((k // group, n), generator=g, device=dev) * 0.5 + 0.75) * (k ** -0.5 / 7)
    got = int4_matmul(x, w, scale)
    deterministic = torch.equal(got, int4_matmul(x, w, scale))
    torch.cuda.synchronize()
    want = int4_matmul_plain(x, w, scale, torch.float32)
    err = (got.float() - want).abs().max().item()
    tol = bf16_ulps_tol(want)
    rms = want.pow(2).mean().sqrt().item()
    del want
    ms = cuda_ms(lambda: int4_matmul(x, w, scale), reps, graph=True)
    plain_ms = cuda_ms(lambda: int4_matmul_plain(x, w, scale), 2)
    w16 = dequant_int4_plain(w, scale).t().contiguous()  # (N, K) bf16, dequantized beforehand
    dequant_ms = cuda_ms(lambda: F.linear(x, w16), reps)
    del w16
    library_ms = int4pack_ms(x, w, scale, group)
    bms, by = bound(2.0 * m * n * k, 2 * m * k + k * n // 2 + 4 * (k // group) * n + 2 * m * n)
    return dict(name="int4_matmul", what=what, shape=[m, k, n], group=group, max_abs_err=err, tol=tol,
                rms_plain=rms, ok=err <= tol and deterministic, deterministic=deterministic, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, library="torch._weight_int4pack_mm (bf16 scales, zero 0)",
                dequant_f_linear_ms=dequant_ms, bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
                tflops=2.0 * m * n * k / ms / 1e9, weight_gbps=k * n / 2 / ms / 1e6)


def int_mm_ms(a, w, x_scale, w_scale, bias) -> tuple[float | None, float | None]:
    """torch._int_mm (cuBLASLt s8 x s8 -> s32) on the K-major weight, alone
    and followed by the plain rescale to bf16 and the bias (H's function),
    where it runs on the card: H's library yardsticks, never called by the
    port."""
    import torch

    wt = w.t()  # (K, N) column-major: the layout cuBLASLt's int8 product takes
    try:
        torch._int_mm(a, wt)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError):
        return None, None

    def rescaled():
        y = (torch._int_mm(a, wt).float() * x_scale[:, None] * w_scale).to(torch.bfloat16)
        return y if bias is None else y + bias

    return cuda_ms(lambda: torch._int_mm(a, wt), 10, graph=True), cuda_ms(rescaled, 10, graph=True)


def check_w8a8_matmul(m: int, k: int, n: int, what: str, reps: int, with_bias: bool = True) -> dict:
    """Kernel H against its plain version: activation and weight codes
    uniform over [-127, 127] (act_quant_int8's and quantize_linear_int8's
    range), x_scale uniform, w_scale d_in^-0.5 / 127, a bf16 N(0, 0.1) bias
    (every w8a8 linear of the DiT has one). The integer sums are exact, so
    the tolerance is 0: bit for bit; a second launch gives the same bits.
    Beside the library call (torch._int_mm), the same followed by the plain
    rescale and bias; all three timed as replayed CUDA graphs, so the
    kernel's and the library's host-side launch work are left out alike."""
    import torch

    from visualcloze_tpu_torch.ops.w8a8_matmul import w8a8_matmul, w8a8_matmul_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11 * m + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    x_scale = torch.rand((m,), generator=g, device=dev) * 0.05 + 1e-3
    w_scale = torch.full((n,), k ** -0.5 / 127, device=dev)
    bias = (torch.randn((n,), generator=g, device=dev) * 0.1).to(torch.bfloat16) if with_bias else None
    got = w8a8_matmul(a, w, x_scale, w_scale, bias)
    deterministic = torch.equal(got, w8a8_matmul(a, w, x_scale, w_scale, bias))
    torch.cuda.synchronize()
    want = w8a8_matmul_plain(a, w, x_scale, w_scale, bias)
    err = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    del want
    ms = cuda_ms(lambda: w8a8_matmul(a, w, x_scale, w_scale, bias), reps, graph=True)
    plain_ms = cuda_ms(lambda: w8a8_matmul_plain(a, w, x_scale, w_scale, bias), 2)
    library_ms, rescaled_ms = int_mm_ms(a, w, x_scale, w_scale, bias)
    bms, by = bound(2.0 * m * n * k, m * k + n * k + 4 * (m + n) + 2 * m * n + (2 * n if with_bias else 0),
                    PEAK_INT8_OPS)
    return dict(name="w8a8_matmul", what=what, shape=[m, k, n], bias=with_bias, max_abs_err=err, tol=0.0,
                rms_plain=rms,
                ok=err == 0.0 and deterministic, deterministic=deterministic, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library="torch._int_mm (s32 out)", int_mm_rescale_bias_ms=rescaled_ms,
                bound_ms=bms, bound_by=by, share_of_bound=bms / ms, tops=2.0 * m * n * k / ms / 1e9)


def check_act_quant(m: int, k: int, bf16: bool, smooth: bool, reps: int) -> dict:
    """Kernel I against its plain version: x N(0, 9) in fp32 or bf16 with one
    outlier channel and an all-zero row (scale 1e-8 / 127, codes 0), a_sinv
    uniform over [0.2, 5] or none. IEEE division and round half to even in
    both: codes and scales bit for bit (tolerance 0); a second launch gives
    the same bits. No single PyTorch call computes it: no library time."""
    import torch

    from visualcloze_tpu_torch.ops.act_quant import act_quant_int8, act_quant_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13 * m + k + bf16 + 2 * smooth)
    x = torch.randn((m, k), generator=g, device=dev) * 3.0
    x[:, k // 3] *= 40.0
    x[m // 2] = 0.0
    x = x.to(torch.bfloat16 if bf16 else torch.float32)
    a_sinv = torch.rand((k,), generator=g, device=dev) * 4.8 + 0.2 if smooth else None
    codes, scale = act_quant_int8(x, a_sinv)
    again = act_quant_int8(x, a_sinv)
    deterministic = torch.equal(codes, again[0]) and torch.equal(scale, again[1])
    torch.cuda.synchronize()
    want_codes, want_scale = act_quant_plain(x, a_sinv)
    err = max((codes.int() - want_codes.int()).abs().max().item(), (scale - want_scale).abs().max().item())
    zero_row = bool((codes[m // 2] == 0).all().item())
    ms = cuda_ms(lambda: act_quant_int8(x, a_sinv), reps, graph=True)
    plain_ms = cuda_ms(lambda: act_quant_plain(x, a_sinv), 5)
    nbytes = m * k * x.element_size() + m * k + 4 * m + (4 * k if smooth else 0)
    bms, by = bound(0.0, nbytes)
    return dict(name="act_quant_int8", shape=[m, k], dtype="bf16" if bf16 else "fp32", a_sinv=smooth,
                max_abs_err=err, tol=0.0, zero_row_codes_zero=zero_row, ok=err == 0 and deterministic and zero_row,
                deterministic=deterministic, ms=ms, plain_ms=plain_ms, library_ms=None,
                library="none (no single PyTorch call)", bound_ms=bms, bound_by=by, share_of_bound=bms / ms)


def bf16_ulps_each(want):
    """One bf16 ulp at each element's magnitude (8 significant bits; the
    smallest normal's below it)."""
    import torch

    mag = want.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _fusion_line(name, what, shape, err, tol, deterministic, ms, plain_ms, nbytes, **extra) -> dict:
    """A kernel line of J-M: memory-bound passes, no single PyTorch call
    computes any of them (no library time)."""
    bms, by = bound(0.0, nbytes)
    return dict(name=name, what=what, shape=shape, max_abs_err=err, tol=tol, ok=err <= tol and deterministic,
                deterministic=deterministic, ms=ms, plain_ms=plain_ms, library_ms=None,
                library="none (no single PyTorch call)", bound_ms=bms, bound_by=by, share_of_bound=bms / ms, **extra)


def _modulation_vectors(g, b: int, c: int, chunks: int = 6):
    """(shift, scale, gate), each a (B, 1, C) fp32 view of a (B, 1, chunks * C)
    modulation output, as Modulation.forward chunks it (N(0, 0.25))."""
    import torch

    out = torch.randn((b, 1, chunks * c), generator=g, device="cuda") * 0.5
    return out.chunk(chunks, dim=-1)[:3]


def check_layernorm_modulate(tokens: int, out_bf16: bool, what: str, reps: int, b: int = 1, skip: int = 0,
                             c: int = 3072) -> dict:
    """Kernel J against its plain version: x N(0.5, 4) bf16, rows
    [skip, skip + tokens) of a (B, skip + tokens, C) tensor (the final
    layer's image tokens after the text ones), the modulation's shift and
    scale as strided chunks. bf16 out: 2 bf16 ulps of the largest output;
    fp32 out: 2^-16 of it (the row sums run in another order); a second
    launch gives the same bits. Timed as a replayed CUDA graph."""
    import torch

    from visualcloze_tpu_torch.ops.block_fusions import layernorm_modulate, layernorm_modulate_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17 * tokens + skip + out_bf16)
    x = (torch.randn((b, skip + tokens, c), generator=g, device=dev) * 2.0 + 0.5).to(torch.bfloat16)[:, skip:]
    shift, scale, _ = _modulation_vectors(g, b, c)
    dt = torch.bfloat16 if out_bf16 else torch.float32
    got = layernorm_modulate(x, shift, scale, dt)
    deterministic = torch.equal(got, layernorm_modulate(x, shift, scale, dt))
    want = layernorm_modulate_plain(x, shift, scale, dt)
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    tol = bf16_ulps_tol(want.float(), 2) if out_bf16 else top * 2.0 ** -16
    ms = cuda_ms(lambda: layernorm_modulate(x, shift, scale, dt), reps, graph=True)
    plain_ms = cuda_ms(lambda: layernorm_modulate_plain(x, shift, scale, dt), 5)
    nbytes = b * tokens * c * (2 + got.element_size()) + 2 * b * c * 4
    return _fusion_line("layernorm_modulate", what, [b, tokens, c], err, tol, deterministic, ms, plain_ms, nbytes,
                        out_dtype="bf16" if out_bf16 else "fp32")


def check_gated_residual(tokens: int, what: str, reps: int, b: int = 1, c: int = 3072) -> dict:
    """Kernel K against its plain version: x N(0, 4), y N(0, 1) bf16, the
    gate a strided chunk; bit for bit (tolerance 0), deterministic."""
    import torch

    from visualcloze_tpu_torch.ops.block_fusions import gated_residual, gated_residual_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19 * tokens + b)
    x = (torch.randn((b, tokens, c), generator=g, device=dev) * 2.0).to(torch.bfloat16)
    y = torch.randn((b, tokens, c), generator=g, device=dev).to(torch.bfloat16)
    _, _, gate = _modulation_vectors(g, b, c)
    got = gated_residual(x, gate, y)
    deterministic = torch.equal(got, gated_residual(x, gate, y))
    err = (got.float() - gated_residual_plain(x, gate, y).float()).abs().max().item()
    ms = cuda_ms(lambda: gated_residual(x, gate, y), reps, graph=True)
    plain_ms = cuda_ms(lambda: gated_residual_plain(x, gate, y), 5)
    return _fusion_line("gated_residual", what, [b, tokens, c], err, 0.0, deterministic, ms, plain_ms,
                        3 * b * tokens * c * 2 + b * c * 4)


def check_qk_norm_split(tokens: int, what: str, reps: int, cols: int = 9216, heads: int = 24, total: int = 0,
                        offset: int = 0) -> dict:
    """Kernel L against its plain version: the first 3 * heads * 128 of
    `cols` columns of an N(0, 4) bf16 projection (linear1's 21504 in the
    single block, the stream's qkv in the double block), written at token
    `offset` of (1, heads, total, 128) buffers, scales uniform over [0.5,
    1.5]; q and k within 2 bf16 ulps of the largest output, v bit for bit,
    the tokens outside [offset, offset + tokens) untouched; deterministic."""
    import torch

    from visualcloze_tpu_torch.ops.block_fusions import qk_norm_split, qk_norm_split_plain, qkv_buffers

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23 * tokens + cols + offset)
    h = (torch.randn((1, tokens, cols), generator=g, device=dev) * 2.0).to(torch.bfloat16)
    qkv = h[..., : 3 * heads * 128]
    qs, ks = ((torch.rand((128,), generator=g, device=dev) + 0.5).to(torch.bfloat16) for _ in range(2))
    total = total or tokens
    got, again, want = (qkv_buffers(qkv, heads, total) for _ in range(3))
    for bufs in (got, again, want):
        for t in bufs:
            t.fill_(3.0)
    qk_norm_split(qkv, qs, ks, heads, got, offset)
    qk_norm_split(qkv, qs, ks, heads, again, offset)
    qk_norm_split_plain(qkv, qs, ks, heads, want, offset)
    deterministic = all(torch.equal(a, c) for a, c in zip(got, again))
    span = slice(offset, offset + tokens)
    err = max((a[:, :, span].float() - w[:, :, span].float()).abs().max().item() for a, w in zip(got[:2], want[:2]))
    tol = max(bf16_ulps_tol(w[:, :, span].float(), 2) for w in want[:2])
    v_equal = torch.equal(got[2], want[2])
    untouched = all(bool((torch.cat([a[:, :, :offset], a[:, :, offset + tokens:]], 2) == 3.0).all()) for a in got)
    ms = cuda_ms(lambda: qk_norm_split(qkv, qs, ks, heads, got, offset), reps, graph=True)
    plain_ms = cuda_ms(lambda: qk_norm_split_plain(qkv, qs, ks, heads, want, offset), 5)
    line = _fusion_line("qk_norm_split", what, [1, tokens, cols, heads], err, tol, deterministic, ms, plain_ms,
                        2 * tokens * 3 * heads * 128 * 2 + 2 * 128 * 2, joint_tokens=total, offset=offset,
                        v_bit_equal=v_equal, outside_untouched=untouched)
    line["ok"] = line["ok"] and v_equal and untouched
    return line


def check_merge_heads(tokens: int, what: str, reps: int, gelu_cols: int = 0, cols: int = 0, padded: int = 0,
                      heads: int = 24) -> dict:
    """Kernel M against its plain version: attention's output (1, heads,
    tokens, 128) N(0, 1) bf16, the last `padded` query rows masked; with
    gelu_cols, gelu(tanh) of the last gelu_cols of `cols` N(0, 9) columns
    (linear1's 12288 of 21504). The merge bit for bit, padded rows zero; the
    gelu within one bf16 ulp of each element; deterministic."""
    import torch

    from visualcloze_tpu_torch.ops.block_fusions import merge_heads, merge_heads_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29 * tokens + gelu_cols + padded)
    x = torch.randn((1, heads, tokens, 128), generator=g, device=dev).to(torch.bfloat16)
    mask = None
    if padded:
        mask = torch.ones((1, tokens), dtype=torch.int32, device=dev)
        mask[:, tokens - padded:] = 0
    gelu = None
    if gelu_cols:
        gelu = (torch.randn((1, tokens, cols), generator=g, device=dev) * 3.0).to(torch.bfloat16)[..., -gelu_cols:]
    got = merge_heads(x, mask, gelu)
    deterministic = torch.equal(got, merge_heads(x, mask, gelu))
    want = merge_heads_plain(x, mask, gelu)
    hd = heads * 128
    merge_err = (got[..., :hd].float() - want[..., :hd].float()).abs().max().item()
    gelu_ulps = 0.0
    if gelu_cols:
        d = (got[..., hd:].float() - want[..., hd:].float()).abs()
        gelu_ulps = (d / bf16_ulps_each(want[..., hd:])).max().item()
    padded_zero = not padded or bool((got[:, tokens - padded:, :hd] == 0).all())
    ms = cuda_ms(lambda: merge_heads(x, mask, gelu), reps, graph=True)
    plain_ms = cuda_ms(lambda: merge_heads_plain(x, mask, gelu), 5)
    nbytes = 2 * tokens * (hd + gelu_cols) * 2 + (tokens * 4 if padded else 0)
    line = _fusion_line("merge_heads", what, [1, heads, tokens, 128, gelu_cols], merge_err, 0.0, deterministic,
                        ms, plain_ms, nbytes, padded_rows=padded, gelu_max_ulps=gelu_ulps, gelu_tol_ulps=1.0,
                        padded_rows_zero=padded_zero)
    line["ok"] = line["ok"] and gelu_ulps <= 1.0 and padded_zero
    return line


def _colsum_tol(terms, dims) -> float:
    """2^-16 of the largest sum of |terms| over `dims`: an fp32 column sum
    over thousands of tokens taken in another order (measured well under it)."""
    return terms.float().abs().sum(dim=dims).max().item() * 2.0 ** -16


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _backward_line(name, what, shape, checks, deterministic, ms, plain_ms, nbytes, **extra) -> dict:
    """A kernel line of J'-M': `checks` {output: (err vs plain backward, err
    vs autograd of the plain forward, tol)}; max_abs_err and tol are the
    first output's, every output must hold both."""
    first = next(iter(checks.values()))
    line = _fusion_line(name, what, shape, max(first[:2]), first[2], deterministic, ms, plain_ms, nbytes,
                        checks={k: dict(vs_plain=a, vs_autograd=b, tol=t) for k, (a, b, t) in checks.items()},
                        **extra)
    line["ok"] = line["ok"] and all(a <= t and b <= t for a, b, t in checks.values())
    return line


def check_layernorm_modulate_bwd(tokens: int, dy_bf16: bool, what: str, reps: int, b: int = 1, skip: int = 0,
                                 c: int = 3072) -> dict:
    """Kernel J' against its plain backward and against torch.autograd.grad
    of J's plain version: x N(0.5, 4) bf16, rows [skip, skip + tokens) of a
    (B, skip + tokens, C) tensor, scale a strided chunk, dy N(0, 1) in J's
    output dtype; dx within 2 bf16 ulps of the largest, dshift and dscale
    (per batch element) within _colsum_tol; two launches give the same bits.
    Timed as a replayed CUDA graph."""
    import torch

    from visualcloze_tpu_torch.ops.block_fusions import (layer_norm, layernorm_modulate_bwd,
                                                         layernorm_modulate_bwd_plain, layernorm_modulate_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31 * tokens + skip + dy_bf16 + b)
    x = (torch.randn((b, skip + tokens, c), generator=g, device=dev) * 2.0 + 0.5).to(torch.bfloat16)[:, skip:]
    shift, scale, _ = _modulation_vectors(g, b, c)
    dt = torch.bfloat16 if dy_bf16 else torch.float32
    dy = torch.randn((b, tokens, c), generator=g, device=dev).to(dt)
    got = layernorm_modulate_bwd(x, scale, dy)
    deterministic = all(torch.equal(a, w) for a, w in zip(got, layernorm_modulate_bwd(x, scale, dy)))
    want = layernorm_modulate_bwd_plain(x, scale, dy)
    ins = [t.detach().requires_grad_() for t in (x, shift, scale)]
    auto = torch.autograd.grad(layernorm_modulate_plain(*ins, dt), ins, dy)
    n = layer_norm(x)
    tols = (bf16_ulps_tol(want[0].float(), 2), _colsum_tol(dy, 1), _colsum_tol(dy.float() * n, 1))
    checks = {k: (_max_err(a, w), _max_err(a, u), t)
              for k, a, w, u, t in zip(("dx", "dshift", "dscale"), got, want, auto, tols)}
    ms = cuda_ms(lambda: layernorm_modulate_bwd(x, scale, dy), reps, graph=True)
    plain_ms = cuda_ms(lambda: layernorm_modulate_bwd_plain(x, scale, dy), 5)
    nbytes = b * tokens * c * (2 + dy.element_size() + 2) + 3 * b * c * 4
    return _backward_line("layernorm_modulate_bwd", what, [b, tokens, c], checks, deterministic, ms, plain_ms,
                          nbytes, dy_dtype="bf16" if dy_bf16 else "fp32")


def check_gated_residual_bwd(tokens: int, what: str, reps: int, b: int = 1, c: int = 3072) -> dict:
    """Kernel K' against its plain backward and autograd of K's plain
    version: y, dout N(0, 1) bf16, the gate a strided chunk; dy bit for bit,
    dgate (per batch element) within _colsum_tol; deterministic."""
    import torch

    from visualcloze_tpu_torch.ops.block_fusions import (gated_residual_bwd, gated_residual_bwd_plain,
                                                         gated_residual_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(37 * tokens + b)
    x, y, dout = (torch.randn((b, tokens, c), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    _, _, gate = _modulation_vectors(g, b, c)
    got = gated_residual_bwd(gate, y, dout)
    deterministic = all(torch.equal(a, w) for a, w in zip(got, gated_residual_bwd(gate, y, dout)))
    want = gated_residual_bwd_plain(gate, y, dout)
    ins = [t.detach().requires_grad_() for t in (gate, y)]
    auto = torch.autograd.grad(gated_residual_plain(x, *ins), ins, dout)[::-1]
    checks = {"dy": (_max_err(got[0], want[0]), _max_err(got[0], auto[0]), 0.0),
              "dgate": (_max_err(got[1], want[1]), _max_err(got[1], auto[1]), _colsum_tol(dout.float() * y, 1))}
    ms = cuda_ms(lambda: gated_residual_bwd(gate, y, dout), reps, graph=True)
    plain_ms = cuda_ms(lambda: gated_residual_bwd_plain(gate, y, dout), 5)
    return _backward_line("gated_residual_bwd", what, [b, tokens, c], checks, deterministic, ms, plain_ms,
                          3 * b * tokens * c * 2 + 2 * b * c * 4)


def check_qk_norm_split_bwd(tokens: int, what: str, reps: int, cols: int = 9216, heads: int = 24, total: int = 0,
                            offset: int = 0, b: int = 1) -> dict:
    """Kernel L' against its plain backward and autograd of L's plain
    version: the raw q, k from the first 3 * heads * 128 of `cols` columns of
    an N(0, 4) bf16 projection, dq, dk, dv N(0, 1) (B, heads, total, 128)
    read at token `offset`; dqkv written into the first 3 * heads * 128 of a
    (B, tokens, cols) gradient buffer (linear1's 21504 columns in the single
    block): q and k's columns within 2 bf16 ulps of the largest, v's bit for
    bit, the buffer's other columns untouched; the scales' gradients within
    _colsum_tol (against autograd's bf16 value: plus one ulp of it);
    deterministic."""
    import torch

    from visualcloze_tpu_torch.ops.block_fusions import qk_norm_split_bwd, qk_norm_split_bwd_plain, qk_norm_split_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41 * tokens + cols + offset + b)
    hd = heads * 128
    qkv = (torch.randn((b, tokens, cols), generator=g, device=dev) * 2.0).to(torch.bfloat16)[..., : 3 * hd]
    qs, ks = ((torch.rand((128,), generator=g, device=dev) + 0.5).to(torch.bfloat16) for _ in range(2))
    total = total or tokens
    grads = [torch.randn((b, heads, total, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
    outs = [torch.full((b, tokens, cols), 3.0, dtype=torch.bfloat16, device=dev) for _ in range(3)]
    got = qk_norm_split_bwd(qkv, qs, ks, heads, *grads, offset, outs[0], True)
    again = qk_norm_split_bwd(qkv, qs, ks, heads, *grads, offset, outs[1], True)
    want = qk_norm_split_bwd_plain(qkv, qs, ks, heads, *grads, offset, outs[2], True)
    deterministic = all(torch.equal(a, w) for a, w in zip(got, again))
    span = slice(offset, offset + tokens)
    ins = [t.detach().requires_grad_() for t in (qkv, qs, ks)]
    auto = torch.autograd.grad(qk_norm_split_plain(*ins, heads), ins, [t[:, :, span] for t in grads])
    qn, kn, _ = qk_norm_split_plain(qkv, torch.ones_like(qs), torch.ones_like(ks), heads)
    qk = slice(0, 2 * hd)
    checks = {"dqkv_qk": (_max_err(got[0][..., qk], want[0][..., qk]), _max_err(got[0][..., qk], auto[0][..., qk]),
                          bf16_ulps_tol(want[0][..., qk].float(), 2)),
              "dqkv_v": (_max_err(got[0][..., 2 * hd:3 * hd], want[0][..., 2 * hd:3 * hd]),
                         _max_err(got[0][..., 2 * hd:3 * hd], auto[0][..., 2 * hd:]), 0.0)}
    for k, i, d, nrm in (("dq_scale", 1, grads[0], qn), ("dk_scale", 2, grads[1], kn)):
        tol = _colsum_tol(d[:, :, span].float() * nrm, (0, 1, 2))
        checks[k] = (_max_err(got[i], want[i]), max(0.0, _max_err(got[i], auto[i]) - bf16_ulps_tol(auto[i], 1)), tol)
    untouched = cols == 3 * hd or bool((outs[0][..., 3 * hd:] == 3.0).all())
    ms = cuda_ms(lambda: qk_norm_split_bwd(qkv, qs, ks, heads, *grads, offset, outs[0], True), reps, graph=True)
    plain_ms = cuda_ms(lambda: qk_norm_split_bwd_plain(qkv, qs, ks, heads, *grads, offset, outs[2], True), 5)
    line = _backward_line("qk_norm_split_bwd", what, [b, tokens, cols, heads], checks, deterministic, ms, plain_ms,
                          8 * b * tokens * hd * 2 + 2 * 128 * (2 + 4), joint_tokens=total, offset=offset,
                          other_columns_untouched=untouched)
    line["ok"] = line["ok"] and untouched
    return line


def check_merge_heads_bwd(tokens: int, what: str, reps: int, gelu_cols: int = 0, cols: int = 0, padded: int = 0,
                          b: int = 1, heads: int = 24) -> dict:
    """Kernel M' against its plain backward and autograd of M's plain
    version: dout N(0, 1) bf16 (B, tokens, heads * 128 [+ gelu_cols]), the
    last `padded` rows of each batch element masked; with gelu_cols, the
    forward's gelu input the last gelu_cols of `cols` N(0, 9) columns
    (linear1's 12288 of 21504). dx bit for bit with the padded rows zero,
    dg within one bf16 ulp of each element (floored at 2^-16 of the
    largest) and laid out in linear1's gradient buffer (the gelu input's
    strides); deterministic."""
    import torch

    from visualcloze_tpu_torch.ops.block_fusions import merge_heads_bwd, merge_heads_bwd_plain, merge_heads_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(43 * tokens + gelu_cols + padded + b)
    hd = heads * 128
    mask = None
    if padded:
        mask = torch.ones((b, tokens), dtype=torch.int32, device=dev)
        mask[:, tokens - padded:] = 0
    gelu = None
    if gelu_cols:
        gelu = (torch.randn((b, tokens, cols), generator=g, device=dev) * 3.0).to(torch.bfloat16)[..., -gelu_cols:]
    dout = torch.randn((b, tokens, hd + gelu_cols), generator=g, device=dev).to(torch.bfloat16)
    got = merge_heads_bwd(dout, heads, mask, gelu)
    again = merge_heads_bwd(dout, heads, mask, gelu)
    deterministic = all(torch.equal(a, w) for a, w in zip(got, again) if a is not None)
    want = merge_heads_bwd_plain(dout, heads, mask, gelu)
    ins = [torch.zeros((b, heads, tokens, 128), dtype=torch.bfloat16, device=dev).requires_grad_()]
    if gelu_cols:
        ins.append(gelu.detach().requires_grad_())
    auto = torch.autograd.grad(merge_heads_plain(ins[0], mask, ins[1] if gelu_cols else None), ins, dout)
    checks = {"dx": (_max_err(got[0], want[0]), _max_err(got[0], auto[0]), 0.0)}
    padded_zero = not padded or not bool(got[0][:, :, tokens - padded:].any())
    in_buffer = True
    if gelu_cols:
        # one bf16 ulp of each element, floored at 2^-16 of the largest: where gelu' nearly vanishes (x < -3),
        # 1 + tanh cancels and two tanhf give different tiny values
        ulps = [((got[1].float() - w.float()).abs()
                 / torch.maximum(bf16_ulps_each(w), w.float().abs().max() * 2.0 ** -16)).max().item()
                for w in (want[1], auto[1])]
        checks["dg_over_tol"] = (*ulps, 1.0)
        in_buffer = got[1].stride() == gelu.stride()
    ms = cuda_ms(lambda: merge_heads_bwd(dout, heads, mask, gelu), reps, graph=True)
    plain_ms = cuda_ms(lambda: merge_heads_bwd_plain(dout, heads, mask, gelu), 5)
    nbytes = b * tokens * ((hd + gelu_cols) * 2 + hd * 2 + 2 * gelu_cols * 2) + (b * tokens * 4 if padded else 0)
    line = _backward_line("merge_heads_bwd", what, [b, heads, tokens, 128, gelu_cols], checks, deterministic, ms,
                          plain_ms, nbytes, padded_rows=padded, padded_rows_zero=padded_zero,
                          dg_in_linear1_buffer=in_buffer)
    line["ok"] = line["ok"] and padded_zero and in_buffer
    return line


# ----------------------------- gradients at full width -----------------------------


def grad_reference() -> dict:
    """One full-width double block and one single block (interleaved RoPE,
    64 padded image tokens) with a rank-128 LoRA whose B is random: the LoRA
    gradients through kernels E, J, K, L and M forward and F, J', K', L' and
    M' backward (J 5, K 5, L 3, M 2 launches each way) vs the all-plain
    route: E and F's plain versions and the blocks' plain code under autograd
    (plain_block_route), which launches no kernel."""
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.config import FluxConfig
    from visualcloze_tpu_torch.models.init import init_linears_, materialize
    from visualcloze_tpu_torch.models.layers import DoubleBlock, SingleBlock
    from visualcloze_tpu_torch.models.lora import init_lora, tree_items, tree_map
    from visualcloze_tpu_torch.ops import flash_attention as fa
    from visualcloze_tpu_torch.ops.rope import embed_nd

    cfg = FluxConfig()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4)
    blocks = materialize(lambda: torch.nn.ModuleDict({"db": DoubleBlock(cfg), "sb": SingleBlock(cfg)}), dev, bf)
    init_linears_(blocks, g)
    for name, prm in blocks.named_parameters():
        if name.endswith(("q_scale", "k_scale")):
            prm.data.fill_(1.0)
    lora = init_lora(blocks, 128, generator=g)
    leaves = []
    for path, t in tree_items(lora):
        if path.endswith(".b"):
            t.normal_(0.0, 0.02, generator=g)
        leaves.append(t.requires_grad_())
    l_txt, side = 256, 32
    l_img = side * side
    img = torch.randn((1, l_img, cfg.hidden_size), generator=g, device=dev).to(bf)
    txt = torch.randn((1, l_txt, cfg.hidden_size), generator=g, device=dev).to(bf)
    vec = torch.randn((1, cfg.hidden_size), generator=g, device=dev).to(bf)
    ids = torch.zeros((1, l_txt + l_img, 3), device=dev)
    ids[0, l_txt:, 0] = 1
    ids[0, l_txt:, 1] = (torch.arange(l_img, device=dev) // side).float()
    ids[0, l_txt:, 2] = (torch.arange(l_img, device=dev) % side).float()
    pe = embed_nd(ids, cfg.axes_dim, cfg.theta)
    mask = torch.ones((1, l_txt + l_img), dtype=torch.int32, device=dev)
    mask[0, -64:] = 0
    cot = torch.randn((1, l_txt + l_img, cfg.hidden_size), generator=g, device=dev) * mask[..., None]

    def grads():
        clora = tree_map(lambda t: t.to(bf), lora)
        i2, t2 = blocks["db"](img, txt, vec, pe, mask, clora["db"], rope_layout="interleaved")
        x = blocks["sb"](torch.cat([t2, i2], dim=1), vec, pe, mask, clora["sb"], rope_layout="interleaved")
        return [gr.float() for gr in torch.autograd.grad((x.float() * cot).sum(), leaves)]

    ops.reset_kernel_launches()
    got = grads()
    launches = ops.kernel_launches()
    saved = (fa.flash_attn_fwd_lse, fa.flash_attn_bwd_dq, fa.flash_attn_bwd_dkv)
    fa.flash_attn_fwd_lse, fa.flash_attn_bwd_dq, fa.flash_attn_bwd_dkv = (
        fa.flash_fwd_lse_plain, fa.flash_bwd_dq_plain, fa.flash_bwd_dkv_plain)
    try:
        with plain_block_route():
            ops.reset_kernel_launches()
            want = grads()
            plain_launches = {n: c for n, c in ops.kernel_launches().items() if c}
    finally:
        fa.flash_attn_fwd_lse, fa.flash_attn_bwd_dq, fa.flash_attn_bwd_dkv = saved
    num = sum((a - b).pow(2).sum() for a, b in zip(got, want))
    den = sum(b.pow(2).sum() for b in want)
    per_leaf = [((a - b).pow(2).sum() / b.pow(2).sum()).sqrt().item() for a, b in zip(got, want)
                if b.abs().max() > 0]
    out = dict(phase="grad_reference", tokens=l_txt + l_img, lora_leaves=len(leaves),
               lora_params=sum(t.numel() for t in leaves), rel_rms_err=(num / den).sqrt().item(),
               worst_leaf_rel_rms_err=max(per_leaf), finite=all(bool(torch.isfinite(a).all()) for a in got),
               launches={k: launches[k] for k in ("flash_attn_fwd_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")},
               tol=5e-2)
    out["fusion_launches"] = autograd_launches(launches)
    per = fusion_calls(1, 1)  # one double and one single block, no final layer: as many each way
    out["fusion_launches_expected"] = {**per, **{f"{n}_bwd": c for n, c in per.items()}}
    out["plain_run_launches"] = plain_launches
    out["ok"] = (out["finite"] and out["rel_rms_err"] <= out["tol"] and all(n > 0 for n in out["launches"].values())
                 and out["fusion_launches"] == out["fusion_launches_expected"] and not plain_launches)
    return out


# ----------------------------- reference on a small input -----------------------------


def rel_rms(a, b) -> float:
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def reference_inputs(model):
    """A small DiT input (256 image + 64 text tokens) and a VAE latent."""
    import torch

    dev = model.device
    g = torch.Generator(device=dev).manual_seed(3)
    cfg = model.cfg
    l_img, l_txt = 256, 64
    ids = torch.zeros((1, l_img, 3), device=dev)
    ids[..., 0] = 1
    ids[..., 1] = (torch.arange(l_img, device=dev) // 16).float()
    ids[..., 2] = (torch.arange(l_img, device=dev) % 16).float()
    inp = dict(
        img=torch.randn((1, l_img, cfg.in_channels), generator=g, device=dev).to(torch.bfloat16),
        img_ids=ids,
        txt=torch.randn((1, l_txt, cfg.context_in_dim), generator=g, device=dev).to(torch.bfloat16),
        txt_ids=torch.zeros((1, l_txt, 3), device=dev),
        timesteps=torch.full((1,), 0.5, device=dev).to(torch.bfloat16),
        y=torch.randn((1, cfg.vec_in_dim), generator=g, device=dev).to(torch.bfloat16),
        guidance=torch.full((1,), 30.0, device=dev).to(torch.bfloat16),
    )
    z = torch.randn((1, 16, 32, model.ae.cfg.z_channels), generator=g, device=dev).to(torch.bfloat16)
    return inp, z


@contextlib.contextmanager
def plain_dit():
    """Kernels A, B, C and J-M swapped for their plain versions where their
    callers reach them (A by attention(), B and C by the VAE, J-M through
    plain_block_route)."""
    import visualcloze_tpu_torch.models.autoencoder as ae_mod
    import visualcloze_tpu_torch.ops.attention as att_mod
    from visualcloze_tpu_torch.ops import conv2d as cv
    from visualcloze_tpu_torch.ops import flash_attention as fa

    plain = {(att_mod, "flash_mha_rope"): fa.flash_attention_plain,
             (ae_mod, "conv3x3_gn_swish"): lambda x, w, b, pre_affine=None, act="swish": cv.conv3x3_plain(
                 x, w, b, pre_affine, act),
             (ae_mod, "flash_attn_d512"): fa.flash_attention_plain}
    saved = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        with plain_block_route():
            yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def reference_checks(model) -> dict:
    """The full-width DiT and VAE through the kernels vs through the plain
    versions (same weights, same small input; A, B, C and J-M swapped for
    their plain versions where their callers reach them, and no kernel
    launched in that run); relative RMS error."""
    import torch

    from visualcloze_tpu_torch import ops

    inp, z = reference_inputs(model)

    @torch.no_grad()
    def run():
        return model.flux(**inp).float(), model.ae.decode(z).float()

    dit_k, vae_k = run()
    ops.reset_kernel_launches()
    with plain_dit():
        dit_p, vae_p = run()
    plain_launches = {n: c for n, c in ops.kernel_launches().items() if c}

    out = dict(dit_rel_rms_err=rel_rms(dit_k, dit_p), vae_rel_rms_err=rel_rms(vae_k, vae_p),
               finite=bool(torch.isfinite(dit_k).all() and torch.isfinite(vae_k).all()),
               plain_run_launches=plain_launches)
    # bf16 roundings of 57 blocks (resp. ~30 VAE layers) in another order
    out["tol"] = 5e-2
    out["ok"] = (out["finite"] and out["dit_rel_rms_err"] <= out["tol"] and out["vae_rel_rms_err"] <= out["tol"]
                 and not plain_launches)
    return out


CFG_SCALE = 2.0


def cfg_forward(model) -> dict:
    """Flux.forward_cfg on the full-width bf16 DiT at B = 2 ([cond | uncond]:
    the default query's 3456 image + 512 text tokens, random bf16 inputs,
    the uncond half's text its own draw), no grad: kernel A 57 times and J-M
    115 / 114 / 76 / 57 (one evaluation at batch 2), held against the same
    forward through their plain versions (plain_dit: no kernel launched;
    reference_checks' 5% relative RMS) and against two B = 1 forwards
    combined as forward_cfg combines them (each row of the batch through the
    kernels alone: 5% relative RMS, and whether the bits agree)."""
    import torch

    from visualcloze_tpu_torch import ops

    dev, cfg = model.device, model.cfg
    g = torch.Generator(device=dev).manual_seed(6)
    l_img, l_txt, side = 3456, 512, 48
    ids = torch.zeros((2, l_img, 3), device=dev)
    ids[..., 0] = 1
    ids[..., 1] = (torch.arange(l_img, device=dev) // (l_img // side)).float()
    ids[..., 2] = (torch.arange(l_img, device=dev) % (l_img // side)).float()
    img = torch.randn((1, l_img, cfg.in_channels), generator=g, device=dev).to(torch.bfloat16).expand(2, -1, -1)
    inp = dict(img=img.contiguous(), img_ids=ids,
               txt=torch.randn((2, l_txt, cfg.context_in_dim), generator=g, device=dev).to(torch.bfloat16),
               txt_ids=torch.zeros((2, l_txt, 3), device=dev),
               timesteps=torch.full((2,), 0.5, device=dev).to(torch.bfloat16),
               y=torch.randn((2, cfg.vec_in_dim), generator=g, device=dev).to(torch.bfloat16),
               guidance=torch.full((2,), 30.0, device=dev).to(torch.bfloat16))
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        t = time.perf_counter()
        got = model.flux.forward_cfg(cfg_scale=CFG_SCALE, **inp)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = ops.kernel_launches()
        halves = [model.flux(**{k: v[i:i + 1] for k, v in inp.items()}) for i in range(2)]
        split = torch.cat([halves[1] + CFG_SCALE * (halves[0] - halves[1]), halves[1]], dim=0)
        ops.reset_kernel_launches()
        with plain_dit():
            want = model.flux.forward_cfg(cfg_scale=CFG_SCALE, **inp)
        plain_launches = {n: c for n, c in ops.kernel_launches().items() if c}
    used = {n: launches[n] for n in ("flash_attn_rope", *FUSIONS)}
    out = dict(phase="cfg_forward", batch=2, tokens=l_img + l_txt, cfg_scale=CFG_SCALE, seconds=seconds,
               shape=list(got.shape), finite=bool(torch.isfinite(got).all()),
               rel_rms_err_vs_plain=rel_rms(got.float(), want.float()),
               rel_rms_err_vs_two_b1=rel_rms(got.float(), split.float()), bit_equal_two_b1=torch.equal(got, split),
               launches=used, launches_expected=dict(FUSION_CALLS, flash_attn_rope=ATTENTION_CALLS),
               plain_run_launches=plain_launches, tol=5e-2)
    out["ok"] = (out["finite"] and out["shape"] == [2, l_img, cfg.out_channels]
                 and out["rel_rms_err_vs_plain"] <= out["tol"] and out["rel_rms_err_vs_two_b1"] <= out["tol"]
                 and used == out["launches_expected"] and not any(launches[n] for n in BACKWARDS)
                 and not plain_launches)
    return out


def quant_reference(model) -> dict:
    """The bf16 serving DiT quantized beside itself (quantize_flux_int8, ~12 GB
    more): on reference_inputs, the int8 DiT through kernel G vs through G's
    plain version (relative RMS, as reference_checks), and the int8 DiT vs the
    bf16 one under the JAX package's own criterion (tests/test_quant.py:46-50:
    correlation > 0.98, mean |Δ| / max |bf16| < 0.15)."""
    import numpy as np
    import torch

    import visualcloze_tpu_torch.models.layers as layers_mod
    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.models.quant import quantize_flux_int8
    from visualcloze_tpu_torch.ops.int8_matmul import int8_matmul_plain

    t = time.perf_counter()
    qflux = quantize_flux_int8(model.flux)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t
    int8_gib = sum(b.numel() * b.element_size() for b in qflux.buffers()) / 2 ** 30
    inp, _ = reference_inputs(model)
    with torch.no_grad():
        ops.reset_kernel_launches()
        got = qflux(**inp).float()
        launches = ops.kernel_launches()["int8_matmul"]
        saved = layers_mod.int8_matmul
        layers_mod.int8_matmul = int8_matmul_plain
        try:
            plain = qflux(**inp).float()
        finally:
            layers_mod.int8_matmul = saved
        ref = model.flux(**inp).float()
    del qflux
    corr = float(np.corrcoef(ref.flatten().cpu().numpy(), got.flatten().cpu().numpy())[0, 1])
    out = dict(phase="quant_reference", quantize_seconds=quantize_s, int8_buffers_gib=int8_gib,
               int8_linears=launches, g_vs_plain_rel_rms_err=rel_rms(got, plain), tol=5e-2,
               int8_vs_bf16_corr=corr, int8_vs_bf16_mean_abs_over_max=((got - ref).abs().mean() / ref.abs().max()).item(),
               int8_vs_bf16_rel_rms=rel_rms(got, ref), finite=bool(torch.isfinite(got).all()))
    out["ok"] = (out["finite"] and launches == INT8_LINEARS and out["g_vs_plain_rel_rms_err"] <= out["tol"]
                 and corr > 0.98 and out["int8_vs_bf16_mean_abs_over_max"] < 0.15)
    return out


def _plain_w8a8_kernels():
    """Kernels I, H and G replaced by their plain versions in the DiT's
    linears, until the returned function restores them."""
    import visualcloze_tpu_torch.models.layers as layers_mod
    from visualcloze_tpu_torch.ops.act_quant import act_quant_plain
    from visualcloze_tpu_torch.ops.int8_matmul import int8_matmul_plain
    from visualcloze_tpu_torch.ops.w8a8_matmul import w8a8_matmul_plain

    saved = (layers_mod.act_quant_int8, layers_mod.w8a8_matmul, layers_mod.int8_matmul)
    layers_mod.act_quant_int8, layers_mod.w8a8_matmul, layers_mod.int8_matmul = (
        act_quant_plain, w8a8_matmul_plain, int8_matmul_plain)

    def restore():
        layers_mod.act_quant_int8, layers_mod.w8a8_matmul, layers_mod.int8_matmul = saved

    return restore


def quant_reference_w8a8(model) -> dict:
    """The bf16 serving DiT quantized beside itself to w8a8 (quantize_flux_w8a8)
    and to SmoothQuant w8a8 (quantize_flux_w8a8_smooth, calibrated on the
    default query: 2x3 grid at 384, 30 Euler steps, statistics every 5th and
    at the last, seed 1), one at a time (~12 GB more): on reference_inputs,
    each through kernels I, H and G vs through their plain versions
    (relative RMS, 5%, as quant_reference), and vs the bf16 DiT under the
    JAX package's own w8a8 criterion (tests/test_quant.py:93-113:
    correlation > 0.97, mean |Δ| / max |bf16| < 0.2)."""
    import numpy as np
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.models.quant import quantize_flux_w8a8, quantize_flux_w8a8_smooth

    inp, _ = reference_inputs(model)
    with torch.no_grad():
        ref = model.flux(**inp).float()
    torch.cuda.synchronize()
    model.stage_seconds = {}
    t = time.perf_counter()
    stats = model.w8a8_calibration_stats(queries=[(synthetic_grid(2, 3, 1), query_prompts(2, 3))], steps=30,
                                         stride=5, seed=1)
    torch.cuda.synchronize()
    out = dict(phase="quant_reference_w8a8", calibration_seconds=time.perf_counter() - t,
               calibration_stage_seconds=dict(model.stage_seconds), tol=5e-2)
    ok = True
    for mode in ("w8a8", "w8a8_smooth"):
        t = time.perf_counter()
        qflux = quantize_flux_w8a8(model.flux) if mode == "w8a8" else quantize_flux_w8a8_smooth(model.flux, stats)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t
        with torch.no_grad():
            ops.reset_kernel_launches()
            got = qflux(**inp).float()
            launches = {k: v for k, v in ops.kernel_launches().items() if k in W8A8_KERNELS + ("int8_matmul",)}
            restore = _plain_w8a8_kernels()
            try:
                plain = qflux(**inp).float()
            finally:
                restore()
        gib = sum(b.numel() * b.element_size() for b in qflux.buffers()) / 2 ** 30
        del qflux
        corr = float(np.corrcoef(ref.flatten().cpu().numpy(), got.flatten().cpu().numpy())[0, 1])
        r = dict(quantize_seconds=quantize_s, quantized_buffers_gib=gib, launches=launches,
                 kernels_vs_plain_rel_rms_err=rel_rms(got, plain), vs_bf16_corr=corr,
                 vs_bf16_mean_abs_over_max=((got - ref).abs().mean() / ref.abs().max()).item(),
                 vs_bf16_rel_rms=rel_rms(got, ref), finite=bool(torch.isfinite(got).all()))
        r["ok"] = (r["finite"] and r["kernels_vs_plain_rel_rms_err"] <= out["tol"] and corr > 0.97
                   and r["vs_bf16_mean_abs_over_max"] < 0.2
                   and launches == {"int8_matmul": INT8_LINEARS - W8A8_LINEARS, "w8a8_matmul": W8A8_LINEARS,
                                    "act_quant_int8": W8A8_LINEARS})
        out[mode] = r
        ok = ok and r["ok"]
        torch.cuda.empty_cache()
    out["ok"] = ok
    return out


W8A8_USED_WITH = ("int8_matmul",) + W8A8_KERNELS


def w8a8_launches_ok(run: dict) -> dict:
    """DiT evaluations (A's launches / 57) and, for a w8a8 DiT, I and H
    launched 228 times each per evaluation, G 86 times: the fields for the
    run's line, with `ok` folded in."""
    evals = run["launches"]["flash_attn_rope"] // ATTENTION_CALLS
    want = {"w8a8_matmul": W8A8_LINEARS * evals, "act_quant_int8": W8A8_LINEARS * evals,
            "int8_matmul": (INT8_LINEARS - W8A8_LINEARS) * evals}
    got = {k: run["launches"][k] for k in want}
    return dict(dit_evaluations=evals, w8a8_launches_expected=want,
                ok=run["ok"] and got == want and run["launches"]["flash_attn_rope"] == ATTENTION_CALLS * evals)


# ----------------------------- the main path -----------------------------


def synthetic_grid(rows: int, cols: int, seed: int):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)

    def cell():
        base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        return Image.fromarray(base).resize((1024, 1024), Image.BILINEAR)

    grid = [[cell() for _ in range(cols)] for _ in range(rows)]
    grid[-1][-1] = None
    return grid


def query_prompts(rows: int, cols: int) -> list[str]:
    return [
        f"A grid layout with {rows} rows and {cols} columns, displaying {rows * cols} images arranged side by side.",
        "Each row shows a photo and its edited versions.",
        "The content of the last image in the final row is: a photo.",
    ]


def run_request(model, name, rows, cols, steps, upsampling, seed, used, unused=(), images_out=None) -> dict:
    """One query through process_images; ok if finite, of the right size, and
    every kernel in `used` launched and none in `unused`. images_out: a list
    that receives the images."""
    import torch

    from visualcloze_tpu_torch import ops

    samples = []
    orig = model.denoise_query

    def recording(q, stage="denoise"):
        out = orig(q, stage)
        samples.append((stage, tuple(q["x"].shape), out))
        return out

    model.denoise_query = recording
    grid = synthetic_grid(rows, cols, seed)
    model.set_grid_size(rows, cols)
    prompts = query_prompts(rows, cols)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    try:
        images = model.process_images(grid, prompts, seed=seed, steps=steps, upsampling_steps=10,
                                      upsampling_noise=0.4, is_upsampling=upsampling)
        torch.cuda.synchronize()
    finally:
        model.denoise_query = orig
    seconds = time.perf_counter() - t0
    launches = ops.kernel_launches()
    import numpy as np

    if images_out is not None:
        images_out.extend(images)
    arrs = [np.asarray(im) for im in images]
    finite = all(bool(torch.isfinite(s).all()) for _, _, s in samples)
    want_size = (1024, 1024) if upsampling else (384, 384)
    out = dict(
        phase="request", name=name, grid=[rows, cols], steps=steps, sdedit_steps=10 if upsampling else 0,
        seconds=seconds, stage_seconds=model.stage_seconds,
        sequences=[{"stage": st, "tokens_img": shp[1]} for st, shp, _ in samples],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        images=[list(im.size) for im in images], latents_finite=finite,
        image_std=[float(a.std()) for a in arrs], launches=launches,
    )
    out["ok"] = (finite and len(images) == 1 and images[0].size == want_size
                 and all(s > 0 for s in out["image_std"]) and all(launches[n] > 0 for n in used)
                 and all(launches[n] == 0 for n in unused))
    if set(FUSIONS) <= set(used):  # J-M once per DiT evaluation's count (A's or D's launches / 57)
        evals = (launches["flash_attn_rope"] + launches["flash_attn_fwd"]) // ATTENTION_CALLS
        out["fusion_launches_expected"] = fusions_expected(evals)
        out["ok"] = out["ok"] and fusion_launches(launches) == out["fusion_launches_expected"]
    return out


# ----------------------------- serving -----------------------------

SERVE_ADAPTERS = (("r64", 64, 64), ("r128", 128, 128))  # name, rank, seed: two adapter signatures
SERVE_REQUESTS = (None, "r64", "r128", None)  # the adapter of each concurrent HTTP request


def _pixel_diff(a, b) -> int | None:
    """Largest |Δ| of two uint8 images (None when their shapes differ)."""
    import numpy as np

    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    return int(np.abs(a - b).max()) if a.shape == b.shape else None


def serve_phase(model, r1, base_images) -> dict:
    """Two random adapters registered on the resident bf16 stack, the HTTP
    frontend over PipelinedServer(max_inflight=2) on 127.0.0.1, four default
    queries (request 1's grid, prompts and seed) POSTed at once from four
    client threads (no adapter, r64, r128, no adapter), the same four through
    a server of depth 1 (the CLI's default on one card), then the r64 query
    through process_images. ok: every answer 200; the adapter-free answers
    are request 1's images bit for bit, the HTTP r64 answer the sequential
    r64 images bit for bit, the depth-1 answers the depth-2 ones, each
    adapter's images differ from the base images; A, B, C and J-M launch 9 x
    their count in request 1 and no other kernel launches."""
    import json as _json
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.models.lora import init_lora, randomize_lora_b, tree_leaves
    from visualcloze_tpu_torch.pipeline import PipelinedServer
    from visualcloze_tpu_torch.pipeline.server import _b64_to_image, _image_to_b64, run_frontend

    def gen(seed):
        return torch.Generator(device=model.device).manual_seed(seed)

    t = time.perf_counter()
    for name, rank, seed in SERVE_ADAPTERS:
        model.add_adapter(name, randomize_lora_b(init_lora(model.flux, rank, generator=gen(seed)), gen(seed + 1)))
    free()
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t
    adapter_bytes = {n: sum(x.numel() * x.element_size() for x in tree_leaves(model.adapters[n]))
                     for n, _, _ in SERVE_ADAPTERS}
    resident = torch.cuda.memory_allocated() / 2 ** 30

    rows, cols, seed = 2, 3, 1
    grid = synthetic_grid(rows, cols, seed)
    prompts = query_prompts(rows, cols)
    payload = {"images": [[None if c is None else _image_to_b64(c) for c in row] for row in grid], "prompts": prompts,
               "seed": seed, "steps": 30, "upsampling": True, "upsampling_steps": 10, "upsampling_noise": 0.4}

    def post_all(max_inflight: int):
        """The four requests at once through a fresh frontend and server of
        this depth: (answers, wall seconds, /metrics)."""
        server = PipelinedServer(model, max_inflight=max_inflight)
        httpd, _ = run_frontend(server, host="127.0.0.1", port=0, block=False, max_inflight=max_inflight,
                                max_queue=8)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        answers: list = [None] * len(SERVE_REQUESTS)

        def post(i: int, adapter) -> None:
            body = dict(payload, **({"adapter": adapter} if adapter else {}))
            req = urllib.request.Request(url + "/v1/generate", data=_json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    out = _json.loads(r.read())
                    answers[i] = dict(status=r.status, images=out["images"], server_latency_s=out["latency_s"])
            except urllib.error.HTTPError as e:
                answers[i] = dict(status=e.code, error=e.read().decode()[:500])
            answers[i]["client_seconds"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        try:
            clients = [threading.Thread(target=post, args=(i, a)) for i, a in enumerate(SERVE_REQUESTS)]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            wall = time.perf_counter() - t0
            with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
                metrics = {ln.split(" ")[0]: float(ln.split(" ")[1]) for ln in r.read().decode().splitlines()
                           if ln and not ln.startswith("#")}
        finally:
            httpd.shutdown()
            server.close()
        return answers, wall, metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    answers, wall, metrics = post_all(2)
    fifo_answers, fifo_wall, fifo_metrics = post_all(1)
    t1 = time.perf_counter()
    sequential = model.process_images(grid, prompts, seed=seed, steps=30, upsampling_steps=10, upsampling_noise=0.4,
                                      is_upsampling=True, adapter="r64", grid_size=(rows, cols))
    torch.cuda.synchronize()
    sequential_s = time.perf_counter() - t1
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.adapters.clear()
    free()

    serving = ("flash_attn_rope", "conv3x3_gn_swish", "flash_attn_d512") + FUSIONS
    queries = 2 * len(SERVE_REQUESTS) + 1
    expected = {n: (queries * r1["launches"][n] if n in serving else 0) for n in launches}
    statuses = [a["status"] for a in answers + fifo_answers]
    ok_http = all(st == 200 for st in statuses)
    diff = {}
    if ok_http:
        got = [[np.asarray(_b64_to_image(b)) for b in a["images"]] for a in answers]
        fifo_got = [[np.asarray(_b64_to_image(b)) for b in a["images"]] for a in fifo_answers]
        for i, adapter in enumerate(SERVE_REQUESTS):
            diff[f"request {i} ({adapter or 'base'}) at depth 1 vs depth 2"] = \
                [_pixel_diff(g, w) for g, w in zip(fifo_got[i], got[i])]
        base = [np.asarray(im) for im in base_images]
        seq = [np.asarray(im) for im in sequential]
        for i, adapter in enumerate(SERVE_REQUESTS):
            ref = base if adapter is None else seq if adapter == "r64" else None
            if ref is not None:
                diff[f"request {i} ({adapter or 'base'}) vs {'request 1' if adapter is None else 'sequential r64'}"] = \
                    [_pixel_diff(g, w) for g, w in zip(got[i], ref)]
            if adapter is not None:
                diff[f"request {i} ({adapter}) vs base"] = [_pixel_diff(g, w) for g, w in zip(got[i], base)]
    bit_equal = {k: all(d == 0 for d in v) for k, v in diff.items() if not k.endswith("vs base")}
    adapters_act = {k: all(d is None or d > 0 for d in v) for k, v in diff.items() if k.endswith("vs base")}
    def summary(answers):
        return [{"adapter": a, **{k: v for k, v in ans.items() if k != "images"}}
                for a, ans in zip(SERVE_REQUESTS, answers)]

    def mean_latency(answers):
        return sum(a["client_seconds"] for a in answers) / len(answers)

    line = dict(
        phase="serve", requests=summary(answers), wall_seconds_concurrent=wall,
        mean_latency_seconds=mean_latency(answers), sequential_r64_seconds=sequential_s,
        request_1_seconds=r1["seconds"], max_inflight=2, metrics=metrics,
        fifo=dict(max_inflight=1, requests=summary(fifo_answers), wall_seconds_concurrent=fifo_wall,
                  mean_latency_seconds=mean_latency(fifo_answers), metrics=fifo_metrics),
        adapters={n: r for n, r, _ in SERVE_ADAPTERS}, adapter_bytes=adapter_bytes,
        adapter_register_seconds=register_s, resident_gib_with_adapters=resident, peak_gib=peak,
        pixel_max_diff=diff, bit_equal=bit_equal, adapters_act=adapters_act, launches=launches,
        launches_expected=expected,
    )
    line["ok"] = (ok_http and len(bit_equal) == 7 and all(bit_equal.values()) and len(adapters_act) == 2
                  and all(adapters_act.values()) and launches == expected)
    return line


def diffusers_phase(model, lora_path: str) -> dict:
    """VisualClozePipeline over the loaded model: the reference LoRA file as
    the runtime adapter "ref", a 2x2 call at 10 steps with
    upsampling_strength=0 (the plain resize) with and without it, then the
    same file folded into the DiT and the call again. ok: the mean |Δ|
    (0-255) of the adapter's image against the folded one is below half of
    its |Δ| against the base image (JAX's criterion), A runs 57 x 9 x 3
    times and J-M their counts for 9 x 3 evaluations, B and C run, no other
    kernel."""
    import numpy as np
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.pipeline import VisualClozePipeline

    pipe = VisualClozePipeline(model).to(model.device)
    grid = synthetic_grid(2, 2, seed=4)
    kw = dict(task_prompt="Each row shows a photo and its edited versions.", content_prompt="a photo.",
              image=grid, num_inference_steps=10, upsampling_strength=0.0, seed=4)
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    t = time.perf_counter()
    pipe.load_lora_weights(lora_path, adapter_name="ref")
    torch.cuda.synchronize()
    seconds = {"load_lora_weights_adapter": time.perf_counter() - t}

    def call(name, **extra):
        t0 = time.perf_counter()
        img = pipe(**kw, **extra).images[0][0]
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return np.asarray(img, np.float32)

    adapted = call("call_adapter", adapter="ref")
    base = call("call_base")
    model.adapters.clear()
    t = time.perf_counter()
    pipe.load_lora_weights(lora_path)
    torch.cuda.synchronize()
    seconds["load_lora_weights_fold"] = time.perf_counter() - t
    folded = call("call_folded")
    launches = ops.kernel_launches()
    vs_folded = float(np.abs(adapted - folded).mean())
    vs_base = float(np.abs(adapted - base).mean())
    serving = ("flash_attn_rope", "conv3x3_gn_swish", "flash_attn_d512") + FUSIONS
    line = dict(phase="diffusers_api", grid=[2, 2], steps=10, image=list(adapted.shape), seconds=seconds,
                mean_abs_diff_adapter_vs_folded=vs_folded, mean_abs_diff_adapter_vs_base=vs_base,
                launches=launches, attention_launches_expected=ATTENTION_CALLS * 9 * 3,
                fusion_launches_expected=fusions_expected(9 * 3))
    line["ok"] = (vs_folded < 0.5 * vs_base and launches["flash_attn_rope"] == ATTENTION_CALLS * 9 * 3
                  and fusion_launches(launches) == line["fusion_launches_expected"]
                  and all(launches[n] > 0 for n in serving)
                  and all(v == 0 for n, v in launches.items() if n not in serving))
    return line


# ----------------------------- int4 DiT, samplers, BFL tools route -----------------------------


def quant_reference_int4(model):
    """The bf16 serving DiT quantized beside itself to int4
    (quantize_flux_int4, ~6 GB more): on reference_inputs, the int4 DiT
    through kernel G4 vs through G4's plain version (relative RMS, 5%, as
    quant_reference), and its output's correlation with the bf16 DiT's
    (> 0.5: a wrong nibble order or group would decorrelate it; random
    weights say nothing of int4 quality). Returns (line, the int4 DiT
    parked in host memory for request_int4)."""
    import numpy as np
    import torch

    import visualcloze_tpu_torch.models.layers as layers_mod
    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.models.quant import quantize_flux_int4
    from visualcloze_tpu_torch.ops.int4_matmul import int4_matmul_plain

    t = time.perf_counter()
    qflux = quantize_flux_int4(model.flux)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t
    int4_gib = sum(b.numel() * b.element_size() for b in qflux.buffers()) / 2 ** 30
    inp, _ = reference_inputs(model)
    with torch.no_grad():
        ops.reset_kernel_launches()
        got = qflux(**inp).float()
        launches = ops.kernel_launches()["int4_matmul"]
        saved = layers_mod.int4_matmul
        layers_mod.int4_matmul = int4_matmul_plain
        try:
            plain = qflux(**inp).float()
        finally:
            layers_mod.int4_matmul = saved
        ref = model.flux(**inp).float()
    corr = float(np.corrcoef(ref.flatten().cpu().numpy(), got.flatten().cpu().numpy())[0, 1])
    out = dict(phase="quant_reference_int4", quantize_seconds=quantize_s, int4_buffers_gib=int4_gib,
               int4_linears=launches, g4_vs_plain_rel_rms_err=rel_rms(got, plain), tol=5e-2, int4_vs_bf16_corr=corr,
               int4_vs_bf16_rel_rms=rel_rms(got, ref), corr_gate=0.5, finite=bool(torch.isfinite(got).all()))
    out["ok"] = (out["finite"] and launches == INT8_LINEARS and out["g4_vs_plain_rel_rms_err"] <= out["tol"]
                 and corr > out["corr_gate"])
    return out, qflux.to("cpu")


def _denoiser(flux, q):
    """model_fn(img, timesteps) of the DiT on a prepared query's tokens."""

    def model_fn(img, timesteps):
        return flux(img=img, img_ids=q["img_ids"], txt=q["txt"], txt_ids=q["txt_ids"], timesteps=timesteps,
                    y=q["vec"], txt_mask=q["txt_mask"], img_mask=q["img_mask"], guidance=q["guidance"])

    return model_fn


def samplers_sde(model) -> dict:
    """A 2x2 query at 384 on the bf16 stack through Sampler.sample_sde on
    10 grid points (SBDM diffusion from 1 - 1e-3, the deterministic Mean step
    last): Euler-Maruyama (9 DiT evaluations) and Heun (17), each twice from
    the same generator seed. ok: finite latents, evaluations = A's launches /
    57 as the method says (J-M their counts per evaluation), the two runs
    bit-equal."""
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.transport import Sampler, create_transport

    model.set_grid_size(2, 2)
    q = model.prepare_query(synthetic_grid(2, 2, 5), query_prompts(2, 2), seed=5, steps=10)
    sampler = Sampler(create_transport())
    model_fn = _denoiser(model.flux, q)
    runs, ok, total = {}, True, {}
    for method, evals in (("Euler", 9), ("Heun", 17)):
        sample = sampler.sample_sde(sampling_method=method, num_steps=10)
        outs, seconds, counts = [], [], []
        for _ in range(2):
            torch.cuda.synchronize()
            ops.reset_kernel_launches()
            t = time.perf_counter()
            with torch.no_grad():
                outs.append(sample(q["x"], model_fn, {"cond": q["img_cond"]},
                                   generator=torch.Generator(device=model.device).manual_seed(6)))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            counts.append(ops.kernel_launches())
        a = [c["flash_attn_rope"] for c in counts]
        r = dict(seconds=seconds, dit_evaluations=[n // ATTENTION_CALLS for n in a],
                 evaluations_expected=evals, finite=bool(torch.isfinite(outs[0]).all()),
                 bit_equal_twice=torch.equal(outs[0], outs[1]), tokens_img=int(q["x"].shape[1]))
        r["fusion_launches_expected"] = fusions_expected(evals)
        r["ok"] = (r["finite"] and r["bit_equal_twice"] and all(n == ATTENTION_CALLS * evals for n in a)
                   and all(fusion_launches(c) == r["fusion_launches_expected"] for c in counts))
        runs[method] = r
        ok = ok and r["ok"]
        for c in counts:
            total = {k: total.get(k, 0) + v for k, v in c.items()}
    return dict(phase="samplers_sde", grid=[2, 2], steps=10, runs=runs, launches=total, ok=ok)


def likelihood(model) -> dict:
    """sample_ode_likelihood on the bf16 DiT: a 2x2 grid at 256 (1024 image +
    512 text tokens), 4 grid points (3 steps), one Rademacher probe a step,
    the divergence by one vector-Jacobian product: the attention under
    autograd is kernel E forward and F backward (57 x 3 each), no kernel A;
    J-M launch 115 / 114 / 76 / 57 times an evaluation forward and J'-M'
    114 / 114 / 75 / 57 in its backward (the vjp is over x alone: the first
    double block's txt stream carries no gradient). ok: a finite logp."""
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.transport import sample_ode_likelihood

    resolution = model.resolution
    model.resolution = 256
    try:
        model.set_grid_size(2, 2)
        q = model.prepare_query(synthetic_grid(2, 2, 7), query_prompts(2, 2), seed=7, steps=4)
    finally:
        model.resolution = resolution
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t = time.perf_counter()
    logp, x_t = sample_ode_likelihood(_denoiser(model.flux, q), q["x"].float(), 4, cond=q["img_cond"],
                                      generator=torch.Generator(device=model.device).manual_seed(8))
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    out = dict(phase="likelihood", grid=[2, 2], resolution=256, tokens_img=int(q["x"].shape[1]),
               tokens_txt=int(q["txt"].shape[1]), steps=3, seconds=time.perf_counter() - t,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, logp=logp.tolist(),
               logp_per_dim=(logp / x_t[0].numel()).tolist(), finite=bool(torch.isfinite(logp).all()),
               launches=launches, fusion_launches_expected=autograd_expected(3, 3, txt_grad=False))
    want = ATTENTION_CALLS * 3
    out["ok"] = (out["finite"] and launches["flash_attn_rope"] == 0
                 and all(launches[n] == want for n in ("flash_attn_fwd_lse", "flash_attn_bwd_dq",
                                                        "flash_attn_bwd_dkv"))
                 and autograd_launches(launches) == out["fusion_launches_expected"])
    return out


BFL_SIZE = 512  # the tools route's image side (1024 image tokens)


def _bfl_query(flux, ae, inp, guidance: float, steps: int = 10):
    """The BFL route's denoise (Euler on steps + 1 grid points, img_cond
    concatenated on channels) and decode: (1, H, W, 3) pixels in [-1, 1]."""
    import torch

    from visualcloze_tpu_torch.models.sampling import unpack
    from visualcloze_tpu_torch.ops.schedule import ode_timesteps
    from visualcloze_tpu_torch.transport import denoise_ode

    bf16 = torch.bfloat16
    q = dict(img_ids=inp["img_ids"], txt=inp["txt"].to(bf16), txt_ids=inp["txt_ids"], vec=inp["vec"].to(bf16),
             txt_mask=None, img_mask=None, guidance=torch.full((1,), guidance, dtype=bf16, device=inp["img"].device))
    cond = inp.get("img_cond")
    with torch.no_grad():
        x = denoise_ode(_denoiser(flux, q), inp["img"], ode_timesteps(steps + 1, inp["img"].shape[1]),
                        cond=None if cond is None else cond.to(bf16))
        return ae.decode(unpack(x, BFL_SIZE, BFL_SIZE).to(bf16)).float()


def _bfl_save(pixels, name: str, nsfw, root) -> dict:
    """save_image with the NSFW gate and the watermark; the watermark's score
    read back from the file (or from the marked array if the gate refused)."""
    import numpy as np
    from PIL import Image

    from visualcloze_tpu_torch.models.postprocess import embed_watermark, extract_watermark_score, save_image

    arr = ((pixels[0].clamp(-1, 1) + 1) * 127.5).round().to("cpu").numpy().astype(np.uint8)
    image = Image.fromarray(arr)
    p_nsfw = nsfw(image)
    path = save_image(image, str(root / f"{name}.png"), nsfw_classifier=nsfw, metadata={"query": name})
    marked = np.asarray(Image.open(path).convert("RGB")) if path else embed_watermark(arr)
    return dict(saved=path is not None, nsfw_prob=p_nsfw, watermark_score=extract_watermark_score(marked),
                image_std=float(arr.std()), finite=bool(np.isfinite(pixels.cpu().numpy()).all()))


def _bfl_prompt(name: str) -> str:
    return f"A photo of a house by a lake, {name} conditioning."


def nsfw_gate(dev):
    """The NSFW gate of save_image: the ViT-base classifier, random (seed 4)."""
    import torch

    from visualcloze_tpu_torch.models.postprocess import build_nsfw_classifier
    from visualcloze_tpu_torch.models.vision_towers import ViTClassifierConfig, build_vit_classifier, init_random_

    vit = build_vit_classifier(ViTClassifierConfig(), dev)
    return build_nsfw_classifier(model=init_random_(vit, torch.Generator(device=dev).manual_seed(4)))


def bfl_fill(model, root) -> dict:
    """The tools route's Fill query on the resident FLUX.1-Fill DiT:
    prepare_fill at 512^2 (a centred square masked), 10 Euler steps,
    decoded, saved through the NSFW gate and the watermark. Returns its
    part of the bfl_route line."""
    import numpy as np
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.models.sampling import get_noise, prepare_fill

    dev = model.device
    t = time.perf_counter()
    nsfw = nsfw_gate(dev)
    nsfw_build_s = time.perf_counter() - t
    gen = torch.Generator(device=dev).manual_seed(21)
    img_cond = np.asarray(synthetic_grid(1, 2, 21)[0][0].resize((BFL_SIZE, BFL_SIZE)), np.float32) / 127.5 - 1.0
    mask = np.zeros((BFL_SIZE, BFL_SIZE), np.float32)
    mask[BFL_SIZE // 4: 3 * BFL_SIZE // 4, BFL_SIZE // 4: 3 * BFL_SIZE // 4] = 1.0
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    t = time.perf_counter()
    noise = get_noise(1, BFL_SIZE // 8, BFL_SIZE // 8, generator=gen, device=dev)
    inp = prepare_fill(model.t5, model.clip, noise, _bfl_prompt("fill"), model.ae, img_cond, mask, generator=gen)
    pixels = _bfl_query(model.flux, model.ae, inp, guidance=30.0)
    torch.cuda.synchronize()
    r = dict(seconds=time.perf_counter() - t, tokens_img=int(inp["img"].shape[1]),
             cond_channels=int(inp["img_cond"].shape[-1]), launches=ops.kernel_launches(),
             **_bfl_save(pixels, "fill", nsfw, root))
    return dict(fill=r, nsfw_build_seconds=nsfw_build_s)


def bfl_route(model, fill: dict, root) -> dict:
    """The rest of the tools route, on the stack's T5, CLIP and VAE with the
    serving DiT freed: one flux-dev-depth DiT (in_channels 128, seed 2) for a
    Canny query and a Depth query (the full-width DepthAnything-large tower
    at 518, random, seed 3), freed; one flux-dev DiT (in_channels 64, seed 3)
    for a Redux query (the SigLIP so400m tower at 384, random, seed 5: 729
    tokens after the 512 text tokens; the projector random, seed 6). Each
    query 10 Euler steps at 512^2, saved as the Fill one. ok: every output
    finite, kernels A, B and C launched in each query and no other kernel."""
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.config import _CONTROL_FLUX, _DEV_FLUX
    from visualcloze_tpu_torch.models.flux import build_flux
    from visualcloze_tpu_torch.models.image_embedders import (CannyImageEncoder, DepthImageEncoder,
                                                              ReduxImageEncoder, init_redux_projector)
    from visualcloze_tpu_torch.models.sampling import get_noise, prepare_control, prepare_redux
    from visualcloze_tpu_torch.models.vision_towers import (DepthAnythingTowerConfig, SigLIPVisionConfig,
                                                            build_depth_anything, build_siglip, init_random_)

    dev = model.device
    cond_img = synthetic_grid(1, 2, 22)[0][0].resize((BFL_SIZE, BFL_SIZE))
    out = dict(phase="bfl_route", size=BFL_SIZE, steps=10, **fill)
    model.flux = None
    free()
    nsfw = nsfw_gate(dev)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def query(name, seed, flux, make_inp, guidance):
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        t = time.perf_counter()
        gen = seeded(seed)
        inp = make_inp(get_noise(1, BFL_SIZE // 8, BFL_SIZE // 8, generator=gen, device=dev), gen)
        pixels = _bfl_query(flux, model.ae, inp, guidance)
        torch.cuda.synchronize()
        out[name] = dict(seconds=time.perf_counter() - t, tokens_img=int(inp["img"].shape[1]),
                         tokens_txt=int(inp["txt"].shape[1]), launches=ops.kernel_launches(),
                         **_bfl_save(pixels, name, nsfw, root))

    t = time.perf_counter()
    flux = build_flux(_CONTROL_FLUX, dev, torch.bfloat16).init_random_(seeded(2))
    depth_tower = init_random_(build_depth_anything(DepthAnythingTowerConfig(), dev), seeded(3))
    torch.cuda.synchronize()
    out["control_build_seconds"] = time.perf_counter() - t
    query("canny", 31, flux, lambda noise, gen: prepare_control(
        model.t5, model.clip, noise, _bfl_prompt("canny"), model.ae, CannyImageEncoder(), cond_img,
        generator=gen), 30.0)
    depth = DepthImageEncoder(model=depth_tower)
    t = time.perf_counter()
    depth(cond_img)
    torch.cuda.synchronize()
    out["depth_tower_seconds"] = time.perf_counter() - t  # the tower at 518, the map back to 512 (a second call)
    query("depth", 32, flux, lambda noise, gen: prepare_control(
        model.t5, model.clip, noise, _bfl_prompt("depth"), model.ae, depth, cond_img, generator=gen), 10.0)
    del flux, depth, depth_tower
    free()

    t = time.perf_counter()
    flux = build_flux(_DEV_FLUX, dev, torch.bfloat16).init_random_(seeded(3))
    siglip = init_random_(build_siglip(SigLIPVisionConfig(), dev), seeded(5))
    redux = ReduxImageEncoder(init_redux_projector(seeded(6), device=dev), siglip_model=siglip)
    torch.cuda.synchronize()
    out["redux_build_seconds"] = time.perf_counter() - t
    redux(cond_img)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out["redux_tokens"] = int(redux(cond_img).shape[1])
    torch.cuda.synchronize()
    out["siglip_redux_seconds"] = time.perf_counter() - t  # SigLIP at 384 and the projector (after a first call)
    query("redux", 33, flux, lambda noise, gen: prepare_redux(
        model.t5, model.clip, noise, _bfl_prompt("redux"), redux, cond_img), 3.5)
    del flux, siglip, redux
    free()

    serving = ("flash_attn_rope", "conv3x3_gn_swish", "flash_attn_d512") + FUSIONS
    names = ("fill", "canny", "depth", "redux")
    out["launches"] = {k: sum(out[n]["launches"][k] for n in names) for k in out["fill"]["launches"]}
    out["ok"] = all(out[n]["finite"] and out[n]["image_std"] > 0 and all(out[n]["launches"][k] > 0 for k in serving)
                    and all(v == 0 for k, v in out[n]["launches"].items() if k not in serving)
                    and fusion_launches(out[n]["launches"]) == fusions_expected(
                        out[n]["launches"]["flash_attn_rope"] // ATTENTION_CALLS) for n in names)
    out["ok"] = out["ok"] and out["redux_tokens"] == 729 and out["redux"]["tokens_txt"] == 512 + 729
    return out


# ----------------------------- training -----------------------------


def write_dataset(root, n: int = 6, size: int = 512) -> str:
    """A Graph200K-format dataset of `n` records of size x size PNGs (seed i
    per record), with a JSON-text config (JSON is YAML)."""
    import numpy as np
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    records = []
    for i in range(n):
        img = Image.fromarray(np.random.default_rng(i).integers(0, 256, (size, size, 3), dtype=np.uint8))
        cond = {}
        for name in ("target", "reference", "foreground", "canny", "depth"):
            path = root / f"{i}_{name}.png"
            img.save(path)
            cond[name] = str(path)
        records.append({"condition": cond, "quality_assessment": {"objectConsistency": 5},
                        "description": {"item": f"item{i}", "description_0": "a photo"}})
    (root / "data.json").write_text(json.dumps(records))
    config = root / "config.yaml"
    config.write_text(json.dumps({"META": [{"path": str(root / "data.json"), "type": "image_grid_graph200k"}]}))
    return str(config)


TRAIN_KERNELS = ("flash_attn_fwd_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "conv3x3_gn_swish",
                 "flash_attn_d512")


def run_training(tmp, remat_policy: str):
    """The trainer's main at full width, 3 steps; returns (phase line, main's result)."""
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.training.train import main as train_main

    config = write_dataset(tmp / "data")
    results = tmp / "results"
    argv = ["--data_path", config, "--results_dir", str(results), "--init_random", "--grid_resolution", "384",
            "--lora_rank", "128", "--max_steps", "3", "--global_bsz", "2", "--micro_bsz", "1",
            "--checkpointing", "--remat_policy", remat_policy, "--ckpt_every", "3", "--log_every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    result = train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.kernel_launches()
    for rec in result["history"]:
        emit(dict(phase="train_step", **rec))
    ckpt = results / "checkpoints" / "0000003"
    files = sorted(p.name for p in ckpt.iterdir()) if ckpt.is_dir() else []
    hist = result["history"]
    micro = len(hist) * 2  # global_bsz 2 of micro_bsz 1: each micro-batch one evaluation, differentiated once
    out = dict(phase="train", argv=argv, seconds=seconds, steps=len(hist), launches=launches,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, checkpoint_files=files,
               checkpoint_gib=sum(p.stat().st_size for p in ckpt.iterdir()) / 2 ** 30 if files else 0.0,
               remat_policy=remat_policy, fusion_launches_expected=autograd_expected(REMAT_PASSES * micro, micro))
    out["ok"] = (len(hist) == 3
                 and all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
                         for r in hist)
                 and hist[0]["lora_b_absmax"] > 0
                 and {"state.pt", "consolidated.00-of-01.pth", "model_args.json", "resume_step.txt"} <= set(files)
                 and (ckpt / "resume_step.txt").read_text() == "3"
                 and all(launches[n] > 0 for n in TRAIN_KERNELS) and launches["int8_matmul"] == 0
                 and autograd_launches(launches) == out["fusion_launches_expected"])
    return out, result


# ----------------------------- multi-card slice on one card -----------------------------

E_KERNEL, F_KERNELS = "flash_attn_fwd_lse", ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")
RING_CASES = ((3968, "the default query's 3968 tokens, its last 64 keys padded"),
              (5760, "the 3x3 grid's 5760 tokens, the last 64 keys padded"))


def ring_chunks() -> dict:
    """The ring's own schedule (ops/ring_attention.py: _ring_fwd_lse, _merge,
    _ring_bwd_pass) in one process over P = 2 and 4 chunks of the full-width
    (1, 24, L, 128) bf16 sequence with a key-padding bias, the rotation done
    by indexing (LocalRing), against whole-sequence E and F: o within E's
    4 bf16 ulps, dq, dk, dv within F's; E, F-dq and F-dkv launch P^2 times
    each and nothing else launches. Then one chunk pair at cp = 4 (L / 4
    tokens against L / 4 keys): E and F timed as replayed CUDA graphs (a
    chunk's kernel is about as short as its wrapper's host-side launch)
    beside their plain versions, SDPA (its forward graph-timed too; its
    backward fwd+bwd - fwd, eager) and the bound."""
    import torch
    import torch.nn.functional as F

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.ops import flash_attention as fa
    from visualcloze_tpu_torch.ops.ring_attention import LocalRing, _ring_bwd_pass, _ring_fwd_lse

    cases, chunks, counted = [], [], {n: 0 for n in ops.KERNELS}
    ok = True
    for L, what in RING_CASES:
        q, k, v, do, bias, valid = attention_case(1, L, True, L + 3)
        o_ref, lse_ref = fa.flash_attn_fwd_lse(q, k, v, bias)
        delta = (do.float() * o_ref.float()).sum(-1)
        ref = {"o": o_ref, "dq": fa.flash_attn_bwd_dq(q, k, v, bias, do, lse_ref, delta)}
        ref["dk"], ref["dv"] = fa.flash_attn_bwd_dkv(q, k, v, bias, do, lse_ref, delta)
        tols = {n: bf16_ulps_tol(t) for n, t in ref.items()}
        for P in (2, 4):
            def split(t, dim=2):
                return [c.contiguous() for c in t.chunk(P, dim=dim)]

            qs, ks, vs, dos, bs = split(q), split(k), split(v), split(do), split(bias, 1)
            torch.cuda.synchronize()
            ops.reset_kernel_launches()
            os_, lses = _ring_fwd_lse(qs, ks, vs, bs, LocalRing(P))
            dqs, dks, dvs = _ring_bwd_pass(qs, ks, vs, bs, os_, lses, dos, LocalRing(P))
            torch.cuda.synchronize()
            launches = ops.kernel_launches()
            got = {"o": torch.cat(os_, 2), "dq": torch.cat(dqs, 2), "dk": torch.cat(dks, 2), "dv": torch.cat(dvs, 2)}
            errs = {n: (got[n].float() - ref[n].float()).abs().max().item() for n in ref}
            others = {n: c for n, c in launches.items() if c and n not in (E_KERNEL, *F_KERNELS)}
            case_ok = (all(errs[n] <= tols[n] for n in errs) and not others
                       and all(launches[n] == P * P for n in (E_KERNEL, *F_KERNELS)))
            for n, c in launches.items():
                counted[n] += c
            cases.append(dict(tokens=L, chunks=P, chunk_tokens=L // P, what=what, errs=errs, tols=tols,
                              launches={n: launches[n] for n in (E_KERNEL, *F_KERNELS)}, other_launches=others,
                              ok=case_ok))
            ok = ok and case_ok
            del os_, lses, dqs, dks, dvs, got
        c = L // 4  # one (query block, key chunk) pair of the cp = 4 ring: block 0 against the padded last chunk
        qc, doc = q[:, :, :c].contiguous(), do[:, :, :c].contiguous()
        kc, vc, bc = k[:, :, L - c:].contiguous(), v[:, :, L - c:].contiguous(), bias[:, L - c:].contiguous()
        lse_c, delta_c = lse_ref[:, :, :c].contiguous(), delta[:, :, :c].contiguous()
        n_keys = c - (L - valid[0])
        # a chunk's kernel is about as short as its wrapper's host-side launch: time replayed CUDA graphs
        e_ms = cuda_ms(lambda: fa.flash_attn_fwd_lse(qc, kc, vc, bc), 20, graph=True)
        e_plain = cuda_ms(lambda: fa.flash_fwd_lse_plain(qc, kc, vc, bc), 2)
        amask = sdpa_mask(bc)
        e_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=amask), 20, graph=True)
        e_bound, e_by = bound(4.0 * 24 * c * n_keys * 128, 2 * 24 * 2 * c * 128 * 2 + 24 * c * 4 + c * 4)
        fargs = (qc, kc, vc, bc, doc, lse_c, delta_c)
        dq_ms = cuda_ms(lambda: fa.flash_attn_bwd_dq(*fargs), 20, graph=True)
        dkv_ms = cuda_ms(lambda: fa.flash_attn_bwd_dkv(*fargs), 20, graph=True)
        dq_plain = cuda_ms(lambda: fa.flash_bwd_dq_plain(*fargs), 2)
        dkv_plain = cuda_ms(lambda: fa.flash_bwd_dkv_plain(*fargs), 2)
        leaves = [t.detach().clone().requires_grad_() for t in (qc, kc, vc)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves, attn_mask=amask)

        f_lib = cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), leaves, doc), 10) - cuda_ms(sdpa_fwd, 10)
        io = 24 * c * (128 * 2 * 4 + 4 * 2) + c * 4
        dq_bound, dq_by = bound(6.0 * 24 * c * n_keys * 128, io + 24 * c * 128 * 2)
        dkv_bound, dkv_by = bound(8.0 * 24 * c * n_keys * 128, io + 2 * 24 * c * 128 * 2)
        chunks.append(dict(
            tokens=L, chunk=[1, 24, c, 128], keys=c, real_keys=n_keys,
            flash_attn_fwd_lse=dict(ms=e_ms, plain_ms=e_plain, library_ms=e_lib, bound_ms=e_bound, bound_by=e_by,
                                    share_of_bound=e_bound / e_ms),
            flash_attn_bwd_dq=dict(ms=dq_ms, plain_ms=dq_plain, bound_ms=dq_bound, bound_by=dq_by,
                                   share_of_bound=dq_bound / dq_ms),
            flash_attn_bwd_dkv=dict(ms=dkv_ms, plain_ms=dkv_plain, bound_ms=dkv_bound, bound_by=dkv_by,
                                    share_of_bound=dkv_bound / dkv_ms),
            f_library_ms=f_lib, library="F.scaled_dot_product_attention (backward: fwd+bwd - fwd, dq dk dv)"))
        del q, k, v, do, ref, leaves
        torch.cuda.empty_cache()
    return dict(phase="ring_chunks", cases=cases, chunk_timing=chunks, launches=counted, ok=ok)


def _leaf_max(tree, key: str) -> float:
    from visualcloze_tpu_torch.models.lora import tree_items

    return max(t.detach().abs().max().item() for p, t in tree_items(tree) if p.endswith("." + key))


def moe_train(tmp) -> dict:
    """The trainer's main at full width and depth with MoE-LoRA: 4 experts of
    rank 32 (and the shared pair, the gate) on every linear, 2 steps of 2
    micro-batches, per-block remat; finite losses, every expert and gate
    leaf moved (expert_b and shared_b off zero, gate_w off its init, drawn
    again from the trainer's seed); E and F launches, seconds per step, peak
    memory."""
    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.models.lora import init_moe_lora, lora_param_count, tree_items
    from visualcloze_tpu_torch.training.train import main as train_main

    config = write_dataset(tmp / "data_moe")
    argv = ["--data_path", config, "--results_dir", str(tmp / "results_moe"), "--init_random",
            "--grid_resolution", "384", "--lora_rank", "32", "--moe_experts", "4", "--max_steps", "2",
            "--global_bsz", "2", "--micro_bsz", "1", "--checkpointing", "--remat_policy", REMAT_POLICY,
            "--ckpt_every", "1000", "--log_every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    result = train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.kernel_launches()
    state = result["state"]
    hist = result["history"]
    trained = dict(tree_items(state.lora))
    init = dict(tree_items(init_moe_lora(state.params, 32, 4, generator=torch.Generator(device="cuda").manual_seed(1))))
    gate_moved = min((trained[p] - init[p]).abs().max().item() for p in trained if p.endswith(".gate_w"))
    expert_a_moved = min((trained[p] - init[p]).abs().max().item() for p in trained if p.endswith(".expert_a"))
    del init
    micro = len(hist) * 2
    out = dict(phase="moe_train", argv=argv, seconds=seconds, steps=len(hist), losses=[r["loss"] for r in hist],
               grad_norms=[r["grad_norm"] for r in hist], step_seconds=[r["seconds"] for r in hist],
               trainable_values=lora_param_count(state.lora), expert_b_absmax=_leaf_max(state.lora, "expert_b"),
               shared_b_absmax=_leaf_max(state.lora, "shared_b"), min_gate_w_moved=gate_moved,
               min_expert_a_moved=expert_a_moved, launches=launches,
               fusion_launches_expected=autograd_expected(REMAT_PASSES * micro, micro),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out["ok"] = (len(hist) == 2 and all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in hist)
                 and out["expert_b_absmax"] > 0 and out["shared_b_absmax"] > 0 and gate_moved > 0
                 and expert_a_moved > 0 and all(launches[n] > 0 for n in (E_KERNEL, *F_KERNELS))
                 and autograd_launches(launches) == out["fusion_launches_expected"])
    del state, result, trained
    return out


DIST_DEPTH = (4, 8)  # (double, single) blocks of dist_one_rank's DiT: its depth cut, its width full


@contextlib.contextmanager
def cut_depth(depth: int, depth_single: int):
    """The loader's published configs with the DiT's depth cut (widths kept)."""
    import dataclasses

    from visualcloze_tpu_torch.pipeline import loader

    configs = loader._configs

    def cut(tiny: bool):
        flux, *rest = configs(tiny)
        return (flux if tiny else dataclasses.replace(flux, depth=depth, depth_single_blocks=depth_single), *rest)

    loader._configs = cut
    try:
        yield
    finally:
        loader._configs = configs


@contextlib.contextmanager
def lora_steps():
    """Record the trainer's LoRA leaves (fp32 copies on the host, by name)
    before its first step and after each step: yields the list the
    snapshots go into. It wraps the step that train.main makes; the
    trainer's own code runs unchanged."""
    import torch

    from visualcloze_tpu_torch.models.lora import tree_items
    from visualcloze_tpu_torch.training import train

    snaps, make = [], train.make_train_step

    def snap(state):
        return {p: t.detach().to("cpu", torch.float32).clone() for p, t in tree_items(state.lora)}

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, *a, **k):
            if not snaps:
                snaps.append(snap(state))
            out = step(state, *a, **k)
            snaps.append(snap(state))
            return out

        return run

    train.make_train_step = recording
    try:
        yield snaps
    finally:
        train.make_train_step = make


def lora_step_diffs(a: list, b: list) -> list[dict]:
    """Per step after the first snapshot: {leaf: |a - b| / |b's change since
    the first snapshot|} (Frobenius norms; 0 where neither moved)."""
    out = []
    for sa, sb in zip(a[1:], b[1:]):
        row = {}
        for p, tb in sb.items():
            moved = (tb - b[0][p]).norm().item()
            diff = (sa[p] - tb).norm().item()
            row[p] = diff / moved if moved > 0 else (0.0 if diff == 0 else math.inf)
        out.append(row)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


UPSTREAM_OF_VEC = ("time_in.", "vector_in.", "guidance_in.")  # the LoRA leaves whose gradients reach vec only
# dist_one_rank's bounds (relative), about twice the readings of a sound run on an H100 80GB HBM3 at
# 700 W (PERF.md) while FSDP2's per-block input hooks still regrouped vec's gradient: 2.10e-5, 1.283e-4,
# 1.442e-4; leaves 7.0e-7 and 0.070 after step 1, 0.050 and 0.118 after step 2. A double block's two
# modulations now share one silu(vec) (models/layers.py), so each block adds one contribution to vec's
# gradient in both runs, in the same order: every figure reads 0, and every leaf's first gradient but
# the UPSTREAM_OF_VEC ones is held equal bit for bit (rest_first_grads_equal). A skipped or wrong update
# of a leaf moves its figure to about 0.5 or more.
DIST_BOUNDS = dict(first_grad_norm=5e-5, second_loss=2.5e-4, second_grad_norm=2.5e-4,
                   step1_leaves=1.5e-6, step1_upstream=0.15, step2_leaves=0.1, step2_upstream=0.25)


@contextlib.contextmanager
def grad_norm_records():
    """Each leaf's gradient norm every time the train step takes its global
    norm (training.step._global_norm, whose first call in a step sees every
    differentiated leaf); yields the list of {leaf: norm} records. The
    trainer's own arithmetic runs unchanged."""
    from visualcloze_tpu_torch.training import step as step_mod

    records, take = [], step_mod._global_norm

    def recording(grads, state=None):
        records.append({n: g.detach().float().norm().item() for n, g in grads.items()})
        return take(grads, state)

    step_mod._global_norm = recording
    try:
        yield records
    finally:
        step_mod._global_norm = take


def dist_one_rank(tmp) -> dict:
    """The trainer's main as torchrun runs it, on one card: RANK 0 of
    WORLD_SIZE 1, so initialize_distributed starts an NCCL group, create_mesh
    builds the mesh over it and shard_params(mode="fsdp") puts the DiT under
    FSDP2; 2 steps, then the same 2 steps with no process group (the same
    seed). The LoRA leaves are recorded before and after each step
    (lora_steps). The first step's loss is equal bit for bit (the forward is
    the same arithmetic). vec's bf16 gradient is the sum of every block's
    contribution (it reaches the UPSTREAM_OF_VEC leaves only); FSDP2's
    per-block hooks sum each block's own contributions first, so each block
    takes vec through one silu (a double block's two modulations share it)
    and both runs add the same contributions in the same order. The first
    step's grad norm, the second step's loss and grad norm, and each leaf's
    change after each step (|a - b| / |b - b_init|) are held within
    DIST_BOUNDS, the upstream leaves apart from the rest (a difference in
    vec's gradient would reach every leaf's first update through the
    global norm's clip and Adam's eps, and every second update through the
    first); every other leaf's first-step gradient (its norm, per leaf) is
    equal bit for bit. The DiT's depth is cut to DIST_DEPTH, its width
    kept."""
    import os

    import torch
    import torch.distributed as dist

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.parallel.sharding import is_fsdp
    from visualcloze_tpu_torch.training.train import main as train_main

    config = write_dataset(tmp / "data_dist", n=4)
    argv = ["--data_path", config, "--init_random", "--grid_resolution", "384", "--lora_rank", "64",
            "--max_steps", "2", "--global_bsz", "2", "--micro_bsz", "1", "--checkpointing", "--remat_policy",
            REMAT_POLICY, "--ckpt_every", "1000", "--log_every", "1"]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    runs, snaps, norms = {}, {}, {}
    with cut_depth(*DIST_DEPTH):
        for name in ("nccl", "single"):
            if name == "nccl":
                os.environ.update(env)
            ops.reset_kernel_launches()
            t0 = time.perf_counter()
            try:
                with lora_steps() as snaps[name], grad_norm_records() as norms[name]:
                    res = train_main(argv + ["--results_dir", str(tmp / f"results_{name}")])
                backend = dist.get_backend() if dist.is_initialized() else None
                fsdp = is_fsdp(res["state"].params)
                mesh = repr(res["state"].mesh)
            finally:
                if name == "nccl":
                    for key in env:
                        os.environ.pop(key, None)
                    if dist.is_initialized():
                        dist.destroy_process_group()
            torch.cuda.synchronize()
            runs[name] = dict(seconds=time.perf_counter() - t0, losses=[r["loss"] for r in res["history"]],
                              grad_norms=[r["grad_norm"] for r in res["history"]], backend=backend,
                              fsdp=fsdp, mesh=mesh, launches=ops.kernel_launches())
            del res
            free()
    a, b = runs["nccl"], runs["single"]
    rel = lambda x, y: abs(x - y) / max(abs(y), 1e-12)  # noqa: E731
    loss_diff = [rel(x, y) for x, y in zip(a["losses"], b["losses"])]
    norm_diff = [rel(x, y) for x, y in zip(a["grad_norms"], b["grad_norms"])]
    init_equal = all(torch.equal(snaps["nccl"][0][p], t) for p, t in snaps["single"][0].items())
    first = [norms[name][0] for name in ("nccl", "single")]
    rest_names = [n for n in first[1] if not n.startswith(UPSTREAM_OF_VEC)]
    rest_equal = len(rest_names) > 0 and all(first[0][n] == first[1][n] for n in rest_names)

    def upstream_norm(rec):
        return math.sqrt(sum(v * v for n, v in rec.items() if n.startswith(UPSTREAM_OF_VEC)))
    leaves = []
    for step, row in enumerate(lora_step_diffs(snaps["nccl"], snaps["single"]), 1):
        up = {p: d for p, d in row.items() if p.startswith(UPSTREAM_OF_VEC)}
        rest = {p: d for p, d in row.items() if p not in up}
        worst = max(rest, key=rest.get)
        leaves.append(dict(step=step, n_leaves=len(row), n_upstream=len(up), upstream_max=max(up.values()),
                           upstream_moved=sum(d > 0 for d in up.values()), rest_max=rest[worst], rest_worst=worst,
                           rest_moved=sum(d > 0 for d in rest.values())))
    bnd = DIST_BOUNDS
    micro = len(a["losses"]) * 2
    expected = autograd_expected(REMAT_PASSES * micro, micro, *DIST_DEPTH)
    leaves_ok = (len(leaves) == 2 and leaves[0]["upstream_max"] <= bnd["step1_upstream"]
                 and leaves[0]["rest_max"] <= bnd["step1_leaves"] and leaves[1]["upstream_max"] <= bnd["step2_upstream"]
                 and leaves[1]["rest_max"] <= bnd["step2_leaves"])
    return dict(phase="dist_one_rank", depth=list(DIST_DEPTH), runs=runs, rel_loss_diff=loss_diff,
                rel_grad_norm_diff=norm_diff, first_loss_equal=a["losses"][:1] == b["losses"][:1],
                init_leaves_equal=init_equal, leaves=leaves, bounds=bnd, launches=a["launches"],
                fusion_launches_expected=expected, rest_first_grads_equal=rest_equal,
                upstream_first_grad_norm_rel_diff=abs(upstream_norm(first[0]) - upstream_norm(first[1]))
                / upstream_norm(first[1]),
                ok=(a["backend"] == "nccl" and a["fsdp"] and b["backend"] is None and len(a["losses"]) == 2
                    and a["losses"][0] == b["losses"][0] and norm_diff[0] <= bnd["first_grad_norm"]
                    and loss_diff[1] <= bnd["second_loss"] and norm_diff[1] <= bnd["second_grad_norm"]
                    and init_equal and rest_equal and leaves_ok and all(math.isfinite(x) for x in a["losses"])
                    and all(autograd_launches(r["launches"]) == expected for r in (a, b))))


TP_SHAPES = ((("single_blocks", "0", "linear1"), 3072, 21504, "column"),
             (("single_blocks", "0", "linear2"), 15360, 3072, "row"),
             (("double_blocks", "0", "img_attn", "qkv"), 3072, 9216, "column"))


def _random_linear(kind: str, k: int, n: int, g):
    """A full-width Int8Linear / Int4DiTLinear / SmoothQuant W8A8Linear on the
    card with random codes, scales (a_sinv in [0.5, 2]) and a bf16 bias."""
    import torch
    from torch import nn

    from visualcloze_tpu_torch.models.layers import Int4DiTLinear, Int8Linear, W8A8Linear

    dev = torch.device("cuda")
    lin = {"int8_matmul": Int8Linear, "int4_matmul": Int4DiTLinear,
           "w8a8_matmul": lambda k, n: W8A8Linear(k, n, smooth=True)}[kind](k, n).to(dev)
    if kind == "int4_matmul":
        lin.w_int4 = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
        lin.w_scale = (torch.rand((k // lin.group, n), generator=g, device=dev) * 0.5 + 0.75) * (k ** -0.5 / 7)
    else:
        shape = (k, n) if kind == "int8_matmul" else (n, k)
        lin.w_int8 = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        lin.w_scale = torch.full((n,), k ** -0.5 / 127, device=dev)
    if kind == "w8a8_matmul":
        lin.a_sinv = torch.rand((k,), generator=g, device=dev) * 1.5 + 0.5
    lin.bias = nn.Parameter((torch.randn((n,), generator=g, device=dev) * 0.1).to(torch.bfloat16),
                            requires_grad=False)
    return lin


def tp_shards() -> dict:
    """The port's tensor-parallel linears (parallel.sharding._shard_linear
    and the linears' own tp paths in models/layers.py) at the tp = 2 shard
    shapes of linear1 and qkv (column halves: whole heads of q, k, v, the
    mlp's slice) and linear2 (row halves), at 3968 tokens, through G, G4 and
    H. Each linear is built at full width (int8, int4, SmoothQuant w8a8);
    each rank's copy is cut by _shard_linear and run on the card in turn,
    the group's collectives done by indexing: a column shard's forward,
    scattered back by its columns (4 bf16 ulps of the unsharded module's
    output); a row shard's product (w8a8: of the group's gathered inputs,
    quantized whole with a_sinv in gather order, its own codes taken),
    summed in fp32 with the bias (8 bf16 ulps: each half is rounded to bf16
    before the sum)."""
    import copy

    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.config import FluxConfig
    from visualcloze_tpu_torch.parallel.sharding import _shard_linear, tp_index

    cfg, m, dev = FluxConfig(), 3968, torch.device("cuda")
    rows, ok = [], True
    with torch.no_grad():
        for path, k, n, kind in TP_SHAPES:
            g = torch.Generator(device=dev).manual_seed(k + n)
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            idx = [tp_index(path, cfg, r, 2) for r in range(2)]
            perm = torch.cat(idx)
            for name in ("int8_matmul", "int4_matmul", "w8a8_matmul"):
                lin = _random_linear(name, k, n, g)
                want = lin(x).float()
                ops.reset_kernel_launches()
                shards = []
                for r in range(2):
                    shard = copy.deepcopy(lin)
                    _shard_linear(shard, kind, idx[r], perm, None, r)
                    if kind == "column":
                        shards.append(shard(x))
                    else:
                        xr = x[:, perm.to(dev)] if name == "w8a8_matmul" else x[:, idx[r].to(dev)]
                        shards.append(shard._product(xr.contiguous(), None))
                    del shard
                launches = ops.kernel_launches()
                if kind == "column":
                    got = torch.empty_like(want)
                    for r, y in enumerate(shards):
                        got[:, idx[r].to(dev)] = y.float()
                    ulps = 4
                else:
                    got, ulps = sum(y.float() for y in shards) + lin.bias.float(), 8
                err = (got - want).abs().max().item()
                tol = bf16_ulps_tol(want, ulps)
                row_ok = err <= tol and launches[name] == 2
                rows.append(dict(kernel=name, linear=".".join(path), kind=kind, shape=[m, k, n],
                                 shard=list(shards[0].shape), launches=launches[name], max_abs_err=err, tol=tol,
                                 ok=row_ok))
                ok = ok and row_ok
                del lin, want, shards, got
            del x
            torch.cuda.empty_cache()
    return dict(phase="tp_shards", checks=rows, ok=ok)


# ----------------------------- checkpoint files -----------------------------

CKPT_DIR = "build/ckpt_roundtrip"  # under the checkout, git-ignored, removed at the end
SHARD_BYTES = 5 * 2 ** 30
CKPT_RANK = 256  # build_visualcloze's default lora_rank


def unpermute_rope_layout_(flux, cfg):
    """The inverse of permute_rope_layout, in place: the half layout's q/k
    channels (qkv rows, linear1's first 3h rows, the norm scales) back in the
    reference's interleaved order, as a BFL checkpoint holds them."""
    import numpy as np
    import torch

    from visualcloze_tpu_torch.models import weights as W

    dev = next(flux.parameters()).device
    inv = torch.from_numpy(np.argsort(W._qkv_out_perm(cfg))).to(dev)
    inv_d = torch.from_numpy(np.argsort(W._half_perm(cfg.head_dim))).to(dev)

    def lin(m):
        idx = torch.cat([inv, torch.arange(len(inv), m.weight.shape[0], device=dev)])
        m.weight.copy_(m.weight[idx])
        m.bias.copy_(m.bias[idx])

    def norm(n):
        n.q_scale.copy_(n.q_scale[inv_d])
        n.k_scale.copy_(n.k_scale[inv_d])

    with torch.no_grad():
        for block in flux.double_blocks:
            for attn in (block.img_attn, block.txt_attn):
                lin(attn.qkv)
                norm(attn.norm)
        for block in flux.single_blocks:
            lin(block.linear1)
            norm(block.norm)
    return flux


def half_rows(name: str, t, cfg):
    """A tensor of the port's Flux named `name`, in the reference order ->
    the half layout (what permute_rope_layout does to that parameter)."""
    import numpy as np
    import torch

    from visualcloze_tpu_torch.models import weights as W

    if re.fullmatch(r"double_blocks\.\d+\.(img|txt)_attn\.qkv\.(weight|bias)|single_blocks\.\d+\.linear1\.(weight|bias)",
                    name):
        perm = W._qkv_out_perm(cfg)
        idx = np.concatenate([perm, np.arange(len(perm), t.shape[0])])
    elif name.endswith(("norm.q_scale", "norm.k_scale")):
        idx = W._half_perm(cfg.head_dim)
    else:
        return t
    return t[torch.from_numpy(idx).to(t.device)]


def hf_state(module, keys: dict) -> dict:
    """The inverse of convert_t5 / convert_clip: a T5 or CLIP module's tensors
    under their HF names (keys: HF name -> the port's name)."""
    from visualcloze_tpu_torch.models import weights as W

    state = W.module_state(module)
    return {hf: state[port] for hf, port in keys.items()}


def save_sharded(state: dict, directory, prefix: str = "model") -> int:
    """state as HF-style shards of at most SHARD_BYTES each; returns the bytes."""
    from visualcloze_tpu_torch.models import weights as W

    directory.mkdir(parents=True, exist_ok=True)
    shards, size = [[]], 0
    for k in sorted(state):
        n = state[k].numel() * state[k].element_size()
        if shards[-1] and size + n > SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(k)
        size += n
    total = 0
    for i, keys in enumerate(shards):
        path = directory / f"{prefix}-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += W.save_safetensors({k: state[k] for k in keys}, str(path))
    return total


def random_lora(flux, rank: int, seed: int):
    """A LoRA on every linear of flux: init_lora's A, B and B's bias N(0, 0.02)
    (a visible delta: zero-init B folds to nothing)."""
    import torch

    from visualcloze_tpu_torch.models.lora import init_lora, lora_entries

    dev = next(flux.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    lora = init_lora(flux, rank, generator=g)
    with torch.no_grad():
        for entry in lora_entries(lora).values():
            entry["b"].normal_(0.0, 0.02, generator=g)
            entry["b_bias"].normal_(0.0, 0.02, generator=g)
    return lora


def write_checkpoints(model, lora, root) -> dict:
    """The serving stack `model` (its DiT in the half layout) as the reference
    checkpoint files under root: (a) the DiT, put back in the reference order,
    as one BFL safetensors file, read back and checked bit for bit; (b) the
    LoRA as a reference-trainer .pth; (c) the VAE; (d) T5 and CLIP as HF
    shards. The DiT is left in the reference order. Returns paths, bytes and
    seconds per file."""
    import torch

    from visualcloze_tpu_torch.models import weights as W

    cfg = model.cfg
    out = {"paths": {}, "bytes": {}, "seconds": {}}

    def timed(key, path, fn):
        t0 = time.perf_counter()
        nbytes = fn()
        out["paths"][key], out["bytes"][key] = str(path), nbytes
        out["seconds"][key] = time.perf_counter() - t0

    unpermute_rope_layout_(model.flux, cfg)
    dit = root / "flux1-fill-dev.safetensors"
    timed("dit", dit, lambda: W.save_safetensors(W.flux_to_torch_state(model.flux, cfg), str(dit)))
    t0 = time.perf_counter()
    back = W.convert_flux(W.load_safetensors(str(dit)), cfg)
    mine = W.module_state(model.flux)
    out["dit_readback_mismatches"] = sum(not torch.equal(back[k].to(v.device), v) for k, v in mine.items())
    out["dit_readback_tensors"] = len(mine)
    out["seconds"]["dit_readback"] = time.perf_counter() - t0
    del back
    lora_path = root / "visualcloze-lora.pth"

    def save_lora():
        torch.save(W.lora_to_torch_state(lora), lora_path)
        return lora_path.stat().st_size

    timed("lora", lora_path, save_lora)
    ae = root / "ae.safetensors"
    timed("vae", ae, lambda: W.save_safetensors(W.vae_to_torch_state(model.ae), str(ae)))
    timed("t5", root / "t5", lambda: save_sharded(hf_state(model.t5.model, W.t5_keys(model.t5.cfg)), root / "t5"))
    timed("clip", root / "clip",
          lambda: save_sharded(hf_state(model.clip.model, W.clip_keys(model.clip.cfg)), root / "clip"))
    return out


def write_snapshot(flux, cfg, root) -> dict:
    """A DiT in the reference order as a diffusers pipeline snapshot:
    transformer/ shards in FluxTransformer2DModel naming and model_index.json."""
    from visualcloze_tpu_torch.models import weights as W

    t0 = time.perf_counter()
    snap = root / "snapshot"
    nbytes = save_sharded(W.flux_to_diffusers_state(flux, cfg), snap / "transformer",
                          prefix="diffusion_pytorch_model")
    (snap / "model_index.json").write_text(json.dumps({"_class_name": "VisualClozePipeline"}))
    return {"path": str(snap), "bytes": nbytes, "seconds": time.perf_counter() - t0}


def check_loaded_dit(flux, cfg, base_state: dict, lora_half=None) -> dict:
    """A loaded DiT (half layout) against the checkpoint it came from:
    base_state, the file's tensors under the port's names in the reference
    order; lora_half, the LoRA in the half layout. Every tensor no LoRA entry
    touches must be bit-identical to the file's (permuted). Every folded
    weight and bias must be within 1 bf16 ulp of the fold computed in float64
    (bf16(w + A@B), bf16(b + b_B)), beyond the rounding bound of the fold's
    own fp32 arithmetic: r * 2^-24 * |A|@|B| for the rank-r product plus
    2^-24 * (|w| + |A@B|) for the sum (the textbook bounds). That bound
    matters only where w and A@B nearly cancel, where a bf16 ulp of the
    result is smaller than the fp32 product's own rounding; such elements are
    counted apart (folded_elems_over_1_ulp, with the largest |result| among
    them)."""
    import torch

    from visualcloze_tpu_torch.models import weights as W
    from visualcloze_tpu_torch.models.lora import lora_entries

    u32 = 2.0 ** -24
    entries = lora_entries(lora_half) if lora_half else {}
    exact = exact_bad = folded = folded_bad = over_ulp = 0
    max_ulps = over_ulp_top = 0.0
    for name, got in W.module_state(flux).items():
        dev = got.device
        base = half_rows(name, base_state[name].to(dev), cfg).double()
        path, leaf = name.rsplit(".", 1)
        e = entries.get(path)
        if e is None:
            exact += 1
            exact_bad += not torch.equal(got, base.to(got.dtype))
            continue
        if leaf == "weight":
            a, b = e["a"].to(dev, torch.float64), e["b"].to(dev, torch.float64)
            prod = (a @ b).T
            want64 = base + prod
            bound = a.shape[1] * u32 * (a.abs() @ b.abs()).T + u32 * (base.abs() + prod.abs())
        else:
            bb = e["b_bias"].to(dev, torch.float64)
            want64 = base + bb
            bound = u32 * (base.abs() + bb.abs())
        want = want64.to(got.dtype).double()
        diff = (got.double() - want).abs()
        top = torch.maximum(got.double().abs(), want.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        max_ulps = max(max_ulps, (diff / ulp).max().item())
        beyond = diff > ulp
        over_ulp += int(beyond.sum())
        if beyond.any():
            over_ulp_top = max(over_ulp_top, want[beyond].abs().max().item())
        folded += 1
        folded_bad += bool((diff > ulp + bound).any())
    return dict(exact_tensors=exact, exact_mismatches=exact_bad, folded_tensors=folded,
                folded_over_bound=folded_bad, folded_max_ulps=max_ulps, folded_elems_over_1_ulp=over_ulp,
                folded_largest_abs_over_1_ulp=over_ulp_top,
                ok=exact_bad == 0 and folded_bad == 0 and exact + folded > 0)


def host_rss_gib() -> float:
    """The process's resident set now (VmRSS), in GiB."""
    with open("/proc/self/status") as f:
        kib = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS:"))
    return kib / 2 ** 20


@contextlib.contextmanager
def host_rss_peak(interval_s: float = 0.005):
    """The resident set before a with-block and its peak during it, sampled
    from VmRSS every interval_s by a thread: a sandboxed /proc may have no
    VmHWM and refuse clear_refs, and ru_maxrss keeps the earlier phases'
    higher peak. Yields the dict that the fields are written into."""
    import threading

    out = {"host_rss_before_gib": host_rss_gib(), "host_rss_sample_s": interval_s}
    peak = [out["host_rss_before_gib"]]
    done = threading.Event()

    def sample():
        while not done.wait(interval_s):
            peak[0] = max(peak[0], host_rss_gib())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        done.set()
        thread.join()
        out["host_peak_rss_gib"] = max(peak[0], host_rss_gib())


def disk(root) -> dict:
    """The file system's usage under root, and the host's available memory."""
    import shutil

    u = shutil.disk_usage(root)
    with open("/proc/meminfo") as f:
        avail = next(int(ln.split()[1]) for ln in f if ln.startswith("MemAvailable:"))
    return {"total_gib": u.total / 2 ** 30, "used_gib": u.used / 2 ** 30, "free_gib": u.free / 2 ** 30,
            "host_mem_available_gib": avail / 2 ** 20}


def load_timed(t5_int4: bool = False, **kw):
    """build_visualcloze(**kw) on the card (then the T5 quantized to int4, as
    the CLI's --t5_int4): (model, the load line's fields: seconds, resident
    and peak GiB, the host's resident GiB before and at its peak)."""
    import torch

    from visualcloze_tpu_torch.models.quant import quantize_t5_int4
    from visualcloze_tpu_torch.pipeline import build_visualcloze

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with host_rss_peak() as host:
        t0 = time.perf_counter()
        model = build_visualcloze(device="cuda", **kw)
        if t5_int4:
            model.t5.model = quantize_t5_int4(model.t5.model)
            free()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return model, dict(load_seconds=seconds, **host,
                       resident_gib=torch.cuda.memory_allocated() / 2 ** 30,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def free() -> None:
    """Return what no longer has a reference to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def fusions_by_collect():
    """J-M's launches in the DiT evaluations that collect calibration
    statistics (collect_a8_stats) and in the others, counted by wrapping
    Flux.forward until the block exits: {"collecting" | "plain_steps":
    {"evaluations", "launches"}}."""
    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.models.flux import Flux

    split = {k: {"evaluations": 0, "launches": dict.fromkeys(FUSIONS, 0)} for k in ("collecting", "plain_steps")}
    orig = Flux.forward

    def forward(self, *args, **kw):
        before = ops.kernel_launches()
        out = orig(self, *args, **kw)
        after = ops.kernel_launches()
        rec = split["collecting" if kw.get("collect_a8_stats") else "plain_steps"]
        rec["evaluations"] += 1
        for n in FUSIONS:
            rec["launches"][n] += after[n] - before[n]
        return out

    Flux.forward = forward
    try:
        yield split
    finally:
        Flux.forward = orig


def checkpoint_phases(r1, serving, bf16_unused, training) -> list:
    """Write the seed-0 stack as checkpoint files, serve from them through
    build_visualcloze (bf16 with the LoRA folded, every solver, int8 with an
    int4 T5, SmoothQuant w8a8, a diffusers snapshot), each checked; returns the main-path runs
    (for the kernels line). The files are removed at the end, whatever happens."""
    import os
    import shutil
    from pathlib import Path

    import torch

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.models import weights as W
    from visualcloze_tpu_torch.models.flux import build_flux
    from visualcloze_tpu_torch.models.lora import lora_param_count, tree_map
    from visualcloze_tpu_torch.pipeline import random_components
    from visualcloze_tpu_torch.transport.sampling import cached_fresh_schedule

    root = Path(CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    runs = []
    try:
        disk_before = disk(root)
        model = random_components(tiny=False, dtype=torch.bfloat16, device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(0), resolution=384)
        cfg = model.cfg
        lora = random_lora(model.flux, CKPT_RANK, seed=5)
        written = write_checkpoints(model, lora, root)
        line = dict(phase="checkpoint_write", **written, total_bytes=sum(written["bytes"].values()),
                    disk_before=disk_before, disk_after=disk(root), lora_rank=CKPT_RANK,
                    lora_params=lora_param_count(lora))
        line["ok"] = written["dit_readback_mismatches"] == 0
        emit(line)
        if not line["ok"]:
            raise RuntimeError("the written DiT does not read back bit for bit")
        # the check's LoRA waits on the host, so that the load's resident and peak are the stack's
        lora_half = tree_map(lambda x: x.cpu(), W.permute_rope_layout_lora(lora, cfg))
        del lora, model
        free()

        paths = written["paths"]
        os.environ.update(FLUX_DEV_FILL=paths["dit"], AE=paths["vae"], T5_PATH=paths["t5"], CLIP_PATH=paths["clip"])
        model, load = load_timed(model_path=paths["lora"])
        check = check_loaded_dit(model.flux, cfg, W.convert_flux(W.load_safetensors(paths["dit"]), cfg), lora_half)
        emit(dict(phase="load_checkpoint", **load, **check, rope_layout=model.rope_layout))
        if not check["ok"]:
            raise RuntimeError(f"the loaded DiT differs from its checkpoint: {check}")
        del lora_half

        rl = run_request(model, "2x3 default query with SDEdit, from checkpoint files", 2, 3, 30, True, seed=1,
                         used=serving, unused=bf16_unused)
        same = {n: (rl["launches"][n], r1["launches"][n]) for n in serving}
        rl.update(phase="request_loaded", launches_vs_request_1=same, stage_seconds_request_1=r1["stage_seconds"])
        rl["ok"] = rl["ok"] and all(a == b for a, b in same.values())
        emit(rl)
        if not rl["ok"]:
            raise RuntimeError("the query on the loaded stack failed")
        runs.append(rl)

        pairs = 9  # 10 grid points
        for solver, want in (("heun", 2 * pairs), ("ab2", pairs + 1),
                             ("cached:3", 1 + int(cached_fresh_schedule(pairs, 3)[1:].sum())), ("dopri5", None)):
            model.solver = solver
            r = run_request(model, f"2x2 query, {solver}", 2, 2, pairs + 1, False, seed=4, used=serving,
                            unused=bf16_unused)
            stats = model.solver_stats.get("denoise", {})
            if want is None:
                want = stats.get("evaluations")
            a = r["launches"]["flash_attn_rope"]
            r.update(phase="solvers", solver=solver, dit_evaluations=a / ATTENTION_CALLS,
                     dit_evaluations_expected=want, solver_stats=stats)
            r["ok"] = r["ok"] and want is not None and a == ATTENTION_CALLS * want
            emit(r)
            if not r["ok"]:
                raise RuntimeError(f"solver {solver} failed")
            runs.append(r)
        del model
        free()

        # the int8 route on the same BFL files: int8 DiT (kernel G), int4 T5
        model, load = load_timed(model_path=paths["lora"], quantize="int8", t5_int4=True)
        rq = run_request(model, "2x3 default query with SDEdit, int8 DiT + int4 T5-XXL from checkpoint files",
                         2, 3, 30, True, seed=1, used=serving + ("int8_matmul",), unused=training + W8A8_KERNELS)
        evals = rq["launches"]["flash_attn_rope"] // ATTENTION_CALLS
        rq.update(phase="load_checkpoint_int8", **load, resident_gib_pr3_synthetic=14.0, dit_evaluations=evals,
                  int8_launches_expected=INT8_LINEARS * evals)
        rq["ok"] = rq["ok"] and rq["launches"]["int8_matmul"] == INT8_LINEARS * evals
        emit(rq)
        if not rq["ok"]:
            raise RuntimeError("the int8 query from checkpoint files failed")
        runs.append(rq)
        del model
        free()

        # the SmoothQuant w8a8 route on the same files: calibrated at load (blank 2x2 grid, 30 steps)
        ops.reset_kernel_launches()
        with fusions_by_collect() as calib_split:
            model, load = load_timed(model_path=paths["lora"], quantize="w8a8_smooth")
        calib_launches = ops.kernel_launches()
        calib = dict(model.stage_seconds)
        rw = run_request(model, "2x3 default query with SDEdit, SmoothQuant w8a8 DiT from checkpoint files",
                         2, 3, 30, True, seed=1, used=serving + W8A8_USED_WITH, unused=training)
        rw.update(phase="load_checkpoint_w8a8_smooth", **load, calibration_stage_seconds=calib,
                  calibration_seconds=sum(calib.values()), calibration_launches=calib_launches,
                  calibration_fusions=calib_split, **w8a8_launches_ok(rw))
        # the calibration: 29 evaluations of the bf16 DiT (kernel A), no quantized kernel; the 7 that
        # collect statistics (every 5th step and the last) run J-M's plain versions, the 22 others the kernels
        rw["ok"] = (rw["ok"] and calib_launches["flash_attn_rope"] == 29 * ATTENTION_CALLS
                    and all(calib_launches[k] == 0 for k in W8A8_USED_WITH)
                    and calib_split["collecting"]["evaluations"] == 7
                    and not any(calib_split["collecting"]["launches"].values())
                    and calib_split["plain_steps"]["launches"] == fusions_expected(22))
        emit(rw)
        if not rw["ok"]:
            raise RuntimeError("the SmoothQuant w8a8 query from checkpoint files failed")
        runs.append(rw)
        del model
        free()

        # the same DiT as a diffusers snapshot, once the BFL file is gone
        os.remove(paths["dit"])

        def seed0_dit():  # random_components' first draw, in the reference order
            return unpermute_rope_layout_(build_flux(cfg, torch.device("cuda"), torch.bfloat16).init_random_(
                torch.Generator(device="cuda").manual_seed(0)), cfg)

        flux = seed0_dit()
        snap = write_snapshot(flux, cfg, root)
        del flux
        free()
        emit(dict(phase="checkpoint_write", part="diffusers snapshot", **snap, disk_after=disk(root), ok=True))
        model, load = load_timed(model_path=snap["path"])
        flux = seed0_dit()  # the DiT the snapshot was written from, rebuilt once the load is measured
        check = check_loaded_dit(model.flux, cfg, W.module_state(flux))
        del flux
        free()
        rs = run_request(model, "2x2 query from a diffusers snapshot", 2, 2, 10, False, seed=4, used=serving,
                         unused=bf16_unused)
        rs.update(phase="load_snapshot", **load, **{f"dit_{k}": v for k, v in check.items()})
        rs["ok"] = rs["ok"] and check["ok"] and check["folded_tensors"] == 0
        emit(rs)
        if not rs["ok"]:
            raise RuntimeError("the snapshot route failed")
        runs.append(rs)

        # the diffusers-style API on the snapshot's model, with the reference LoRA file still on disk
        rd = diffusers_phase(model, paths["lora"])
        emit(rd)
        if not rd["ok"]:
            raise RuntimeError("the diffusers-style API phase failed")
        runs.append(rd)
        del model
        free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs


def main() -> int:
    import gc
    import tempfile
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from visualcloze_tpu_torch.ops import cuda_build
    from visualcloze_tpu_torch.pipeline import random_components, synthetic_full_components

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    emit(dict(phase="env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
              tf32_matmul=False, tf32_cudnn=False))

    secs = cuda_build.build(force=True)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if any(w in ln for w in ("registers", "spill", "C75"))]
             for n, log in cuda_build.BUILD_LOG.items()}
    spill_bytes = {n: sum(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", log))
                   for n, log in cuda_build.BUILD_LOG.items()}
    emit(dict(phase="build", seconds=max(secs.values()), per_source=secs, ptxas=ptxas, spill_bytes=spill_bytes))
    if any(spill_bytes.values()):
        raise RuntimeError(f"ptxas spilled registers: {spill_bytes}")

    checks = [
        lambda: [check_attention_rope(3968, False, 20)],
        lambda: [check_attention_rope(4608, False, 20)],
        lambda: [check_attention_rope(5760, True, 10)],
        lambda: check_attention_fwd(1, 3968, False, 20),
        lambda: check_attention_fwd(2, 5760, True, 10),
        lambda: check_attention_fwd(1, 7680, True, 5),  # E's longest training sequence, with a bias
        lambda: check_attention_fwd(1, 300, False, 20, lk=1000),  # Lq != Lk, as a ring chunk passes them
        lambda: [check_attention_rope(4096, False, 10, holes=True)],  # masked keys inside the sequence
        lambda: check_attention_fwd(2, 4096, False, 10, holes=True),
        lambda: check_attention_bwd(1, 3968, False, 10),
        lambda: check_attention_bwd(2, 5760, True, 5),
        lambda: check_attention_bwd(1, 7680, True, 5),  # the trainer's longest Graph200K sequence
        lambda: [check_attention_d512(6912, 10)],
        lambda: [check_attention_d512(16384, 5)],
        lambda: [check_attention_d512(1100, 20, b=2)],  # several batches, a ragged L
        lambda: [check_attention_d512(17, 20)],  # shorter than one tile
        lambda: [check_conv((1, 384, 1152, 128, 128), True, 10)],  # encoder/decoder level 0
        lambda: [check_conv((1, 192, 576, 128, 256), True, 10)],   # encoder level 1, first conv
        lambda: [check_conv((1, 96, 288, 512, 512), False, 10)],   # decoder upsample conv
        lambda: [check_conv((1, 48, 144, 512, 512), True, 20)],    # bottleneck
        lambda: [check_conv((1, 1024, 1024, 128, 128), True, 5)],  # SDEdit image, level 0
        lambda: [check_conv((1, 192, 576, 512, 256), True, 10)],   # decoder 512 -> 256
        lambda: [check_conv((1, 384, 1152, 256, 128), True, 10)],  # decoder 256 -> 128
        lambda: [check_conv((1, 37, 91, 128, 128), True, 20, b0_scale=4.0)],  # ragged; swish(b0) on the border
        lambda: [check_int8_matmul(3968, 3072, 21504, "linear1", 20)],
        lambda: [check_int8_matmul(3968, 15360, 3072, "linear2", 20)],
        lambda: [check_int8_matmul(3456, 3072, 9216, "img_attn.qkv", 20)],
        lambda: [check_int8_matmul(1, 3072, 18432, "double-block modulation", 50)],
        lambda: [check_int8_matmul(3456, 3072, 64, "final_layer.linear", 50)],
        lambda: [check_int8_matmul(4097, 3072, 3072, "ragged M (proj)", 20)],
        lambda: [check_int8_matmul(512, 3072, 3072, "text stream proj", 50)],
        lambda: [check_int8_matmul(512, 12288, 3072, "text stream linear2", 50)],
        lambda: [check_int4_matmul(3968, 3072, 21504, "linear1", 20)],
        lambda: [check_int4_matmul(3968, 15360, 3072, "linear2", 20)],
        lambda: [check_int4_matmul(3456, 3072, 9216, "img_attn.qkv", 20)],
        lambda: [check_int4_matmul(1, 3072, 18432, "double-block modulation", 50)],
        lambda: [check_int4_matmul(3456, 3072, 64, "final_layer.linear", 50)],
        lambda: [check_int4_matmul(4097, 3072, 3072, "ragged M (proj)", 20)],
        lambda: [check_int4_matmul(512, 3072, 3072, "text stream proj", 50)],
        lambda: [check_int4_matmul(512, 12288, 3072, "text stream linear2", 50)],
        lambda: [check_int4_matmul(17, 3072, 3072, "cluster edge: M 17, a pair with an empty peer", 50)],
        lambda: [check_int4_matmul(129, 3072, 3072, "cluster edge: M 129, a pair with one row in its peer", 50)],
        lambda: [check_int4_matmul(257, 3072, 3072, "cluster edge: M 257, an odd count of tiles", 50)],
        lambda: [check_int4_matmul(257, 3072, 64, "cluster edge: M 257, N 64", 50)],
        lambda: [check_w8a8_matmul(3968, 3072, 21504, "linear1", 20)],
        lambda: [check_w8a8_matmul(3968, 15360, 3072, "linear2", 20)],
        lambda: [check_w8a8_matmul(3968, 3072, 9216, "qkv", 20)],
        lambda: [check_w8a8_matmul(3968, 3072, 3072, "proj", 20)],
        lambda: [check_w8a8_matmul(3968, 3072, 12288, "mlp.0", 20)],
        lambda: [check_w8a8_matmul(3968, 12288, 3072, "mlp.2", 20)],
        lambda: [check_w8a8_matmul(3456, 3072, 9216, "img_attn.qkv", 20)],
        lambda: [check_w8a8_matmul(512, 3072, 9216, "text stream qkv", 50)],
        lambda: [check_w8a8_matmul(512, 12288, 3072, "text stream mlp.2", 50)],
        lambda: [check_w8a8_matmul(4097, 3072, 3072, "ragged M (proj)", 20)],
        lambda: [check_w8a8_matmul(3968, 3072, 21504, "linear1 without a bias", 20, with_bias=False)],
        lambda: [check_w8a8_matmul(7, 3072, 64, "cluster edge: M 7, N 64, an empty peer", 50, with_bias=False)],
        lambda: [check_w8a8_matmul(129, 12288, 3072, "cluster edge: M 129, one row in the peer", 50)],
        lambda: [check_w8a8_matmul(257, 3072, 9216, "cluster edge: M 257, an odd count of tiles", 50)],
        lambda: [check_w8a8_matmul(333, 3072, 3072, "cluster edge: M 333 without a bias", 50, with_bias=False)],
        lambda: [check_act_quant(3456, 3072, False, False, 50)],  # a double block's qkv / mlp.0 input (fp32)
        lambda: [check_act_quant(3968, 3072, True, False, 50)],   # linear1's input
        lambda: [check_act_quant(3456, 12288, True, False, 50)],  # mlp.2's input
        lambda: [check_act_quant(3968, 15360, True, False, 50)],  # linear2's input
        lambda: [check_act_quant(3456, 3072, False, True, 50)],   # the same with SmoothQuant's a_sinv
        lambda: [check_act_quant(3968, 3072, True, True, 50)],
        lambda: [check_act_quant(3456, 12288, True, True, 50)],
        lambda: [check_act_quant(3968, 15360, True, True, 50)],
        lambda: [check_act_quant(3456, 12288, False, False, 50)],  # fp32 at the wider K too
        lambda: [check_act_quant(3968, 15360, False, True, 50)],
        lambda: [check_act_quant(512, 3072, False, True, 50)],    # the text stream
        lambda: [check_act_quant(7, 15360, False, False, 50)],    # a few rows
        # J: bf16 out (single block; dense, int8, int4 linears), fp32 out (a w8a8 linear in a double block)
        lambda: [check_layernorm_modulate(3968, True, "single block, the default query's 3968 tokens", 50)],
        lambda: [check_layernorm_modulate(3968, False, "single block's tokens, fp32 out", 50)],
        lambda: [check_layernorm_modulate(3456, False, "double block img stream before a w8a8 qkv (fp32)", 50)],
        lambda: [check_layernorm_modulate(3456, True, "double block img stream before a bf16 qkv", 50)],
        lambda: [check_layernorm_modulate(512, True, "double block txt stream", 50)],
        lambda: [check_layernorm_modulate(4608, True, "single block, SDEdit's 4608 tokens", 50)],
        lambda: [check_layernorm_modulate(3456, True, "final layer: img rows after 512 txt rows, batch 2", 50,
                                          b=2, skip=512)],
        lambda: [check_layernorm_modulate(7, False, "a ragged 7 rows, fp32 out", 50)],
        # K
        lambda: [check_gated_residual(3968, "single block, 3968 tokens", 50)],
        lambda: [check_gated_residual(3456, "double block img stream", 50)],
        lambda: [check_gated_residual(512, "double block txt stream", 50)],
        lambda: [check_gated_residual(4608, "single block, SDEdit's 4608 tokens", 50)],
        lambda: [check_gated_residual(7, "a ragged 7 rows, batch 2", 50, b=2)],
        # L: linear1's 21504-column rows; the double block's streams into one joint 3968-token buffer
        lambda: [check_qk_norm_split(3968, "single block: linear1's first 9216 of 21504 columns", 50, cols=21504)],
        lambda: [check_qk_norm_split(3456, "double block img stream at token 512 of the joint 3968", 50,
                                     total=3968, offset=512)],
        lambda: [check_qk_norm_split(512, "double block txt stream at token 0 of the joint 3968", 50, total=3968)],
        lambda: [check_qk_norm_split(4608, "single block, SDEdit's 4608 tokens", 50, cols=21504)],
        lambda: [check_qk_norm_split(3968, "tp = 2: 12 heads of linear1's 10752 local columns", 50, cols=10752,
                                     heads=12)],
        lambda: [check_qk_norm_split(7, "a ragged 7 rows at token 5 of 16", 50, total=16, offset=5)],
        # M: the single block writes linear2's whole input (the merge, then gelu of linear1's last 12288)
        lambda: [check_merge_heads(3968, "single block, 64 padded query rows", 50, gelu_cols=12288, cols=21504,
                                   padded=64)],
        lambda: [check_merge_heads(3968, "double block: the merge alone", 50)],
        lambda: [check_merge_heads(4608, "single block, SDEdit's 4608 tokens", 50, gelu_cols=12288, cols=21504)],
        lambda: [check_merge_heads(5760, "the 3x3 grid: 5760 tokens, 512 padded rows", 50, padded=512)],
        lambda: [check_merge_heads(7, "a ragged 7 rows, 2 padded, with gelu", 50, gelu_cols=12288, cols=21504,
                                   padded=2)],
        # J'-M', the trainer's and the likelihood's backward (B = 2: the column sums per batch element)
        lambda: [check_layernorm_modulate_bwd(3968, True, "single block, 3968 tokens", 50)],
        lambda: [check_layernorm_modulate_bwd(3456, True, "double block img stream", 50)],
        lambda: [check_layernorm_modulate_bwd(512, True, "double block txt stream", 50)],
        lambda: [check_layernorm_modulate_bwd(3968, True, "single block, batch 2", 50, b=2)],
        lambda: [check_layernorm_modulate_bwd(3456, True, "final layer: img rows after 512 txt rows, batch 2", 50,
                                              b=2, skip=512)],
        lambda: [check_layernorm_modulate_bwd(3968, False, "fp32 dy (a J stored in fp32)", 50)],
        lambda: [check_layernorm_modulate_bwd(7, True, "a ragged 7 rows", 50)],
        lambda: [check_gated_residual_bwd(3968, "single block, 3968 tokens", 50)],
        lambda: [check_gated_residual_bwd(3456, "double block img stream", 50)],
        lambda: [check_gated_residual_bwd(512, "double block txt stream", 50)],
        lambda: [check_gated_residual_bwd(3968, "single block, batch 2", 50, b=2)],
        lambda: [check_gated_residual_bwd(7, "a ragged 7 rows, batch 2", 50, b=2)],
        lambda: [check_qk_norm_split_bwd(3968, "single block: into linear1's 21504-column gradient buffer", 50,
                                         cols=21504)],
        lambda: [check_qk_norm_split_bwd(3456, "double block img stream from token 512 of the joint 3968", 50,
                                         total=3968, offset=512)],
        lambda: [check_qk_norm_split_bwd(512, "double block txt stream from token 0 of the joint 3968", 50,
                                         total=3968)],
        lambda: [check_qk_norm_split_bwd(3968, "single block, batch 2", 50, cols=21504, b=2)],
        lambda: [check_qk_norm_split_bwd(3968, "tp = 2: 12 heads of linear1's 10752 local columns", 50,
                                         cols=10752, heads=12)],
        lambda: [check_qk_norm_split_bwd(7, "a ragged 7 rows from token 5 of 16", 50, total=16, offset=5)],
        lambda: [check_merge_heads_bwd(3968, "single block, 64 padded query rows", 50, gelu_cols=12288, cols=21504,
                                       padded=64)],
        lambda: [check_merge_heads_bwd(3968, "double block: the merge alone", 50)],
        lambda: [check_merge_heads_bwd(3968, "single block, batch 2, 64 padded rows each", 50, gelu_cols=12288,
                                       cols=21504, padded=64, b=2)],
        lambda: [check_merge_heads_bwd(5760, "the 3x3 grid: the merge alone, 512 padded rows", 50, padded=512)],
        lambda: [check_merge_heads_bwd(7, "a ragged 7 rows, 2 padded, with gelu", 50, gelu_cols=12288, cols=21504,
                                       padded=2)],
    ]
    first = {}
    for fn in checks:
        for r in fn():
            emit(dict(phase="kernel", **r))
            if not r["ok"]:
                raise RuntimeError(f"kernel check failed: {r}")
            first.setdefault(r["name"], r)
        torch.cuda.empty_cache()

    rring = ring_chunks()
    emit(rring)
    if not rring["ok"]:
        raise RuntimeError("the ring's chunk schedule failed")
    rtp = tp_shards()
    emit(rtp)
    if not rtp["ok"]:
        raise RuntimeError("a tensor-parallel shard failed")
    torch.cuda.empty_cache()

    gref = grad_reference()
    emit(gref)
    if not gref["ok"]:
        raise RuntimeError(f"gradient reference failed: {gref}")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    model = random_components(tiny=False, dtype=torch.bfloat16, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0), resolution=384)
    torch.cuda.synchronize()
    emit(dict(phase="init", seconds=time.perf_counter() - t,
              params_gib=torch.cuda.memory_allocated() / 2 ** 30,
              depth=[model.cfg.depth, model.cfg.depth_single_blocks], hidden=model.cfg.hidden_size))

    ref = reference_checks(model)
    emit(dict(phase="reference", **ref))
    if not ref["ok"]:
        raise RuntimeError(f"reference check failed: {ref}")
    rcfg = cfg_forward(model)
    emit(rcfg)
    if not rcfg["ok"]:
        raise RuntimeError(f"the classifier-free-guidance forward failed: {rcfg}")
    free()

    serving = ("flash_attn_rope", "conv3x3_gn_swish", "flash_attn_d512") + FUSIONS
    training = ("flash_attn_fwd", "flash_attn_fwd_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    bf16_unused = training + ("int8_matmul", "int4_matmul") + W8A8_KERNELS
    r1_images = []
    r1 = run_request(model, "2x3 default query with SDEdit", 2, 3, 30, True, seed=1, used=serving,
                     unused=bf16_unused, images_out=r1_images)
    emit(r1)
    if not r1["ok"]:
        raise RuntimeError("request 1 failed")
    # cut the second request's steps, never its width or depth, if time runs short
    per_step = r1["stage_seconds"].get("denoise", 60.0) / 29
    budget = TIME_LIMIT_S * 0.3 - elapsed()
    steps2 = int(max(2, min(30, 1 + budget / (per_step * 1.6))))
    r2 = run_request(model, "3x3 query, padded to 5760 tokens", 3, 3, steps2, False, seed=2, used=serving,
                     unused=bf16_unused)
    emit(r2)
    if not r2["ok"]:
        raise RuntimeError("request 2 failed")
    rserve = serve_phase(model, r1, r1_images)
    emit(rserve)
    if not rserve["ok"]:
        raise RuntimeError("the serving phase failed")
    qref = quant_reference(model)
    emit(qref)
    if not qref["ok"]:
        raise RuntimeError(f"int8 reference failed: {qref}")
    wref = quant_reference_w8a8(model)
    emit(wref)
    if not wref["ok"]:
        raise RuntimeError(f"w8a8 reference failed: {wref}")
    rsde = samplers_sde(model)
    emit(rsde)
    if not rsde["ok"]:
        raise RuntimeError("the SDE samplers failed")
    free()
    rlik = likelihood(model)
    emit(rlik)
    if not rlik["ok"]:
        raise RuntimeError("the likelihood failed")
    free()
    qref4, qflux4 = quant_reference_int4(model)
    emit(qref4)
    if not qref4["ok"]:
        raise RuntimeError(f"int4 reference failed: {qref4}")
    bfl_dir = tempfile.TemporaryDirectory()
    fill = bfl_fill(model, Path(bfl_dir.name))
    free()

    # the bf16 DiT swapped for its w8a8 copy (bf16 T5, CLIP and VAE), serving request 1's query
    from visualcloze_tpu_torch.models.quant import quantize_flux_w8a8

    model.flux = quantize_flux_w8a8(model.flux)
    free()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    rw = run_request(model, "2x3 default query with SDEdit, w8a8 DiT", 2, 3, 30, True, seed=1,
                     used=serving + W8A8_USED_WITH, unused=training + ("int4_matmul",))
    rw.update(phase="request_w8a8", resident_gib=resident, w8a8_launches_predicted=W8A8_LINEARS * 38,
              stage_seconds_bf16=r1["stage_seconds"], **w8a8_launches_ok(rw))
    emit(rw)
    if not rw["ok"]:
        raise RuntimeError("w8a8 request failed")

    # the w8a8 DiT swapped for the int4 copy (bf16 T5, CLIP and VAE), serving request 1's query
    model.flux = None
    free()
    model.flux = qflux4.to(model.device)
    del qflux4
    free()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    r4 = run_request(model, "2x3 default query with SDEdit, int4 DiT", 2, 3, 30, True, seed=1,
                     used=serving + ("int4_matmul",), unused=training + ("int8_matmul",) + W8A8_KERNELS)
    evals = r4["launches"]["flash_attn_rope"] // ATTENTION_CALLS  # 29 + 9 predicted
    r4.update(phase="request_int4", resident_gib=resident, dit_evaluations=evals,
              int4_launches_predicted=INT8_LINEARS * 38, int4_launches_expected=INT8_LINEARS * evals,
              stage_seconds_bf16=r1["stage_seconds"], launches_bf16=r1["launches"])
    r4["ok"] = (r4["ok"] and evals == 38 and r4["launches"]["int4_matmul"] == INT8_LINEARS * 38
                and all(r4["launches"][n] == r1["launches"][n] for n in serving))
    emit(r4)
    if not r4["ok"]:
        raise RuntimeError("int4 request failed")
    try:
        rbfl = bfl_route(model, fill, Path(bfl_dir.name))
    finally:
        bfl_dir.cleanup()
    emit(rbfl)
    if not rbfl["ok"]:
        raise RuntimeError("the BFL tools route failed")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the single-card int8 stack, serving request 1's query
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    qmodel = synthetic_full_components(tiny=False, t5_int4=True, device="cuda",
                                       generator=torch.Generator(device="cuda").manual_seed(0), resolution=384)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    emit(dict(phase="init_int8", seconds=time.perf_counter() - t, resident_gib=resident,
              init_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
    rq = run_request(qmodel, "2x3 default query with SDEdit, int8 DiT + int4 T5-XXL + int8 CLIP-L", 2, 3, 30, True,
                     seed=1, used=serving + ("int8_matmul",), unused=training + W8A8_KERNELS + ("int4_matmul",))
    evals = rq["launches"]["flash_attn_rope"] // ATTENTION_CALLS  # DiT evaluations: 29 + 9 predicted
    rq.update(phase="request_int8", resident_gib=resident, dit_evaluations=evals,
              int8_launches_predicted=INT8_LINEARS * 38, int8_launches_expected=INT8_LINEARS * evals,
              stage_seconds_bf16=r1["stage_seconds"])
    rq["ok"] = rq["ok"] and rq["launches"]["int8_matmul"] == INT8_LINEARS * evals
    emit(rq)
    if not rq["ok"]:
        raise RuntimeError("int8 request failed")
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        train, result = run_training(Path(tmp), REMAT_POLICY)
        emit(train)
        if not train["ok"]:
            raise RuntimeError("training failed")
    model = result["model"]
    del result
    gc.collect()
    torch.cuda.empty_cache()  # the LoRA, its gradients and AdamW's state are gone
    emit(dict(phase="freed", allocated_gib=torch.cuda.memory_allocated() / 2 ** 30))
    r3 = run_request(model, "2x2 query, interleaved layout", 2, 2, 9, False, seed=3,
                     used=("flash_attn_fwd", "conv3x3_gn_swish", "flash_attn_d512") + FUSIONS,
                     unused=("flash_attn_rope", "flash_attn_fwd_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                             "int8_matmul", "int4_matmul") + W8A8_KERNELS)
    emit(dict(r3, phase="query_interleaved", rope_layout=model.rope_layout))
    if not r3["ok"]:
        raise RuntimeError("interleaved query failed")
    del model
    free()

    with tempfile.TemporaryDirectory() as tmp:
        rmoe = moe_train(Path(tmp))
        emit(rmoe)
        if not rmoe["ok"]:
            raise RuntimeError("MoE-LoRA training failed")
        free()
        rdist = dist_one_rank(Path(tmp))
        emit(rdist)
        if not rdist["ok"]:
            raise RuntimeError("the one-rank distributed trainer failed")
    free()

    loaded = checkpoint_phases(r1, serving, bf16_unused, training)

    kernels = []
    for name in REPLACES:
        r = first[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=sum(run["launches"][name] for run in (rring, r1, r2, rserve, rsde, rlik, rw, r4, rbfl, rq, train,
                                                           r3, rmoe, rdist, *loaded)),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
        ))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as exc:  # report the failed phase, then fail
        traceback.print_exc()
        emit({"phase": "failed", "error": f"{type(exc).__name__}: {exc}", "elapsed_s": elapsed()})
        code = 1
    sys.exit(code)
