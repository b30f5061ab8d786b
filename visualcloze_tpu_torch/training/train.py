"""Training CLI of the port: the VisualCloze LoRA trainer on one GPU
(counterpart of visualcloze_tpu/training/train.py, with the same flags).

  python -m visualcloze_tpu_torch.training.train --data_path data.yaml \\
      --init_random --grid_resolution 384 --lora_rank 128 --global_bsz 2 \\
      --micro_bsz 1 --checkpointing --remat_policy full --max_steps 3
      the full-width FLUX.1-Fill DiT (19 + 38 blocks, hidden 3072) with
      random weights in bf16 on the GPU, attention through kernels E and F;
  python -m visualcloze_tpu_torch.training.train --data_path data.yaml \\
      --device cpu --tiny --init_random --precision fp32 ...
      the tiny model on the CPU (the kernels' plain versions).

Across cards it is launched by torchrun, one process per card:

  torchrun --nproc_per_node 8 -m visualcloze_tpu_torch.training.train \
      --data_path data.yaml --init_random --fsdp 8 ...

with JAX's mesh flags: --dp, --fsdp (0: every rank the other axes leave),
--tp, --cp (the DiT's tokens split over cp ranks, ring attention), --pp (GPipe over the single trunk,
--pp_microbatches), --ep (MoE-LoRA experts, with --moe_experts) and --sdp
(ZeRO-2: weights replicated, gradients and AdamW state sharded). Every rank
loads and encodes the same global batch and trains on its share of it
(micro_bsz per data rank and micro-batch); the LoRA is replicated and its
gradients averaged (parallel/, training/step.py). --device cpu runs the
ranks as a gloo group. JAX's refusals stand: --cp with --pp, --pp with
remat dots_split, --init_from with --moe_experts.

The model keeps the reference's interleaved RoPE channel order, so its LoRA
exports drop into the reference. Per-step randomness is a function of
(seed, step, data rank): a resumed run draws at step k what an
uninterrupted one draws.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.lora import init_lora, init_moe_lora, lora_param_count, tree_items, tree_map
from ..ops.attention import RingSpec
from ..parallel import (create_mesh, initialize_distributed, replicate_tree, shard_large_params, shard_lora,
                        shard_micro_batches, shard_params)
from ..transport import create_transport
from ..utils.misc import PhaseTimer, SmoothedValue
from . import checkpoint as ckpt
from .batch import prepare_train_batch, to_micro_batches
from .step import init_train_state, make_optimizer, make_train_step, trainable_mask

logger = logging.getLogger("train")

# the JAX package's model names; with --init_random every one builds FLUX.1-Fill's shapes
MODEL_NAMES = ("flux-dev", "flux-dev-lora", "flux-dev-fill-lora", "flux-schnell", "flux-dev-canny",
               "flux-dev-canny-lora", "flux-dev-depth", "flux-dev-depth-lora", "flux-dev-fill")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="VisualCloze trainer (PyTorch/CUDA)")
    p.add_argument("--model_name", default="flux-dev-fill-lora", choices=MODEL_NAMES)
    p.add_argument("--data_path", required=True)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--grid_resolution", type=int, default=384)
    p.add_argument("--cache_data_on_disk", action="store_true")
    p.add_argument("--max_steps", type=int, default=100_000)
    p.add_argument("--global_bsz", type=int, default=16)
    p.add_argument("--micro_bsz", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=2.0)
    p.add_argument("--snr_type", default="lognorm")
    p.add_argument("--no_shift", action="store_true")
    p.add_argument("--caption_dropout_prob", type=float, default=0.1)
    p.add_argument("--training_type", default="lora",
                   choices=["lora", "full_model", "double_block", "bias", "norm"])
    p.add_argument("--lora_rank", type=int, default=128)
    p.add_argument("--moe_experts", type=int, default=0,
                   help="MoE-LoRA: number of expert LoRA pairs (0 = plain LoRA); experts split over --ep")
    p.add_argument("--ep", type=int, default=1, help="expert-parallel mesh axis size (MoE-LoRA)")
    p.add_argument("--use_model_ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.95)
    p.add_argument("--checkpointing", action="store_true", help="activation remat per block")
    p.add_argument("--remat_policy", default="dots", choices=["dots", "dots_split", "full"],
                   help="dots keeps matmul outputs, dots_split also the attention's saved tensors, "
                        "full recomputes everything (least memory)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel mesh axis")
    p.add_argument("--fsdp", type=int, default=0, help="FSDP mesh axis (0 = all remaining ranks)")
    p.add_argument("--sdp", action="store_true",
                   help="ZeRO-2: weights replicated over the data axes, gradients and AdamW state sharded")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh axis")
    p.add_argument("--cp", type=int, default=1,
                   help="sequence parallelism: the DiT's tokens split over a cp axis, ring attention between "
                        "them (the txt length and the seq bucket divisible by cp)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline parallelism: GPipe over the single-block trunk (38 %% pp == 0)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="pipeline microbatches per micro-batch (0 = pp)")
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--resume", default=None)
    p.add_argument("--init_from", default=None, help="consolidated LoRA .pth to start from")
    p.add_argument("--global_seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--init_random", action="store_true",
                   help="random base weights (no FLUX checkpoint is in the repository)")
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke tests)")
    p.add_argument("--max_seq_bucket", type=int, default=512)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--use_tensorboard", action="store_true",
                   help="log loss/grad_norm to results_dir/tb (tensorboardX)")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", default="visualcloze-tpu")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="compute dtype (bf16 on the GPU; fp32 for the CPU run)")
    p.add_argument("--prompt_bank", default="reference", choices=["reference", "original"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def _check_args(args) -> None:
    """JAX's refusals, and the port's: no FLUX weights are in the repository."""
    if args.cp > 1 and args.pp > 1:
        raise SystemExit("--cp and --pp cannot be combined: ring attention cannot nest inside the "
                         "pipelined trunk (pick one; fsdp/tp/dp compose with either)")
    if args.pp > 1 and args.remat_policy == "dots_split":
        raise SystemExit("--remat_policy dots_split is not implemented for the pipelined trunk; use dots or "
                         "full with --pp")
    if args.init_from and args.moe_experts > 0:
        raise SystemExit("--init_from loads a plain-LoRA .pth, which has no MoE-expert format; it cannot be "
                         "combined with --moe_experts (the MoE tree would be silently replaced)")
    if not (args.init_random or args.tiny):
        raise SystemExit("no FLUX/T5/CLIP/VAE weights are in the repository: pass --init_random")


def build_mesh(args, device: torch.device):
    """The (pp, dp, fsdp, tp, cp, ep) mesh over the launcher's ranks (JAX's
    arithmetic: --fsdp 0 takes every rank the other axes leave), or None
    for one process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    fixed = args.dp * args.tp * args.cp * args.ep * args.pp
    fsdp = args.fsdp or max(1, world // fixed)
    if world == 1 and fixed * fsdp == 1 and not dist.is_initialized():
        return None
    return create_mesh(dp=args.dp, fsdp=fsdp, tp=args.tp, cp=args.cp, ep=args.ep, pp=args.pp, device=device)


def _step_generator(device: torch.device, seed: int, step: int, stream: int) -> torch.Generator:
    """A generator that depends only on (seed, step, stream): resume-safe."""
    return torch.Generator(device=device).manual_seed(((seed + 1000) * 1_000_003 + step) * 2 + stream)


def _b_absmax(lora) -> float | None:
    """max |B| over the LoRA's B factors (zero at init; moves once trained)."""
    if lora is None:
        return None
    maxes = [t.detach().abs().max() for path, t in tree_items(lora) if path.endswith((".b", "_b"))]
    return float(torch.stack(maxes).max()) if maxes else None


def main(argv=None) -> dict:
    """Train; returns {"history": one record per logged step, "model": the
    pipeline holding the frozen base components, "state": the TrainState,
    "ckpt_root": ...}."""
    args = parse_args(argv)
    _check_args(args)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s] %(message)s")
    from ..data import DataLoader, Graph200KItemProcessor, GridDataset, dataloader_collate_fn, get_train_sampler
    from ..data.prefix_instruction import graph200k_task_dicts, set_prompt_bank
    from ..pipeline.loader import random_components

    set_prompt_bank(args.prompt_bank)
    device = resolve_device(args.device)
    _, _, local_rank = initialize_distributed(device)
    if device.type == "cuda" and dist.is_initialized():
        device = torch.device("cuda", local_rank)
    mesh = build_mesh(args, device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if mesh is not None:
        logger.info("mesh: %s over %d ranks", mesh, dist.get_world_size() if dist.is_initialized() else 1)
    compute_dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    is_lora = args.training_type == "lora"

    # ----- models: the base in the compute dtype for LoRA, fp32 masters otherwise -----
    bundle = random_components(
        tiny=args.tiny, dtype=compute_dtype if is_lora else torch.float32, device=device,
        generator=torch.Generator(device=device).manual_seed(args.global_seed),
        resolution=args.grid_resolution, rope_layout="interleaved",
    )
    flux_cfg, flux = bundle.cfg, bundle.flux
    lora = None
    if is_lora:
        lora_gen = torch.Generator(device=device).manual_seed(args.global_seed + 1)
        if args.init_from:
            lora = tree_map(lambda t: t.to(device), ckpt.load_torch_lora(args.init_from, flux_cfg))
        elif args.moe_experts > 0:
            lora = init_moe_lora(flux, args.lora_rank, args.moe_experts, generator=lora_gen)
        else:
            lora = init_lora(flux, args.lora_rank, generator=lora_gen)
        logger.info("LoRA params: %.1fM", lora_param_count(lora) / 1e6)
    logger.info("base params: %.2fB", sum(p.numel() for p in flux.parameters()) / 1e9)

    mask = trainable_mask(flux, args.training_type) if args.training_type not in ("lora", "full_model") else None
    if mesh is not None:
        mp = compute_dtype if not is_lora and compute_dtype != torch.float32 else None
        shard_params(flux, mesh, mode="sdp" if args.sdp else "fsdp", param_dtype=mp)
        for frozen in (bundle.t5.model, bundle.clip.model, bundle.ae.encoder, bundle.ae.decoder):
            shard_large_params(frozen, mesh)  # the frozen encoders' large tensors over fsdp, as JAX's
        if lora is not None:
            lora = shard_lora(replicate_tree(lora, mesh), mesh)
    optimizer = make_optimizer(args.lr, args.wd, args.grad_clip)
    state = init_train_state(flux, lora, optimizer, args.training_type, args.use_model_ema, mask=mask,
                             mesh=mesh, sdp=args.sdp)
    transport = create_transport("Linear", "velocity", snr_type=args.snr_type, do_shift=not args.no_shift)
    train_step = make_train_step(
        transport, optimizer, args.training_type,
        ema_decay=args.ema_decay if args.use_model_ema else None,
        remat=args.checkpointing,
        remat_policy=None if args.remat_policy == "full" else args.remat_policy,
        compute_dtype=compute_dtype, rope_layout="interleaved",
        attn_impl=RingSpec(mesh, "cp") if args.cp > 1 else None,
        mesh=mesh, pp_microbatches=args.pp_microbatches or None,
    )

    # ----- resume -----
    ckpt_root = os.path.join(args.results_dir, "checkpoints")
    resume_step = 0
    resume_dir = args.resume
    if args.auto_resume and resume_dir is None:
        resume_dir = ckpt.find_latest_checkpoint(ckpt_root)
    if resume_dir:
        logger.info("resuming from %s", resume_dir)
        ckpt.restore_into(state, ckpt.load_checkpoint(resume_dir))
        resume_step = ckpt.load_resume_step(resume_dir)

    # ----- data -----
    dataset = GridDataset(
        args.data_path, Graph200KItemProcessor(resolution=args.grid_resolution),
        cache_on_disk=args.cache_data_on_disk,
        task_dicts={"image_grid_graph200k": graph200k_task_dicts}, process_index=0, seed=args.global_seed,
    )
    n_data = mesh.size(("dp", "fsdp")) if mesh is not None else 1
    global_micro = args.micro_bsz * n_data  # micro_bsz is per data rank, as in JAX
    if args.global_bsz % global_micro != 0:
        raise SystemExit(f"--global_bsz {args.global_bsz} must be a multiple of micro_bsz x dp x fsdp = "
                         f"{args.micro_bsz} x {n_data} = {global_micro}")
    if args.pp > 1 and args.micro_bsz % args.pp:
        raise SystemExit(f"--micro_bsz {args.micro_bsz} must split over --pp {args.pp}")
    data_rank = mesh.rank(("pp", "dp", "fsdp")) if mesh is not None else 0
    sampler = get_train_sampler(len(dataset), 0, 1, args.global_bsz, args.max_steps, resume_step,
                                args.global_seed)
    loader_iter = iter(DataLoader(dataset, sampler, args.global_bsz, dataloader_collate_fn,
                                  num_workers=args.num_workers))

    tb_writer = None
    if args.use_tensorboard and rank0:
        from tensorboardX import SummaryWriter

        tb_writer = SummaryWriter(os.path.join(args.results_dir, "tb"))
    wandb_run = None
    if args.use_wandb and rank0:
        try:
            import wandb

            wandb_run = wandb.init(project=args.wandb_project, config=vars(args))
        except Exception as e:  # wandb is optional
            logger.warning("wandb unavailable (%s); continuing without it", e)

    # ----- loop -----
    os.makedirs(ckpt_root, exist_ok=True)
    timer = PhaseTimer()
    loss_meter = SmoothedValue()
    history = []
    logger.info("training for %d steps from %d on %s", args.max_steps, resume_step, device)

    # SIGTERM (preemption): finish the step in flight, checkpoint, exit cleanly
    preempted = {"flag": False}

    def _on_preempt(signum, frame):
        del frame
        preempted["flag"] = True
        logger.warning("signal %d: checkpoint at next step boundary", signum)

    on_main = threading.current_thread() is threading.main_thread()
    old_handler = signal.signal(signal.SIGTERM, _on_preempt) if on_main else None
    try:
        for step in range(resume_step, args.max_steps):
            timer.reset()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            _, rows_batch, prompts, _, grid_shapes = next(loader_iter)
            timer.mark("DataloadSecs")

            rng = np.random.default_rng((args.global_seed, 0, step))
            batch = prepare_train_batch(
                bundle.ae, bundle.t5, bundle.clip, rows_batch, prompts, grid_shapes, rng,
                caption_dropout=args.caption_dropout_prob, bucket=args.max_seq_bucket,
                compute_dtype=compute_dtype, generator=_step_generator(device, args.global_seed, step, 0),
            )
            batch = to_micro_batches(batch, global_micro)
            if mesh is not None:
                batch = shard_micro_batches(batch, mesh)
            timer.mark("EncodeSecs")

            metrics = train_step(state, batch, _step_generator(device, args.global_seed + 7919 * data_rank, step, 1))
            if step % args.log_every == 0:
                loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
                timer.mark("TrainSecs")
                loss_meter.update(loss)
                record = dict(
                    step=step, loss=loss, grad_norm=gn, lora_b_absmax=_b_absmax(state.lora),
                    tokens_img=int(batch["x1"].shape[-2]), tokens_txt=int(batch["txt"].shape[-2]),
                    real_img_tokens=batch["img_mask"].sum(dim=-1).flatten().tolist(),
                    seconds={k: v.value for k, v in timer.meters.items()},
                    peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                                  if device.type == "cuda" else None),
                )
                history.append(record)
                logger.info("step %d loss %.4f (%s) grad_norm %.3f %s", step, loss, loss_meter, gn,
                            timer.summary())
                if tb_writer is not None:
                    tb_writer.add_scalar("loss", loss, step)
                    tb_writer.add_scalar("grad_norm", gn, step)
                    tb_writer.add_scalar("lr", args.lr, step)
                if wandb_run is not None:
                    wandb_run.log({"loss": loss, "grad_norm": gn, "lr": args.lr}, step=step)

            stop = preempted["flag"]
            if dist.is_initialized():  # SIGTERM lands per rank; the save below is collective
                flag = torch.tensor(float(stop), device=device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                stop = bool(flag.item())
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.max_steps or stop:
                t0 = time.perf_counter()
                path = ckpt.save_checkpoint(ckpt_root, step + 1, state, model_args=vars(args),
                                            save_ema=args.use_model_ema)
                logger.info("saved checkpoint %s in %.1fs", path, time.perf_counter() - t0)
            if stop:
                logger.warning("preempted at step %d: checkpoint saved, exiting cleanly for "
                               "--auto_resume restart", step + 1)
                break
    finally:
        loader_iter.close()  # stops the loader's producer thread
        if on_main:
            signal.signal(signal.SIGTERM, old_handler)
    if tb_writer is not None:
        tb_writer.close()
    logger.info("done")
    return {"history": history, "model": bundle, "state": state, "ckpt_root": ckpt_root}


if __name__ == "__main__":
    main()
