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

One process, one device: gradients are accumulated over global_bsz /
micro_bsz micro-batches. The mesh flags (--dp --fsdp --tp --cp --pp --ep
above 1), --sdp and --moe_experts are refused: multi-device training and
MoE-LoRA are not ported yet (ROADMAP items 4 and 5). The model keeps the
reference's interleaved RoPE channel order, so its LoRA exports drop into the
reference. Per-step randomness is a function of (seed, step): a resumed run
draws at step k what an uninterrupted one draws.
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

from ..device import resolve_device
from ..models.lora import init_lora, lora_param_count, tree_items, tree_map
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
    p.add_argument("--moe_experts", type=int, default=0, help="MoE-LoRA: not ported (ROADMAP item 5)")
    p.add_argument("--ep", type=int, default=1, help="expert-parallel axis: not ported (ROADMAP item 5)")
    p.add_argument("--use_model_ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.95)
    p.add_argument("--checkpointing", action="store_true", help="activation remat per block")
    p.add_argument("--remat_policy", default="dots", choices=["dots", "dots_split", "full"],
                   help="dots keeps matmul outputs, dots_split also the attention's saved tensors, "
                        "full recomputes everything (least memory)")
    for axis in ("dp", "tp", "cp", "pp"):
        p.add_argument(f"--{axis}", type=int, default=1, help="mesh axis: not ported (ROADMAP item 4)")
    p.add_argument("--fsdp", type=int, default=0, help="0 or 1: one device (ROADMAP item 4)")
    p.add_argument("--sdp", action="store_true", help="ZeRO-2: not ported (ROADMAP item 4)")
    p.add_argument("--pp_microbatches", type=int, default=0)
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


def _refuse_unported(args) -> None:
    for axis in ("dp", "tp", "cp", "pp", "ep"):
        if getattr(args, axis) > 1:
            raise SystemExit(f"--{axis} {getattr(args, axis)}: multi-device training is not "
                             "ported yet (ROADMAP item 4); the port trains on one device")
    if args.fsdp > 1 or args.sdp:
        raise SystemExit("--fsdp > 1 / --sdp: sharded training is not ported yet (ROADMAP item 4)")
    if args.moe_experts > 0:
        raise SystemExit("--moe_experts: MoE-LoRA is not ported yet (ROADMAP item 5)")
    if not (args.init_random or args.tiny):
        raise SystemExit("no FLUX/T5/CLIP/VAE weights are in the repository: pass --init_random")


def _step_generator(device: torch.device, seed: int, step: int, stream: int) -> torch.Generator:
    """A generator that depends only on (seed, step, stream): resume-safe."""
    return torch.Generator(device=device).manual_seed(((seed + 1000) * 1_000_003 + step) * 2 + stream)


def _b_absmax(lora) -> float | None:
    """max |B| over the LoRA's B factors (zero at init; moves once trained)."""
    if lora is None:
        return None
    maxes = [t.detach().abs().max() for path, t in tree_items(lora) if path.endswith(".b")]
    return float(torch.stack(maxes).max())


def main(argv=None) -> dict:
    """Train; returns {"history": one record per logged step, "model": the
    pipeline holding the frozen base components, "state": the TrainState,
    "ckpt_root": ...}."""
    args = parse_args(argv)
    _refuse_unported(args)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s] %(message)s")
    from ..data import DataLoader, Graph200KItemProcessor, GridDataset, dataloader_collate_fn, get_train_sampler
    from ..data.prefix_instruction import graph200k_task_dicts, set_prompt_bank
    from ..pipeline.loader import random_components

    set_prompt_bank(args.prompt_bank)
    device = resolve_device(args.device)
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
        if args.init_from:
            lora = tree_map(lambda t: t.to(device), ckpt.load_torch_lora(args.init_from, flux_cfg))
        else:
            lora = init_lora(flux, args.lora_rank,
                             generator=torch.Generator(device=device).manual_seed(args.global_seed + 1))
        logger.info("LoRA params: %.1fM", lora_param_count(lora) / 1e6)
    logger.info("base params: %.2fB", sum(p.numel() for p in flux.parameters()) / 1e9)

    mask = trainable_mask(flux, args.training_type) if args.training_type not in ("lora", "full_model") else None
    optimizer = make_optimizer(args.lr, args.wd, args.grad_clip)
    state = init_train_state(flux, lora, optimizer, args.training_type, args.use_model_ema, mask=mask)
    transport = create_transport("Linear", "velocity", snr_type=args.snr_type, do_shift=not args.no_shift)
    train_step = make_train_step(
        transport, optimizer, args.training_type,
        ema_decay=args.ema_decay if args.use_model_ema else None,
        remat=args.checkpointing,
        remat_policy=None if args.remat_policy == "full" else args.remat_policy,
        compute_dtype=compute_dtype, rope_layout="interleaved",
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
    if args.global_bsz % args.micro_bsz != 0:
        raise SystemExit(f"--global_bsz {args.global_bsz} must be a multiple of --micro_bsz {args.micro_bsz}")
    sampler = get_train_sampler(len(dataset), 0, 1, args.global_bsz, args.max_steps, resume_step,
                                args.global_seed)
    loader_iter = iter(DataLoader(dataset, sampler, args.global_bsz, dataloader_collate_fn,
                                  num_workers=args.num_workers))

    tb_writer = None
    if args.use_tensorboard:
        from tensorboardX import SummaryWriter

        tb_writer = SummaryWriter(os.path.join(args.results_dir, "tb"))
    wandb_run = None
    if args.use_wandb:
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
            batch = to_micro_batches(batch, args.micro_bsz)
            timer.mark("EncodeSecs")

            metrics = train_step(state, batch, _step_generator(device, args.global_seed, step, 1))
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
