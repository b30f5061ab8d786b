"""VisualClozeModel: the end-to-end inference pipeline (counterpart of
visualcloze_tpu/pipeline/visualcloze.py).

grid preprocessing -> a VAE encode per row -> T5/CLIP + token packing -> the
rectified-flow denoise of the DiT with the chosen ODE solver -> a VAE decode
per row -> crop of the query cells -> the optional SDEdit upsampling pass.

Noise: a query draws its Gaussians from a torch.Generator seeded with `seed`,
in this order: per grid row the VAE posterior noise then the row's latent
noise; per upsampled cell the posterior noise of the image, of the blank
image, then the latent noise. `noise={"vae": [...], "latent": [...]}` hands
the arrays in instead (in the same order), since jax.random and
torch.Generator give different numbers from one seed. Every path that runs
the stages one by one (pipeline/orchestrator.py) draws from the query's own
source in this order, so its images equal process_images' bit for bit.

Runtime LoRA adapters (add_adapter) are applied unfolded at denoise time and
selected per query (`adapter=`), so one base DiT serves many tasks. A query
keeps its own stage seconds and solver statistics (q["stage_seconds"],
q["solver_stats"]) and takes its grid size as an argument, so that server
threads can run queries at once; process_images copies them to the model's
stage_seconds and solver_stats for its sequential callers.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from ..config import FluxConfig
from ..device import resolve_device
from ..models.autoencoder import AutoEncoder
from ..models.flux import Flux
from ..models.layers import lora_delta_dtype
from ..models.lora import Lora, lora_entries, tree_items, tree_replace
from ..models.quant import merge_a8_stats, quantize_flux_w8a8_smooth
from ..models.sampling import prepare_modified
from ..models.weights import permute_rope_layout, permute_rope_layout_lora
from ..ops import cuda_build
from ..ops.packing import pack_mask, patchify, unpatchify
from ..ops.schedule import ode_timesteps
from ..transport.sampling import _velocity_fn, denoise_ode, denoise_ode_adaptive
from . import preprocessing as pp

CONTENT_INSTRUCTIONS = [
    "The content of the last image in the final row is: ",
    "The last image of the last row depicts: ",
    "In the final row, the last image shows: ",
    "The last image in the bottom row illustrates: ",
    "The content of the bottom-right image is: ",
    "The final image in the last row portrays: ",
    "The last image of the final row displays: ",
    "In the last row, the final image captures: ",
    "The bottom-right corner image presents: ",
    "The content of the last image in the concluding row is: ",
    "In the last row, ",
    "The editing instruction in the last row is: ",
]

BF16 = torch.bfloat16


class NoiseSource:
    """The Gaussian draws of one query: from a seeded generator, or, per kind
    ("vae", "latent"), from arrays given by the caller in order of use."""

    def __init__(self, device: torch.device, seed: int, given: dict | None = None):
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.given = {k: list(v) for k, v in (given or {}).items()}

    def normal(self, kind: str, shape) -> torch.Tensor:
        shape = tuple(shape)
        if kind in self.given:
            if not self.given[kind]:
                raise ValueError(f"no given {kind!r} noise left for a draw of shape {shape}")
            t = torch.as_tensor(np.array(self.given[kind].pop(0), dtype=np.float32))
            if tuple(t.shape) != shape:
                raise ValueError(f"given {kind!r} noise has shape {tuple(t.shape)}, need {shape}")
            return t.to(self.device)
        return torch.randn(shape, generator=self.generator, dtype=torch.float32, device=self.device)


def _bf16_scalar(value: float, device) -> torch.Tensor:
    # JAX rounds a Python scalar to the bf16 array's dtype before the op
    return torch.tensor(value, dtype=BF16, device=device)


class VisualClozeModel:
    """construct, set_grid_size, process_images, upsampling.

    flux: the DiT with LoRA folded in (models/lora.fold_lora; the loader
    folds while it places the weights); ae, t5, clip: the VAE and the two
    TextEncoders. rope_layout "half" (the serving layout) or "interleaved"
    (the reference's channel order, as the trainer keeps it); in both the
    blocks' kernel L rotates q and k and kernel D attends. With "half" and permute_params the constructor permutes the
    q/k channels of `flux` from the reference order in place
    (models/weights.permute_rope_layout), as the JAX constructor does;
    permute_params=False: the caller's weights already sit in the half order
    (a JAX model's converted params, or random weights, where any order is a
    valid half layout). solver: euler, heun, ab2, cached[:K] or dopri5;
    time_shifting_factor warps the stage-1 grid. adapters: named runtime
    LoRA trees (add_adapter), applied unfolded when a query names one, with
    their delta times lora_scale. The text length is the TextEncoders' own
    (the loader's max_length). attn_impl: None (the kernels) or an
    ops.attention.RingSpec, under which every DiT evaluation splits its
    tokens over the spec's cp axis and attends with ring attention (with a
    DiT sharded over the same mesh, loader.build_visualcloze(mesh=...)).
    Across ranks every rank runs the same query on the same noise: the
    outputs agree."""

    def __init__(
        self,
        flux_cfg: FluxConfig,
        flux: Flux,
        ae: AutoEncoder,
        t5,
        clip,
        *,
        resolution: int = 384,
        solver: str = "euler",
        time_shifting_factor: float = 1.0,
        rope_layout: str = "half",
        adapters: dict[str, dict] | None = None,
        lora_scale: float = 1.0,
        permute_params: bool = True,
        device: str | torch.device | None = None,
        attn_impl=None,
    ):
        if rope_layout not in ("half", "interleaved"):
            raise ValueError(f"rope_layout must be 'half' or 'interleaved', got {rope_layout!r}")
        self.cfg = flux_cfg
        if rope_layout == "half" and permute_params:
            permute_rope_layout(flux, flux_cfg)
        self.rope_layout = rope_layout
        self.flux = flux
        self.ae = ae
        self.t5 = t5
        self.clip = clip
        self.resolution = resolution
        self.solver = solver
        self.time_shifting_factor = time_shifting_factor
        self.device = resolve_device(device)
        self.grid_h: int | None = None
        self.grid_w: int | None = None
        self.stage_seconds: dict[str, float] = {}
        self.solver_stats: dict[str, dict] = {}
        self.adapters: dict[str, Lora] = {}
        self.lora_scale = lora_scale
        self.attn_impl = attn_impl
        self.mesh = None  # the parallel.Mesh the DiT is sharded over (loader.place_model)
        self.dit_device: torch.device | None = None  # the DiT's card when it is not self.device (PipelinedServer)
        for name, tree in (adapters or {}).items():
            self.add_adapter(name, tree)

    def add_adapter(self, name: str, lora: Lora) -> None:
        """Register a runtime LoRA adapter (a tree of models/lora.py, in the
        reference channel order: init_lora, convert_lora_any). It is permuted
        into the half layout where the model serves in it, and put on the
        model's device once, each entry's factors already in the dtype its
        linear computes the delta in (the cast models/layers._lora_delta
        would make at every call, made once). An entry with no linear in the
        DiT is refused, as fold_lora refuses it."""
        if self.rope_layout == "half":
            lora = permute_rope_layout_lora(lora, self.cfg)
        modules = dict(self.flux.named_modules())
        placed = {}
        for path, entry in lora_entries(lora).items():
            if path not in modules:
                raise ValueError(f"adapter {name!r}: LoRA entry {path!r} has no linear in the model")
            dtype = None if "expert_a" in entry else lora_delta_dtype(modules[path])
            placed.update({f"{path}.{k}": v.to(self.dit_device or self.device, dtype) for k, v in entry.items()})
        self.adapters[name] = tree_replace(lora, placed)

    def _resolve_adapter(self, name: str | None) -> Lora | None:
        if name is None:
            return None
        if name not in self.adapters:
            raise ValueError(f"unknown adapter {name!r}; loaded: {sorted(self.adapters)}")
        return self.adapters[name]

    def adapter_warm_set(self) -> list[str | None]:
        """[None] + the first registered adapter of each signature (leaf
        paths, shapes and dtypes: rank and coverage), as JAX's, where one
        signature is one compiled denoise program. Here it is one set of
        GEMM shapes, whose cuBLAS heuristics a warmup pass settles."""
        passes: list[str | None] = [None]
        seen: set = set()
        for name, tree in self.adapters.items():
            sig = tuple((path, tuple(x.shape), x.dtype) for path, x in tree_items(tree))
            if sig not in seen:
                seen.add(sig)
                passes.append(name)
        return passes

    def warmup(self, grid_shapes: list[tuple[int, int]], steps: int = 30, upsampling_steps: int = 10,
               upsampling_noise: float = 0.4, upsampling_sizes: Sequence[tuple[int, int]] = (),
               submit: Callable[..., list[Image.Image]] | None = None) -> None:
        """One blank query per grid shape, query-cell size and adapter
        signature: the kernels are built and loaded, and the caching
        allocator and cuBLAS have seen every shape before the first request.
        The cell sizes are (resolution, resolution) and each (W, H) of
        upsampling_sizes, since the SDEdit pass runs at the query cell's own
        size. submit: the callable the queries go through, with
        process_images' arguments (default process_images; the server passes
        its own submit path, so the warmup runs where the requests run)."""
        run = submit or self.process_images
        res = self.resolution
        cell_sizes = [(res, res)] + [s for s in upsampling_sizes if s != (res, res)]
        for gh, gw in grid_shapes:
            for cw, ch in cell_sizes:
                blank = Image.new("RGB", (cw, ch), (0, 0, 0))
                grid = [[blank] * gw for _ in range(gh)]
                grid[-1][-1] = None
                for adapter in self.adapter_warm_set():
                    run(grid, ["warmup", "", ""], grid_size=(gh, gw), seed=1, steps=steps,
                        upsampling_steps=upsampling_steps, upsampling_noise=upsampling_noise, is_upsampling=True,
                        adapter=adapter)

    def enable_aot(self, cache_dir: str | None = None) -> str:
        """Keep the compiled kernels under cache_dir (default
        $VISUALCLOZE_AOT_DIR, else build/torch_kernels/ of the checkout), so
        that the next process loads them instead of running nvcc: the
        counterpart of JAX's serialized executables (pipeline/aot.py), since
        the port's compiled artefacts are the kernels' shared libraries.
        Raises if a kernel library is already loaded from another directory.
        Returns the directory."""
        return str(cuda_build.set_build_dir(cache_dir))

    @contextlib.contextmanager
    def _stage(self, name: str, seconds: dict[str, float]):
        """Adds the stage's wall time (device work included) to seconds[name]."""
        t0 = time.perf_counter()
        yield
        for dev in {self.device, self.dit_device or self.device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    def _shared_seed(self, seed: int) -> int:
        """Rank 0's seed on every rank of the model's mesh (its ranks run each
        query together and must draw the same noise); `seed` without one."""
        if self.mesh is None or self.mesh.device_mesh is None:
            return seed
        import torch.distributed as dist

        box = torch.tensor([seed], dtype=torch.int64, device=self.device if self.device.type == "cuda" else "cpu")
        dist.broadcast(box, src=0)
        return int(box.item())

    def set_grid_size(self, h: int, w: int) -> None:
        self.grid_h = h
        self.grid_w = w

    def encode_row(self, row_img: np.ndarray, noise: NoiseSource) -> torch.Tensor:
        """(H, W, 3) [-1, 1] pixels -> (1, H/8, W/8, z) scaled latent."""
        x = torch.from_numpy(np.ascontiguousarray(row_img, dtype=np.float32))[None].to(self.device)
        h, w = row_img.shape[:2]
        f = self.ae.cfg.downsample_factor
        eps = noise.normal("vae", (1, h // f, w // f, self.ae.cfg.z_channels))
        return self.ae.encode(x, eps)

    def decode_latent(self, z: torch.Tensor) -> np.ndarray:
        """(1, h, w, z) scaled latent -> (H, W, 3) pixels in [0, 1]."""
        x = self.ae.decode(z)
        return (x[0].to(torch.float32).cpu().numpy() + 1.0) / 2.0

    def process_images(
        self,
        images: list[list[Image.Image | None]],
        prompts: Sequence[str],
        seed: int = 0,
        cfg: float = 30.0,
        steps: int = 30,
        upsampling_steps: int = 10,
        upsampling_noise: float = 0.4,
        is_upsampling: bool = True,
        noise: dict | None = None,
        adapter: str | None = None,
        grid_size: tuple[int, int] | None = None,
    ) -> list[Image.Image]:
        """Generate the masked query cells: prepare -> denoise -> finalize.
        `adapter` selects a registered runtime LoRA for both denoise stages;
        grid_size defaults to set_grid_size's. The query's stage seconds and
        solver statistics become the model's stage_seconds and solver_stats."""
        q = self.prepare_query(images, prompts, seed=seed, cfg=cfg, steps=steps, noise=noise, adapter=adapter,
                               grid_size=grid_size)
        self.stage_seconds, self.solver_stats = q["stage_seconds"], q["solver_stats"]
        samples = self.denoise_query(q)
        return self.finalize_query(
            q, samples,
            upsampling_steps=upsampling_steps,
            upsampling_noise=upsampling_noise,
            is_upsampling=is_upsampling,
        )

    @torch.no_grad()
    def prepare_query(
        self,
        images: list[list[Image.Image | None]],
        prompts: Sequence[str],
        seed: int = 0,
        cfg: float = 30.0,
        steps: int = 30,
        noise: dict | None = None,
        grid_size: tuple[int, int] | None = None,
        adapter: str | None = None,
    ) -> dict[str, Any]:
        """Preprocess, VAE-encode each row, encode the prompt and pack tokens.
        Safe to run from several threads at once when grid_size is given (no
        use of set_grid_size's state); an unknown adapter raises before any
        work."""
        self._resolve_adapter(adapter)
        if seed == 0:
            seed = self._shared_seed(int(np.random.randint(0, 2 ** 31 - 1)))
        src = NoiseSource(self.device, seed, noise)
        grid_h, grid_w = grid_size if grid_size is not None else (self.grid_h, self.grid_w)
        assert grid_h is not None and grid_w is not None, "call set_grid_size first"
        dev = self.device
        seconds: dict[str, float] = {}

        with self._stage("preprocess", seconds):
            processed, mask_position, _, upsampling_size = pp.preprocess_grid(
                images, grid_h, grid_w, self.resolution
            )
            row_images, row_masks = pp.build_grid_rows(processed, mask_position, grid_h, grid_w)

        with self._stage("vae_encode", seconds):
            cond_tokens, mask_tokens, noise_rows, sizes = [], [], [], []
            for row, mask in zip(row_images, row_masks):
                lat = self.encode_row(row, src)
                cond_tokens.append(patchify(lat.to(BF16))[0])
                mask_tokens.append(pack_mask(torch.from_numpy(mask)[None].to(dev, BF16))[0])
                sizes.append(row.shape[:2])
                noise_rows.append(src.normal("latent", lat.shape).to(BF16))
            img_cond = torch.cat(
                [torch.cat(cond_tokens, dim=0), torch.cat(mask_tokens, dim=0)], dim=-1
            )[None]

        with self._stage("text_encode", seconds):
            true_len = sum(h * w // 256 for (h, w) in sizes)
            # bucket to 128 only: kernel D takes any length
            inp = prepare_modified(
                self.t5, self.clip, [noise_rows], [" ".join(prompts)], bucket=128
            )
            if inp["img"].shape[1] > true_len:
                img_cond = F.pad(img_cond, (0, 0, 0, inp["img"].shape[1] - true_len))

        ts = ode_timesteps(
            steps, true_len, do_shift=True, time_shifting_factor=self.time_shifting_factor
        )
        full = bool(inp["img_mask"].all())
        return {
            "x": inp["img"].to(BF16),
            "ts": ts,
            "img_cond": img_cond,
            "txt": inp["txt"].to(BF16),
            "txt_ids": inp["txt_ids"],
            "txt_mask": None if full else inp["txt_mask"],
            "vec": inp["vec"].to(BF16),
            "img_ids": inp["img_ids"],
            "img_mask": None if full else inp["img_mask"],
            "guidance": torch.full((1,), cfg, dtype=BF16, device=dev),
            "sizes": sizes,
            "mask_position": mask_position,
            "grid_w": grid_w,
            "upsampling_size": upsampling_size,
            "cfg": cfg,
            "noise": src,
            "content_prompt": prompts[2] if len(prompts) > 2 else "",
            "adapter": adapter,
            "stage_seconds": seconds,
            "solver_stats": {},
        }

    @torch.no_grad()
    def denoise_query(self, q: dict[str, Any], stage: str = "denoise") -> torch.Tensor:
        """The rectified-flow loop over the full DiT with the model's solver
        and the query's adapter (q["adapter"]); its seconds and solver
        statistics go to the query's records."""
        lora = self._resolve_adapter(q.get("adapter"))
        stats: dict = {}
        with self._stage(stage, q.setdefault("stage_seconds", {})):
            out = _denoise(
                self.flux, q["x"], q["ts"], q["img_cond"], q["txt"], q["txt_ids"],
                q["txt_mask"], q["vec"], q["img_ids"], q["img_mask"], q["guidance"], self.rope_layout,
                method=self.solver, stats=stats, lora=lora,
                lora_scale=self.lora_scale if lora is not None else 1.0, attn_impl=self.attn_impl,
            )
        if stats:
            q.setdefault("solver_stats", {})[stage] = stats
        return out

    @torch.no_grad()
    def calibrate_w8a8_smooth(
        self,
        queries: list[tuple[list, Sequence[str]]] | None = None,
        grid_size: tuple[int, int] = (2, 2),
        steps: int = 30,
        stride: int = 5,
        alpha: float = 0.5,
        seed: int = 1,
        noise: list[dict | None] | None = None,
    ):
        """SmoothQuant calibration, then the swap of the resident unquantized
        DiT for the equalized w8a8 one (JAX calibrate_w8a8_smooth):
        w8a8_calibration_stats, then models/quant.quantize_flux_w8a8_smooth
        with `alpha`. The old DiT is dropped from the model (freed unless the
        caller holds it). Returns the statistics tree. stage_seconds holds the
        calibration queries' prepare stages, "calibrate_denoise" and
        "quantize"."""
        self.stage_seconds = {}
        stats = self.w8a8_calibration_stats(queries, grid_size, steps, stride, seed, noise)
        with self._stage("quantize", self.stage_seconds):
            self.flux = quantize_flux_w8a8_smooth(self.flux, stats, alpha)
        return stats

    @torch.no_grad()
    def w8a8_calibration_stats(
        self,
        queries: list[tuple[list, Sequence[str]]] | None = None,
        grid_size: tuple[int, int] = (2, 2),
        steps: int = 30,
        stride: int = 5,
        seed: int = 1,
        noise: list[dict | None] | None = None,
    ):
        """The elementwise max of the w8a8 linears' input statistics over
        each query's Euler trajectory with the resident unquantized DiT:
        collected at every `stride`-th step and the last, the plain forward
        on the others. queries: (images, prompts) pairs in process_images'
        format; None calibrates on a blank grid of grid_size (gray cells at
        the model's resolution, the last one masked). noise: per query, the
        draws to use in place of the generator's (see NoiseSource). The
        prepare stages and "calibrate_denoise" add to stage_seconds."""
        if queries is None:
            gh, gw = grid_size
            blank = Image.new("RGB", (self.resolution, self.resolution), (128, 128, 128))
            grid = [[blank] * gw for _ in range(gh)]
            grid[-1][-1] = None
            queries = [(grid, ["calibration", "", ""])]
        noise = noise or [None] * len(queries)
        stats = None
        for (images, prompts), given in zip(queries, noise):
            q = self.prepare_query(images, list(prompts), seed=seed, steps=steps, noise=given,
                                   grid_size=(len(images), len(images[0])))
            for k, v in q["stage_seconds"].items():
                self.stage_seconds[k] = self.stage_seconds.get(k, 0.0) + v
            ts = np.asarray(q["ts"], np.float32)
            x = q["x"]

            def model_fn(img, timesteps, collect):
                return self.flux(
                    img=img, img_ids=q["img_ids"], txt=q["txt"], txt_ids=q["txt_ids"], timesteps=timesteps,
                    y=q["vec"], txt_mask=q["txt_mask"], img_mask=q["img_mask"], guidance=q["guidance"],
                    rope_layout=self.rope_layout, collect_a8_stats=collect, attn_impl=self.attn_impl,
                )

            plain = _velocity_fn(functools.partial(model_fn, collect=False), x, q["img_cond"])
            collecting = _velocity_fn(functools.partial(model_fn, collect=True), x, q["img_cond"])
            n = len(ts) - 1
            with self._stage("calibrate_denoise", self.stage_seconds):
                for i in range(n):
                    if i % stride == 0 or i == n - 1:
                        v, st = collecting(x, ts[i])
                        stats = merge_a8_stats(stats, st)
                    else:
                        v = plain(x, ts[i])
                    # JAX's step: the fp32 difference as a weakly typed scalar of v's dtype
                    dt = torch.tensor(float(ts[i + 1] - ts[i]), dtype=v.dtype, device=v.device)
                    x = x + (dt * v).to(x.dtype)
        if stats is None:
            raise ValueError("calibration collected no statistics (steps >= 2 and one query at least are "
                             "needed): refusing to quantize unequalized")
        return stats

    @torch.no_grad()
    def finalize_query(
        self,
        q: dict[str, Any],
        samples: torch.Tensor,
        upsampling_steps: int = 10,
        upsampling_noise: float = 0.4,
        is_upsampling: bool = True,
    ) -> list[Image.Image]:
        """Per-row decode, query-cell crop, optional SDEdit upsampling (with
        the query's adapter, its stages added to the query's records)."""
        with self._stage("vae_decode", q.setdefault("stage_seconds", {})):
            output_rows = []
            start = 0
            for (h, w) in q["sizes"]:
                end = start + (h * w // 256)
                lat = unpatchify(samples[:, start:end], h // 8, w // 8)
                output_rows.append(pp.array_to_image(self.decode_latent(lat)))
                start = end

        ret: list[Image.Image] = []
        last = output_rows[-1]
        ret_w, ret_h = last.width, last.height
        grid_w = q["grid_w"]
        for j in range(grid_w):
            if not q["mask_position"][j]:
                continue
            cropped = last.crop((j * ret_w // grid_w, 0, (j + 1) * ret_w // grid_w, ret_h))
            if is_upsampling:
                ret.append(
                    self.upsampling(
                        cropped, q["upsampling_size"], q["cfg"],
                        upsampling_steps=upsampling_steps,
                        upsampling_noise=upsampling_noise,
                        noise=q["noise"],
                        content_prompt=q["content_prompt"],
                        adapter=q.get("adapter"),
                        parent=q,
                    )
                )
            else:
                ret.append(cropped)
        return ret

    @torch.no_grad()
    def upsampling(
        self,
        image: Image.Image,
        target_size: tuple[int, int] | None,
        cfg: float,
        upsampling_steps: int,
        upsampling_noise: float,
        noise: NoiseSource,
        content_prompt: str,
        adapter: str | None = None,
        parent: dict[str, Any] | None = None,
    ) -> Image.Image:
        """SDEdit stage-2 refinement of one cell."""
        q = self.prepare_upsampling(
            image, target_size, cfg,
            upsampling_steps=upsampling_steps,
            upsampling_noise=upsampling_noise,
            noise=noise, content_prompt=content_prompt, adapter=adapter, parent=parent,
        )
        if isinstance(q, Image.Image):  # noise >= 1.0: plain resize
            return q
        samples = self.denoise_query(q, stage="sdedit_denoise")
        return self.finalize_upsampling(q, samples)

    @torch.no_grad()
    def prepare_upsampling(
        self,
        image: Image.Image,
        target_size: tuple[int, int] | None,
        cfg: float,
        upsampling_steps: int,
        upsampling_noise: float,
        noise: NoiseSource,
        content_prompt: str,
        adapter: str | None = None,
        parent: dict[str, Any] | None = None,
    ) -> dict[str, Any] | Image.Image:
        """Resize cap (1024^2), re-encode, noise mix, packing. Returns the
        resized image directly when upsampling_noise >= 1.0. parent: the
        stage-1 query, whose stage seconds and solver statistics the SDEdit
        stages add to (else records of their own)."""
        self._resolve_adapter(adapter)
        seconds = parent.setdefault("stage_seconds", {}) if parent is not None else {}
        solver_stats = parent.setdefault("solver_stats", {}) if parent is not None else {}
        for c in CONTENT_INSTRUCTIONS:
            if content_prompt.startswith(c):
                content_prompt = content_prompt.replace(c, "")
        if target_size is None:
            target_size = (1024, 1024)
        if target_size[0] * target_size[1] > 1024 * 1024:
            aspect_ratio = target_size[0] / target_size[1]
            new_h = int((1024 * 1024 / aspect_ratio) ** 0.5)
            target_size = (int(new_h * aspect_ratio), new_h)
        image = image.resize(((target_size[0] // 16) * 16, (target_size[1] // 16) * 16))
        if upsampling_noise >= 1.0:
            return image

        dev = self.device
        arr = pp.image_to_array(image)
        with self._stage("sdedit_prepare", seconds):
            latent = self.encode_row(arr, noise)
            blank = self.encode_row(np.zeros_like(arr), noise)
            h, w = arr.shape[:2]
            mask = pack_mask(torch.ones((1, h, w), dtype=BF16, device=dev))
            latent_tok = patchify(latent.to(BF16))
            blank_tok = patchify(blank.to(BF16))
            img_cond = torch.cat([blank_tok, mask], dim=-1)
            lat_noise = noise.normal("latent", latent.shape).to(BF16)
            inp = prepare_modified(self.t5, self.clip, [[lat_noise]], [content_prompt], bucket=128)
            true_len = latent_tok.shape[1]
            if inp["img"].shape[1] > true_len:
                pad = inp["img"].shape[1] - true_len
                latent_tok = F.pad(latent_tok, (0, 0, 0, pad))
                img_cond = F.pad(img_cond, (0, 0, 0, pad))
            x = inp["img"].to(BF16) * _bf16_scalar(1.0 - upsampling_noise, dev) + latent_tok * _bf16_scalar(
                upsampling_noise, dev
            )
        ts = ode_timesteps(
            upsampling_steps, int(x.shape[1]), do_shift=False, strength=upsampling_noise,
            time_shifting_factor=1.0,
        )
        full = bool(inp["img_mask"].all())
        return {
            "x": x,
            "ts": ts,
            "img_cond": img_cond,
            "txt": inp["txt"].to(BF16),
            "txt_ids": inp["txt_ids"],
            "txt_mask": None if full else inp["txt_mask"],
            "vec": inp["vec"].to(BF16),
            "img_ids": inp["img_ids"],
            "img_mask": None if full else inp["img_mask"],
            "guidance": torch.full((1,), cfg, dtype=BF16, device=dev),
            "true_len": true_len,
            "hw": (h, w),
            "adapter": adapter,
            "stage_seconds": seconds,
            "solver_stats": solver_stats,
        }

    @torch.no_grad()
    def finalize_upsampling(self, q: dict[str, Any], samples: torch.Tensor) -> Image.Image:
        """SDEdit decode."""
        h, w = q["hw"]
        with self._stage("sdedit_decode", q.setdefault("stage_seconds", {})):
            lat = unpatchify(samples[:, : q["true_len"]], h // 8, w // 8)
            return pp.array_to_image(self.decode_latent(lat))


def _denoise(flux: Flux, x, ts, cond, txt, txt_ids, txt_mask, vec, img_ids, img_mask, guidance, rope_layout,
             method: str = "euler", stats: dict | None = None, lora: Lora | None = None, lora_scale: float = 1.0,
             attn_impl=None):
    """The hot loop: the solver's steps over the full DiT (dopri5 from the
    grid's first to its last time, adaptively), with an unfolded LoRA. The
    RoPE tables are built once, the ids being fixed for the query."""
    pe = flux.rope_tables(img_ids, txt_ids, attn_impl)

    def model_fn(img, timesteps):
        return flux(
            img=img, img_ids=img_ids, txt=txt, txt_ids=txt_ids, timesteps=timesteps, y=vec,
            txt_mask=txt_mask, img_mask=img_mask, guidance=guidance, rope_layout=rope_layout,
            lora=lora, lora_scale=lora_scale, attn_impl=attn_impl, pe=pe,
        )

    if method == "dopri5":
        return denoise_ode_adaptive(model_fn, x, ts[0], ts[-1], cond=cond, stats=stats)
    return denoise_ode(model_fn, x, ts, cond=cond, method=method)
