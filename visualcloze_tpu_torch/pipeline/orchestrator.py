"""Pipelined serving over the staged pipeline, and a pool of replicas
(counterpart of visualcloze_tpu/pipeline/orchestrator.py).

PipelinedServer runs each query's stages (prepare_query, denoise_query,
finalize_query, and per masked cell the SDEdit triple prepare_upsampling,
denoise_query, finalize_upsampling) in a pool of `max_inflight` worker
threads, behind an encoder lock (VAE, T5, CLIP) and a DiT lock, so that one
query's encode or decode is issued while another query's denoise holds the
DiT. Each query draws its noise from its own source in the order
process_images does, so the images equal sequential process_images' bit for
bit.

Placement: by default the encoders and the DiT live on the model's device.
With encoder_device and dit_device (JAX's two-chip disaggregated placement)
the VAE, T5 and CLIP move to one card and the DiT with its adapters to the
other; each query's tensors cross to the DiT's card for the denoise and its
samples come back (`_to`), so the two cards work on two queries at once
with max_inflight 2. On one card every stage runs on its worker thread's
default CUDA stream; no side stream is used, since a tensor that crosses
streams would need record_stream before the caching allocator could reuse
its memory. So on one card a second worker overlaps no device work: it
interleaves two queries' stages, which delays the first answer and adds no
throughput. The default max_inflight is therefore 1 (queries in arrival
order).

MeshLeader / follow_mesh: a model whose DiT spans a mesh (torchrun, --tp,
--fsdp, --cp) needs every rank to run the same queries in the same order;
rank 0's server broadcasts each query to the others before running it.

ReplicaPool is host logic over any objects with submit/close: least-loaded
dispatch, failover once per remaining replica, and health accounting.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Sequence

import torch
from PIL import Image

from ..device import same_device
from ..models.lora import tree_map
from ..utils import tracing
from .visualcloze import VisualClozeModel

logger = logging.getLogger(__name__)


def _on(device):
    """The card's context for a stage: the hand-written kernels launch on the
    current device, which a worker thread does not inherit."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ReplicaPool:
    """Least-loaded dispatch over N serving replicas (the scale-out unit).

    submit() routes a query to the healthy replica with the fewest queries
    in flight; duck-types PipelinedServer's submit/close, so ServingFrontend
    (pipeline/server.py) serves a pool as it serves one server.

    Failover: a query that fails on one replica is retried once on each
    remaining replica. A replica with `unhealthy_after` consecutive failures
    stops receiving new queries until one of its retries succeeds (it is still
    tried last when every replica is unhealthy, which is its recovery probe).
    A ValueError is a client error (a bad request, an unknown adapter): it
    is the same on every replica, so it is neither retried nor counted.
    health() reports each replica's state."""

    def __init__(self, replicas: Sequence["PipelinedServer"], unhealthy_after: int = 3):
        if not replicas:
            raise ValueError("ReplicaPool needs at least one replica")
        self.replicas = list(replicas)
        self.unhealthy_after = unhealthy_after
        self._inflight = [0] * len(self.replicas)
        self._failures = [0] * len(self.replicas)  # consecutive
        self._lock = threading.Lock()

    def _pick(self, tried: set[int]) -> int | None:
        """Least-loaded among healthy untried replicas; any untried one when
        none is healthy; None when all have been tried."""
        with self._lock:
            untried = [i for i in range(len(self.replicas)) if i not in tried]
            if not untried:
                return None
            healthy = [i for i in untried if self._failures[i] < self.unhealthy_after]
            i = min(healthy or untried, key=self._inflight.__getitem__)
            self._inflight[i] += 1
            return i

    def _failed(self, out: Future, tried: set[int], i: int, err: BaseException, args, kwargs) -> None:
        """Count a failure of replica i, then retry elsewhere or give up."""
        with self._lock:
            self._failures[i] += 1
            more = len(tried) < len(self.replicas)
        if more:
            self._dispatch(out, tried, args, kwargs)
        else:
            out.set_exception(err)

    def _dispatch(self, out: Future, tried: set[int], args, kwargs) -> None:
        i = self._pick(tried)
        if i is None:  # defensive: callers check len(tried) before recursing
            if not out.done():
                out.set_exception(RuntimeError("no replica available"))
            return
        tried.add(i)
        try:
            inner = self.replicas[i].submit(*args, **kwargs)
        except Exception as err:
            # e.g. a shut-down executor: an unhandled raise here (inside
            # submit() or a done-callback) would leave `out` unresolved and
            # leak the in-flight slot, so it counts as a failed query
            with self._lock:
                self._inflight[i] -= 1
            self._failed(out, tried, i, err, args, kwargs)
            return

        def _done(f: Future):
            with self._lock:
                self._inflight[i] -= 1
            err = f.exception()
            if err is None:
                with self._lock:
                    self._failures[i] = 0
                out.set_result(f.result())
            elif isinstance(err, ValueError):
                out.set_exception(err)
            else:
                self._failed(out, tried, i, err, args, kwargs)

        inner.add_done_callback(_done)

    def submit(self, *args, **kwargs) -> Future:
        out: Future = Future()
        out.set_running_or_notify_cancel()
        self._dispatch(out, set(), args, kwargs)
        return out

    def health(self) -> list[dict[str, int | bool]]:
        """Per replica: queries in flight, consecutive failures, and whether
        it is in the dispatch set (for /healthz)."""
        with self._lock:
            return [
                {"in_flight": self._inflight[i], "consecutive_failures": self._failures[i],
                 "healthy": self._failures[i] < self.unhealthy_after}
                for i in range(len(self.replicas))
            ]

    def close(self) -> None:
        for r in self.replicas:
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PipelinedServer:
    """Pipelined serving of a VisualClozeModel from `max_inflight` threads.

    encoder_device: the card for the VAE, T5 and CLIP weights (None: where
    they are); dit_device: the card for the DiT and its runtime adapters.
    The model's weights are moved there."""

    def __init__(self, model: VisualClozeModel, encoder_device=None, dit_device=None, max_inflight: int = 1):
        if encoder_device is not None and not same_device(encoder_device, model.device):
            dev = torch.device(encoder_device)
            model.ae.to(dev)
            for enc in (model.t5, model.clip):
                enc.model.to(dev)
            model.device = dev
        self.dit_device = None
        if dit_device is not None and not same_device(dit_device, model.device):
            dev = torch.device(dit_device)
            model.flux.to(dev)
            model.adapters = {name: tree_map(lambda t: t.to(dev), tree) for name, tree in model.adapters.items()}
            model.dit_device = self.dit_device = dev
        self.model = model
        self._enc_lock = threading.Lock()
        self._dit_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_inflight)

    def submit(
        self,
        images: list[list[Image.Image | None]],
        prompts: Sequence[str],
        grid_size: tuple[int, int],
        seed: int = 0,
        cfg: float = 30.0,
        steps: int = 30,
        upsampling_steps: int = 10,
        upsampling_noise: float = 0.4,
        is_upsampling: bool = True,
        adapter: str | None = None,
    ) -> Future:
        """Enqueue one query; a Future of its list of images. grid_size is
        the query's own (the model's set_grid_size state is not touched), so
        queries of different grids run at once; `adapter` selects a
        registered runtime LoRA."""
        return self._pool.submit(self._run, images, prompts, grid_size, seed, cfg, steps, upsampling_steps,
                                 upsampling_noise, is_upsampling, adapter)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _to(q: dict[str, Any], device) -> dict[str, Any]:
        """The query with its tensors on `device` (its records stay shared)."""
        if device is None:
            return q
        return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in q.items()}

    def _denoise(self, q, stage: str = "denoise"):
        with self._dit_lock, _on(self.dit_device or self.model.device):
            samples = self.model.denoise_query(self._to(q, self.dit_device), stage)
        return samples if self.dit_device is None else samples.to(self.model.device)

    @contextlib.contextmanager
    def _encoders(self):
        with self._enc_lock, _on(self.model.device):
            yield

    def _run(self, images, prompts, grid_size, seed, cfg, steps, upsampling_steps, upsampling_noise,
             is_upsampling, adapter=None) -> list[Image.Image]:
        """One query's stages on this worker thread, traced as one "query" span."""
        with tracing.span("query", query=tracing.new_query()):
            m = self.model
            with self._encoders():
                q = m.prepare_query(images, prompts, seed=seed, cfg=cfg, steps=steps, grid_size=grid_size,
                                    adapter=adapter)
            samples = self._denoise(q)
            with self._encoders():
                crops = m.finalize_query(q, samples, is_upsampling=False)
            if not is_upsampling:
                return crops
            # SDEdit per masked cell, drawing from the query's noise in process_images' order
            out: list[Image.Image] = []
            for img in crops:
                with self._encoders():
                    uq = m.prepare_upsampling(img, q["upsampling_size"], cfg, upsampling_steps=upsampling_steps,
                                              upsampling_noise=upsampling_noise, noise=q["noise"],
                                              content_prompt=q["content_prompt"], adapter=adapter, parent=q)
                if isinstance(uq, Image.Image):  # noise >= 1.0: plain resize
                    out.append(uq)
                    continue
                us = self._denoise(uq, "sdedit_denoise")
                with self._encoders():
                    out.append(m.finalize_upsampling(uq, us))
            return out


class MeshLeader:
    """Rank 0's face of a server whose model spans a mesh: each submitted
    query is broadcast to the other ranks (follow_mesh) and then run, one at
    a time, so that every rank issues the same collectives in order."""

    def __init__(self, server):
        self.server = server
        self._pool = ThreadPoolExecutor(max_workers=1)

    def submit(self, *args, **kwargs) -> Future:
        return self._pool.submit(self._run, args, kwargs)

    def _run(self, args, kwargs):
        import torch.distributed as dist

        dist.broadcast_object_list([(args, kwargs)], src=0)
        return self.server.submit(*args, **kwargs).result()

    def __getattr__(self, name):  # the frontend reads the inner server's health where it has one
        return getattr(self.server, name)

    def close(self) -> None:
        import torch.distributed as dist

        self._pool.shutdown(wait=True)
        dist.broadcast_object_list([None], src=0)
        self.server.close()


def follow_mesh(server) -> tuple[int, int]:
    """The loop of a rank other than 0: run each query rank 0 broadcasts,
    until it broadcasts None; returns (queries run, queries that raised). A
    query that raises (an unknown adapter, a bad grid) raises on rank 0
    too, whose server answers it with the error and goes on; so does this
    loop, to stay in step."""
    import torch.distributed as dist

    n = failed = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return n, failed
        args, kwargs = box[0]
        n += 1
        try:
            server.submit(*args, **kwargs).result()
        except Exception:  # rank 0 reports it to the client; this rank only keeps in step
            failed += 1
            logger.exception("query %d raised on this rank (as on rank 0)", n)
