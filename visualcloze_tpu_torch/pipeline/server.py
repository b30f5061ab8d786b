"""HTTP serving frontend over the pipelined server (counterpart of
visualcloze_tpu/pipeline/server.py), on the standard library's http.server:

  POST /v1/generate   JSON in, JSON out (base64 PNG cells); admission is
                      bounded (429 beyond max_inflight + max_queue)
  GET  /healthz       liveness and queue depth (and each replica's health
                      behind a ReplicaPool)
  GET  /metrics       Prometheus text: request, failure, client-error and
                      rejection counters, the in-flight and queue-depth
                      gauges, latency quantiles over a ring buffer

Request (application/json):
  {
    "images": [[<b64 PNG or null>, ...], ...],   # grid rows; null = a masked cell
    "prompts": [layout, task, content],
    "grid_size": [h, w],                          # optional (taken from images)
    "seed": 0, "cfg": 30.0, "steps": 30,
    "upsampling": true, "upsampling_steps": 10, "upsampling_noise": 0.4,
    "adapter": "name"                             # optional runtime LoRA
  }
Response: {"images": [<b64 PNG>, ...], "latency_s": float, "id": str}.
Errors: 400 for a client error (a malformed request, an unknown adapter),
404 for another path, 429 when saturated, 504 after result_timeout_s.

ThreadingHTTPServer gives each connection a handler thread; the handlers
wait on the server's futures, whose pool bounds the queries on the card
(max_inflight).
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np
from PIL import Image

from .orchestrator import PipelinedServer


def _b64_to_image(b64) -> Image.Image:
    """Decode one grid cell; any malformed payload is a client error."""
    try:
        return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    except Exception as e:
        raise ValueError(f"invalid image cell (base64 PNG expected): {e}") from e


def _image_to_b64(img: Image.Image) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


class _Metrics:
    """Lock-guarded counters + a latency ring buffer for /metrics."""

    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.failures_total = 0
        self.client_errors_total = 0
        self.rejected_total = 0
        self.in_flight = 0
        self._lat = np.zeros(window, np.float64)
        self._n = 0

    def start(self):
        with self._lock:
            self.requests_total += 1
            self.in_flight += 1

    def done(self, latency_s: float, ok: bool, client_err: bool = False):
        with self._lock:
            self.in_flight -= 1
            if client_err:
                self.client_errors_total += 1  # 400s are not server failures
            elif not ok:
                self.failures_total += 1
            else:
                self._lat[self._n % len(self._lat)] = latency_s
                self._n += 1

    def rejected(self):
        with self._lock:
            self.rejected_total += 1

    def render(self, queue_depth: int) -> str:
        with self._lock:
            lat = self._lat[: min(self._n, len(self._lat))]
            q50, q95 = (
                (float(np.quantile(lat, 0.5)), float(np.quantile(lat, 0.95)))
                if lat.size else (0.0, 0.0)
            )
            lines = [
                "# TYPE visualcloze_requests_total counter",
                f"visualcloze_requests_total {self.requests_total}",
                "# TYPE visualcloze_failures_total counter",
                f"visualcloze_failures_total {self.failures_total}",
                "# TYPE visualcloze_client_errors_total counter",
                f"visualcloze_client_errors_total {self.client_errors_total}",
                "# TYPE visualcloze_rejected_total counter",
                f"visualcloze_rejected_total {self.rejected_total}",
                "# TYPE visualcloze_in_flight gauge",
                f"visualcloze_in_flight {self.in_flight}",
                "# TYPE visualcloze_queue_depth gauge",
                f"visualcloze_queue_depth {queue_depth}",
                "# TYPE visualcloze_latency_seconds summary",
                f'visualcloze_latency_seconds{{quantile="0.5"}} {q50:.6f}',
                f'visualcloze_latency_seconds{{quantile="0.95"}} {q95:.6f}',
            ]
        return "\n".join(lines) + "\n"


class ServingFrontend:
    """Bounded-admission HTTP frontend over a PipelinedServer (or a
    ReplicaPool). max_queue counts the requests waiting beyond max_inflight:
    max_inflight + max_queue are admitted at once."""

    def __init__(self, server: PipelinedServer, max_queue: int = 8,
                 max_inflight: int = 1, result_timeout_s: float | None = 900.0):
        self.server = server
        self.max_queue = max_queue
        # Bound on one query's wait (queue + denoise). Without it a wedged
        # backend call pins its handler thread and its admission slot for
        # good, and after max_inflight + max_queue of them every request
        # gets 429 while /healthz stays green. On timeout the client gets 504
        # and the slot is released; the backend future is left to finish or
        # fail on its own (a ReplicaPool still counts it). None: no bound.
        self.result_timeout_s = result_timeout_s
        self.metrics = _Metrics()
        self._admit = threading.Semaphore(max_inflight + max_queue)
        self._depth_lock = threading.Lock()
        self._depth = 0

    @property
    def queue_depth(self) -> int:
        with self._depth_lock:
            return self._depth

    def handle_generate(self, body: dict[str, Any]) -> dict[str, Any]:
        """Validate + run one query; raises ValueError on bad requests."""
        rows = body.get("images")
        prompts = body.get("prompts")
        if not isinstance(rows, list) or not rows or not isinstance(prompts, list):
            raise ValueError("'images' (grid rows) and 'prompts' are required")
        if not all(isinstance(r, list) and r for r in rows):
            raise ValueError("'images' must be a list of non-empty row lists")
        widths = {len(r) for r in rows}
        if len(widths) != 1:
            raise ValueError("ragged grid: all rows must have equal length")
        grid = [
            [None if c is None else _b64_to_image(c) for c in row] for row in rows
        ]
        gs = body.get("grid_size")
        if gs is not None and (not isinstance(gs, (list, tuple)) or len(gs) != 2):
            raise ValueError("'grid_size' must be a [h, w] pair")
        try:  # malformed scalars (e.g. "seed": null) are client errors, not 500s
            gh, gw = (int(gs[0]), int(gs[1])) if gs is not None else (
                len(grid), len(grid[0]))
            kwargs = dict(
                grid_size=(gh, gw),
                seed=int(body.get("seed", 0)),
                cfg=float(body.get("cfg", 30.0)),
                steps=int(body.get("steps", 30)),
                upsampling_steps=int(body.get("upsampling_steps", 10)),
                upsampling_noise=float(body.get("upsampling_noise", 0.4)),
                is_upsampling=bool(body.get("upsampling", True)),
                adapter=body.get("adapter"),
            )
        except TypeError as e:
            raise ValueError(f"bad request parameter: {e}") from e
        if (gh, gw) != (len(grid), len(grid[0])):
            raise ValueError(f"grid_size {(gh, gw)} != images shape")
        fut = self.server.submit(grid, [str(p) for p in prompts], **kwargs)
        images = fut.result(timeout=self.result_timeout_s)
        return {"images": [_image_to_b64(im) for im in images]}

    # ----------------------------- HTTP plumbing -----------------------------

    def make_handler(self):
        fe = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: str, ctype="application/json"):
                data = payload.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    payload = {"ok": True, "queue_depth": fe.queue_depth}
                    health = getattr(fe.server, "health", None)
                    if callable(health):  # ReplicaPool reports per-replica
                        replicas = health()
                        payload["replicas"] = replicas
                        payload["ok"] = any(r["healthy"] for r in replicas)
                    self._send(200, json.dumps(payload))
                elif self.path == "/metrics":
                    self._send(200, fe.metrics.render(fe.queue_depth),
                               ctype="text/plain; version=0.0.4")
                else:
                    self._send(404, json.dumps({"error": "not found"}))

            def do_POST(self):
                if self.path != "/v1/generate":
                    self._send(404, json.dumps({"error": "not found"}))
                    return
                if not fe._admit.acquire(blocking=False):
                    fe.metrics.rejected()
                    self._send(429, json.dumps({"error": "server saturated"}))
                    return
                with fe._depth_lock:
                    fe._depth += 1
                fe.metrics.start()
                t0 = time.perf_counter()
                ok = client_err = False
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    out = fe.handle_generate(body)
                    out["latency_s"] = round(time.perf_counter() - t0, 4)
                    out["id"] = uuid.uuid4().hex[:12]
                    ok = True
                    code, payload = 200, out
                except (ValueError, json.JSONDecodeError) as e:
                    client_err = True
                    code, payload = 400, {"error": str(e)}
                except TimeoutError:  # fut.result(result_timeout_s)
                    code, payload = 504, {"error": f"backend timeout: query exceeded {fe.result_timeout_s}s"}
                except Exception as e:  # pragma: no cover - defensive
                    code, payload = 500, {"error": f"{type(e).__name__}: {e}"}
                finally:
                    # counted before the answer leaves, so that a client that
                    # has its answer finds it in /metrics and the queue depth
                    fe.metrics.done(time.perf_counter() - t0, ok, client_err)
                    with fe._depth_lock:
                        fe._depth -= 1
                    fe._admit.release()
                self._send(code, json.dumps(payload))

        return Handler

    def serve(self, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        return httpd


def run_frontend(
    server,
    host: str = "0.0.0.0",
    port: int = 8000,
    max_inflight: int = 1,
    max_queue: int = 8,
    block: bool = True,
    result_timeout_s: float | None = 900.0,
):
    """HTTP frontend over any submit/close server (PipelinedServer or
    ReplicaPool). block=False returns (httpd, frontend) with a daemon thread
    serving (tests and embedding); block=True serves until SIGTERM or
    SIGINT, then drains the queries in flight."""
    fe = ServingFrontend(server, max_queue=max_queue, max_inflight=max_inflight,
                         result_timeout_s=result_timeout_s)
    httpd = fe.serve(host, port)
    if block:  # pragma: no cover - interactive path
        import signal as _signal

        def _stop(signum, frame):
            del frame
            print(f"signal {signum}: draining in-flight queries and stopping")
            threading.Thread(target=httpd.shutdown, daemon=True).start()

        try:
            _signal.signal(_signal.SIGTERM, _stop)
            _signal.signal(_signal.SIGINT, _stop)
        except ValueError:
            pass  # not the main thread
        try:
            httpd.serve_forever()
        finally:
            server.close()  # waits for in-flight futures (pool shutdown)
        return None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, fe


def run_server(
    model,
    host: str = "0.0.0.0",
    port: int = 8000,
    encoder_device=None,
    dit_device=None,
    max_inflight: int = 1,
    max_queue: int = 8,
    block: bool = True,
    result_timeout_s: float | None = 900.0,
):
    """A VisualClozeModel behind a PipelinedServer and the HTTP frontend.
    encoder_device, dit_device: PipelinedServer's placement (the encoders and
    the DiT on two cards), None to keep the model's."""
    ps = PipelinedServer(
        model, encoder_device=encoder_device, dit_device=dit_device,
        max_inflight=max_inflight,
    )
    return run_frontend(
        ps, host=host, port=port, max_inflight=max_inflight,
        max_queue=max_queue, block=block, result_timeout_s=result_timeout_s,
    )
