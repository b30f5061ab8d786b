"""The port's serving stack on the CPU at the tiny configs: the pipelined
server (pipeline/orchestrator.PipelinedServer) against sequential
process_images, bit for bit; ReplicaPool's failover (the cases of
tests/test_replica_failover.py, on the port's pool); the HTTP frontend
(pipeline/server.py, the cases of tests/test_server.py); the serve CLI as a
subprocess; and the Gradio app against a stub gradio and without one."""

import base64
import io
import json
import os
import socket
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from PIL import Image

from visualcloze_tpu_torch.models.lora import init_lora, randomize_lora_b
from visualcloze_tpu_torch.pipeline import PipelinedServer, ReplicaPool, random_components
from visualcloze_tpu_torch.pipeline.server import run_frontend, run_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny model's ops are too small to split across threads: under
    several test workers on a few cores, torch's intra-op threads only wait
    on each other (10-100x slower). One thread here, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _img(seed, size=64):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def model():
    m = random_components(tiny=True, device="cpu", resolution=64)
    m.add_adapter("task", randomize_lora_b(init_lora(m.flux, 4, generator=torch.Generator().manual_seed(1)),
                                           torch.Generator().manual_seed(2)))
    return m


# ----------------------------- PipelinedServer -----------------------------


QUERIES = [
    # (grid, prompts, grid_size, seed, adapter)
    ([[_img(1), _img(2)], [_img(3), None]], ["a 2x2 grid", "task", "The content of the last image is: x"], (2, 2),
     5, None),
    ([[_img(4), None]], ["a 1x2 grid", "task", "y"], (1, 2), 6, "task"),
]


@pytest.mark.parametrize("upsampling", [False, True])
def test_pipelined_server_equals_sequential_process_images(model, upsampling):
    """Two queries of different grids (one with an adapter) at once through
    two workers give sequential process_images' images bit for bit."""
    kw = dict(steps=2, upsampling_steps=2, is_upsampling=upsampling)
    want = [model.process_images(g, p, seed=s, adapter=a, grid_size=gs, **kw) for g, p, gs, s, a in QUERIES]
    with PipelinedServer(model, max_inflight=2) as srv:
        futures = [srv.submit(g, p, grid_size=gs, seed=s, adapter=a, **kw) for g, p, gs, s, a in QUERIES]
        got = [f.result(timeout=300) for f in futures]
    assert (model.grid_h, model.grid_w) == (None, None)  # the server never set the model's grid
    for w, g in zip(want, got):
        assert len(w) == len(g) == 1 and w[0].size == g[0].size
        np.testing.assert_array_equal(np.asarray(w[0]), np.asarray(g[0]))


def test_pipelined_server_keeps_each_querys_records(model):
    q1 = model.prepare_query(*QUERIES[0][:2], seed=1, steps=2, grid_size=(2, 2))
    q2 = model.prepare_query(*QUERIES[1][:2], seed=1, steps=2, grid_size=(1, 2), adapter="task")
    model.denoise_query(q2)
    assert set(q1["stage_seconds"]) == {"preprocess", "vae_encode", "text_encode"}
    assert "denoise" in q2["stage_seconds"] and "denoise" not in q1["stage_seconds"]
    assert q1["adapter"] is None and q2["adapter"] == "task"


@pytest.mark.parametrize("kw", [{"encoder_device": "meta"}, {"dit_device": "meta"},
                                {"encoder_device": "cpu", "dit_device": "meta"}])
def test_pipelined_server_refuses_another_device_by_roadmap_item(kw):
    """The disaggregated placement (JAX's two chips): PipelinedServer moves
    the VAE, T5 and CLIP to encoder_device (the model's device follows) and
    the DiT with its runtime adapters to dit_device. The meta device stands
    in for a second card; the model is a fresh tiny one."""
    from visualcloze_tpu_torch.models.lora import init_lora, tree_leaves

    m = random_components(tiny=True, device="cpu", resolution=64)
    m.add_adapter("a", init_lora(m.flux, 2, generator=torch.Generator().manual_seed(0)))
    with PipelinedServer(m, **kw) as ps:
        enc, dit = kw.get("encoder_device"), kw.get("dit_device")
        enc_type = "meta" if enc == "meta" else "cpu"
        assert m.device.type == enc_type
        for mod in (m.ae, m.t5.model, m.clip.model):
            assert all(p.device.type == enc_type for p in mod.parameters())
        dit_type = "meta" if dit == "meta" else "cpu"
        assert all(p.device.type == dit_type for p in m.flux.parameters())
        assert all(t.device.type == dit_type for t in tree_leaves(m.adapters["a"]))
        assert (ps.dit_device is not None) == (dit == "meta") and m.dit_device == ps.dit_device


# ----------------------------- ReplicaPool -----------------------------


class FakeReplica:
    """submit() resolves at once: a value when healthy, an exception when failing."""

    def __init__(self, name: str, failing: bool = False):
        self.name = name
        self.failing = failing
        self.calls = 0
        self.closed = False

    def submit(self, *args, **kwargs) -> Future:
        self.calls += 1
        fut: Future = Future()
        if self.failing:
            fut.set_exception(RuntimeError(f"{self.name} crashed"))
        else:
            fut.set_result(f"{self.name}:{args[0] if args else ''}")
        return fut

    def close(self) -> None:
        self.closed = True


class ValueErrorReplica(FakeReplica):
    def submit(self, *args, **kwargs) -> Future:
        self.calls += 1
        fut: Future = Future()
        fut.set_exception(ValueError("unknown adapter 'x'"))
        return fut


class RaisingReplica(FakeReplica):
    """submit() raises itself, as a shut-down executor does."""

    def submit(self, *args, **kwargs) -> Future:
        self.calls += 1
        raise RuntimeError(f"{self.name}: cannot schedule new futures after shutdown")


def test_failover_retries_on_a_healthy_replica():
    bad, good = FakeReplica("bad", failing=True), FakeReplica("good")
    pool = ReplicaPool([bad, good])
    assert pool.submit("q").result(timeout=5) == "good:q"
    assert bad.calls == 1 and good.calls == 1
    health = pool.health()
    assert health[0]["consecutive_failures"] == 1
    assert health[1] == {"in_flight": 0, "consecutive_failures": 0, "healthy": True}


def test_unhealthy_replica_leaves_the_dispatch_set():
    bad, good = FakeReplica("bad", failing=True), FakeReplica("good")
    pool = ReplicaPool([bad, good], unhealthy_after=3)
    for _ in range(3):
        pool.submit("q").result(timeout=5)
    assert not pool.health()[0]["healthy"]
    bad_calls = bad.calls
    for _ in range(4):
        assert pool.submit("q").result(timeout=5) == "good:q"
    assert bad.calls == bad_calls


def test_recovery_resets_failures():
    flaky, other = FakeReplica("flaky", failing=True), FakeReplica("other", failing=True)
    pool = ReplicaPool([flaky, other], unhealthy_after=2)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            pool.submit("q").result(timeout=5)
    assert [h["healthy"] for h in pool.health()] == [False, False]
    flaky.failing = False  # all unhealthy: still tried, as the recovery probe
    assert pool.submit("q").result(timeout=5).startswith("flaky:")
    assert pool.health()[0] == {"in_flight": 0, "consecutive_failures": 0, "healthy": True}


def test_all_replicas_failing_raises_the_last_error():
    a, b = FakeReplica("a", failing=True), FakeReplica("b", failing=True)
    pool = ReplicaPool([a, b])
    with pytest.raises(RuntimeError, match="crashed"):
        pool.submit("q").result(timeout=5)
    assert a.calls == 1 and b.calls == 1


def test_close_closes_every_replica():
    rs = [FakeReplica("a"), FakeReplica("b")]
    with ReplicaPool(rs) as pool:
        pool.submit("q").result(timeout=5)
    assert all(r.closed for r in rs)
    with pytest.raises(ValueError, match="at least one"):
        ReplicaPool([])


def test_client_errors_neither_fail_over_nor_count():
    a, b = ValueErrorReplica("a"), FakeReplica("b")
    pool = ReplicaPool([a, b])
    for _ in range(5):
        with pytest.raises(ValueError, match="unknown adapter"):
            pool.submit("q").result(timeout=5)
    assert b.calls == 0
    assert all(h["healthy"] and h["consecutive_failures"] == 0 for h in pool.health())


def test_a_raising_submit_fails_over_and_releases_its_slot():
    dead, good = RaisingReplica("dead"), FakeReplica("good")
    pool = ReplicaPool([dead, good])
    assert pool.submit("q").result(timeout=5) == "good:q"
    assert dead.calls == 1 and good.calls == 1
    h = pool.health()
    assert h[0]["in_flight"] == 0 and h[0]["consecutive_failures"] == 1


def test_a_raising_submit_on_every_replica_resolves_the_future():
    a, b = RaisingReplica("a"), RaisingReplica("b")
    pool = ReplicaPool([a, b])
    with pytest.raises(RuntimeError, match="shutdown"):
        pool.submit("q").result(timeout=5)
    assert all(h["in_flight"] == 0 for h in pool.health())


# ----------------------------- the HTTP frontend -----------------------------


def _b64(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, body, path="/v1/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.status, r.read().decode()


@pytest.fixture(scope="module")
def endpoint(model):
    httpd, fe = run_server(model, host="127.0.0.1", port=0, block=False)
    yield f"http://127.0.0.1:{httpd.server_address[1]}", fe
    httpd.shutdown()
    fe.server.close()


def test_healthz(endpoint):
    url, _ = endpoint
    status, text = _get(url, "/healthz")
    assert status == 200 and json.loads(text) == {"ok": True, "queue_depth": 0}


def test_generate_round_trip_with_an_adapter_and_metrics(endpoint, model):
    """The answer is process_images' image bit for bit (PNG is lossless)."""
    url, _ = endpoint
    grid, prompts, _, seed, _ = QUERIES[0]
    body = {"images": [[None if c is None else _b64(c) for c in row] for row in grid], "prompts": prompts,
            "seed": seed, "cfg": 4.0, "steps": 2, "upsampling": False, "adapter": "task"}
    status, out = _post(url, body)
    assert status == 200, out
    assert len(out["images"]) == 1 and out["latency_s"] > 0 and len(out["id"]) == 12
    got = Image.open(io.BytesIO(base64.b64decode(out["images"][0])))
    want = model.process_images(grid, prompts, seed=seed, cfg=4.0, steps=2, is_upsampling=False, adapter="task",
                                grid_size=(2, 2))[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    _, text = _get(url, "/metrics")
    assert "visualcloze_requests_total 1" in text and "visualcloze_failures_total 0" in text
    assert 'visualcloze_latency_seconds{quantile="0.5"}' in text and "visualcloze_queue_depth 0" in text


def test_generate_client_errors_are_400s(endpoint):
    url, fe = endpoint
    fails = fe.metrics.failures_total
    cell = _b64(_img(0))
    cases = [
        ({"prompts": ["a"]}, "images"),
        ({"images": [[cell], [cell, None]], "prompts": ["a", "b", "c"]}, "ragged"),
        ({"images": [[cell, None]], "prompts": ["a", "b", "c"], "grid_size": [2, 2]}, "grid_size"),
        ({"images": [[cell, None]], "prompts": ["a", "b", "c"], "grid_size": 2}, "grid_size"),
        ({"images": [[cell, None]], "prompts": ["a", "b", "c"], "seed": None}, "parameter"),
        ({"images": [["!!notbase64", None]], "prompts": ["a", "b", "c"]}, "invalid image cell"),
        ({"images": ["abc"], "prompts": ["a", "b", "c"]}, "row lists"),
        ({"images": [[cell, None]], "prompts": ["a", "b", "c"], "steps": 2, "adapter": "nope"}, "unknown adapter"),
    ]
    for body, words in cases:
        status, out = _post(url, body)
        assert status == 400 and words in out["error"], (body, out)
    assert fe.metrics.failures_total == fails
    assert fe.metrics.client_errors_total >= len(cases)


def test_unknown_paths_are_404s(endpoint):
    url, _ = endpoint
    assert _post(url, {}, path="/v1/nope")[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404


class WedgedServer:
    def __init__(self):
        self.futures = []

    def submit(self, *a, **k):
        self.futures.append(Future())  # never resolves
        return self.futures[-1]

    def close(self):
        pass


def test_a_wedged_backend_gives_504_and_releases_its_slot():
    httpd, fe = run_frontend(WedgedServer(), host="127.0.0.1", port=0, block=False, result_timeout_s=0.3)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        status, out = _post(url, {"images": [[None]], "prompts": ["a", "b", "c"]})
        assert status == 504 and "timeout" in out["error"]
        assert fe.metrics.failures_total == 1 and fe.queue_depth == 0
    finally:
        httpd.shutdown()


def test_requests_beyond_the_admission_bound_get_429():
    """max_inflight + max_queue = 1 request admitted; the next one is refused
    while the first waits on a backend that has not answered."""
    import threading

    backend = WedgedServer()
    httpd, fe = run_frontend(backend, host="127.0.0.1", port=0, block=False, max_inflight=1, max_queue=0,
                             result_timeout_s=5.0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        first = {}
        t = threading.Thread(target=lambda: first.update(r=_post(url, {"images": [[None]], "prompts": ["a"]})))
        t.start()
        deadline = time.time() + 5
        while not backend.futures and time.time() < deadline:
            time.sleep(0.01)
        status, out = _post(url, {"images": [[None]], "prompts": ["a"]})
        assert status == 429 and "saturated" in out["error"]
        backend.futures[0].set_result([_img(0)])
        t.join(10)
        assert first["r"][0] == 200
        _, text = _get(url, "/metrics")
        assert "visualcloze_rejected_total 1" in text
    finally:
        httpd.shutdown()


def test_healthz_reports_each_replica_of_a_pool():
    pool = ReplicaPool([FakeReplica("a", failing=True), FakeReplica("b")], unhealthy_after=1)
    pool.submit("q").result(timeout=5)
    httpd, _ = run_frontend(pool, host="127.0.0.1", port=0, block=False)
    try:
        status, text = _get(f"http://127.0.0.1:{httpd.server_address[1]}", "/healthz")
        body = json.loads(text)
        assert status == 200 and body["ok"] is True
        assert [r["healthy"] for r in body["replicas"]] == [False, True]
    finally:
        httpd.shutdown()


# ----------------------------- the serve CLI -----------------------------


def test_serve_cli_serves_a_demo_with_an_adapter_on_the_cpu(tmp_path):
    """python -m visualcloze_tpu_torch.serve --demo --device cpu: boots with
    a random adapter and the grid and SDEdit warmups, answers /healthz and a
    /v1/generate round trip with the adapter, stops on SIGTERM."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(tmp_path / "serve.log", "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "visualcloze_tpu_torch.serve", "--demo", "--device", "cpu", "--port", str(port),
         "--host", "127.0.0.1", "--warmup_grids", "1x2", "--warmup_upsampling", "96x96", "--lora", "a=random",
         "--aot_dir", str(tmp_path / "kernels"), "--replicas", "2"],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
    )
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 240
        while True:
            assert child.poll() is None, (tmp_path / "serve.log").read_text()[-3000:]
            try:
                if _get(url, "/healthz")[0] == 200:
                    break
            except (urllib.error.URLError, OSError):
                pass
            assert time.time() < deadline, "serve did not come up"
            time.sleep(0.5)
        _, text = _get(url, "/healthz")
        assert len(json.loads(text)["replicas"]) == 2
        status, out = _post(url, {"images": [[_b64(_img(5)), None]], "prompts": ["warm", "", "a square"],
                                  "grid_size": [1, 2], "seed": 3, "steps": 2, "upsampling": True,
                                  "upsampling_steps": 2, "adapter": "a"})
        assert status == 200, out
        assert Image.open(io.BytesIO(base64.b64decode(out["images"][0]))).size[0] >= 64
    finally:
        child.terminate()
        try:
            child.wait(30)
        except subprocess.TimeoutExpired:
            child.kill()
        log.close()
    assert not (tmp_path / "kernels").exists()  # nothing is built on the CPU


@pytest.mark.parametrize("flags", [pytest.param(["--tp", "2"], id="flags0-ROADMAP item 4"),
                                   pytest.param(["--fsdp", "2"], id="flags1-ROADMAP item 4"),
                                   pytest.param(["--cp", "2"], id="flags2-ROADMAP item 4")])
def test_serve_cli_refuses_multi_card_flags_by_roadmap_item(flags):
    """--tp / --fsdp / --cp shard the served DiT over torchrun's ranks (run on
    two gloo ranks in tests/test_torch_parallel.py); one process that no
    launcher started is told to launch two."""
    from visualcloze_tpu_torch import serve

    with pytest.raises(SystemExit, match="needs 2 ranks, found 1"):
        serve.main(["--demo", "--device", "cpu", *flags])


def test_cli_adapter_specs_refuse_duplicates_and_random_without_demo(model):
    from visualcloze_tpu_torch import inference, serve

    with pytest.raises(SystemExit, match="duplicate"):
        inference.parse_adapters(["foo=a.pth", "foo=b.pth"])
    with pytest.raises(SystemExit, match="NAME=PATH"):
        inference.parse_adapters(["foo"])
    args = serve.parse_args(["--lora", "x=random", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --demo"):
        inference.add_adapters(model, args)


# ----------------------------- the Gradio app -----------------------------


class FakeComponent:
    def __init__(self, kind, **kwargs):
        self.kind = kind
        self.kwargs = kwargs
        self.handlers = {}

    def change(self, fn, inputs, outputs):
        self.handlers.setdefault("change", []).append((fn, inputs, outputs))

    def click(self, fn, inputs, outputs):
        self.handlers.setdefault("click", []).append((fn, inputs, outputs))

    def select(self, fn, inputs, outputs):
        self.handlers.setdefault("select", []).append((fn, inputs, outputs))


class FakeContext:
    def __init__(self, kind, registry, **kwargs):
        self.component = FakeComponent(kind, **kwargs)
        registry.append(self.component)

    def __enter__(self):
        return self.component

    def __exit__(self, *a):
        return False


def make_fake_gradio(registry):
    gr = types.ModuleType("gradio")

    def ctx(kind):
        return lambda *args, **kwargs: FakeContext(kind, registry, args=args, **kwargs)

    def comp(kind):
        def make(*args, **kwargs):
            c = FakeComponent(kind, args=args, **kwargs)
            registry.append(c)
            return c

        return make

    def blocks(**kwargs):
        b = FakeContext("Blocks", registry, **kwargs)
        b.component.launch = lambda **kw: registry.append(FakeComponent("launch", **kw))
        return b

    class SelectData:
        def __init__(self, index=0):
            self.index = index

    gr.Blocks = blocks
    gr.Row, gr.Accordion, gr.Tab = ctx("Row"), ctx("Accordion"), ctx("Tab")
    for kind in ("Markdown", "Slider", "Image", "Textbox", "Number", "Checkbox", "Button", "Gallery"):
        setattr(gr, kind, comp(kind))
    gr.SelectData = SelectData
    gr.update = lambda **kw: kw
    return gr


def test_app_builds_the_ui_and_its_handlers_on_a_stub_gradio(monkeypatch):
    from visualcloze_tpu_torch import app

    registry: list[FakeComponent] = []
    fake_gr = make_fake_gradio(registry)
    monkeypatch.setitem(sys.modules, "gradio", fake_gr)
    app.main(["--demo", "--device", "cpu"])
    kinds = [c.kind for c in registry]
    assert kinds.count("Image") >= 25 + 1 and "launch" in kinds
    galleries = [c for c in registry if c.kind == "Gallery"]
    assert len(galleries) == 16 and all(c.kwargs.get("value") for c in galleries)
    fn, _, _ = galleries[0].handlers["select"][0]
    out = fn(fake_gr.SelectData(index=0))
    assert len(out) == 7 + 25 and out[0] >= 2 and out[1] >= 2 and isinstance(out[2], str) and out[2]
    gen_fn, _, _ = next(c for c in registry if c.kind == "Button").handlers["click"][0]
    images = [None] * 25  # the 5x5 cells, row-major: (0, 0), (0, 1), (1, 0) given, (1, 1) masked
    images[0] = images[1] = images[5] = _img(0)
    out_img = gen_fn(2, 2, *images, "A grid layout with 2 rows and 2 columns.", "task", "content", 0, 30.0, 2, 2,
                     1.0, False)
    assert isinstance(out_img, Image.Image) and out_img.size == (64, 64)


def test_app_galleries_read_the_committed_assets():
    from visualcloze_tpu_torch import app

    entries = app.gallery_entries()
    assert len(entries) == 16, sorted(entries)
    for family, items in entries.items():
        assert len(items) >= 4 and len({ex.prompts[-1] for _, ex in items}) >= 4, family
        for thumb, ex in items:
            assert os.path.exists(thumb), (family, thumb)
            assert all(c is None or os.path.exists(c) for row in ex.rows(context_num=1) for c in row)
    out = app.apply_example_outputs(entries["dense_prediction"][0][1])
    assert out[0] >= 2 and out[1] >= 2 and len(out) == 7 + 25


def test_app_without_gradio_stops_with_a_clear_error(monkeypatch):
    from visualcloze_tpu_torch import app

    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio raises ImportError
    with pytest.raises(SystemExit, match="gradio is not installed"):
        app.main(["--demo", "--device", "cpu"])


def test_launch_counts_survive_concurrent_launches():
    """Server threads launch kernels at once: with a short switch interval,
    16 threads adding 2000 launches each lose no count."""
    import threading

    from visualcloze_tpu_torch import ops
    from visualcloze_tpu_torch.ops import cuda_build

    wrapper = ops.KERNELS["flash_attn_rope"]
    old = sys.getswitchinterval()
    ops.reset_kernel_launches()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=lambda: [cuda_build.count_launch(wrapper) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert ops.kernel_launches()["flash_attn_rope"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        ops.reset_kernel_launches()
