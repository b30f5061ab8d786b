"""A run of a cell, at the tiny widths on the CPU: it is correct, its
control and the faults a served cell can have are caught, it loads nothing
of JAX, and without a card the benchmark refuses to run."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from bench_port import check, run
from bench_port.tests.tiny import tiny_spec

SEED = 2 ** 35 + 21


def _run(workload="bf16.default_query", prepare=None, control=False, seed=SEED):
    return run.run_cell(tiny_spec(workload), seed, 0.1, False, torch.device("cpu"), prepare=prepare,
                        control=control)


@pytest.mark.parametrize("workload", ["bf16.default_query", "w8a8.default_query", "bf16.graph200k_mix"])
def test_a_sound_run_is_correct_and_its_control_is_not(workload):
    res = _run(workload, control=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    limit = res["checks"]["dit_rel_err"]["limit"]
    assert res["control"]["dit_rel_err"] > limit > res["checks"]["dit_rel_err"]["value"]
    assert list(res)[-1] == "checks"


def _state_unchanged(model):
    """Every Euler step hands back the state it was given."""
    import visualcloze_tpu_torch.pipeline.visualcloze as vc

    def frozen(model_fn, x, ts, cond=None, method="euler"):
        velocity = vc._velocity_fn(model_fn, x, cond)
        for t in ts[:-1]:
            velocity(x, t)
        return x

    model.restore = (vc, vc.denoise_ode)
    vc.denoise_ode = frozen


def _steps_skipped(model):
    """The loops integrate over every other point of their grids: half the evaluations, twice the dt."""
    import visualcloze_tpu_torch.pipeline.visualcloze as vc

    orig = vc.denoise_ode
    model.restore = (vc, orig)
    vc.denoise_ode = lambda model_fn, x, ts, cond=None, method="euler": orig(model_fn, x, ts[::2], cond, method)


def _velocity_altered(model):
    fwd = model.flux.forward
    model.flux.forward = lambda **kw: fwd(**kw) * 1.5


def _image_altered(model):
    dec = model.ae.decode
    model.ae.decode = lambda z: dec(z) + 0.25


def _grid_warped(model):
    """The loops' time grids warped by a time-shifting factor of 3, not VisualCloze's 1."""
    model.time_shifting_factor = 3.0


def _cell_mirrored(model):
    """SDEdit refines the query cell mirrored: a wrong crop between the two stages."""
    from PIL import Image

    up = model.upsampling
    model.upsampling = lambda image, *a, **k: up(image.transpose(Image.FLIP_LEFT_RIGHT), *a, **k)


@pytest.mark.parametrize("fault", [_state_unchanged, _steps_skipped, _velocity_altered, _image_altered, _grid_warped,
                                   _cell_mirrored])
def test_a_broken_timed_path_comes_out_not_correct(fault):
    # the served cells run one query at a time on one card: no batch to halve, no exchange between cards
    planted = []

    def prepare(model):
        fault(model)
        planted.append(getattr(model, "restore", None))

    try:
        res = _run(prepare=prepare)
    finally:
        if planted and planted[0] is not None:
            setattr(planted[0][0], "denoise_ode", planted[0][1])
    assert not res["correct"], res["checks"]
    if fault in (_grid_warped, _cell_mirrored):  # code between the checked calls: the hand-offs catch it
        assert res["checks"]["handoff_max_abs"]["value"] > 0, res["checks"]


def test_the_run_loads_nothing_of_jax():
    code = ("import json, torch; from bench_port import run; from bench_port.tests.tiny import tiny_spec; "
            "run.run_cell(tiny_spec(), 5, 0.1, True, torch.device('cpu')); "
            "import bench_port.control; print(json.dumps(run.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, bench_port.check, bench_port.reference.flux, bench_port.reference.vae, "
            "bench_port.reference.text; print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'visualcloze_tpu', 'visualcloze_tpu_torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", "bf16.default_query", "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_on_the_card_the_program_passes_and_the_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs only there")
    with open(run.ROOT / "BENCHMARK.json") as f:
        import json

        spec = run.resolve(json.load(f), "bf16.default_query")
    res = run.run_cell(spec, SEED, 1.0, False, torch.device("cuda", 0), control=True)
    assert res["correct"], res["checks"]
    assert any(res["control"][n] > res["checks"][n]["limit"] for n in check.NUMBERS)
