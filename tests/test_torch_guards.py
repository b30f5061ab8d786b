"""Guards of the port: it imports without CUDA or triton, its entry points
refuse to run without a GPU unless the caller asks for the CPU, and no file of
it (nor chip_smoke.py) imports JAX or the JAX package."""

import ast
import importlib
import pkgutil
import sys
from pathlib import Path

import pytest
import torch

import visualcloze_tpu_torch
from visualcloze_tpu_torch import ops
from visualcloze_tpu_torch.device import resolve_device
from visualcloze_tpu_torch.pipeline import random_components

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "visualcloze_tpu_torch"


def test_every_module_imports_without_cuda_or_triton():
    names = [m.name for m in pkgutil.walk_packages(visualcloze_tpu_torch.__path__, "visualcloze_tpu_torch.")]
    assert len(names) >= 20, names
    for name in names:
        importlib.import_module(name)
    assert "triton" not in sys.modules or sys.modules["triton"] is None or torch.cuda.is_available()


def test_cuda_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_components(tiny=True)
    assert resolve_device("cpu").type == "cpu"


def test_cpu_path_runs_the_plain_versions_and_counts_no_launch():
    ops.reset_kernel_launches()
    q = torch.randn(1, 1, 16, 512)
    ops.flash_attn_d512(q, q, q)
    x = torch.randn(1, 4, 4, 8)
    ops.conv3x3_gn_swish(x, torch.randn(3, 3, 8, 8), torch.zeros(8), act="none")
    assert ops.kernel_launches() == {"flash_attn_rope": 0, "flash_attn_d512": 0, "conv3x3_gn_swish": 0}


def _imports(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module)
    return found


def test_port_imports_nothing_of_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "visualcloze_tpu", "flax"), (path, mod)
        text = path.read_text()
        assert "import jax" not in text and "visualcloze_tpu." not in text.replace(
            "visualcloze_tpu/", ""), path


def test_inference_cli_sizes_the_model_by_device(tmp_path, monkeypatch):
    from PIL import Image

    from visualcloze_tpu_torch import inference

    out = tmp_path / "demo.jpg"
    inference.main(["--demo", "--device", "cpu", "--steps", "2", "--no_upsampling", "-o", str(out)])
    assert Image.open(out).size == (64, 64)  # the tiny fp32 model at resolution 64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no --device: the card, full width
        inference.main(["--demo", "-o", str(out)])


def test_profile_step_classes_kernels_by_demangled_name():
    from visualcloze_tpu_torch.profile_step import kernel_class

    assert kernel_class("(anonymous namespace)::flash_fwd(__nv_bfloat16 const*, int)") == "attention (kernel A)"
    assert kernel_class("(anonymous namespace)::rope_rotate(__nv_bfloat16 const*)") == "attention (kernel A)"
    assert kernel_class("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN") == "gemm (linears)"
    assert kernel_class("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)") == "other"
