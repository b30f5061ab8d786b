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
    q4 = torch.randn(1, 2, 16, 128, requires_grad=True)
    out = ops.flash_attn_fwd(q4, q4, q4)
    ops.flash_attn_fwd_lse(q4, q4, q4)
    from visualcloze_tpu_torch.ops.flash_attention import flash_mha

    flash_mha(q4, q4, q4).sum().backward()
    assert q4.grad is not None and out.shape == q4.shape
    y = ops.int8_matmul(torch.randn(3, 64), torch.ones(64, 16, dtype=torch.int8), torch.ones(16))
    assert y.shape == (3, 16) and y.dtype == torch.bfloat16
    assert ops.kernel_launches() == {name: 0 for name in ops.KERNELS}
    assert set(ops.KERNELS) == {"flash_attn_rope", "flash_attn_d512", "conv3x3_gn_swish", "flash_attn_fwd",
                                "flash_attn_fwd_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "int8_matmul"}


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
    scanned = {str(f.relative_to(PKG)) for f in files if PKG in f.parents}
    for module in ("training/train.py", "training/step.py", "training/batch.py", "training/checkpoint.py",
                   "data/dataset.py", "data/data_reader.py", "data/degradations.py", "data/loader.py",
                   "transport/transport.py", "models/lora.py", "models/weights.py", "utils/misc.py",
                   "models/quant.py", "ops/int8_matmul.py"):
        assert module in scanned, module
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


def test_inference_cli_serves_the_int8_stack_on_the_cpu(tmp_path):
    """--quantize int8 --t5_int4 on the CPU: the tiny model quantized after the
    fact (int8 DiT through G's plain version, int4 T5), as JAX's --demo; the
    w8a8 modes are refused."""
    from PIL import Image

    from visualcloze_tpu_torch import inference
    from visualcloze_tpu_torch.models.layers import Int8Linear
    from visualcloze_tpu_torch.models.quant import Int4Linear

    out = tmp_path / "int8.jpg"
    argv = ["--demo", "--device", "cpu", "--steps", "2", "--upsampling_steps", "2", "--quantize", "int8",
            "--t5_int4", "-o", str(out)]
    inference.main(argv)
    assert Image.open(out).size == (64, 64)
    model = inference.build_model(inference.parse_args(argv), torch.device("cpu"))
    assert isinstance(model.flux.single_blocks[0].linear1, Int8Linear)
    assert isinstance(model.t5.model.blocks[0].attn.q, Int4Linear)
    for mode in ("w8a8", "w8a8_smooth"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 1"):
            inference.main(["--demo", "--device", "cpu", "--quantize", mode, "-o", str(out)])


def test_profile_step_classes_kernels_by_demangled_name():
    from visualcloze_tpu_torch.profile_step import kernel_class

    assert kernel_class("(anonymous namespace)::flash_fwd(__nv_bfloat16 const*, int)") == "attention (kernel A)"
    assert kernel_class("void (anonymous namespace)::flash_fwd<false>(__nv_bfloat16 const*)") == "attention (kernel A)"
    assert kernel_class("void (anonymous namespace)::flash_fwd<true>(__nv_bfloat16 const*)") == \
        "attention forward (kernel E)"
    assert kernel_class("(anonymous namespace)::flash_bwd_dkv(__nv_bfloat16 const*)") == \
        "attention backward (kernel F)"
    assert kernel_class("(anonymous namespace)::rope_rotate(__nv_bfloat16 const*)") == "attention (kernel A)"
    assert kernel_class("void (anonymous namespace)::int8_matmul_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
                        "signed char const*)") == "int8 matmul (kernel G)"
    assert kernel_class("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN") == "gemm (linears)"
    assert kernel_class("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)") == "other"


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::int8_matmul_wide<__nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, float const*)",
    "void (anonymous namespace)::int8_matmul_wide<float>(CUtensorMap_st, CUtensorMap_st, float const*)",
    "void (anonymous namespace)::int8_gemv<__nv_bfloat16, 1>(__nv_bfloat16 const*, signed char const*)",
    "void (anonymous namespace)::int8_gemv<float, 4>(__nv_bfloat16 const*, signed char const*)",
])
def test_profile_step_classes_both_bodies_of_kernel_g(name):
    from visualcloze_tpu_torch.profile_step import kernel_class

    assert kernel_class(name) == "int8 matmul (kernel G)"


def test_profile_step_classes_vae_kernels_by_demangled_name():
    from visualcloze_tpu_torch.profile_step import vae_class

    assert vae_class("void (anonymous namespace)::conv3x3_kernel<true, true>(CUtensorMap_st, CUtensorMap_st)") == \
        "conv (kernel B)"
    assert vae_class("(anonymous namespace)::flash_d512(CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*)") == \
        "attention (kernel C)"
    assert vae_class("(anonymous namespace)::flash_d512_kernel(__nv_bfloat16 const*)") == "attention (kernel C)"
    assert vae_class("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)") == "other"
    assert vae_class("void at::native::conv_depthwise2d_forward_kernel<float>(float const*)") == "other"


def test_profile_step_vae_mode_refuses_other_modes():
    from visualcloze_tpu_torch.profile_step import main

    for other in (["--train"], ["--quantize", "int8"]):
        with pytest.raises(SystemExit):
            main(["--vae", *other])


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    from visualcloze_tpu_torch.training.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data_path", "unused.yaml", "--tiny", "--init_random"])


@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_fwd_lse", "flash_attn_bwd_dq",
                                  "flash_attn_bwd_dkv", "flash_mha", "int8_matmul", "flash_attn_d512",
                                  "conv3x3_gn_swish"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(name):
    """A tensor that is not on the CPU goes to the kernel path, which refuses
    what it does not take: here a meta tensor, never the plain version."""
    from visualcloze_tpu_torch.ops import flash_attention as fa

    if name == "int8_matmul":
        x = torch.empty((4, 128), device="meta", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            ops.int8_matmul(x, torch.empty((128, 64), device="meta", dtype=torch.int8),
                            torch.empty((64,), device="meta"))
        return
    if name == "conv3x3_gn_swish":
        x = torch.empty((1, 8, 8, 128), device="meta", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            ops.conv3x3_gn_swish(x, torch.empty((3, 3, 128, 128), device="meta", dtype=torch.bfloat16),
                                 torch.empty((128,), device="meta"), act="none")
        return
    if name == "flash_attn_d512":
        q = torch.empty((1, 1, 16, 512), device="meta", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attn_d512(q, q, q)
        return
    q = torch.empty((1, 2, 16, 128), device="meta")
    lse = torch.empty((1, 2, 16), device="meta")
    args = (q, q, q) if name in ("flash_attn_fwd", "flash_attn_fwd_lse", "flash_mha") else (
        q, q, q, None, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fa, name)(*args)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_mha(q, q, q)
