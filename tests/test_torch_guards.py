"""Guards of the port: it imports without CUDA or triton, its entry points
refuse to run without a GPU unless the caller asks for the CPU, and no file of
it (nor chip_smoke.py) imports JAX, the JAX package or the root examples
package (which imports the JAX package)."""

import ast
import dataclasses
import importlib
import pkgutil
import sys
from pathlib import Path

import numpy as np
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
    codes, scale = ops.act_quant_int8(torch.randn(3, 128))
    assert codes.dtype == torch.int8 and scale.shape == (3,)
    y = ops.w8a8_matmul(codes, torch.ones(16, 128, dtype=torch.int8), scale, torch.ones(16))
    assert y.shape == (3, 16) and y.dtype == torch.bfloat16
    codes, scale = ops.gelu_act_quant(torch.randn(3, 128).to(torch.bfloat16))
    assert codes.dtype == torch.int8 and scale.shape == (3,)
    y = ops.int4_matmul(torch.randn(3, 64), torch.full((32, 16), 0x99, dtype=torch.uint8), torch.ones(1, 16))
    assert y.shape == (3, 16) and y.dtype == torch.bfloat16
    x = torch.randn(2, 5, 64)
    vec = torch.randn(2, 1, 64)
    assert ops.layernorm_modulate(x, vec, vec, torch.bfloat16).dtype == torch.bfloat16
    assert ops.gated_residual(x, vec, x).shape == x.shape
    q, k, v = ops.qk_norm_split(torch.randn(2, 5, 3 * 2 * 16), torch.ones(16), torch.ones(16), 2)
    assert q.shape == k.shape == v.shape == (2, 2, 5, 16)
    assert ops.merge_heads(q, torch.ones(2, 5, dtype=torch.int32), x).shape == (2, 5, 2 * 16 + 64)
    assert ops.layernorm_modulate_quant(x, vec, vec)[0].shape == (2 * 5, 64)
    (c0, s0), (c1, s1) = ops.merge_heads_quant(q, None, None, None, 2)
    assert c0.shape == (2 * 2, 2 * 16) and c1.shape == (2 * 3, 2 * 16) and s1.shape == (2 * 3,)
    assert ops.layernorm_modulate_bwd(x, vec, x)[0].shape == x.shape
    assert ops.gated_residual_bwd(vec, x, x)[1].shape == vec.shape
    qkv = torch.randn(2, 5, 3 * 2 * 16)
    assert ops.qk_norm_split_bwd(qkv, torch.ones(16), torch.ones(16), 2, q, k, v)[0].shape == qkv.shape
    assert ops.merge_heads_bwd(torch.randn(2, 5, 2 * 16 + 64), 2, None, x)[1].shape == x.shape
    x = torch.randn(1, 4, 4, 64)
    a, bb = ops.group_norm_stats(x, torch.ones(64), torch.zeros(64), 32)
    assert ops.group_norm_apply(x, a, bb, "swish").shape == x.shape
    assert ops.KERNELS["group_norm"](x, torch.ones(64), torch.zeros(64), 32, act="swish").shape == x.shape
    assert ops.kernel_launches() == {name: 0 for name in ops.KERNELS}
    assert set(ops.KERNELS) == {"flash_attn_rope", "flash_attn_d512", "conv3x3_gn_swish", "flash_attn_fwd",
                                "flash_attn_fwd_lse", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "int8_matmul",
                                "w8a8_matmul", "act_quant_int8", "gelu_act_quant", "int4_matmul",
                                "layernorm_modulate", "gated_residual", "qk_norm_split", "merge_heads",
                                "layernorm_modulate_quant", "merge_heads_quant", "layernorm_modulate_bwd",
                                "gated_residual_bwd", "qk_norm_split_bwd", "merge_heads_bwd", "group_norm_stats",
                                "group_norm_apply", "group_norm"}


def _imports(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module)
    return found


def test_port_imports_nothing_of_jax():
    """Every module of the port, chip_smoke.py and the multi-rank tests'
    worker (tests/torch_parallel_jobs.py, which must not load JAX on its
    ranks)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_jobs.py"]
    assert len(files) > 20
    scanned = {str(f.relative_to(PKG)) for f in files if PKG in f.parents}
    for module in ("training/train.py", "training/step.py", "training/batch.py", "training/checkpoint.py",
                   "data/dataset.py", "data/data_reader.py", "data/degradations.py", "data/loader.py",
                   "transport/transport.py", "models/lora.py", "models/weights.py", "utils/misc.py",
                   "models/quant.py", "ops/int8_matmul.py", "serve.py", "app.py", "sample.py", "gradio_tasks.py",
                   "pipeline/orchestrator.py", "pipeline/server.py", "pipeline/diffusers_api.py", "utils/metrics.py",
                   "ops/int4_matmul.py", "transport/sampling.py", "models/sampling.py", "models/vision_towers.py",
                   "models/image_embedders.py", "models/postprocess.py", "models/api.py", "ops/ring_attention.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py", "parallel/pipeline.py",
                   "parallel/collectives.py"):
        assert module in scanned, module
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "visualcloze_tpu", "flax", "examples"), (path, mod)
        text = path.read_text()
        assert "import jax" not in text and "visualcloze_tpu." not in text.replace(
            "visualcloze_tpu/", ""), path


def _module_level_imports(path: Path) -> set[str]:
    """Modules imported at import time of `path` (not inside a function)."""
    found = set()

    def visit(stmts):
        for node in stmts:
            if isinstance(node, ast.Import):
                found.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                found.add(node.module)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                visit(node.body)
                visit(getattr(node, "orelse", []))
                visit(getattr(node, "finalbody", []))
                for h in getattr(node, "handlers", []):
                    visit(h.body)

    visit(ast.parse(path.read_text(), filename=str(path)).body)
    return found


def test_port_needs_neither_safetensors_nor_transformers():
    """The card's machine has neither package: the port reads and writes
    safetensors itself, and imports transformers only inside
    load_hf_tokenizer (a local tokenizer directory)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tops = {m.split(".")[0] for m in _module_level_imports(path)}
        assert not tops & {"safetensors", "transformers"}, path
        everywhere = {m.split(".")[0] for m in _imports(path)}
        assert "safetensors" not in everywhere, path
        if "transformers" in everywhere:
            assert path == PKG / "models" / "conditioner.py", path
    tree = ast.parse((PKG / "models" / "conditioner.py").read_text())
    importers = {f.name for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                 and any(isinstance(n, ast.ImportFrom) and n.module == "transformers" for n in ast.walk(f))}
    assert importers == {"load_hf_tokenizer"}


def patch_loader_tiny(mp) -> None:
    """The port's loader reads the published widths, as JAX's does: patch in
    the tiny configs and a FallbackTokenizer over each tiny vocabulary (as
    tests/test_torch_checkpoints.py patches JAX's loader)."""
    from visualcloze_tpu_torch import config
    from visualcloze_tpu_torch.models.conditioner import FallbackTokenizer
    from visualcloze_tpu_torch.pipeline import loader

    flux, ae, t5, clip = loader._configs(True)
    spec = config.configs["flux-dev-fill-lora"]
    mp.setitem(config.configs, "flux-dev-fill-lora", dataclasses.replace(spec, flux=flux))
    mp.setattr(loader, "AutoEncoderConfig", lambda: ae)
    mp.setattr(loader, "T5Config", lambda max_length=512: t5)
    mp.setattr(loader, "CLIPTextConfig", lambda: clip)
    mp.setattr(loader, "default_tokenizer",
               lambda kind, path=None: FallbackTokenizer((t5 if kind == "t5" else clip).vocab_size))


def _write_tiny_checkpoints(root):
    """A tiny random stack written as checkpoint files by chip_smoke's writers
    (BFL DiT, reference LoRA .pth, VAE, T5 and CLIP HF shards) -> (model's
    config, LoRA in the half layout, written)."""
    import chip_smoke
    from visualcloze_tpu_torch.models import weights as W

    model = random_components(tiny=True, device="cpu")
    lora = chip_smoke.random_lora(model.flux, 4, seed=5)
    written = chip_smoke.write_checkpoints(model, lora, root)
    assert written["dit_readback_mismatches"] == 0 and written["dit_readback_tensors"] > 0
    return model, W.permute_rope_layout_lora(lora, model.cfg), written


def test_inference_cli_serves_checkpoint_files_on_the_cpu(tmp_path, monkeypatch):
    """The non-demo CLI on the CPU: tiny files written as the chip smoke test
    writes them at full width, loaded through build_visualcloze (the LoRA
    folded, the DiT permuted to the half layout and checked against its file),
    then one query with --solver heun; a diffusers snapshot of the same DiT
    loads bit for bit."""
    from PIL import Image

    from visualcloze_tpu_torch import inference
    from visualcloze_tpu_torch.models import weights as W
    from visualcloze_tpu_torch.pipeline import build_visualcloze

    monkeypatch.syspath_prepend(str(ROOT))  # chip_smoke.py, at the root of the checkout
    import chip_smoke

    model, lora_half, written = _write_tiny_checkpoints(tmp_path)
    paths = written["paths"]
    for var, key in (("FLUX_DEV_FILL", "dit"), ("AE", "vae"), ("T5_PATH", "t5"), ("CLIP_PATH", "clip")):
        monkeypatch.setenv(var, paths[key])
    patch_loader_tiny(monkeypatch)
    loaded = build_visualcloze(model_path=paths["lora"], dtype=torch.float32, device="cpu")
    check = chip_smoke.check_loaded_dit(loaded.flux, model.cfg,
                                        W.convert_flux(W.load_safetensors(paths["dit"]), model.cfg), lora_half)
    assert check["ok"] and check["exact_tensors"] > 0 and check["folded_tensors"] > 0, check

    cell = tmp_path / "cell.png"
    Image.new("RGB", (64, 64), (120, 180, 90)).save(cell)
    out = tmp_path / "out.jpg"
    inference.main(["--model_path", paths["lora"], "--device", "cpu", "--resolution", "64",
                    "--rows", f"{cell},{cell}", "--rows", f"{cell},MASK", "--steps", "3", "--solver", "heun",
                    "--no_upsampling", "-o", str(out)])
    assert Image.open(out).size == (64, 64)

    snap = chip_smoke.write_snapshot(model.flux, model.cfg, tmp_path)  # model.flux: the reference order now
    loaded = build_visualcloze(model_path=snap["path"], dtype=torch.float32, device="cpu")
    check = chip_smoke.check_loaded_dit(loaded.flux, model.cfg, W.module_state(model.flux))
    assert check["ok"] and check["folded_tensors"] == 0, check


@pytest.mark.parametrize("flags", [pytest.param(["--tp", "2"], id="flags0-4"),
                                   pytest.param(["--fsdp", "2"], id="flags1-4"),
                                   pytest.param(["--cp", "2"], id="flags2-4")])
def test_inference_cli_refuses_unported_flags_by_roadmap_item(flags):
    """The multi-card flags are served (tests/test_torch_parallel.py runs
    them on two gloo ranks); in one process, which no launcher started, the
    CLI asks for torchrun with as many ranks as the mesh needs, before it
    loads anything."""
    from visualcloze_tpu_torch import inference

    with pytest.raises(SystemExit, match="needs 2 ranks, found 1 .*torchrun --nproc_per_node 2"):
        inference.main(["--model_path", "lora.pth", "--device", "cpu", "--rows", "a.png,MASK", *flags])


def test_inference_cli_serves_a_runtime_adapter_on_the_cpu(tmp_path, monkeypatch):
    """--demo --lora a=random --adapter a --lora_scale 0.5: the adapter is
    registered (rank 4, B drawn) at scale 0.5 and the query goes through it;
    the image differs from the one without --adapter."""
    from PIL import Image

    from visualcloze_tpu_torch import inference

    from visualcloze_tpu_torch.pipeline.visualcloze import VisualClozeModel

    used = []

    orig = VisualClozeModel.denoise_query

    def recording(self, q, stage="denoise"):
        used.append((q.get("adapter"), self.lora_scale, sorted(self.adapters)))
        return orig(self, q, stage)

    monkeypatch.setattr(VisualClozeModel, "denoise_query", recording)
    base = ["--demo", "--device", "cpu", "--steps", "2", "--no_upsampling", "--lora", "a=random", "--lora",
            "b=random", "--lora_scale", "0.5"]
    inference.main([*base, "--adapter", "a", "-o", str(tmp_path / "a.jpg")])
    inference.main([*base, "-o", str(tmp_path / "base.jpg")])
    assert used == [("a", 0.5, ["a", "b"]), (None, 0.5, ["a", "b"])]
    a, b = (np.asarray(Image.open(tmp_path / f"{n}.jpg"), np.float32) for n in ("a", "base"))
    assert a.shape == b.shape == (64, 64, 3) and np.abs(a - b).mean() > 0.5


@pytest.mark.parametrize("flags", [["--aot_dir", "DIR"], ["--no_aot"]])
def test_inference_cli_takes_the_kernel_directory_flags(tmp_path, monkeypatch, flags):
    """--aot_dir points the kernel build at DIR (the default is
    $VISUALCLOZE_AOT_DIR, else build/torch_kernels/); --no_aot rebuilds the
    kernels, which on the CPU means nothing: no nvcc runs."""
    from visualcloze_tpu_torch import inference
    from visualcloze_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.DEFAULT_BUILD_DIR)
    monkeypatch.delenv("VISUALCLOZE_AOT_DIR", raising=False)
    ran = []
    monkeypatch.setattr(cuda_build.subprocess, "Popen", lambda *a, **k: ran.append(a))
    flags = [str(tmp_path / "kernels") if f == "DIR" else f for f in flags]
    inference.main(["--demo", "--device", "cpu", "--steps", "2", "--no_upsampling", *flags,
                    "-o", str(tmp_path / "out.jpg")])
    want = tmp_path / "kernels" if "--aot_dir" in flags else cuda_build.DEFAULT_BUILD_DIR
    assert cuda_build.BUILD_DIR == want.resolve() and ran == [] and (tmp_path / "out.jpg").exists()


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_smooth"])
def test_inference_cli_serves_the_w8a8_modes_on_the_cpu(tmp_path, mode):
    """--demo --device cpu --quantize w8a8 | w8a8_smooth: the tiny fp32 model
    with its DiT quantized after the fact (w8a8_smooth calibrated first, 4
    steps, statistics every 2nd, as the JAX CLI's demo), served through the
    plain versions of kernels I, H and G; the image is written."""
    from PIL import Image

    from visualcloze_tpu_torch import inference
    from visualcloze_tpu_torch.models.layers import Int8Linear, W8A8Linear

    out = tmp_path / f"{mode}.jpg"
    argv = ["--demo", "--device", "cpu", "--steps", "2", "--upsampling_steps", "2", "--quantize", mode,
            "-o", str(out)]
    inference.main(argv)
    assert Image.open(out).size == (64, 64)
    model = inference.build_model(inference.parse_args(argv), torch.device("cpu"))
    lin = model.flux.single_blocks[0].linear1
    assert isinstance(lin, W8A8Linear) and (lin.a_sinv is not None) == (mode == "w8a8_smooth")
    assert isinstance(model.flux.single_blocks[0].modulation.lin, Int8Linear)


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
    fact (int8 DiT through G's plain version, int4 T5), as JAX's --demo."""
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


def test_profile_step_classes_kernels_by_demangled_name():
    from visualcloze_tpu_torch.profile_step import kernel_class

    assert kernel_class("(anonymous namespace)::flash_fwd(__nv_bfloat16 const*, int)") == \
        "attention (kernel A or D)"
    assert kernel_class("void (anonymous namespace)::flash_fwd<false>(__nv_bfloat16 const*)") == \
        "attention (kernel A or D)"
    assert kernel_class("void (anonymous namespace)::flash_fwd<true>(__nv_bfloat16 const*)") == \
        "attention forward (kernel E)"
    assert kernel_class("(anonymous namespace)::flash_bwd_dkv(__nv_bfloat16 const*)") == \
        "attention backward (kernel F)"
    assert kernel_class("(anonymous namespace)::rope_rotate(__nv_bfloat16 const*)") == "rotation pass (kernel A)"
    assert kernel_class("void (anonymous namespace)::int8_matmul_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
                        "signed char const*)") == "int8 matmul (kernel G)"
    assert kernel_class("(anonymous namespace)::w8a8_matmul_kernel(CUtensorMap, CUtensorMap, float const*)") == \
        "w8a8 matmul (kernel H)"
    assert kernel_class("void (anonymous namespace)::act_quant_kernel<__nv_bfloat16>(__nv_bfloat16 const*)") == \
        "activation quantize (kernel I)"
    assert kernel_class("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN") == "gemm (linears)"
    assert kernel_class("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)") == "other"


@pytest.mark.parametrize("name, cls", [
    ("void (anonymous namespace)::ln_modulate_kernel<__nv_bfloat16>(__nv_bfloat16 const*, long long, long long, "
     "float const*, long long, float const*, long long, __nv_bfloat16*, int, int)", "layernorm modulate (kernel J)"),
    ("void (anonymous namespace)::ln_modulate_kernel<float>(__nv_bfloat16 const*, long long, long long, "
     "float const*, long long, float const*, long long, float*, int, int)", "layernorm modulate (kernel J)"),
    ("(anonymous namespace)::gated_residual_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
     "long long, __nv_bfloat16*, int, int)", "gated residual (kernel K)"),
    ("(anonymous namespace)::qk_norm_split_kernel(__nv_bfloat16 const*, long long, long long, __nv_bfloat16 const*)",
     "head split + q/k norm (kernel L)"),
    ("(anonymous namespace)::merge_heads_kernel(__nv_bfloat16 const*, int const*, __nv_bfloat16 const*)",
     "head merge + gelu (kernel M)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>(int)", "other"),
    ("void (anonymous namespace)::ln_modulate_quant_kernel<true>(__nv_bfloat16 const*, long long, long long, "
     "float const*, long long, float const*, long long, float const*, signed char*, float*, int, int)",
     "layernorm modulate + quantize (kernel J, codes)"),
    ("(anonymous namespace)::merge_heads_quant_kernel(__nv_bfloat16 const*, int const*, __nv_bfloat16 const*, "
     "long long, long long, int, int, int, int, int, float const*, signed char*, float*)",
     "head merge + quantize (kernel M, codes)"),
    ("void (anonymous namespace)::merge_heads_quant_kernel<4>(__nv_bfloat16 const*, int const*, "
     "__nv_bfloat16 const*, long long, long long, int, int, int, int, int, int, float const*, signed char*, float*, "
     "float const*, signed char*, float*)", "head merge + quantize (kernel M, codes)"),
    ("void (anonymous namespace)::ln_modulate_quant_kernel<false, 128>(__nv_bfloat16 const*, long long, long long, "
     "float const*, long long, float const*, long long, float const*, signed char*, float*, int, int, int)",
     "layernorm modulate + quantize (kernel J, codes)"),
    ("(anonymous namespace)::gelu_act_quant_kernel(__nv_bfloat16 const*, float const*, signed char*, float*, int)",
     "gelu + quantize (kernel O)"),
])
def test_profile_step_classes_the_block_fusions_by_demangled_name(name, cls):
    from visualcloze_tpu_torch.profile_step import kernel_class

    assert kernel_class(name) == cls


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::int8_matmul_wide<__nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, float const*)",
    "void (anonymous namespace)::int8_matmul_wide<float>(CUtensorMap_st, CUtensorMap_st, float const*)",
    "void vc::wide::matmul_wide<(anonymous namespace)::Int8Convert, __nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, "
    "float const*, __nv_bfloat16*, int, int, int, int, int, unsigned int)",
    "void vc::wide::matmul_wide<(anonymous namespace)::Int8Convert, float>(CUtensorMap_st, CUtensorMap_st, "
    "float const*, float*, int, int, int, int, int, unsigned int)",
    "void (anonymous namespace)::int8_gemv<__nv_bfloat16, 1>(__nv_bfloat16 const*, signed char const*)",
    "void (anonymous namespace)::int8_gemv<float, 4>(__nv_bfloat16 const*, signed char const*)",
    "void vc::wide::matmul_wide<(anonymous namespace)::Int8Convert<2>, __nv_bfloat16>(CUtensorMap_st, "
    "CUtensorMap_st, float const*, __nv_bfloat16*, int, int, int, int, int, unsigned int)",
    "void vc::wide::matmul_wide<(anonymous namespace)::Int8Convert<1>, float>(CUtensorMap_st, CUtensorMap_st, "
    "float const*, float*, int, int, int, int, int, unsigned int)",
])
def test_profile_step_classes_both_bodies_of_kernel_g(name):
    from visualcloze_tpu_torch.profile_step import kernel_class

    assert kernel_class(name) == "int8 matmul (kernel G)"


@pytest.mark.parametrize("name", [
    "void vc::wide::matmul_wide<(anonymous namespace)::Int4Convert, __nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, "
    "float const*, __nv_bfloat16*, int, int, int, int, int, unsigned int)",
    "void (anonymous namespace)::int4_gemv<float, 4>(__nv_bfloat16 const*, unsigned char const*)",
])
def test_profile_step_classes_both_bodies_of_kernel_g4(name):
    from visualcloze_tpu_torch.profile_step import kernel_class

    assert kernel_class(name) == "int4 matmul (kernel G4)"


@pytest.mark.parametrize("name", [
    "(anonymous namespace)::w8a8_matmul_kernel(CUtensorMap, CUtensorMap, float const*)",
    "void (anonymous namespace)::w8a8_matmul_kernel<256>(CUtensorMap_st, CUtensorMap_st, float const*, "
    "float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, unsigned int, unsigned int)",
    "void (anonymous namespace)::w8a8_matmul_kernel<128>(CUtensorMap_st, CUtensorMap_st, float const*)",
])
def test_profile_step_classes_both_tile_widths_of_kernel_h(name):
    from visualcloze_tpu_torch.profile_step import kernel_class

    assert kernel_class(name) == "w8a8 matmul (kernel H)"


@pytest.mark.parametrize("m, n, tile_n, paired", [
    (512, 3072, 128, True), (512, 9216, 128, True),  # the text stream: 256-column tiles fill under half of 66 pairs
    (3968, 3072, 256, True), (3968, 9216, 256, True), (3968, 12288, 256, True), (3456, 9216, 256, True),
    (3968, 21504, 256, False),  # 31 tiles: 1344 pair tiles take 21 rounds, 2604 lone tiles 20
    (4097, 3072, 256, False),  # 33 tiles: pairs take 4 rounds, lone CTAs 3
    (7, 64, 128, True), (129, 3072, 128, True),
])
def test_w8a8_tile_plan_pairs_and_narrows_only_where_that_takes_fewer_rounds(m, n, tile_n, paired):
    """Kernel H's persistent plan on the H100's 66 resident clusters of two
    CTAs (132 lone CTAs): 128-column tiles for the text stream, 256 for the
    image stream; pairs unless rounding the 128-row tiles up to even costs
    a round; the grid never holds more clusters than tiles or than fit."""
    from visualcloze_tpu_torch.ops.w8a8_matmul import tile_plan

    got_n, got_paired, clusters = tile_plan(m, n, 66)
    assert (got_n, got_paired) == (tile_n, paired)
    groups = -(-(-(-m // 128)) // (2 if paired else 1))
    assert clusters == min(66 if paired else 132, groups * -(-n // tile_n))


def test_w8a8_tile_plan_counts_rounds_of_the_resident_clusters():
    """With fewer resident clusters the same shape may take the wide tile:
    the plan follows the card's count, not a constant."""
    from visualcloze_tpu_torch.ops.w8a8_matmul import tile_plan

    assert tile_plan(512, 3072, 66) == (128, True, 48)
    assert tile_plan(512, 3072, 24) == (256, True, 24)  # 24 wide pair tiles fill 24 pairs in one round
    assert tile_plan(4097, 3072, 66) == (256, False, 132)


@pytest.mark.parametrize("m, n, paired", [
    (3968, 3072, True), (3456, 9216, True), (512, 3072, True), (3456, 64, True),
    (4097, 3072, False),  # 33 tiles: the pairs' rounded grid (408 CTAs) starts a 4th wave where 396 fill 3
    (16, 3072, False), (1, 18432, False),  # the GEMV body
])
def test_wide_body_pairs_its_ctas_unless_that_adds_a_wave(m, n, paired):
    """G's and G4's wide body on the H100's 132 SMs: 2-CTA clusters along M
    wherever rounding the 128-row tiles up to even costs no more time than
    the pair saves, lone CTAs where it starts a wave of its own."""
    from visualcloze_tpu_torch.ops.int4_matmul import PAIR_TIME as G4_PAIR_TIME
    from visualcloze_tpu_torch.ops.int8_matmul import PAIR_TIME, wide_pairs

    assert wide_pairs(m, n, 132, PAIR_TIME) == paired
    assert wide_pairs(m, n, 132, G4_PAIR_TIME) == paired


def test_wide_pairs_weighs_waves_by_the_pairs_time():
    """31 tiles x 84 (linear1): the pairs' grid takes 21 waves where lone
    CTAs take 20, so a pair pays only if it is more than 1/21 faster a tile,
    as G's (0.9) and G4's (0.85) are."""
    from visualcloze_tpu_torch.ops.int4_matmul import PAIR_TIME as G4_PAIR_TIME
    from visualcloze_tpu_torch.ops.int8_matmul import PAIR_TIME, wide_pairs

    assert wide_pairs(3968, 21504, 132, G4_PAIR_TIME) and wide_pairs(3968, 21504, 132, PAIR_TIME)
    assert wide_pairs(3968, 21504, 132, 0.95) and not wide_pairs(3968, 21504, 132, 0.96)


def test_profile_step_classes_vae_kernels_by_demangled_name():
    from visualcloze_tpu_torch.profile_step import vae_class

    assert vae_class("void (anonymous namespace)::conv3x3_kernel<true, true>(CUtensorMap_st, CUtensorMap_st)") == \
        "conv (kernel B)"
    assert vae_class("(anonymous namespace)::flash_d512(CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*)") == \
        "attention (kernel C)"
    assert vae_class("(anonymous namespace)::flash_d512_kernel(__nv_bfloat16 const*)") == "attention (kernel C)"
    assert vae_class("void (anonymous namespace)::group_norm_stats_pass<false>(__nv_bfloat16 const*, float*)") == \
        "group norm (kernel N)"
    assert vae_class("void (anonymous namespace)::group_norm_apply_kernel<true>(__nv_bfloat16 const*)") == \
        "group norm (kernel N)"
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
                                  "conv3x3_gn_swish", "layernorm_modulate", "gated_residual", "qk_norm_split",
                                  "merge_heads"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(name):
    """A tensor that is not on the CPU goes to the kernel path, which refuses
    what it does not take: here a meta tensor, never the plain version."""
    from visualcloze_tpu_torch.ops import flash_attention as fa

    x = torch.empty((1, 8, 3 * 2 * 128), device="meta", dtype=torch.bfloat16)
    vec = torch.empty((1, 1, x.shape[-1]), device="meta")
    fusion_args = {"layernorm_modulate": (x, vec, vec), "gated_residual": (x, vec, x),
                   "qk_norm_split": (x, vec[0, 0, :128], vec[0, 0, :128], 2),
                   "merge_heads": (torch.empty((1, 2, 8, 128), device="meta", dtype=torch.bfloat16),)}
    if name in fusion_args:
        assert name in ops.KERNELS
        with pytest.raises(ValueError, match="CUDA"):
            ops.KERNELS[name](*fusion_args[name])
        return
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


@pytest.mark.parametrize("kw", ["adapters", "lora_scale"])
def test_pipeline_accepts_runtime_adapters_and_their_scale(kw):
    """VisualClozeModel(adapters=, lora_scale=) registers the adapters (in the
    half layout, on the model's device) and keeps the scale; add_adapter
    adds one more."""
    from visualcloze_tpu_torch.models.lora import init_lora, tree_leaves
    from visualcloze_tpu_torch.pipeline import VisualClozeModel

    m = random_components(tiny=True, device="cpu")
    style = init_lora(m.flux, 2, generator=torch.Generator().manual_seed(0))
    args = {"adapters": {"style": style}} if kw == "adapters" else {"lora_scale": 0.5}
    model = VisualClozeModel(m.cfg, m.flux, m.ae, m.t5, m.clip, permute_params=False, device="cpu", **args)
    assert model.lora_scale == (0.5 if kw == "lora_scale" else 1.0)
    assert sorted(model.adapters) == (["style"] if kw == "adapters" else [])
    model.add_adapter("other", style)
    assert "other" in model.adapters and len(tree_leaves(model.adapters["other"])) == len(tree_leaves(style))
