"""Builds the hand-written CUDA kernels under csrc/ and binds them with ctypes.

Each `csrc/*.cu` file is one shared library with a plain C interface, compiled
with nvcc for sm_90a (Hopper) into `build/torch_kernels/` of the checkout at
first use (an installed package builds into `_build/torch_kernels/` beside
its own files) and rebuilt when a source is newer than its library. Nothing here
runs when the package is imported: a CPU-only install never needs nvcc.
set_build_dir moves the libraries elsewhere (VisualClozeModel.enable_aot,
the CLIs' --aot_dir), before any is loaded.

    python -m visualcloze_tpu_torch.ops.cuda_build   # build every kernel now
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = CSRC.parents[1]
DEFAULT_BUILD_DIR = (_ROOT / "build" if (_ROOT / "setup.py").exists() else CSRC.parent / "_build") / "torch_kernels"
BUILD_DIR = DEFAULT_BUILD_DIR
# one library per source file
SOURCES = ("flash_attn_rope", "flash_attn_bwd", "flash_attn_d512", "conv3x3_gn_swish", "int8_matmul", "w8a8_matmul",
           "act_quant_int8", "int4_matmul", "layernorm_modulate", "gated_residual", "qk_norm_split", "merge_heads",
           "layernorm_modulate_bwd", "gated_residual_bwd", "qk_norm_split_bwd", "merge_heads_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # name -> nvcc's stderr (ptxas register/spill report)
_LOCK = threading.RLock()  # server threads load and launch at once
_COUNT_LOCK = threading.Lock()


def set_build_dir(path=None) -> Path:
    """Build and load the kernel libraries under `path` from now on (None:
    $VISUALCLOZE_AOT_DIR, else DEFAULT_BUILD_DIR). Raises if a library is
    already loaded from another directory. Returns the directory."""
    global BUILD_DIR
    path = Path(path or os.environ.get("VISUALCLOZE_AOT_DIR") or DEFAULT_BUILD_DIR).resolve()
    with _LOCK:
        if _LIBS and path != BUILD_DIR:
            raise RuntimeError(f"kernel libraries are already loaded from {BUILD_DIR}; "
                               f"cannot move the build directory to {path}")
        BUILD_DIR = path
    return path


def count_launch(wrapper) -> None:
    """Add one to the launch count of a kernel wrapper (read by ops.kernel_launches)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return out.stat().st_mtime < newest


def build(names=SOURCES, force: bool = False) -> dict[str, float]:
    """Compile the named kernels, one nvcc process per source, all started
    together. Returns {name: seconds} for the ones built; raises with nvcc's
    output if any fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))
    seconds, errors = {}, []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out + err
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}{err}")
            continue
        os.replace(tmp, _lib_path(name))  # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, argtypes: list, source: str | None = None):
    """The C entry point `name` of the library of `source` (default: `name`),
    built if needed, typed with `argtypes`. Pointers and the stream must be
    ctypes.c_void_p, or ctypes cuts them to 32 bits."""
    source = source or name
    with _LOCK:
        if source not in _LIBS:
            build([source])
            _LIBS[source] = ctypes.CDLL(str(_lib_path(source)))
        fn = getattr(_LIBS[source], name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return fn


def check(name: str, status: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError_t {status}")


if __name__ == "__main__":
    for n, s in build(force=True).items():
        print(f"built {n} in {s:.1f}s")
        print(BUILD_LOG[n])
