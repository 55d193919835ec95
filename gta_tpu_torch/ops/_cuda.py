"""Build and load the port's hand-written CUDA kernels.

Each `gta_tpu_torch/csrc/<name>.cu` compiles with nvcc into a shared library
with a plain C interface, bound with ctypes (no PyTorch headers, so a build
takes seconds); shared device helpers live in `csrc/*.cuh`. Builds happen on
first use, from the sources in the checkout, into `gta_tpu_torch/_build/`; a
library's file name carries a hash of its source, the headers and the flags,
so an edited source is never served a stale build.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("gta_fused_fwd", "gta_fused_bwd", "flash_core_fwd", "flash_core_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the operand dtypes every kernel has an instance for (fp32: 3xTF32 products,
# csrc/attn_core.cuh; bf16: bf16 products with fp32 accumulation,
# csrc/attn_sm90.cuh)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output of the builds made by this process (register / spill
# counts from -Xptxas -v), by kernel name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build CUDA kernels")
    return path


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile every named kernel that has no current build, all nvcc
    processes started together."""
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name in todo:
            target = library_path(name)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, target, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def check_kernel_dtype(name: str, dtype: torch.dtype) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for an operand
    dtype that no kernel instance covers (a CUDA tensor of it would
    otherwise reach no kernel)."""
    if dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"{name}: the CUDA kernels have fp32 and bf16 instances, got {dtype} operands "
            "(ROADMAP queue 1 item 3e: other compute dtypes)"
        )
