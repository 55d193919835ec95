"""Build and load the port's hand-written CUDA kernels.

Each `gta_tpu_torch/csrc/<name>.cu` compiles with nvcc into a shared library
with a plain C interface, bound with ctypes (no PyTorch headers, so a build
takes seconds); shared device helpers live in `csrc/*.cuh`. The attention
kernels (KERNELS) compile once per head width in KERNEL_HEAD_DIMS
(`-DHEAD_DIM=<C>`, library `<name>_c<C>`), every width its own nvcc
process, so the widths build side by side. Builds happen on first use, from
the sources in the checkout, into `gta_tpu_torch/_build/`; a library's file
name carries a hash of its source, the headers and the flags, so an edited
source is never served a stale build. A failed build raises with the
compiler's output.

The attention wrappers (ops/flash_core.py, ops/gta_fused.py) share their
head-width rule here: every multiple of 8 in [32, 128] runs in the
smallest instance at or above it (`kernel_head_dim`), its operands
zero-padded to that width per head (`pad_heads`) and the results cut back
(`unpad_heads`); other widths raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("gta_fused_fwd", "gta_fused_bwd", "flash_core_fwd", "flash_core_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the head widths every kernel has an instance (a library) for
KERNEL_HEAD_DIMS = (32, 64, 96, 128)

# the operand dtypes every kernel has an instance for (fp32: 3xTF32 products,
# csrc/attn_core.cuh; bf16: bf16 products with fp32 accumulation,
# csrc/attn_sm90.cuh)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output of the builds made by this process (register / spill
# counts from -Xptxas -v), by library (`library`)
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build CUDA kernels")
    return path


Instance = Tuple[str, Optional[int]]  # (source name, head width or None)


def library(name: str, width: Optional[int] = None) -> str:
    """The library of source `name` at head width `width` (None: a source
    built without -DHEAD_DIM, such as the probes)."""
    return name if width is None else f"{name}_c{width}"


def _flags(width: Optional[int]) -> List[str]:
    return [*NVCC_FLAGS, *(() if width is None else (f"-DHEAD_DIM={width}",))]


def library_path(name: str, width: Optional[int] = None) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources) + " ".join(_flags(width)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{library(name, width)}-{digest}.so"


def instances(names: Iterable[str] = KERNELS) -> List[Instance]:
    """Every head width's library of each named kernel."""
    return [(name, width) for name in names for width in KERNEL_HEAD_DIMS]


def build(todo: Optional[Iterable[Instance]] = None) -> None:
    """Compile every named (source, width) library that has no current build
    (by default every kernel at every width), all nvcc processes started
    together."""
    with _lock:
        todo = [i for i in (instances() if todo is None else todo) if not library_path(*i).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, width in todo:
            target = library_path(name, width)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(width), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((library(name, width), target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for label, target, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOGS[label] = log
            if proc.returncode != 0:
                failed.append(f"{label} (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str, width: Optional[int] = None) -> ctypes.CDLL:
    """The loaded library of source `name` at head width `width`, built
    first if needed."""
    label = library(name, width)
    lib = _libs.get(label)
    if lib is None:
        build([(name, width)])
        lib = ctypes.CDLL(str(library_path(name, width)))
        _libs[label] = lib
    return lib


def kernel_head_dim(name: str, C: int) -> int:
    """The head width of the instance that runs head width C: C itself where
    it has one, else the smallest one above it (the operands zero-padded to
    it, `pad_heads`). Raises NotImplementedError, naming its ROADMAP item,
    for a width that is not a multiple of 8 in [32, 128]."""
    if C % 8 or not KERNEL_HEAD_DIMS[0] <= C <= KERNEL_HEAD_DIMS[-1]:
        raise NotImplementedError(
            f"{name}: the CUDA kernels are built for head dims {KERNEL_HEAD_DIMS} and run every multiple of 8 "
            f"in [{KERNEL_HEAD_DIMS[0]}, {KERNEL_HEAD_DIMS[-1]}] in the next one up, got {C} "
            "(ROADMAP queue 1 item 3d: other head widths)"
        )
    return next(w for w in KERNEL_HEAD_DIMS if w >= C)


def pad_heads(x: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    """Token-major [..., T, H*C] -> [..., T, H*width], each head's columns
    past C zero (x itself where C == width)."""
    C = x.shape[-1] // heads
    if C == width:
        return x
    return F.pad(x.reshape(*x.shape[:-1], heads, C), (0, width - C)).reshape(*x.shape[:-1], heads * width)


def unpad_heads(x: torch.Tensor, heads: int, C: int) -> torch.Tensor:
    """The inverse of `pad_heads`: each head's first C columns, contiguous."""
    width = x.shape[-1] // heads
    if C == width:
        return x
    return x.reshape(*x.shape[:-1], heads, width)[..., :C].reshape(*x.shape[:-1], heads * C)


def check_kernel_dtype(name: str, dtype: torch.dtype) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for an operand
    dtype that no kernel instance covers (a CUDA tensor of it would
    otherwise reach no kernel)."""
    if dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"{name}: the CUDA kernels have fp32 and bf16 instances, got {dtype} operands "
            "(ROADMAP queue 1 item 3e: other compute dtypes)"
        )


def launch_counters(fn):
    """Give a kernel wrapper its launch counts: `launches` (fp32 instances)
    and `launches_bf16`, and the same by instance width
    (`launches_by_width`, `launches_bf16_by_width`)."""
    fn.launches = fn.launches_bf16 = 0
    fn.launches_by_width = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
    fn.launches_bf16_by_width = dict.fromkeys(KERNEL_HEAD_DIMS, 0)
    return fn


def count_launch(fn, bf16: bool, width: int) -> None:
    """One launch of `fn`'s instance of that dtype and width."""
    if bf16:
        fn.launches_bf16 += 1
        fn.launches_bf16_by_width[width] += 1
    else:
        fn.launches += 1
        fn.launches_by_width[width] += 1
