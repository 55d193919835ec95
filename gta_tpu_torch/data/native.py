"""ctypes binding of the port's host C++: the PNG decoder
(`csrc/png_decode.cpp`) and the synthetic-scene renderer
(`csrc/synthetic_render.cpp`), with the names of the JAX package's
gta_tpu/data/native.py.

Both sources build with g++ into one library at first use, into
`gta_tpu_torch/_build/libgta_host-<hash>.so`; the hash covers the sources,
the flags and the host CPU's feature flags (the build is `-march=native`),
so an edited source or another CPU never gets a stale build. Each process
builds into a file of its own and renames it into place, so processes that
build at once (test workers) do not collide. Nothing falls back: a failed
build raises RuntimeError with g++'s output, and a file that does not
decode raises ValueError naming the file and the reason. The numpy codec
(`data/png.py`) and renderer (`data/synthetic.py`) are the plain versions;
only the callers' `native=False` / `use_native=False` selects them.

The calls release the interpreter lock (ctypes), so loader threads overlap
them with each other and with numpy work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "png_decode.cpp", _PKG / "csrc" / "synthetic_render.cpp")
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_ubyte)
_INT = ctypes.POINTER(ctypes.c_int)
_PATHS = ctypes.POINTER(ctypes.c_char_p)
_I = ctypes.c_int


def _cpu_flags() -> bytes:
    """The host CPU's feature flags, which `-march=native` builds for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in SOURCES) + " ".join(FLAGS + LIBS).encode() + _cpu_flags()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libgta_host-{digest}.so"


def _build(target: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the port's host library (data/native.py)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), *map(str, SOURCES), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}) building {target.name}:\n{proc.stderr}")
    os.replace(tmp, target)


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.gta_render_views.argtypes = [_F32] * 5 + [_I] * 4 + [ctypes.c_float] * 2 + [_F32] * 2
            lib.gta_render_views.restype = None
            lib.gta_png_error.argtypes = [_I]
            lib.gta_png_error.restype = ctypes.c_char_p
            lib.gta_png_header.argtypes = [ctypes.c_char_p, _INT, _INT, _INT]
            lib.gta_png_header.restype = _I
            lib.gta_decode_pngs_u8.argtypes = [_PATHS, _I, _I, _I, _I, _I, _U8, _INT]
            lib.gta_decode_pngs_u8.restype = _I
            lib.gta_decode_pngs_rgb.argtypes = [_PATHS, _I, _I, _I, _I, _F32, _INT]
            lib.gta_decode_pngs_rgb.restype = _I
            lib.gta_decode_pngs_gray.argtypes = [_PATHS, _I, _I, _I, _I, _U8, _INT]
            lib.gta_decode_pngs_gray.restype = _I
            _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32)


def render_views(
    cam_pos: np.ndarray,  # [NV, 3]
    extrinsics: np.ndarray,  # [NV, 4, 4]
    centers: np.ndarray,  # [K, 3]
    radii: np.ndarray,  # [K]
    colors: np.ndarray,  # [K, 3]
    h: int,
    w: int,
    focal: float = 0.035,
    sensor_w: float = 0.032,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render NV views of a sphere scene: (images [NV, h, w, 3], unit rays
    [NV, h, w, 3]), float32, the views in parallel threads."""
    lib = get_lib()
    nv = cam_pos.shape[0]
    cam_pos, extrinsics, centers, radii, colors = (
        np.ascontiguousarray(a, np.float32) for a in (cam_pos, extrinsics, centers, radii, colors))
    if extrinsics.shape != (nv, 4, 4) or centers.shape != (len(radii), 3) or colors.shape != centers.shape:
        raise ValueError(f"render_views: cam_pos {cam_pos.shape}, extrinsics {extrinsics.shape}, centers "
                         f"{centers.shape}, radii {radii.shape}, colors {colors.shape}")
    images = np.empty((nv, h, w, 3), np.float32)
    rays = np.empty((nv, h, w, 3), np.float32)
    lib.gta_render_views(
        _fptr(cam_pos), _fptr(extrinsics), _fptr(centers), _fptr(radii), _fptr(colors),
        len(radii), nv, h, w, focal, sensor_w, _fptr(images), _fptr(rays),
    )
    return images, rays


def _decode(entry: str, paths: Sequence[str], shape, dtype, ptr, *args, threads: int) -> np.ndarray:
    """Run a decode entry over `paths` into a new [n, *shape] array; raise
    ValueError naming every file that failed and why."""
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, *shape), dtype)
    status = np.zeros(n, np.intc)
    names = (ctypes.c_char_p * n)(*(os.fsencode(p) for p in paths))
    failed = getattr(lib, entry)(names, n, *args, threads, out.ctypes.data_as(ptr), status.ctypes.data_as(_INT))
    if failed:
        raise ValueError("; ".join(f"{paths[i]}: {lib.gta_png_error(int(status[i])).decode()}"
                                   for i in np.flatnonzero(status)))
    return out


def decode_pngs_rgb(paths: Sequence[str], h: int, w: int, threads: int = 0) -> np.ndarray:
    """RGB, RGBA or palette PNGs of size h x w as [n, h, w, 3] float32,
    `imread(p)[..., :3].astype(np.float32) / 255.0` of each; `threads`
    files at a time (0: one thread per core)."""
    return _decode("gta_decode_pngs_rgb", paths, (h, w, 3), np.float32, _F32, h, w, threads=threads)


def decode_pngs_gray(paths: Sequence[str], h: int, w: int, threads: int = 0) -> np.ndarray:
    """Gray PNGs (colour type 0) of size h x w as [n, h, w] uint8."""
    return _decode("gta_decode_pngs_gray", paths, (h, w), np.uint8, _U8, h, w, threads=threads)


def decode_pngs_u8(paths: Sequence[str], threads: int = 0) -> np.ndarray:
    """PNGs of one shape and colour type, stacked as `np.stack([imread(p)
    for p in paths])` (data/png.py) returns them: uint8 [n, h, w] for gray,
    [n, h, w, c] otherwise, palettes expanded to RGB."""
    if not paths:
        raise ValueError("decode_pngs_u8: no paths")
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = get_lib()
    status = lib.gta_png_header(os.fsencode(paths[0]), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if status:
        raise ValueError(f"{paths[0]}: {lib.gta_png_error(status).decode()}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    return _decode("gta_decode_pngs_u8", paths, shape, np.uint8, _U8, h.value, w.value, c.value,
                   threads=threads)
