"""The port's host library (gta_tpu_torch/data/native.py: csrc/png_decode.cpp
and csrc/synthetic_render.cpp, built with g++ and zlib) against its plain
versions and the JAX package.

- The PNG decoder against the port's numpy codec (data/png.py), byte for
  byte: files from the port's encoder (every filter row by row, colour
  types 0/2/3/4/6, widths 1, 7 and 320, the image data over several IDAT
  chunks, a palette with tRNS and indices past its end) and from imageio,
  PIL and cv2. Its float32 RGB equals `imread(p)[..., :3].astype(np.float32)
  / 255.0`; it rejects what data/png.py rejects, naming the file; one
  thread and many give the same bytes.
- The renderer and `SyntheticScenes(use_native=True)` against the JAX
  package's, which runs the same C++ from its tracked library
  (csrc/build/libgta_native.so, loaded as it is: never rebuilt here).
- The build: a failed compile raises with g++'s output, and processes that
  build at once all load one library.
"""

import ctypes
import os
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

import cv2
from gta_tpu.config import DataConfig as JDataConfig
from gta_tpu.data import native as j_native
from gta_tpu.data.synthetic import SyntheticScenes as JSyntheticScenes
from gta_tpu.geometry.rays import lookat_extrinsic as j_lookat_extrinsic
from gta_tpu_torch.config import DataConfig
from gta_tpu_torch.data import native, png
from gta_tpu_torch.data.synthetic import SyntheticScenes
from tests.test_torch_readers import _rewrite_ihdr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _split_idat(data: bytes, parts: int) -> bytes:
    """`data` with its IDAT data cut over `parts` IDAT chunks."""
    out, idat = [png.SIGNATURE], b""
    for kind, body in png._chunks(data, "<split>"):
        if kind == b"IDAT":
            idat += body
            continue
        if kind == b"IEND":
            step = -(-len(idat) // parts)
            out += [png._chunk(b"IDAT", idat[i : i + step]) for i in range(0, len(idat), step)]
        out.append(png._chunk(kind, body))
    return b"".join(out)


def _with_chunk(data: bytes, kind: bytes, body: bytes) -> bytes:
    """`data` with one more chunk before its first IDAT."""
    i = data.index(b"IDAT") - 4
    return data[:i] + png._chunk(kind, body) + data[i:]


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _assert_same(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ----------------------------------------------------------------- the decoder


@pytest.mark.parametrize("w", [1, 7, 320])
@pytest.mark.parametrize("colour", [0, 2, 3, 4, 6])
def test_decoder_equals_numpy_codec_on_port_files(tmp_path, colour, w):
    """Three files a case: every filter row by row in one IDAT, a random
    filter per row over 3 IDAT chunks, and Paeth rows over 5 (a palette
    file also carries a tRNS chunk and indices past its 200 entries)."""
    rng = np.random.RandomState(colour * 1000 + w)
    h = 24 if w == 320 else 13
    channels = {0: None, 2: 3, 3: None, 4: 2, 6: 4}[colour]
    palette = rng.randint(0, 256, (200, 3)).astype(np.uint8) if colour == 3 else None
    paths = []
    for k, (ft, parts) in enumerate(((np.arange(h) % 5, 1), (rng.randint(0, 5, h), 3), (4, 5))):
        shape = (h, w) if channels is None else (h, w, channels)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        data = _split_idat(png.encode_png(img, filter=ft, palette=palette), parts)
        if colour == 3:
            data = _with_chunk(data, b"tRNS", bytes(range(10)))
        paths.append(_write(tmp_path / f"f{k}.png", data))
    want = png.imread_stack(paths)
    _assert_same(native.decode_pngs_u8(paths), want)
    if colour in (2, 3, 6):
        _assert_same(native.decode_pngs_rgb(paths, h, w), want[..., :3].astype(np.float32) / 255.0)
    if colour == 0:
        _assert_same(native.decode_pngs_gray(paths, h, w), want)


def test_decoder_equals_imageio_on_library_files(tmp_path):
    """Files from imageio, PIL and cv2 (their own filter choices and IDAT
    chunking; a PIL palette image with and without tRNS): the host decoder
    returns what imageio and the numpy codec return."""
    rng = np.random.RandomState(0)
    h, w = 60, 80
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([(xx * 3) % 256, (yy * 5) % 256, (xx + yy) % 256], -1).astype(np.uint8)
    imgs = {
        "rgb_smooth": smooth,
        "rgb_noise": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
        "gray": ((xx // 3 + yy // 5) % 7 * 30).astype(np.uint8),
        "rgba": np.concatenate([smooth, rng.randint(0, 256, (h, w, 1)).astype(np.uint8)], -1),
        "gray_alpha": np.stack([smooth[..., 0], smooth[..., 2]], -1),
    }
    paths = []
    for name, img in imgs.items():
        for writer in ("imageio", "pil", "cv2"):
            path = str(tmp_path / f"{name}_{writer}.png")
            if writer == "imageio":
                imageio.imwrite(path, img)
            elif writer == "pil":
                Image.fromarray(img).save(path)
            elif name != "gray_alpha":  # cv2 writes no gray + alpha
                cv2.imwrite(path, img[..., [2, 1, 0, 3][: img.shape[-1]]] if img.ndim == 3 else img)
            else:
                continue
            paths.append(path)
    im = Image.fromarray(rng.randint(0, 40, (h, w)).astype(np.uint8), "P")
    im.putpalette([int(v) for v in rng.randint(0, 256, 256 * 3)])
    for name, kw in (("palette", {}), ("palette_trns", {"transparency": 3})):
        paths.append(str(tmp_path / f"{name}.png"))
        im.save(paths[-1], **kw)
    for path in paths:
        want = imageio.imread(path)
        _assert_same(native.decode_pngs_u8([path]), want[None])
        _assert_same(png.imread(path), want)
        if want.ndim == 3 and want.shape[-1] >= 3:
            _assert_same(native.decode_pngs_rgb([path], h, w), want[None, ..., :3].astype(np.float32) / 255.0)


def test_rgb_output_is_the_division_by_255(tmp_path):
    """Every byte value decodes to float32(x) / 255, the value the readers'
    numpy path and the JAX reader's imageio path produce; the JAX package's
    libpng path multiplies by float32(1 / 255), which differs in the last
    bit at 126 of the 256 values (a note on the reference, not a port
    fault)."""
    img = np.arange(256 * 3, dtype=np.int64).reshape(16, 16, 3) % 256
    path = _write(tmp_path / "all.png", png.encode_png(img.astype(np.uint8), filter=np.arange(16) % 5))
    got = native.decode_pngs_rgb([path], 16, 16)[0]
    x = img.astype(np.float32)
    _assert_same(got, x / 255.0)
    _assert_same(got, (x / np.float32(255)).astype(np.float32))
    values = np.arange(256, dtype=np.float32)
    assert int(np.sum(values / np.float32(255) != values * np.float32(1.0 / 255.0))) == 126


def test_decoder_rejects_what_the_numpy_codec_rejects(tmp_path):
    """Interlace, bit depths other than 8, a bad CRC, truncation, a missing
    IEND, no PNG at all, a wrong size or colour type, a missing file: each
    raises ValueError naming the file and the reason, as data/png.py
    raises for the same files (the size and colour checks are the
    decoder's own)."""
    img = np.random.RandomState(4).randint(0, 256, (16, 20, 3)).astype(np.uint8)
    good = png.encode_png(img, filter=4)
    ok = _write(tmp_path / "ok.png", good)
    bad_crc = bytearray(good)
    bad_crc[good.index(b"IDAT") + 6] ^= 0x01
    cases = {
        "interlaced.png": (_rewrite_ihdr(good, interlace=1), "Adam7"),
        "crc.png": (bytes(bad_crc), "bad CRC"),
        "truncated.png": (good[:-20], "truncated"),
        "noiend.png": (good[:-12], "truncated"),
        "gif.png": (b"GIF89a" + good[6:], "not a PNG"),
        "idat.png": (good[: good.index(b"IDAT") + 4] + good[good.index(b"IDAT") + 4 :][:5], "truncated"),
    }
    for name, (data, reason) in cases.items():
        path = _write(tmp_path / name, data)
        with pytest.raises(ValueError, match=f"{name}"):
            png.imread(path)
        with pytest.raises(ValueError, match=f"{name}: .*{reason}"):
            native.decode_pngs_rgb([ok, path], 16, 20)
        with pytest.raises(ValueError, match=f"{name}: .*{reason}"):
            native.decode_pngs_u8([path])
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, img.astype(np.uint16) * 257)
    p4 = str(tmp_path / "p4.png")
    im = Image.fromarray((img[..., 0] % 4).astype(np.uint8), "P")
    im.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255])
    im.save(p4, bits=4)
    for path in (deep, p4):
        with pytest.raises(ValueError, match="bit depth"):
            png.imread(path)
        with pytest.raises(ValueError, match=f"{os.path.basename(path)}: bit depth"):
            native.decode_pngs_u8([path])
    with pytest.raises(ValueError, match="ok.png: image of another size"):
        native.decode_pngs_rgb([ok], 16, 21)
    gray = _write(tmp_path / "gray.png", png.encode_png(img[..., 0]))
    with pytest.raises(ValueError, match="gray.png: image of another colour type"):
        native.decode_pngs_rgb([ok, gray], 16, 20)
    with pytest.raises(ValueError, match="ok.png: image of another colour type"):
        native.decode_pngs_gray([gray, ok], 16, 20)
    with pytest.raises(ValueError, match="gray.png: image of another colour type"):
        native.decode_pngs_u8([ok, gray])
    with pytest.raises(ValueError, match="missing.png: cannot open"):
        native.decode_pngs_gray([str(tmp_path / "missing.png")], 16, 20)


def test_one_thread_and_many_give_the_same_bytes(tmp_path):
    rng = np.random.RandomState(9)
    paths = [_write(tmp_path / f"f{k}.png", png.encode_png(
        rng.randint(0, 256, (48, 64, 3)).astype(np.uint8), filter=rng.randint(0, 5, 48))) for k in range(12)]
    one = native.decode_pngs_rgb(paths, 48, 64, threads=1)
    for threads in (0, 3, 12, 40):
        _assert_same(native.decode_pngs_rgb(paths, 48, 64, threads=threads), one)
    _assert_same(native.decode_pngs_u8(paths, threads=5), native.decode_pngs_u8(paths, threads=1))


# ---------------------------------------------------------------- the renderer


@pytest.fixture
def jax_tracked_renderer(monkeypatch):
    """The JAX package's native module on its tracked library, loaded as it
    is (its get_lib would rebuild it from csrc/ if the sources looked
    newer). That library holds the renderer but no PNG decoder."""
    lib = ctypes.CDLL(os.path.join(REPO, "csrc", "build", "libgta_native.so"))
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.gta_render_views.argtypes = [f32] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [f32] * 2
    lib.gta_render_views.restype = None
    monkeypatch.setattr(j_native, "_lib", lib)
    assert not hasattr(lib, "gta_decode_pngs_rgb")


def test_renderer_equals_jax_native_renderer(jax_tracked_renderer):
    rng = np.random.RandomState(0)
    K, NV, h, w = 6, 5, 60, 80
    centers = rng.uniform(-3, 3, (K, 3)).astype(np.float32)
    radii = rng.uniform(0.4, 1.1, K).astype(np.float32)
    colors = rng.rand(K, 3).astype(np.float32)
    pos = rng.uniform(5, 8, (NV, 3)).astype(np.float32)
    ext = np.stack([j_lookat_extrinsic(p) for p in pos])
    want = j_native.render_views(pos, ext, centers, radii, colors, h, w)
    got = native.render_views(pos, ext, centers, radii, colors, h, w)
    for g, wnt in zip(got, want):
        _assert_same(g, wnt)
    np.testing.assert_allclose(np.linalg.norm(got[1], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("mode,full_scale,over", [
    ("train", False, {}),
    ("test", True, dict(downsample=1)),
    ("val", False, dict(return_transform=False)),
    ("test", True, dict(downsample=1, return_transform=False)),
], ids=["train", "test_full", "val_rays", "test_full_rays"])
def test_synthetic_scenes_native_equal_jax_native(jax_tracked_renderer, mode, full_scale, over):
    """`SyntheticScenes(use_native=True)` items equal the JAX package's
    `SyntheticScenes(use_native=True)` items byte for byte; against the
    numpy renderer (use_native=False) they hold test_native.py's bounds
    (rays 1e-4, >= 99.5 % of pixels within 1e-3)."""
    kw = {**dict(dataset="synthetic", height=48, width=64, downsample=0, num_points=64, downsample_input_coord=2,
                 num_input_views=2, num_target_views=2, num_views=4), **over}
    ours = SyntheticScenes(DataConfig(**kw), mode, full_scale=full_scale, use_native=True)
    theirs = JSyntheticScenes(JDataConfig(**kw), mode, full_scale=full_scale, use_native=True)
    plain = SyntheticScenes(DataConfig(**kw), mode, full_scale=full_scale)
    for idx in (0, 5):
        got, want = ours[idx], theirs[idx]
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(np.asarray(got[k]), np.asarray(want[k]))
        ref = plain[idx]
        assert np.abs(got["input_rays"] - ref["input_rays"]).max() < 1e-4
        close = np.abs(got["input_images"] - ref["input_images"]).max(-1) < 1e-3
        assert close.mean() > 0.995


# ------------------------------------------------------------------- the build


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    target = native.library_path()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed(.|\n)*broken.cpp(.|\n)*error"):
        native._build(target)
    assert not target.exists() and not list((tmp_path / "build").glob("*.tmp"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native._build(target)


def test_processes_that_build_at_once_load_one_library(tmp_path):
    code = (
        "import sys, pathlib; from gta_tpu_torch.data import native; "
        f"native.BUILD_DIR = pathlib.Path({str(tmp_path)!r}); "
        "lib = native.get_lib(); print(native.library_path().name, lib.gta_png_error(0).decode())"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({out for out, _ in outs}) == 1 and outs[0][0].split()[1] == "ok"
    assert [p.name for p in tmp_path.iterdir()] == [outs[0][0].split()[0]]
