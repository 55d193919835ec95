"""The port's dataset readers against the JAX package's, on the CPU.

- `gta_tpu_torch/data/png.py` against `imageio.v2.imread` on files written
  by imageio, cv2 and PIL (their own filter choices, IDAT chunking) and by
  the port's encoder (every filter type, a per-row mix, colour types 0, 2,
  3, 4 and 6); what it rejects.
- CLEVR-TR (`data/clevrtr.py`), MSN-Hard's `prep_scene` (`data/msn.py`)
  and RealEstate10K (`data/re10k.py`) items byte-equal to the JAX
  package's, on fixtures written here (CLEVR-TR in the layout of
  tests/test_data.py, RealEstate10K as tests/test_re10k.py writes it). The
  JAX CLEVR-TR reader runs its per-file imageio path here: its native
  decoder is switched off for the comparison, since it scales by
  1.0f / 255 where imageio's path divides by 255.
- The registry, `collate` with the `org_` keys, the loader on a stream and
  across epochs.
- The train and evaluate CLIs on a positional datapath, and the train
  CLI's stream-position skip on a resume.

The model end to end on these fixtures: tests/test_torch_readers_e2e.py.
"""

import dataclasses
import json
import os
import struct
import sys
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from gta_tpu.config import DataConfig as JDataConfig
from gta_tpu.data import native as j_native
from gta_tpu.data.clevrtr import CLEVRTR as JCLEVRTR
from gta_tpu.data.loader import Loader as JLoader
from gta_tpu.data.msn import lookat_extrinsic_from_rays as j_lookat_extrinsic_from_rays, prep_scene as j_prep_scene
from gta_tpu.data.re10k import RealEstate10K as JRealEstate10K
from gta_tpu.data.synthetic import SyntheticScenes as JSyntheticScenes, collate as j_collate
from gta_tpu.geometry.coords import make_2dcoord as j_make_2dcoord, make_2dimgcoord as j_make_2dimgcoord
from gta_tpu.geometry.rays import camera_rays
from gta_tpu_torch import evaluate as t_evaluate
from gta_tpu_torch.config import DataConfig
from gta_tpu_torch.data import png
from gta_tpu_torch.data.clevrtr import CLEVRTR
from gta_tpu_torch.data.loader import Loader
from gta_tpu_torch.data.msn import MultiShapeNet, lookat_extrinsic_from_rays, prep_scene
from gta_tpu_torch.data.re10k import RealEstate10K, resize_area
from gta_tpu_torch.data.registry import get_dataset
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.geometry.coords import make_2dcoord, make_2dimgcoord
from gta_tpu_torch.train import __main__ as t_train
from tests.test_re10k import _make_dump
from tests.test_torch_train import _tiny_yaml

H, W, NV = 240, 320, 5  # the CLEVR-TR layout


def _assert_items_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def _idat_count(path) -> int:
    with open(path, "rb") as f:
        return sum(kind == b"IDAT" for kind, _ in png._chunks(f.read(), path))


# ---------------------------------------------------------------- PNG codec


def _library_images(rng):
    yy, xx = np.mgrid[:H, :W]
    smooth = np.stack([(xx * 0.7) % 256, (yy * 1.1) % 256, (xx + yy) % 256], -1).astype(np.uint8)
    return {
        "rgb_smooth": smooth,
        "rgb_noise": rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
        "gray": ((xx // 3 + yy // 5) % 7 * 30).astype(np.uint8),
        "rgba": np.concatenate([smooth, rng.randint(0, 256, (H, W, 1)).astype(np.uint8)], -1),
        "gray_alpha": np.stack([smooth[..., 0], smooth[..., 2]], -1),
    }


@pytest.mark.parametrize("writer", ["imageio", "cv2", "pil"])
def test_decoder_equals_imageio_on_library_files(tmp_path, writer):
    """Each library's own filter choices (PIL and libpng pick a filter per
    row) and IDAT chunking (PIL 64 KiB, libpng 8 KiB: the noise frame spans
    many chunks)."""
    imgs = _library_images(np.random.RandomState(0))
    for name, img in imgs.items():
        path = str(tmp_path / f"{name}.png")
        if writer == "imageio":
            imageio.imwrite(path, img)
        elif writer == "pil":
            Image.fromarray(img).save(path)
        else:
            if name == "gray_alpha":  # cv2 writes no gray + alpha
                continue
            bgr = img[..., [2, 1, 0, 3][: img.shape[-1]]] if img.ndim == 3 else img
            cv2.imwrite(path, bgr)
        want = imageio.imread(path)
        got = png.imread(path)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        if name == "rgb_noise":
            assert _idat_count(path) > 1
    # a palette image (PIL's 8-bit P mode), with and without tRNS, both
    # expanded to RGB as imageio expands them
    rng = np.random.RandomState(1)
    idx = rng.randint(0, 40, (H, W)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette([int(v) for v in rng.randint(0, 256, 256 * 3)])
    for name, kw in (("palette", {}), ("palette_trns", {"transparency": 3})):
        path = str(tmp_path / f"{name}.png")
        im.save(path, **kw)
        want = imageio.imread(path)
        got = png.imread(path)
        assert got.shape == want.shape == (H, W, 3), name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_encoder_round_trip_every_filter_and_colour_type(tmp_path, filt):
    """The port's encoder at each filter type and a per-row mix, for colour
    types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA):
    imageio and the port's decoder read back the array written."""
    rng = np.random.RandomState(2)
    h, w = 37, 53
    ft = rng.randint(0, 5, h) if filt == "mixed" else filt
    palette = rng.randint(0, 256, (200, 3)).astype(np.uint8)
    cases = {
        0: (rng.randint(0, 256, (h, w)).astype(np.uint8), None),
        2: (rng.randint(0, 256, (h, w, 3)).astype(np.uint8), None),
        3: (rng.randint(0, 200, (h, w)).astype(np.uint8), palette),
        4: (rng.randint(0, 256, (h, w, 2)).astype(np.uint8), None),
        6: (rng.randint(0, 256, (h, w, 4)).astype(np.uint8), None),
    }
    for colour, (img, pal) in cases.items():
        path = str(tmp_path / f"c{colour}.png")
        png.write_png(path, img, filter=ft, palette=pal)
        with open(path, "rb") as f:
            assert f.read()[25] == colour  # IHDR's colour type byte
        want = img if pal is None else pal[img]
        np.testing.assert_array_equal(imageio.imread(path), want, err_msg=str(colour))
        got = png.imread(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, colour
        np.testing.assert_array_equal(got, want, err_msg=str(colour))


def test_stack_decode_equals_one_by_one(tmp_path):
    """`imread_stack` (one wavefront for a stack) equals imageio per file,
    across mixed, Sub/Up-only and Paeth-only files."""
    rng = np.random.RandomState(3)
    paths = []
    for k, ft in enumerate([rng.randint(0, 5, 29), [1, 2] * 14 + [1], 4, 3, 0]):
        path = str(tmp_path / f"s{k}.png")
        png.write_png(path, rng.randint(0, 256, (29, 41, 3)).astype(np.uint8), filter=ft)
        paths.append(path)
    np.testing.assert_array_equal(png.imread_stack(paths), np.stack([imageio.imread(p) for p in paths]))


def _rewrite_ihdr(data: bytes, **fields) -> bytes:
    """`data` with IHDR fields replaced (depth, colour, interlace) and its CRC
    recomputed."""
    w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(depth=depth, colour=colour, interlace=interlace)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["colour"], comp, filt, vals["interlace"])
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def test_decoder_rejects_interlace_other_depths_bad_crc_and_truncation(tmp_path):
    img = np.random.RandomState(4).randint(0, 256, (16, 20, 3)).astype(np.uint8)
    good = png.encode_png(img, filter=4)
    np.testing.assert_array_equal(png.decode_png(good)[0], img)
    with pytest.raises(ValueError, match="f.png: Adam7"):
        png.decode_png(_rewrite_ihdr(good, interlace=1), "f.png")
    path16 = str(tmp_path / "deep.png")
    cv2.imwrite(path16, (img.astype(np.uint16) * 257))
    with pytest.raises(ValueError, match="deep.png: bit depth 16"):
        png.imread(path16)
    path4 = str(tmp_path / "p4.png")
    im = Image.fromarray((img[..., 0] % 4).astype(np.uint8), "P")
    im.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255])
    im.save(path4, bits=4)
    with pytest.raises(ValueError, match="p4.png: bit depth [124]"):
        png.imread(path4)
    idat = good.index(b"IDAT")
    bad = bytearray(good)
    bad[idat + 6] ^= 0x01
    with pytest.raises(ValueError, match="x.png: bad CRC in a b'IDAT' chunk"):
        png.decode_png(bytes(bad), "x.png")
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(good[:-20], "t.png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + good[6:], "g.png")


# ------------------------------------------------------------------ CLEVR-TR


def _write_clevr_split(root, split, scenes, rng):
    """Scenes of the JAX layout (tests/test_data.py): cameras on a ring,
    seeded noise frames and gray mask indices 0-6; even scenes written by
    imageio (PIL's filters), odd ones by the port's encoder cycling through
    every filter type row by row."""
    d = os.path.join(root, split)
    for sub in ("metadata", "imgs", "masks"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for s in scenes:
        qs, ps = [], []
        for v in range(NV):
            az = 2 * np.pi * v / NV + 0.1 * s
            qs.append([np.cos(az / 2), 0.0, 0.0, np.sin(az / 2)])
            ps.append([7 * np.cos(az), 7 * np.sin(az), 4.0])
            img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
            mask = rng.randint(0, 7, (H, W)).astype(np.uint8)
            for kind, arr in (("imgs/img", img), ("masks/masks", mask)):
                path = os.path.join(d, f"{kind}_{s}_{v}.png")
                if s % 2:
                    png.write_png(path, arr, filter=np.arange(H) % 5)
                else:
                    imageio.imwrite(path, arr)
        with open(os.path.join(d, "metadata", f"{s}.json"), "w") as f:
            json.dump({"camera": {"quaternions": qs, "positions": ps}}, f)


@pytest.fixture(scope="module")
def clevr_root(tmp_path_factory):
    """3 train scenes (2 train, 1 val by the 90/10 split) and 1 test scene."""
    root = str(tmp_path_factory.mktemp("clevrtr"))
    rng = np.random.RandomState(5)
    _write_clevr_split(root, "train", range(3), rng)
    _write_clevr_split(root, "test", [7], rng)
    return root


@pytest.fixture
def jax_imageio_path(monkeypatch):
    """The JAX CLEVR-TR reader on its per-file imageio path."""
    monkeypatch.setattr(j_native, "decode_pngs_rgb", lambda *a, **k: None)
    monkeypatch.setattr(j_native, "decode_pngs_gray", lambda *a, **k: None)


CLEVR = dict(dataset="clevrtr", num_views=NV, num_points=60, num_input_views=2, num_target_views=3)


@pytest.mark.parametrize("mode,full_scale,over", [
    ("train", False, dict(downsample=1)),
    ("val", False, dict(downsample=1, camera_noise=0.1)),
    ("test", True, dict(downsample=1)),
    ("test", True, dict(downsample=0, return_transform=False)),
    ("train", False, dict(downsample=0, return_transform=False, camera_noise=0.1, overlap=True)),
    ("train", False, dict(downsample=1, return_org_rays=True, return_org_images=True)),
    ("val", False, dict(downsample=1, return_transform=False, return_org_rays=True, return_org_images=True)),
    ("train", True, dict(downsample=1, image_coord=True, kubric_basis=True, avoid_zerocamorg=True)),
    ("test", False, dict(downsample=0, canonical_view=False, reconstruction=True, num_target_views=2)),
], ids=["train", "val_noise", "test_full", "test_full_rays", "train_rays_noise", "org", "val_org_rays",
        "imgcoord_kubric", "no_canon"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_clevrtr_items_byte_equal(clevr_root, jax_imageio_path, mode, full_scale, over, native):
    kw = {**CLEVR, "path": clevr_root, **over}
    ours = CLEVRTR(DataConfig(**kw), mode, full_scale=full_scale, seed=3, native=native)
    theirs = JCLEVRTR(JDataConfig(**kw), mode, full_scale=full_scale, seed=3)
    assert ours.metadata_paths == theirs.metadata_paths and len(ours) == {"train": 2, "val": 1, "test": 1}[mode]
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for idx in range(len(ours)):
            _assert_items_equal(ours[idx], theirs[idx])


def test_coords_equal_jax():
    for h, w in ((240, 320), (7, 5)):
        assert make_2dimgcoord(h, w).tobytes() == j_make_2dimgcoord(h, w).tobytes()
        assert make_2dcoord(h, w).tobytes() == j_make_2dcoord(h, w).tobytes()


def test_loader_epochs_pick_the_views_jax_picks(clevr_root, jax_imageio_path):
    """`Loader.set_epoch` reaches the dataset: two epochs of CLEVR-TR through
    the port's Loader pick the input views the JAX Loader (one worker) picks,
    and different ones from each other."""
    kw = {**CLEVR, "path": clevr_root, "downsample": 1}
    ours = Loader(CLEVRTR(DataConfig(**kw), "train", seed=1), 2, shuffle=False)
    theirs = JLoader(JCLEVRTR(JDataConfig(**kw), "train", seed=1), 2, shuffle=False, num_workers=1)
    picked = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        (got,), (want,) = list(ours), list(theirs)
        np.testing.assert_array_equal(got.input_images.numpy(), np.asarray(want.input_images))
        np.testing.assert_array_equal(got.input_transforms.numpy(), np.asarray(want.input_transforms))
        picked.append(got.input_images.numpy())
    assert not np.array_equal(picked[0], picked[1])


def test_collate_keeps_the_org_keys(clevr_root, jax_imageio_path):
    kw = {**CLEVR, "path": clevr_root, "downsample": 1, "return_org_rays": True, "return_org_images": True}
    items = [CLEVRTR(DataConfig(**kw), "train")[i] for i in (0, 1)]
    got = collate(items)
    want = j_collate([JCLEVRTR(JDataConfig(**kw), "train")[i] for i in (0, 1)])
    assert got.input_org_rays.shape == (2, 2, H, W, 3) and got.input_images.shape == (2, 2, H // 2, W // 2, 3)
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        g = getattr(got, f.name)
        if w is None:
            assert g is None, f.name
        else:
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), f.name


# ------------------------------------------------------------------- MSN-Hard


def _msn_scene(rng, nv=10, h=16, w=16):
    """A raw MSN-Hard scene as sunds yields it: uint8 colour, ray origins
    and directions of look-at cameras on a ring, instance ids."""
    color = rng.randint(0, 256, (nv, h, w, 3)).astype(np.uint8)
    origins = np.zeros((nv, h, w, 3), np.float32)
    dirs = np.zeros((nv, h, w, 3), np.float32)
    for v in range(nv):
        az = 2 * np.pi * v / nv
        pos = np.array([6 * np.cos(az), 6 * np.sin(az), 3.0 + 0.1 * v])
        origins[v] = pos
        dirs[v] = camera_rays(pos, width=w, height=h)
    inst = rng.randint(0, 40, (nv, h, w, 1)).astype(np.int32)
    return color, origins, dirs, inst


@pytest.mark.parametrize("instances", [True, False], ids=["instances", "no_instances"])
@pytest.mark.parametrize("return_transform,full_scale,downsample", [
    (True, False, 0), (True, True, 0), (False, False, 0), (False, True, 0),
    # the transform branch shares the input grid with full-size targets, so
    # `downsample` goes with the ray branch only (in JAX as here)
    (False, False, 1),
], ids=["transform", "transform_full", "rays", "rays_full", "rays_downsampled"])
def test_prep_scene_byte_equal(instances, return_transform, full_scale, downsample):
    kw = dict(dataset="msn", num_input_views=5, num_target_views=5, num_views=10, num_points=50,
              downsample=downsample, downsample_input_coord=2, return_transform=return_transform)
    color, origins, dirs, inst = _msn_scene(np.random.RandomState(6))
    inst = inst if instances else None
    coord = make_2dcoord(16, 16)
    got = prep_scene(DataConfig(**kw), color, origins, dirs, inst, 7, np.random.RandomState(9), coord, full_scale)
    want = j_prep_scene(JDataConfig(**kw), color, origins, dirs, inst, 7, np.random.RandomState(9), coord,
                        full_scale)
    _assert_items_equal(got, want)
    assert lookat_extrinsic_from_rays(origins[3, 0, 0], dirs[3]).tobytes() == \
        j_lookat_extrinsic_from_rays(origins[3, 0, 0], dirs[3]).tobytes()


def test_multishapenet_needs_sunds_as_jax_does():
    cfg = dict(dataset="msn", path="/nonexistent", num_views=10, num_input_views=5, num_target_views=5)
    with pytest.raises(RuntimeError, match="requires the `sunds` package") as ours:
        MultiShapeNet(DataConfig(**cfg), "train")
    from gta_tpu.data.msn import MultiShapeNet as JMultiShapeNet

    with pytest.raises(RuntimeError) as theirs:
        JMultiShapeNet(JDataConfig(**cfg), "train")
    assert str(ours.value) == str(theirs.value)


# -------------------------------------------------------------- RealEstate10K


@pytest.fixture(scope="module")
def re10k_dump(tmp_path_factory):
    """tests/test_re10k.py's dump: 2 train videos (1 train, 1 val) and 1 test
    video of 40 frames of 24x32, written by cv2."""
    root = str(tmp_path_factory.mktemp("re10k"))
    _make_dump(root, n_videos=2, split="train")
    _make_dump(root, n_videos=1, split="test")
    return root


RE10K = dict(dataset="re10k", num_points=64, num_input_views=2, num_target_views=2, height=24, width=32,
             downsample_input_coord=2)


@pytest.mark.parametrize("mode,full_scale,over,gaps", [
    ("train", False, dict(return_transform=True), (5, 10)),
    ("val", False, dict(return_transform=False), (5, 10)),
    ("test", True, dict(return_transform=True), (45, 135)),
    ("test", True, dict(return_transform=False, avoid_zerocamorg=True), (5, 10)),
    ("train", False, dict(return_transform=True, reconstruction=True, canonical_view=False), (1, 3)),
    ("train", False, dict(return_transform=True, num_target_views=3), (1, 1)),
], ids=["train", "val_rays", "test_full", "test_full_rays", "recon_no_canon", "gap1"])
def test_re10k_items_byte_equal(re10k_dump, mode, full_scale, over, gaps):
    kw = {**RE10K, "path": re10k_dump, **over}
    ours = RealEstate10K(DataConfig(**kw), mode, full_scale=full_scale, seed=2, min_gap=gaps[0], max_gap=gaps[1])
    theirs = JRealEstate10K(JDataConfig(**kw), mode, full_scale=full_scale, seed=2, min_gap=gaps[0],
                            max_gap=gaps[1])
    assert ours.camera_paths == theirs.camera_paths and len(ours) == 1
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        _assert_items_equal(ours[0], theirs[0])


def test_re10k_resampled_items_match_jax(re10k_dump):
    """Frames of another size than the config's: the port's area resample
    against the JAX reader's cv2.resize(INTER_AREA) (a 2x downscale here).
    The pixel fields agree to 1e-6: both are fp32 weighted means of values
    in [0, 1] summed in another order; every other field is byte-equal."""
    kw = {**RE10K, "path": re10k_dump, "height": 24, "width": 32, "downsample": 1}
    ours = RealEstate10K(DataConfig(**kw), "test", full_scale=True, min_gap=5, max_gap=10)[0]
    theirs = JRealEstate10K(JDataConfig(**kw), "test", full_scale=True, min_gap=5, max_gap=10)[0]
    assert ours["input_images"].shape == (2, 12, 16, 3)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        if k in ("input_images", "target_pixels"):
            np.testing.assert_allclose(ours[k], theirs[k], atol=1e-6, rtol=0, err_msg=k)
        else:
            assert np.asarray(ours[k]).tobytes() == np.asarray(theirs[k]).tobytes(), k


@pytest.mark.parametrize("src,dst", [((240, 320), (120, 160)), ((250, 333), (120, 160)), ((24, 32), (120, 160)),
                                     ((90, 320), (120, 160))],
                         ids=["integer_down", "fractional_down", "up", "mixed"])
def test_resize_area_matches_cv2(src, dst):
    """Within 1e-6 of cv2.resize INTER_AREA (fp32 rounding of weighted
    means in [0, 1]; far inside the 1/255 of one 8-bit level)."""
    img = np.random.RandomState(7).rand(*src, 3).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = resize_area(img, *dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_re10k_jpeg_frames_through_pil_or_raise(tmp_path, monkeypatch):
    from gta_tpu_torch.data import re10k

    path = str(tmp_path / "f.jpg")
    Image.fromarray(np.random.RandomState(8).randint(0, 256, (24, 32, 3)).astype(np.uint8)).save(path)
    np.testing.assert_array_equal(re10k._imread(path), imageio.imread(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="no JPEG decoder.*install PIL"):
        re10k._imread(path)


# ----------------------------------------------------- registry and the loader


def test_registry_builds_every_dataset(clevr_root, re10k_dump):
    assert isinstance(get_dataset("train", DataConfig(**{**CLEVR, "path": clevr_root})), CLEVRTR)
    for name in ("re10k", "acid"):
        ds = get_dataset("test", DataConfig(**{**RE10K, "dataset": name, "path": re10k_dump}), full_scale=True)
        assert isinstance(ds, RealEstate10K) and len(ds) == 1
    with pytest.raises(RuntimeError, match="sunds"):
        get_dataset("train", DataConfig(dataset="msn", path="/nonexistent"))
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("train", DataConfig(dataset="imagenet"))


class _Stream:
    """An iterable dataset (no __getitem__) over synthetic items, with the
    stream-position `skip` the MSN-Hard reader has."""

    def __init__(self, cfg, n, synthetic=SyntheticScenes):
        self.items = synthetic(cfg, "train", max_len=n)
        self.n, self._skip, self.skipped = n, 0, []

    def __len__(self):
        return self.n

    def skip(self, n):
        self._skip += n
        self.skipped.append(n)

    def __iter__(self):
        skip, self._skip = self._skip, 0
        return (self.items[i] for i in range(skip, self.n))


def test_iterable_loader_batches_the_stream_in_jax_order():
    kw = dict(dataset="synthetic", height=16, width=24, num_points=16, downsample_input_coord=2)
    ours = Loader(_Stream(DataConfig(**kw), 11, lambda c, m, max_len: SyntheticScenes(
        c, m, max_len=max_len, use_native=False)), 3)
    theirs = JLoader(_Stream(JDataConfig(**kw), 11, lambda c, m, max_len: JSyntheticScenes(
        c, m, max_len=max_len, use_native=False)), 3, num_workers=1)
    assert len(ours) == len(theirs) == 3
    got, want = list(ours), list(theirs)
    assert [b.sceneid.tolist() for b in got] == [np.asarray(b.sceneid).tolist() for b in want] == \
        [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    for g, w in zip(got, want):
        assert g.input_images.numpy().tobytes() == np.asarray(w.input_images).tobytes()


def test_train_cli_skips_consumed_stream_items_on_resume(tmp_path, monkeypatch, capsys):
    """A resume over an iterable dataset skips the items the current epoch
    already consumed (train.py:307-313), and says so."""
    from gta_tpu_torch.data import registry

    streams = []

    def stream(mode, cfg, full_scale=False, max_len=None, seed=0):
        cfg = dataclasses.replace(cfg, dataset="synthetic")
        streams.append(_Stream(cfg, max_len or 10))
        return streams[-1]

    monkeypatch.setattr(registry, "get_dataset", stream)
    path = _tiny_yaml(tmp_path)
    base = [path, str(tmp_path / "data"), "--outdir", str(tmp_path / "run"), "--device", "cpu"]
    t_train.main(base + ["--exit-after", "1"])
    assert "Skipping" not in capsys.readouterr().out
    t_train.main(base + ["--exit-after", "2"])
    out = capsys.readouterr().out
    assert "Resumed from checkpoint at it=2" in out and "Skipping 4 already-consumed stream items." in out
    assert streams[-2].skipped == [4] and "it=2, loss=" in out


def test_train_then_evaluate_clis_on_a_datapath(tmp_path, clevr_root, capsys):
    """`python -m gta_tpu_torch.train <config> <datapath>` then `evaluate
    <config> <datapath> --ckpt best` on the CLEVR-TR fixture, on the CPU:
    the CLEVR-TR reader (not the synthetic fallback), 120x160 inputs and
    240x320 full-scale views."""
    path = _tiny_yaml(tmp_path)
    run = str(tmp_path / "run")
    t_train.main([path, clevr_root, "--outdir", run, "--device", "cpu", "--exit-after", "1", "--evalnow",
                  "--max-eval", "1"])
    out = capsys.readouterr().out
    assert "Loading training set (clevrtr)" in out and "synthetic" not in out
    assert "New best model (psnr" in out and "Iteration limit reached" in out
    got = t_evaluate.main([path, clevr_root, "--device", "cpu", "--outdir", run, "--ckpt", "best",
                           "--max-scenes", "1"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint best" in out and "synthetic" not in out
    assert "Evaluating 1 scenes of CLEVRTR (test split) at 240x320 full-scale views" in out
    assert got["n_scenes"] == 1 and got["ckpt"] == "best" and np.isfinite([got["psnr"], got["ssim"]]).all()
