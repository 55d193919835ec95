"""PNG codec over zlib and numpy: the port's one reader and writer of PNGs.

The dataset readers decode their frames and masks with `imread`, where the
JAX package calls imageio or PIL (gta_tpu/data/clevrtr.py:26-34,
re10k.py:94-102), which the machines that run the port on a GPU do not
have. `imread` returns what `imageio.v2.imread` returns for the same file:
uint8, [H, W] for gray, [H, W, 2] gray + alpha, [H, W, 3] RGB, [H, W, 4]
RGBA, and a palette image expanded through its PLTE to [H, W, 3] (imageio
ignores a tRNS chunk there, and so does this decoder).

Decoded: colour types 0, 2, 3, 4 and 6 at bit depth 8, not interlaced,
every scanline filter (None, Sub, Up, Average, Paeth, mixed from row to
row), the image data split over any number of IDAT chunks. Every chunk's
CRC is checked. Adam7 interlacing, other bit depths, a bad CRC, a missing
chunk or a truncated file raise ValueError naming the file.

Speed: rows filtered only by None, Sub and Up decode in a few whole-array
steps (Sub is a cumulative sum mod 256 along the row, a run of Up rows one
along the columns). Average and Paeth need the decoded left neighbour and
the decoded pixel above, so an image with any such row decodes as an
anti-diagonal wavefront: h + w - 1 numpy steps, pixel (y, x) in step
y + x, each row's filter picked by a mask. `imread_stack` runs one
wavefront for all the images of one shape it is given (a scene's views),
so the steps' fixed cost is paid once.

`encode_png` / `write_png` write the same colour types, with a `filter`
argument (0-4 for every row, or one per row) so the tests and the chip
smoke can write every filter type, and tEXt chunks.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> colour type (no palette)


def _chunks(data: bytes, name: str):
    """(kind, body) of every chunk up to IEND, each CRC checked."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"{name}: truncated PNG (in a {kind!r} chunk)")
        body = data[pos + 8 : pos + 8 + n]
        if struct.unpack(">I", data[end - 4 : end])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{name}: bad CRC in a {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: left a, up b, upper-left c."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_linear(f: np.ndarray, ft: np.ndarray) -> np.ndarray:
    """Rows filtered by None (0), Sub (1) and Up (2) only: f [h, w, bpp]
    uint8, ft [h]. uint8 sums wrap mod 256, as the filters do."""
    out = f.copy()
    sub = ft == 1
    if sub.any():
        out[sub] = np.cumsum(f[sub], axis=1, dtype=np.uint8)
    up = ft == 2
    up[0] = False  # the row above the first is zero: Up is None there
    if up.any():
        # a run of Up rows adds its rows to the last other row before it
        rows = np.arange(len(ft))
        start = np.maximum.accumulate(np.where(up, 0, rows))
        cum = np.cumsum(f, axis=0, dtype=np.uint8)
        ys = rows[up]
        out[ys] = out[start[ys]] + cum[ys] - cum[start[ys]]
    return out


def _unfilter_wavefront(f: np.ndarray, ft: np.ndarray) -> np.ndarray:
    """Any mix of the five filters, for m images of one shape at once:
    f [m, h, w, bpp] uint8, ft [m, h]. Pixel (y, x) is decoded in step
    y + x, when its left, upper and upper-left neighbours are done. The
    decoded images sit in r with a zero row above and a zero column to the
    left; one step's pixels are then a slice of stride w in r (and w - 1
    in f)."""
    m, h, w, bpp = f.shape
    w1 = w + 1
    r = np.zeros((m, (h + 1) * w1, bpp), np.int16)
    ff = f.reshape(m, h * w, bpp).astype(np.int16)
    kinds = [(ft == k)[..., None] for k in range(5)]
    counts = [np.concatenate([[0], np.cumsum((ft == k).any(0))]) for k in range(5)]
    fstep = max(w - 1, 1)
    for t in range(h + w - 1):
        y0, y1 = max(0, t - w + 1), min(h - 1, t)
        n = y1 - y0 + 1
        i = (y0 + 1) * w1 + (t - y0) + 1
        span = (n - 1) * w + 1
        a = r[:, i - 1 : i - 1 + span : w]
        b = r[:, i - w1 : i - w1 + span : w]
        pred = np.zeros((m, n, bpp), np.int16)
        if counts[1][y1 + 1] > counts[1][y0]:
            pred = np.where(kinds[1][:, y0 : y1 + 1], a, pred)
        if counts[2][y1 + 1] > counts[2][y0]:
            pred = np.where(kinds[2][:, y0 : y1 + 1], b, pred)
        if counts[3][y1 + 1] > counts[3][y0]:
            pred = np.where(kinds[3][:, y0 : y1 + 1], (a + b) >> 1, pred)
        if counts[4][y1 + 1] > counts[4][y0]:
            c = r[:, i - w1 - 1 : i - w1 - 1 + span : w]
            pred = np.where(kinds[4][:, y0 : y1 + 1], _paeth(a, b, c), pred)
        j = y0 * w + (t - y0)
        r[:, i : i + span : w] = (ff[:, j : j + (n - 1) * fstep + 1 : fstep] + pred) & 255
    return r.reshape(m, h + 1, w1, bpp)[:, 1:, 1:].astype(np.uint8)


def _parse(data: bytes, name: str):
    """(header (w, h, colour), filtered scanlines [h, 1 + w * bpp], palette,
    {tEXt key: value}) of PNG bytes, every rejection raised here."""
    header, palette, idat, text = None, None, [], {}
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: IHDR chunk of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            key, value = body.split(b"\0", 1)
            text[key.decode("latin-1")] = value.decode("latin-1")
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if interlace:
        raise ValueError(f"{name}: Adam7-interlaced PNGs are not supported")
    if depth != 8:
        raise ValueError(f"{name}: bit depth {depth} is not supported (8 only)")
    if colour not in _CHANNELS:
        raise ValueError(f"{name}: colour type {colour} is not a PNG colour type")
    if compression or filter_method:
        raise ValueError(f"{name}: unknown compression or filter method")
    if colour == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    if not idat:
        raise ValueError(f"{name}: no IDAT chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from e
    stride = w * _CHANNELS[colour]
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{name}: image data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{name}: unknown scanline filter type {int(rows[:, 0].max())}")
    return (w, h, colour), rows, palette, text


def _expand(img: np.ndarray, colour: int, palette) -> np.ndarray:
    """Decoded samples [..., h, w, bpp] as imageio returns them."""
    if colour == 3:
        # as PIL, which imageio decodes through: indices past the palette
        # read black
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette[:256]
        return full[img[..., 0]]
    return img[..., 0] if colour == 0 else img


def decode_pngs(datas: Sequence[bytes], names: Sequence[str]):
    """[(image as `imread` returns it, {tEXt key: value})] of PNG bytes.
    Images of one shape and colour type that need the wavefront decode in
    one, so its steps are paid once for all of them."""
    parsed = [_parse(d, n) for d, n in zip(datas, names)]
    out = [None] * len(parsed)
    groups: Dict[tuple, list] = {}
    for k, (header, rows, palette, text) in enumerate(parsed):
        w, h, colour = header
        f = rows[:, 1:].reshape(h, w, _CHANNELS[colour])
        ft = rows[:, 0]
        if (ft >= 3).any():
            groups.setdefault(header, []).append(k)
        else:
            out[k] = (_expand(_unfilter_linear(f, ft), colour, palette), text)
    for (w, h, colour), ks in groups.items():
        f = np.stack([parsed[k][1][:, 1:] for k in ks]).reshape(len(ks), h, w, _CHANNELS[colour])
        imgs = _unfilter_wavefront(f, np.stack([parsed[k][1][:, 0] for k in ks]))
        for k, img in zip(ks, imgs):
            out[k] = (_expand(img, colour, parsed[k][2]), parsed[k][3])
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, Dict[str, str]]:
    """(image as `imread` returns it, {tEXt key: value}) of PNG bytes."""
    return decode_pngs([data], [name])[0]


def read_png(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """(image, {tEXt key: value}) of the PNG file at `path`."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def imread(path: str) -> np.ndarray:
    """The PNG file at `path` as `imageio.v2.imread` returns it."""
    return read_png(path)[0]


def imread_stack(paths: Sequence[str]) -> np.ndarray:
    """The PNG files at `paths`, of one shape, stacked: [n, ...] as
    `np.stack([imread(p) for p in paths])`, decoded together."""
    datas = []
    for p in paths:
        with open(p, "rb") as f:
            datas.append(f.read())
    imgs = [img for img, _ in decode_pngs(datas, paths)]
    if len({img.shape for img in imgs}) > 1:
        raise ValueError(f"images of different shapes: {dict(zip(paths, (img.shape for img in imgs)))}")
    return np.stack(imgs)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _filter(img: np.ndarray, ft: np.ndarray) -> np.ndarray:
    """Filtered scanlines [h, 1 + w * bpp] of img [h, w, bpp] uint8, row y
    by filter ft[y]."""
    h, w, bpp = img.shape
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    out = ((x - preds[ft, np.arange(h)]) & 255).astype(np.uint8)
    return np.concatenate([ft.astype(np.uint8)[:, None], out.reshape(h, w * bpp)], axis=1)


def encode_png(
    img: np.ndarray,
    filter: Union[int, Sequence[int]] = 0,
    palette: Optional[np.ndarray] = None,
    text: Optional[Dict[str, str]] = None,
) -> bytes:
    """PNG bytes of a uint8 image: [H, W] or [H, W, 1] gray, [H, W, 2] gray
    + alpha, [H, W, 3] RGB, [H, W, 4] RGBA; with `palette` ([N, 3] uint8,
    N <= 256), img is [H, W] palette indices (colour type 3). `filter`:
    one filter type (0-4) for every scanline, or one per scanline. `text`
    becomes tEXt chunks (Latin-1) after IHDR (and PLTE); the data, zlib
    level 6, goes into one IDAT chunk."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, bpp = img.shape
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        if bpp != 1 or palette.ndim != 2 or palette.shape[1] != 3 or not 1 <= len(palette) <= 256:
            raise ValueError(f"a palette image takes [H, W] indices and an [N <= 256, 3] palette, "
                             f"got {img.shape} and {palette.shape}")
        colour = 3
    elif bpp in _COLOUR_TYPE:
        colour = _COLOUR_TYPE[bpp]
    else:
        raise ValueError(f"encode_png takes 1-4 channels, got {img.shape}")
    ft = np.broadcast_to(np.asarray(filter, np.int64), (h,))
    if ft.min() < 0 or ft.max() > 4:
        raise ValueError(f"filter types are 0-4, got {sorted(set(ft.tolist()))}")
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", palette.tobytes()))
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1")))
    data = zlib.compress(_filter(np.ascontiguousarray(img), ft).tobytes(), 6)
    out += [_chunk(b"IDAT", data), _chunk(b"IEND", b"")]
    return b"".join(out)


def write_png(path: str, img: np.ndarray, **kwargs) -> None:
    """Write `encode_png(img, **kwargs)` to `path`."""
    data = encode_png(img, **kwargs)
    with open(path, "wb") as f:
        f.write(data)
