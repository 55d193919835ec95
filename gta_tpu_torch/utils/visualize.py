"""Rendered-view / segmentation grid writer (the JAX package's
gta_tpu/utils/visualize.py).

`colorize_clusters` and `checkerboard_composite` are the JAX file's: the
same palette and the same board, bit for bit. `draw_visualization_grid`
keeps its signature and layout (one row per batch item, the columns in
order, each image clipped to [0, 1], written to `<path>.png`), with one
deliberate difference: it imports neither matplotlib nor PIL, which the
machines that run the port on a GPU do not have. It assembles the grid as
one numpy array and writes it with `write_png`, through the port's own
PNG codec (data/png.py: zlib and numpy); the column titles go into a PNG
tEXt chunk ("Columns") where matplotlib drew them above the first row.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from gta_tpu_torch.data import png

# distinct cluster colors for segmentation maps (reference visualize.py
# colorizes cluster ids over a checkerboard; a fixed palette here)
_PALETTE = np.array(
    [
        [0.894, 0.102, 0.110],
        [0.216, 0.494, 0.722],
        [0.302, 0.686, 0.290],
        [0.596, 0.306, 0.639],
        [1.000, 0.498, 0.000],
        [1.000, 1.000, 0.200],
        [0.651, 0.337, 0.157],
        [0.969, 0.506, 0.749],
        [0.600, 0.600, 0.600],
        [0.121, 0.471, 0.706],
        [0.682, 0.780, 0.910],
        [0.890, 0.467, 0.761],
    ],
    dtype=np.float32,
)
GAP = 2  # white pixels between the grid's cells


def colorize_clusters(ids: np.ndarray) -> np.ndarray:
    """Integer cluster maps [B, H, W] -> RGB [B, H, W, 3] via a fixed palette."""
    return _PALETTE[np.asarray(ids) % len(_PALETTE)]


def checkerboard_composite(rgba: np.ndarray, square: int = 8) -> np.ndarray:
    """Composite [..., H, W, 4] RGBA over the reference's light checkerboard
    (visualize.py:7-17): transparent regions show the board."""
    h, w = rgba.shape[-3:-1]
    yy, xx = np.meshgrid(np.arange(h) // square, np.arange(w) // square, indexing="ij")
    board = np.where(((yy + xx) % 2) == 0, 0.8, 0.6)[..., None].astype(np.float32)
    a = rgba[..., 3:4]
    return rgba[..., :3] * a + board * (1.0 - a)


def write_png(path: str, rgb: np.ndarray, text: Optional[Dict[str, str]] = None) -> None:
    """Write uint8 RGB [H, W, 3] as an 8-bit truecolor PNG (every scanline
    unfiltered), with `text` as tEXt chunks (Latin-1): the port's codec,
    data/png.py."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {rgb.shape}")
    png.write_png(path, rgb, text=text)


def read_png(path: str):
    """(image, {tEXt key: value}) of a PNG file (data/png.py)."""
    return png.read_png(path)


def draw_visualization_grid(columns, path: str):
    """columns: list of (title, data[, kind]) -> grid PNG at <path>.png.

    kind 'image' (default): data [B, H, W, 3] in [0, 1], or [B, H, W, 4]
    RGBA composited over a checkerboard (reference visualize.py:7-17).
    kind 'clustering': data [B, H, W] integer ids, palette-colorized.
    Rows are batch items, every image of one size; cells are GAP white
    pixels apart. Returns the uint8 grid [rows, cols, 3] it wrote.
    """
    cols = []
    for col in columns:
        title, data = col[0], col[1]
        kind = col[2] if len(col) > 2 else "image"
        if kind == "clustering":
            data = colorize_clusters(data)
        data = np.asarray(data)
        if data.ndim == 4 and data.shape[-1] == 4:
            data = checkerboard_composite(data)
        cols.append((title, data))

    n_rows, h, w = cols[0][1].shape[:3]
    grid = np.ones((n_rows * (h + GAP) - GAP, len(cols) * (w + GAP) - GAP, 3), np.float32)
    for c, (_, imgs) in enumerate(cols):
        for r in range(n_rows):
            y, x = r * (h + GAP), c * (w + GAP)
            grid[y : y + h, x : x + w] = np.clip(imgs[r], 0.0, 1.0)
    grid = np.round(grid * 255.0).astype(np.uint8)
    write_png(path + ".png", grid, {"Columns": " | ".join(t for t, _ in cols)})
    return grid
