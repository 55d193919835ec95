"""Pixel-coordinate grids and sinusoidal positional encodings.

`make_2dcoord` and `make_2dimgcoord` are numpy builders (static, computed
once per config); the encodings are torch functions. Semantics match the
reference framework's coordinate conventions (reference gta.py:9-28,
layers.py:52-96).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def make_2dcoord(h: int, w: int) -> np.ndarray:
    """Row-major normalized pixel coords in [0, 1), shape [h, w, 2].

    coord[i, j] = (i/h, j/w).
    """
    x = np.arange(h, dtype=np.float32) / h
    y = np.arange(w, dtype=np.float32) / w
    xg, yg = np.meshgrid(x, y, indexing="ij")
    return np.stack([xg, yg], -1).astype(np.float32)


def make_2dimgcoord(h: int, w: int) -> np.ndarray:
    """Image-convention coords (x right-to-left, y bottom-to-top), [h, w, 2]
    (reference gta.py:19-28)."""
    x = (np.arange(w, dtype=np.float32) / w)[::-1]
    y = (np.arange(h, dtype=np.float32) / h)[::-1]
    xg, yg = np.meshgrid(x, y, indexing="xy")
    return np.stack([xg, yg], -1).astype(np.float32)


def octave_posenc(coords: torch.Tensor, num_octaves: int, start_octave: int = 0) -> torch.Tensor:
    """Octave sin/cos encoding: [..., D] -> [..., 2*D*num_octaves].

    Output layout is (all sines, all cosines), each block grouped per input
    dim with octaves fastest-varying (reference layers.py:52-81).
    """
    shape = coords.shape[:-1]
    dim = coords.shape[-1]
    octaves = torch.arange(
        start_octave, start_octave + num_octaves, dtype=torch.float32, device=coords.device
    )
    mult = torch.pow(2.0, octaves) * math.pi  # [O]
    scaled = coords[..., None] * mult  # [..., D, O]
    sines = torch.sin(scaled).reshape(*shape, dim * num_octaves)
    cosines = torch.cos(scaled).reshape(*shape, dim * num_octaves)
    return torch.cat([sines, cosines], -1)


def ray_posenc(pos: torch.Tensor, rays: torch.Tensor, pos_octaves: int = 15,
               pos_start_octave: int = 0, ray_octaves: int = 15,
               ray_start_octave: int = 0) -> torch.Tensor:
    """Concatenated camera-position + ray-direction octave encoding
    (reference layers.py:84-96, 180 channels at the 15/15 default)."""
    return torch.cat(
        [
            octave_posenc(pos, pos_octaves, pos_start_octave),
            octave_posenc(rays, ray_octaves, ray_start_octave),
        ],
        -1,
    )
