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


def posenc_2d_grid(d_model: int, height: int, width: int) -> np.ndarray:
    """Fixed 2D transformer positional encoding [d_model, h, w] (reference
    common.py:115-140): a sin/cos ladder with base 10000, the first half
    of the channels over the width, the second half over the height."""
    if d_model % 4 != 0:
        raise ValueError(f"d_model must be divisible by 4, got {d_model}")
    pe = np.zeros((d_model, height, width), dtype=np.float32)
    half = d_model // 2
    div_term = np.exp(np.arange(0.0, half, 2) * -(np.log(10000.0) / half))  # [half/2]
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    pe[0:half:2] = np.sin(pos_w * div_term).T[:, None, :].repeat(height, 1)
    pe[1:half:2] = np.cos(pos_w * div_term).T[:, None, :].repeat(height, 1)
    pe[half::2] = np.sin(pos_h * div_term).T[:, :, None].repeat(width, 2)
    pe[half + 1 :: 2] = np.cos(pos_h * div_term).T[:, :, None].repeat(width, 2)
    return pe


def posenc_2d_coord(d_model: int, coord: torch.Tensor, scale=(1.0, 1.0)) -> torch.Tensor:
    """Coord-conditioned 2D positional encoding [..., 2] -> [..., d_model]
    (reference common.py:143-168): coord in [0, 1] rescaled by `scale` to
    pixel units; sin/cos interleaved over the width ladder, then the height
    ladder."""
    if d_model % 4 != 0:
        raise ValueError(f"d_model must be divisible by 4, got {d_model}")
    coord = coord * torch.tensor(scale, dtype=coord.dtype, device=coord.device)
    half = d_model // 2
    log_base = torch.log(torch.tensor(10000.0)) / half  # in fp32, as the JAX package takes it
    div_term = torch.exp(torch.arange(0.0, half, 2) * -log_base).to(coord.dtype).to(coord.device)
    h = coord[..., 0:1] * div_term
    w = coord[..., 1:2] * div_term
    pe_w = torch.stack([torch.sin(w), torch.cos(w)], -1).reshape(*coord.shape[:-1], -1)
    pe_h = torch.stack([torch.sin(h), torch.cos(h)], -1).reshape(*coord.shape[:-1], -1)
    return torch.cat([pe_w, pe_h], -1)
