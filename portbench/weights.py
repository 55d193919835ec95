"""The benchmark's weights, made on the device from the seed.

One normal draw on the device covers every parameter of the reference
model of a config (its names are the program's too); each leaf takes its
slice, scaled by its kind: a matrix or kernel by 1 / sqrt(fan in), a
LayerNorm's scale 1 + 0.1 N, a bias or LayerNorm offset 0.02 N, the
decoder's constant query N, GTA's trans_coeff 0.01 (1 + 0.1 N), the
published initial value with a spread. The same dict loads into the
program and the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import Model
from portbench.scenes import generator

WEIGHT_SALT = 1


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{parameter name: fp32 tensor on `device`} for the config's model."""
    shapes = {k: p.shape for k, p in Model(config).named_parameters()}
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, WEIGHT_SALT, device), device=device)
    out, cur = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[cur:cur + n].reshape(shape)
        cur += n
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            x = x / math.sqrt(math.prod(shape[1:]))
        elif leaf == "trans_coeff":
            x = 0.01 * (1 + 0.1 * x)
        elif leaf == "initial_emb":
            pass
        elif leaf == "weight":  # a LayerNorm's scale
            x = 1 + 0.1 * x
        else:
            x = 0.02 * x
        out[name] = x.contiguous()
    return out
