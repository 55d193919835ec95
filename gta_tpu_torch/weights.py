"""Weights across frameworks: the JAX package's flax params -> the port's
state_dict.

The port names its parameters after the reference PyTorch implementation's
state_dict keys, so the map is the reference key map: `flax_path_to_torch_key`
is the port's own copy of the JAX package's utils/ref_import.py:223-286
mapping: every attention method's parameters (tau as `attend.tau`, rpe's
q/k/v_bias, gbt's geo_weights, ape/mln's linear*, repast's to_q/to_k/to_v,
elementwise_mul's rep_to_vec), the encoder's lin_ray, frustum_phi.{0,2}
and FTL's top-level trans_coeff. Orientation: Dense kernels
[in, out] -> Linear weights [out, in]; Conv kernels HWIO -> OIHW; the fused
to_qkv column order q|k|v carries over unchanged. No so3 basis change is
applied: the port's reps use the JAX package's basis as it is.

The DiT (models/dit.py) names its parameters after the flax modules, so
its paths map as they are: `block_{i}/attn/to_qkv/kernel` ->
`block_{i}.attn.to_qkv.weight`, an Embed's `embedding` -> `weight`
(`y_embed.table.weight`, [num_classes + 1, hidden] as it is).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """Map a flax param path (relative to the {'params': ...} root) to the
    reference's torch parameter key."""
    out = []
    n = len(path)
    for i, t in enumerate(path):
        leaf = "weight" if i + 1 < n and path[i + 1] in ("kernel", "scale") else "bias"
        if t.startswith("conv") and t[4:].isdigit() and i + 2 < n:
            j = int(path[i + 1].split("_")[1])  # Conv_{j}
            return ".".join(out + [f"conv_blocks.{t[4:]}.layers.{2 * j}.weight"])
        if t.startswith("norm_attn_") or t.startswith("norm_ff_"):
            which = 0 if t.startswith("norm_attn_") else 1
            return ".".join(out + [f"layers.{t.rsplit('_', 1)[1]}.{which}.norm.{leaf}"])
        if t.startswith("attn_"):
            idx = t[len("attn_"):]
            sub = list(path[i + 1 :])
            if sub == ["tau"]:  # the adjustable softmax's temperature
                return ".".join(out + [f"layers.{idx}.0.fn.attend.tau"])
            if sub[0] == "to_out":  # Sequential(linear, dropout)
                return ".".join(out + [f"layers.{idx}.0.fn.to_out.0.{'weight' if sub[1] == 'kernel' else 'bias'}"])
            if sub[-1] in ("kernel", "bias"):
                return ".".join(out + [f"layers.{idx}.0.fn"] + sub[:-1] + ["weight" if sub[-1] == "kernel" else "bias"])
            return ".".join(out + [f"layers.{idx}.0.fn"] + sub)  # trans_coeff, *_bias, geo_weights
        if t.startswith("ff_"):
            dense = {"Dense_0": "0", "Dense_1": "3"}[path[i + 1]]
            leaf = "weight" if path[i + 2] == "kernel" else "bias"
            return ".".join(out + [f"layers.{t[len('ff_'):]}.1.fn.net.{dense}.{leaf}"])
        for stem, step in (("input_mlp", 2), ("frustum_phi", 2), ("render_mlp", 2)):
            if t.startswith(stem) and t[len(stem):].isdigit():
                return ".".join(out + [f"{stem}.{step * int(t[len(stem):])}.{leaf}"])
        if t == "render_mlp_out":
            return ".".join(out + [f"render_mlp.8.{leaf}"])
        if t == "ftl_trans_coeff":
            return "trans_coeff"
        if i == n - 1 and t in ("kernel", "bias", "embedding"):
            return ".".join(out + ["bias" if t == "bias" else "weight"])
        out.append(t)
    return ".".join(out)


def _flatten(tree: Mapping, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def _orient(path: Tuple[str, ...], value: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:  # Dense [in, out] -> Linear [out, in]
        return value.T
    if value.ndim == 4:  # Conv HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    raise ValueError(f"unexpected kernel rank {value.ndim} at {'/'.join(path)}")


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (a nested mapping of arrays, with or without the
    'params' root) -> a state_dict for the port's model."""
    if "params" in params:
        params = params["params"]
    return {
        flax_path_to_torch_key(path): torch.tensor(_orient(path, value), dtype=torch.float32)
        for path, value in _flatten(params).items()
    }
