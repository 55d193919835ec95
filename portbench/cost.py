"""The work a call needs, counted from shapes, and the chip's peaks.

Rewritten from the port's smoke test (`chip_smoke.fused_cost`, `bwd_cost`,
`flash_cost`), which read the program's own table objects; here every count
comes from the attention call's shapes and the config's GTA options, so it
stays the same work whatever implements it. Each operand is counted once:
q, k, v (and the output's cotangent) read once, the outputs (and their
gradients) written once, the GTA tables (fp32) read once and their
cotangents written once.

`model_flops` counts a step's or a render's multiply-adds (two FLOPs each)
on the benchmark's plain reference with `torch.utils.flop_counter`, on the
meta device: forward and backward for a training step, nothing recomputed.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s, TF32 495, fp32 67
# (CUDA cores); HBM3 3.35 TB/s. Rates at the 700 W power limit.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
ELEM_BYTES = {"bf16": 2, "fp32": 4}


@dataclasses.dataclass(frozen=True)
class AttnCall:
    """One attention call: batch B, heads H, query / key tokens Tq / Tk,
    head width C, the query / key view counts, and the GTA options that set
    its transforms (`mats`: per-view C x C matrices, from SE(3) or SO(3);
    `rotors`: SO(2) rotor tables; `v_transform`)."""

    kernel: str  # "gta_fused" or "flash_core"
    B: int
    H: int
    Tq: int
    Tk: int
    C: int
    nq: int = 1
    nk: int = 1
    mats: bool = False
    rotors: bool = False
    v_transform: bool = True
    backward: bool = False


def _tables(c: AttnCall) -> float:
    """fp32 elements of a fused GTA call's tables: per-view matrices for q,
    k and the output, full-width rotor cos / sin of both sides."""
    n = 0.0
    if c.mats:
        n += c.B * c.C * c.C * (c.nq + c.nk + c.nq * c.v_transform)
    if c.rotors:
        n += 2.0 * c.B * c.C * (c.Tq + c.Tk)
    return n


def _mats(c: AttnCall) -> float:
    return c.B * c.C * c.C * (c.nq + c.nk + c.nq * c.v_transform) if c.mats else 0.0


def work(c: AttnCall, precision: str) -> tuple:
    """(flops, bytes) of one call, forward or backward."""
    elem = ELEM_BYTES[precision]
    B, H, Tq, Tk, C = c.B, c.H, c.Tq, c.Tk, c.C
    D = H * C
    if c.kernel == "flash_core":
        if c.backward:
            return 10.0 * B * H * Tq * Tk * C, elem * B * (2.0 * Tq * D + 2 * Tk * D) + elem * B * (Tq * D + 2 * Tk * D)
        return 4.0 * B * H * Tq * Tk * C, elem * B * (Tq * D + 2 * Tk * D) + elem * B * Tq * D
    m = 1.0 if c.mats else 0.0
    if c.backward:
        flops = 5 * 2.0 * Tq * Tk * C + 2 * 2.0 * C * C * m * (Tq * (1 + c.v_transform) + Tk * (1 + c.v_transform))
        return flops * B * H, elem * (4.0 * B * Tq * D + 4 * B * Tk * D) + 4.0 * (_tables(c) + _mats(c))
    flops = 4.0 * Tq * Tk * C + 2.0 * C * C * m * (Tq * (1 + c.v_transform) + Tk * (1 + c.v_transform))
    return flops * B * H, elem * (2.0 * B * Tq * D + 2 * B * Tk * D) + 4.0 * _tables(c)


def bound_s(calls: List[AttnCall], precision: str) -> float:
    """The least time the calls need on the chip: for each, the larger of
    its FLOPs over the peak and its bytes over the bandwidth."""
    peak = PEAK_FLOPS[precision]
    return sum(max(f / peak, b / PEAK_BYTES) for f, b in (work(c, precision) for c in calls))


def attention_calls(sizes: dict, attn: dict, traffic: dict) -> List[AttnCall]:
    """The attention calls of one unit of a cell's traffic: a training step
    (every layer's forward and backward at the batch) or a render call
    (forwards: the encoder at the call's scenes, the decoder once per chunk
    of the full frame)."""
    d, e, dec = sizes["data"], sizes["encoder"], sizes["decoder"]
    kernel = "gta_fused" if attn["method"] == "gta" else "flash_core"
    fd = attn["f_dims"]
    gta = dict(mats=bool(fd.get("se3") or fd.get("so3")), rotors=bool(fd.get("so2"))) if kernel == "gta_fused" else {}
    tokens = d["num_input_views"] * d["tokens_per_view"]
    views = dict(nk=d["num_input_views"]) if kernel == "gta_fused" else {}
    enc = AttnCall(kernel, 0, e["heads"], tokens, tokens, e["attdim"] // e["heads"], nq=views.get("nk", 1), **views, **gta)
    if traffic["entry"] == "train_step":
        B = traffic["batch_size"]
        q_views = dict(nq=d["num_target_views"]) if kernel == "gta_fused" else {}
        dcall = AttnCall(kernel, B, dec["heads"], d["num_points"], tokens, dec["dim_head"], **q_views, **views, **gta)
        calls = [dataclasses.replace(enc, B=B)] * e["num_att_blocks"] + [dcall] * dec["num_att_blocks"]
        return calls + [dataclasses.replace(c, backward=True) for c in calls]
    B, pixels = traffic["scenes_per_call"], d["height"] * d["width"]
    chunk = traffic["chunk"]
    q_views = dict(nq=1) if kernel == "gta_fused" else {}
    dcall = AttnCall(kernel, B, dec["heads"], chunk, tokens, dec["dim_head"], **q_views, **views, **gta)
    return [dataclasses.replace(enc, B=B)] * e["num_att_blocks"] + [dcall] * (dec["num_att_blocks"] * (
        -(-pixels // chunk)))


def model_flops(config: dict, traffic: dict) -> float:
    """FLOPs of one unit of the traffic on the plain reference (meta
    tensors, counted by torch.utils.flop_counter): a training step's
    forward and backward at one scene times the batch, or a render call's
    forward at one scene and one chunk times the call's scenes and
    chunks."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import Model, Precision, Run

    sizes = config["sizes"]
    d = sizes["data"]
    NI, NT, H, W = d["num_input_views"], d["num_target_views"], d["height"], d["width"]
    meta = torch.device("meta")
    model = Model(config).to(meta)
    f = lambda *s: torch.zeros(s, device=meta)  # noqa: E731
    scene = {"input_images": f(1, NI, H, W, 3), "input_camera_pos": f(1, NI, 3), "input_rays": f(1, NI, H, W, 3),
             "input_transforms": f(1, NI, 4, 4), "input_coord": f(1, NI, d["tokens_per_view"], 2)}
    run = Run(Precision("fp32"))
    counter = FlopCounterMode(display=False)
    if traffic["entry"] == "train_step":
        P = d["num_points"] // NT
        scene.update(target_pixels=f(1, NT * P, 3), target_rays=f(1, NT * P, 3), target_camera_pos=f(1, NT * P, 3),
                     target_transforms=f(1, NT, 4, 4), target_coord=f(1, NT, P, 2))
        with counter:
            pred = model(scene, run)
            ((pred - scene["target_pixels"]) ** 2).mean().backward()
        return float(counter.get_total_flops()) * traffic["batch_size"]
    chunk, pixels = traffic["chunk"], H * W
    n = min(chunk, pixels)
    for p in model.parameters():
        p.requires_grad_(False)
    with counter:
        z, geo = model.encoder(scene, run)
        enc = counter.get_total_flops()
        query = {"camera_pos": f(1, n, 3), "rays": f(1, n, 3), "transforms": f(1, 1, 4, 4), "coord": f(1, 1, n, 2)}
        model.decoder(z, geo, query, run)
        dec = counter.get_total_flops() - enc
    return float(enc + dec * -(-pixels // chunk)) * traffic["scenes_per_call"]
