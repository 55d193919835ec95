"""What decides `correct`: the program's outputs on the timed path against
the plain reference (portbench/reference.py), after the window, with the
program's state freed.

Training (the three set-up steps, which go through the window's own call):
  loss_gap    the largest |loss - ref| / ref over the three steps;
  grad_gap    over the leaves, the largest gap between the program's and
              the reference's norm of the first step's gradient (each
              from AdamW's first moment after one step), over the larger
              of the reference leaf's norm and the median leaf's;
  change_gap  the same for each leaf's change over the three steps,
              leaving out leaves whose reference gradient is under a
              thousandth of the median leaf's (they move by round-off);
              it catches a leaf left unmoved or moved double (reads 1);
  change_total_gap  the gap between the whole model's change norms (over
              those leaves), over the reference's: steady from seed to
              seed, where the worst leaf swings with the noise of one
              small leaf in the later steps (the output layer's read 10x
              its usual gap on a sound seed). A fault that shifts every
              leaf's change, as half a batch left out does, moves it.
Rendering (the frames of the calls the driver sampled):
  pixel_max_err  the largest |pixel - ref| over every channel of every
                 sampled frame;
  pixel_rms_err  the root mean square of those differences.
Each number has its limit in portbench/limits/<workload>.json.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict

import torch

from portbench import reference

HERE = Path(__file__).resolve().parent


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> list:
    names = [k for k in ref if keep is None or k in keep]
    floor = statistics.median(ref[k] for k in ref)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor) for k in names]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    g_med = statistics.median(ref["grad_norms"].values())
    moved = {k for k, g in ref["grad_norms"].items() if g >= 1e-3 * g_med}
    total = {side: math.sqrt(sum(r["change_norms"][k] ** 2 for k in moved))
             for side, r in (("prog", prog), ("ref", ref))}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": max(leaf_gaps(prog["grad_norms"], ref["grad_norms"])),
        "change_gap": max(leaf_gaps(prog["change_norms"], ref["change_norms"], moved)),
        "change_total_gap": abs(total["prog"] - total["ref"]) / total["ref"],
    }


def reference_train(config: dict, weights, readings: dict, seed: int, precision: str = "fp32") -> dict:
    return reference.train_readings(config, weights, readings["batches"], seed, precision)


def frame_numbers(frames, refs) -> Dict[str, float]:
    diff = torch.cat([(torch.as_tensor(f, device=r.device) - r).reshape(-1) for f, r in zip(frames, refs)])
    return {"pixel_max_err": float(diff.abs().max()), "pixel_rms_err": float(diff.square().mean().sqrt())}


def reference_frames(config: dict, weights, readings: dict, precision: str = "fp32"):
    h, w = readings["height"], readings["width"]
    return [reference.render(config, weights, inputs, novel, h, w, precision)
            for _, inputs, novel in readings["frames"]]


def numbers(config: dict, traffic: dict, weights, readings: dict, seed: int, precision: str = "fp32"):
    """The compared numbers of the program's readings against the reference
    at `precision` (fp32; fp8 is the control)."""
    if traffic["entry"] == "train_step":
        return train_numbers(readings, reference_train(config, weights, readings, seed, precision))
    return frame_numbers([f for f, _, _ in readings["frames"]], reference_frames(config, weights, readings, precision))


def limits(workload: str) -> Dict[str, float]:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]


def verdict(values: Dict[str, float], lim: Dict[str, float]) -> bool:
    return all(math.isfinite(v) and v <= lim[k] for k, v in values.items())
