"""The readings the limits of a cell's comparison are set from (run on the
chip, at the cell's own sizes; the benchmark's runs never run it):

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--fault-seeds <n> ...] [--faults <name> ...]

- program: the numbers portbench/check.py compares, of the program's timed
  path against the fp32 reference, one line a seed (the lower reading is
  their largest);
- control: the fp8 reference (portbench/reference.Precision) put in the
  program's place, against the fp32 reference, on the same inputs (the
  upper reading is their smallest);
- faults, planted in the program: for training, half the batch left out
  with the mean over the rest (`half_batch`); a step that leaves the state
  unchanged reads 1 on change_gap by the measure and needs no run. For
  rendering, half of each call's scenes left out (`half_batch`) and one
  frame of a call replaced by another scene's (`altered_answer`);
- two more readings of training, named with `--faults`: AdamW's weight
  decay left out (`no_weight_decay`), and the dropout masks drawn from
  another stream than the seed's (`other_dropout`), which shows how far
  the comparison leans on the program drawing its masks as the reference
  does.
Serving seeds drive a short window of `sample_calls` + 4 calls.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from contextlib import contextmanager

import torch

from portbench import check, drivers, run


@contextmanager
def fault(name: str):
    """The program with fault `name` planted (the Trainer's methods
    patched for the block's length)."""
    from gta_tpu_torch.parallel import dist as pdist
    from gta_tpu_torch.train.trainer import Trainer

    saved = {k: getattr(Trainer, k) for k in ("__init__", "_loss_fn", "render_image")}
    step_seed = pdist.step_seed
    if name == "half_batch":
        def loss_fn(self, batch):
            half = batch.target_pixels.shape[0] // 2
            return saved["_loss_fn"](self, dataclasses.replace(batch, **{
                f.name: getattr(batch, f.name)[:half] for f in dataclasses.fields(batch)
                if getattr(batch, f.name) is not None}))

        def render(self, batch, *a, **kw):
            out = saved["render_image"](self, batch, *a, **kw)
            out[out.shape[0] // 2:] = 0.0
            return out

        Trainer._loss_fn, Trainer.render_image = loss_fn, render
    elif name == "altered_answer":
        def render(self, batch, *a, **kw):
            out = saved["render_image"](self, batch, *a, **kw)
            out[0] = out[1]
            return out

        Trainer.render_image = render
    elif name == "no_weight_decay":
        def init(self, *a, **kw):
            saved["__init__"](self, *a, **kw)
            for group in self.optimizer.param_groups:
                group["weight_decay"] = 0.0

        Trainer.__init__ = init
    elif name == "other_dropout":
        pdist.step_seed = lambda seed, step, rank_=None: step_seed(seed + 1, step, rank_)
    elif name != "none":
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(Trainer, k, v)
        pdist.step_seed = step_seed


def program_run(config, traffic, seed, device, fault_name="none"):
    """(weights, readings) of the program's timed path for `seed`."""
    with fault(fault_name):
        drv = drivers.driver(config, traffic, seed, device)
        if traffic["entry"] == "render_image":
            for i in range(traffic["sample_calls"] + 4):
                drv.trace_step(i)
        readings, weights = drv.readings(), drv.weights
        drv.close()
    return weights, readings


def reference_side(config, traffic, weights, readings, seed, precision):
    if traffic["entry"] == "train_step":
        return check.reference_train(config, weights, readings, seed, precision)
    return check.reference_frames(config, weights, readings, precision)


def compare(traffic, prog, ref):
    if traffic["entry"] == "train_step":
        return check.train_numbers(prog, ref)
    return check.frame_numbers(prog, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=None, help="the faults of --fault-seeds (default: the cell's)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run.set_cache_dirs()
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, config, traffic = run.cell_files(bench, args.workload)
    faults = args.faults or ["half_batch"] + (["altered_answer"] if traffic["entry"] == "render_image" else [])
    rows = {"program": [], "control": [], **{f: [] for f in faults}}

    def emit(kind, seed, values):
        rows[kind].append(values)
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **values}), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        weights, readings = program_run(config, traffic, seed, args.device)
        ref = reference_side(config, traffic, weights, readings, seed, "fp32")
        if seed in args.seeds:
            prog = readings if traffic["entry"] == "train_step" else [f for f, _, _ in readings["frames"]]
            emit("program", seed, compare(traffic, prog, ref))
        if seed in args.control_seeds:
            emit("control", seed, compare(traffic, reference_side(config, traffic, weights, readings, seed, "fp8"), ref))
        del weights, readings, ref
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        for name in faults:
            weights, readings = program_run(config, traffic, seed, args.device, name)
            ref = reference_side(config, traffic, weights, readings, seed, "fp32")
            prog = readings if traffic["entry"] == "train_step" else [f for f, _, _ in readings["frames"]]
            emit(name, seed, compare(traffic, prog, ref))
    summary = {kind: {k: (max if kind == "program" else min)(r[k] for r in vals) for k in vals[0]}
               for kind, vals in rows.items() if vals}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
