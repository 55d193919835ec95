"""chip_smoke.py's gradient checks on the flagship over many scene pairs
from both synthetic renderers, and whether they catch a planted fault.

Usage (one CUDA card), from the repository root:
    python -m gta_tpu_torch.scripts.probe_grad_scenes [--pairs 6]

The flagship (runs/clevrtr/GTA/gta, full width, dropout 0, random weights
from the config's seed) takes B=2 steps on training scenes (2p, 2p + 1),
p < --pairs, from the numpy renderer and from the host renderer
(`SyntheticScenes(use_native=...)`), each through chip_smoke.grads_phase
as the smoke run holds its own pair: each attention call's q, k, v
cotangents and a fused GTA call's rep-matrix cotangents (dMq, dMk, dMo)
against the call's float64 VJP (CALL_TOL + CALL_RULE x the plain fp32
version's error), the whole gradient's error against a float64 step at
most TOL above the plain attention's, each trans_coeff scalar's error at
most TC_TOL x the sum of its terms' absolute values; pass or fail, and the
numbers. Then, on the first pair of each renderer, the same checks with
each of two planted faults, swapped into the card's kernel step by
`card_entry`: the cotangent dq of the first attention call scaled by
(1 + 1e-3), and that call's dMk (the fused backward kernel's cotangent of
the key-side rep matrix) scaled by (1 + 1e-3); each must fail them. Exits
0 when every clean pair passes and every planted fault is caught.

An earlier version of this script (git history) held the old checks
(per-tensor relative L2 card vs CPU, trans_coeff to 2e-3) and measured
kappa, each call's cancellation; grads_phase now takes both into its
checks.
"""

from __future__ import annotations

import argparse
import dataclasses

CONFIG = "runs/clevrtr/GTA/gta/config.yaml"


class _ScaleGrad:
    """x in the forward, the cotangent times `factor` in the backward (built
    on first use: torch is imported inside the functions)."""

    fn = None

    @classmethod
    def apply(cls, x, factor):
        import torch

        if cls.fn is None:
            class Fn(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x, f):
                    ctx.f = f
                    return x.view_as(x)

                @staticmethod
                def backward(ctx, g):
                    return g * ctx.f, None
            cls.fn = Fn
        return cls.fn.apply(x, factor)


def planted_dq_fault(entry, factor=1 + 1e-3):
    """`entry` (the fused GTA kernels' entry) with the cotangent of the first
    call's q scaled by `factor`."""
    calls = {"n": 0}

    def wrapped(qB, kB, vB, *args):
        calls["n"] += 1
        if calls["n"] == 1:
            qB = _ScaleGrad.apply(qB, factor)
        return entry(qB, kB, vB, *args)
    return wrapped


def planted_dm_fault(entry, factor=1 + 1e-3):
    """`entry` (the fused GTA kernels' entry) with the first call's dMk, the
    cotangent the backward kernel returns for the key-side rep matrix,
    scaled by `factor` (the table goes to the kernel through `_ScaleGrad`)."""
    from gta_tpu_torch.ops import gta_fused as tgf

    calls = {"n": 0}

    def wrapped(*args):
        calls["n"] += 1
        if calls["n"] > 1:
            return entry(*args)
        build = tgf.fused_tables

        def tables(*a):
            t = build(*a)
            return t if t.mk is None else dataclasses.replace(t, mk=_ScaleGrad.apply(t.mk, factor))
        tgf.fused_tables = tables
        try:
            return entry(*args)
        finally:
            tgf.fused_tables = build
    return wrapped


FAULTS = {"dq": planted_dq_fault, "dMk": planted_dm_fault}


def checks(pairs: int):
    """chip_smoke.grads_phase on every pair of both renderers, then with each
    planted fault on the first pair of each; prints a summary line per
    renderer and returns True when every clean pair passes and every
    planted fault is caught."""
    import chip_smoke
    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.train.trainer import Trainer

    cfg = load_config(CONFIG)
    m = cfg.model
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, dropout=0.0), decoder=dataclasses.replace(m.decoder, dropout=0.0)))
    card, cpu = Trainer(cfg), Trainer(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    ok = True
    for native in (False, True):
        renderer = "native" if native else "numpy"
        results = []
        for p in range(pairs):
            items = (2 * p, 2 * p + 1)
            try:
                results.append((True, chip_smoke.grads_phase(cfg, f"probe {renderer}", items, (card, cpu),
                                                             native=native)))
            except AssertionError as e:
                print(f"probe {renderer} items {items}: FAILED {e}", flush=True)
                results.append((False, None))
        caught = {}
        for fault, plant in FAULTS.items():
            try:
                chip_smoke.grads_phase(cfg, f"probe {renderer} planted {fault}", (0, 1), (card, cpu), plant,
                                       native=native)
                caught[fault] = False
            except AssertionError as e:
                caught[fault] = True
                print(f"probe {renderer} planted {fault} fault caught: {e}", flush=True)
        passed = sum(r[0] for r in results)
        worst = [max(r[1][i] for r in results if r[0]) if passed else None for i in (0, 1, 2)]
        print(f"probe {renderer}: {passed}/{pairs} pairs pass (largest excess of the whole gradient's error against "
              f"fp64 over the plain attention's {worst[0]}, limit {chip_smoke.TOL}; largest trans_coeff error over "
              f"its terms {worst[1]}, limit {chip_smoke.TC_TOL}; largest call cotangent error over its limit "
              f"{worst[2]}, limit 1); planted faults: "
              + ", ".join(f"{f} {'caught' if c else 'NOT caught'}" for f, c in caught.items()), flush=True)
        ok = ok and passed == pairs and all(caught.values())
    return ok


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=6)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    raise SystemExit(0 if checks(a.pairs) else 1)


if __name__ == "__main__":
    main()
