"""How far the flagship's fp32 trans_coeff gradients on the card sit from
fp64, over many scene pairs from both synthetic renderers, and where the
error enters.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.probe_grad_scenes [--pairs 6]

The flagship (runs/clevrtr/GTA/gta, full width, dropout 0, random weights
from the config's seed) takes B=2 steps on training scenes (2p, 2p + 1),
p < --pairs, from the numpy renderer and from the host renderer
(`SyntheticScenes(use_native=...)`). Per pair:
  * the whole step, as chip_smoke.py's grads_phase compares it: the card
    through the kernels against the CPU (the largest relative L2 difference
    of a parameter tensor, held to 1e-4 there, and of a trans_coeff
    scalar, held to 2e-3), and each device's fp32 gradients against a
    float64 step on the card (plain attention, fp32 ray encodings): the
    largest excess of the card's error over the CPU's;
  * per attention call, on the inputs and output cotangent that the card's
    fp32 step gave that call: the kernel's trans_coeff cotangent and its
    dq, dk, dv against the plain version in fp64, beside the plain
    version's own error in fp32 on the card; and the cancellation of the
    call's trans_coeff cotangent, kappa = sum |dM * dM/dtc| / |sum dM *
    dM/dtc| over the entries of the matrices Mq, Mk, Mo (fp64).
A call whose cotangent is a sum with heavy cancellation (large kappa)
turns the kernel's small errors in dM into a large relative error of the
scalar; a fault in the kernel shows as an error in dq, dk, dv or in the
cotangent far above the plain version's at any kappa.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

CONFIG = "runs/clevrtr/GTA/gta/config.yaml"


def cast_reps(reps, dtype):
    """GeomReps with every floating tensor in `dtype`."""
    import torch

    def cast(x):
        if isinstance(x, tuple):
            return tuple(cast(y) for y in x)
        return x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x

    return dataclasses.replace(reps, **{f.name: cast(getattr(reps, f.name)) for f in dataclasses.fields(reps)})


def main():
    import torch

    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.models import decoder, encoder, layers
    from gta_tpu_torch.ops import flash_core as fc
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.gta import _blockdiag_mat
    from gta_tpu_torch.train.trainer import Trainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default="chiprun_out/probe_grad_scenes.jsonl")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = load_config(CONFIG)
    m = cfg.model
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, dropout=0.0), decoder=dataclasses.replace(m.decoder, dropout=0.0)))
    card, cpu = Trainer(cfg), Trainer(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    names = [n for n, _ in cpu.model.named_parameters()]
    kernel_gta = layers.fused_gta_attention_tokens

    def tables(reps, args, tc):
        """fused_tables with the matrices in tc's dtype (fused_tables makes
        them fp32 whatever the reps' dtype)."""
        t = tgf.fused_tables(reps, args, tc)
        mats = {f: None if getattr(t, f) is None else _blockdiag_mat(reps, args, tc, side, tc.dtype).transpose(-1, -2)
                for f, side in (("mq", "q"), ("mk", "k"), ("mo", "out"))}
        return dataclasses.replace(t, **mats)

    def plain_gta(qB, kB, vB, heads, reps, args, trans_coeff, scale):
        tgf.check_supported(reps, args, qB.shape[1], kB.shape[1])
        t = tables(reps, args, trans_coeff)
        return tgf.gta_fused_fwd_plain(qB.contiguous(), kB.contiguous(), vB.contiguous(), t, heads, scale)

    def plain_gta32(qB, kB, vB, heads, reps, args, trans_coeff, scale):
        """The whole-step reference's attention, as chip_smoke.py's grads_phase
        takes it: fp32 matrix tables in an fp64 step."""
        t = tgf.fused_tables(reps, args, trans_coeff)
        return tgf.gta_fused_fwd_plain(qB.contiguous(), kB.contiguous(), vB.contiguous(), t, heads, scale)

    def plain_flash(q, k, v, heads, scale):
        return fc.flash_core_fwd_plain(q.contiguous(), k.contiguous(), v.contiguous(), heads, scale)

    # the attention module each call comes from
    current = {"name": None}
    for name, mod in card.model.named_modules():
        if getattr(mod, "trans_coeff", None) is not None:
            mod.register_forward_pre_hook(lambda mod, args, name=name: current.update(name=name))

    def grads(trainer, batch):
        _, _, g = trainer.loss_and_grads(batch)
        return [x.detach().cpu().double() for x in g]

    def rel(x, r):
        return (x - r).norm().item() / max(r.norm().item(), 1e-300)

    def call_grads(fn, call, dtype):
        q, k, v = (x.to(dtype).requires_grad_() for x in call["qkv"])
        tc = call["tc"].to(dtype).requires_grad_()
        out = fn(q, k, v, call["heads"], cast_reps(call["reps"], dtype), call["args"], tc, call["scale"])
        return torch.autograd.grad(out, [q, k, v, tc], call["g"].to(dtype))

    def kappa(call):
        """sum |dM * dM/dtc| / |sum dM * dM/dtc| over the tables' entries, fp64."""
        d = torch.float64
        q, k, v = (x.to(d) for x in call["qkv"])
        reps, args, tc = cast_reps(call["reps"], d), call["args"], call["tc"].to(d)
        t = tables(reps, args, tc)
        t0 = tables(reps, args, torch.zeros_like(tc))
        t2 = tables(reps, args, 2 * tc)
        mats = [f for f in ("mq", "mk", "mo") if getattr(t, f) is not None]
        leaves = {f: getattr(t, f).detach().requires_grad_() for f in mats}
        out = tgf.gta_fused_fwd_plain(q, k, v, dataclasses.replace(t, **leaves), call["heads"], call["scale"])
        dms = torch.autograd.grad(out, list(leaves.values()), call["g"].to(d))
        terms, lin = [], 0.0
        for f, dm in zip(mats, dms):
            deriv = (getattr(t, f) - getattr(t0, f)) / tc
            lin = max(lin, rel((getattr(t2, f) - getattr(t, f)) / tc, deriv))  # M is linear in tc
            terms.append((dm * deriv).flatten())
        terms = torch.cat(terms)
        return terms.abs().sum().item() / max(terms.sum().abs().item(), 1e-300), terms.sum().item(), lin

    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    rows = []
    for native in (False, True):
        scenes = SyntheticScenes(cfg.data, "train", seed=cfg.seed, use_native=native)
        for p in range(a.pairs):
            t0 = time.perf_counter()
            batch = collate([scenes[2 * p], scenes[2 * p + 1]])
            calls = []

            def capture(qB, kB, vB, heads, reps, args, trans_coeff, scale):
                out = kernel_gta(qB, kB, vB, heads, reps, args, trans_coeff, scale)
                call = dict(name=current["name"], qkv=[x.detach() for x in (qB, kB, vB)], heads=heads, reps=reps,
                            args=args, tc=trans_coeff.detach(), scale=scale)
                out.register_hook(lambda g, call=call: call.update(g=g.detach()))
                calls.append(call)
                return out

            layers.fused_gta_attention_tokens = capture
            try:
                g_card = grads(card, batch)
            finally:
                layers.fused_gta_attention_tokens = kernel_gta
            g_cpu = grads(cpu, batch)
            posenc = encoder.ray_posenc

            def posenc_fp32(pos, rays, *args):
                return posenc(pos.float(), rays.float(), *args).to(pos.dtype)

            flash = layers.flash_attention
            layers.fused_gta_attention_tokens, layers.flash_attention = plain_gta32, plain_flash
            encoder.ray_posenc = decoder.ray_posenc = posenc_fp32
            try:
                card.model.double()
                batch64 = dataclasses.replace(batch, **{
                    f.name: getattr(batch, f.name).double() for f in dataclasses.fields(batch)
                    if getattr(batch, f.name) is not None and getattr(batch, f.name).is_floating_point()})
                g64 = grads(card, batch64)
            finally:
                card.model.float()
                layers.fused_gta_attention_tokens, layers.flash_attention = kernel_gta, flash
                encoder.ray_posenc = decoder.ray_posenc = posenc
            step = {"params": [], "trans_coeff": []}
            for n, gk, gc, gr in zip(names, g_card, g_cpu, g64):
                kind = "trans_coeff" if n.endswith("trans_coeff") else "params"
                step[kind].append(dict(name=n, card_vs_cpu=rel(gk, gc), card=rel(gk, gr), cpu=rel(gc, gr),
                                       value=gr.flatten()[0].item() if kind == "trans_coeff" else None))
            per_call = []
            for call in calls:
                ker = call_grads(kernel_gta, call, torch.float32)
                p32 = call_grads(plain_gta, call, torch.float32)
                p64 = call_grads(plain_gta, call, torch.float64)
                kap, dtc, lin = kappa(call)
                per_call.append(dict(
                    name=call["name"], kappa=kap, dtc=dtc, dtc_check=rel(p64[3].cpu(), torch.tensor([dtc], dtype=torch.float64)),
                    linearity=lin, tc_kernel=rel(ker[3].double(), p64[3]), tc_plain32=rel(p32[3].double(), p64[3]),
                    dqkv_kernel=max(rel(x.double(), r) for x, r in zip(ker[:3], p64[:3])),
                    dqkv_plain32=max(rel(x.double(), r) for x, r in zip(p32[:3], p64[:3]))))
            worst = {k: max(v, key=lambda r: r["card_vs_cpu"]) for k, v in step.items()}
            excess = {k: max(v, key=lambda r: r["card"] - r["cpu"]) for k, v in step.items()}
            row = dict(renderer="native" if native else "numpy", items=[2 * p, 2 * p + 1], step=step,
                       calls=per_call, seconds=time.perf_counter() - t0)
            rows.append(row)
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
            tc_ex = excess["trans_coeff"]
            print(f"{row['renderer']} items {row['items']}: card vs cpu params {worst['params']['card_vs_cpu']:.3e} "
                  f"({worst['params']['name']}), trans_coeff {worst['trans_coeff']['card_vs_cpu']:.3e} "
                  f"({worst['trans_coeff']['name']}); vs fp64, largest excess of the card over the CPU: params "
                  f"{excess['params']['card'] - excess['params']['cpu']:.3e}, trans_coeff "
                  f"{tc_ex['card'] - tc_ex['cpu']:.3e} ({tc_ex['name']}: card {tc_ex['card']:.3e} cpu "
                  f"{tc_ex['cpu']:.3e}, fp64 value {tc_ex['value']:.3e}) [{row['seconds']:.1f} s]", flush=True)
            for c in per_call:
                print(f"    {c['name']}: kappa {c['kappa']:.1f}; trans_coeff cotangent vs fp64 kernel "
                      f"{c['tc_kernel']:.3e} plain fp32 {c['tc_plain32']:.3e}; dq/dk/dv kernel {c['dqkv_kernel']:.3e} "
                      f"plain fp32 {c['dqkv_plain32']:.3e} (sum check {c['dtc_check']:.1e}, linear {c['linearity']:.1e})",
                      flush=True)
    # the summary: how often each check passes, by renderer
    for r in ("numpy", "native"):
        sel = [row for row in rows if row["renderer"] == r]
        tc = [max(x["card_vs_cpu"] for x in row["step"]["trans_coeff"]) for row in sel]
        pa = [max(x["card_vs_cpu"] for x in row["step"]["params"]) for row in sel]
        print(f"{r}: trans_coeff card vs cpu per pair {[f'{x:.2e}' for x in tc]} ({sum(x <= 2e-3 for x in tc)}/"
              f"{len(tc)} within 2e-3); params {[f'{x:.2e}' for x in pa]} ({sum(x <= 1e-4 for x in pa)}/{len(pa)} "
              f"within 1e-4)", flush=True)


if __name__ == "__main__":
    main()
