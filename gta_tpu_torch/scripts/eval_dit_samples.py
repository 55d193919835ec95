"""The DiT family's sample metric, from a trained checkpoint.

Port of scripts/eval_dit_samples.py: samples --per-class class-conditional
images of every class (CFG + DDIM) and scores them with the training-free
spectral classifier (utils/stripe_classifier.py): the procedural classes
are oriented stripes whose orientation and frequency are functions of the
label, so class-conditional sample accuracy says whether the model learned
p(x|y). Also reports the per-class eval loss on held-out labelled images.
Prints one JSON line and writes it to <outdir>/dit_sample_eval.json.

Usage:
    python -m gta_tpu_torch.scripts.eval_dit_samples runs/imagenet/DiT/dit_gta/config.yaml \
        --outdir <run dir holding ckpts/> [--ckpt latest] [--per-class 24] [--steps 50]
        [--guidance 4.0] [--max-eval 200] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--outdir", required=True, help="run dir holding ckpts/")
    ap.add_argument("--ckpt", default="latest")
    ap.add_argument("--per-class", type=int, default=24)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance", type=float, default=4.0)
    ap.add_argument("--max-eval", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)

    from gta_tpu_torch.data.images import SyntheticImages, collate_images
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.dit_trainer import DiTTrainer, load_dit_config
    from gta_tpu_torch.utils.stripe_classifier import accuracy

    cfg = load_dit_config(args.config)
    mcfg = cfg.model
    trainer = DiTTrainer(cfg, device=args.device)
    ckpt = Checkpointer(args.outdir)
    if not ckpt.exists(args.ckpt):
        raise SystemExit(f"checkpoint '{args.ckpt}' not found under {args.outdir}/ckpts")
    ckpt.restore(args.ckpt, trainer)
    it = trainer.step
    print(f"Loaded {args.ckpt} at it={it}")

    # class-conditional samples, scored by the spectral classifier
    K, n = mcfg.num_classes, args.per_class
    labels = np.repeat(np.arange(K), n)
    chunk = max(K, 64 // max(1, n) * n)  # keep sample batches modest
    imgs = np.concatenate([
        trainer.sample(labels[i:i + chunk], seed=args.seed + i, steps=args.steps, guidance=args.guidance)
        for i in range(0, len(labels), chunk)
    ], 0)
    acc, per = accuracy(imgs, labels, K)

    # per-class eval loss on held-out labelled images
    ds = SyntheticImages(mcfg.input_size, mcfg.num_classes, "test", args.max_eval)
    ev = collate_images([ds[i] for i in range(args.max_eval)])
    losses = np.full(K, np.nan)
    for k in range(K):
        sel = ev["label"] == k
        if sel.any():
            m = trainer.evaluate([{"image": ev["image"][sel], "label": ev["label"][sel]}], seed=args.seed)
            losses[k] = m["loss"]

    result = {
        "config": args.config,
        "it": it,
        "per_class_n": n,
        "sample_class_accuracy": round(acc, 4),
        "per_class_accuracy": [round(float(x), 4) for x in per],
        "per_class_eval_loss": [round(float(x), 5) for x in losses],
        "eval_loss_mean": round(float(np.nanmean(losses)), 5),
        "steps": args.steps,
        "guidance": args.guidance,
    }
    print(json.dumps(result))
    out_path = os.path.join(args.outdir, "dit_sample_eval.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"written: {out_path}")


if __name__ == "__main__":
    main()
