"""Standalone evaluation of the port: PSNR / SSIM / MSE, and LPIPS-VGG when
its weights exist, on full-scale frames (the JAX package's evaluate.py).

Protocol as reference evaluate.py:81-145: batch-1 full-scale test split,
render every target view's full frame and score it per view: transform-mode
models through `render_image(chunk=16384)` from the native-resolution
canonical ray grid and the view's transform, non-transform models (the SRT
baseline) through `render_rays(chunk=16384)` on the view's own rays.
CLEVR-TR configs score 240x320 frames from 120x160 inputs, msn ones
128x128, RealEstate10K / ACID ones the config's height and width after
`downsample` (the reader resamples its frames to that size). SSIM
(`utils/metrics.ssim`) and LPIPS-VGG (`utils/lpips.py`) run in fp32 with
TF32 off on the device that rendered the frame, whatever the model's
compute dtype.

Usage:
    python -m gta_tpu_torch.evaluate <config.yaml> [datapath] [--synthetic]
        [--ckpt latest|best|step_N] [--outdir DIR] [--state-dict model.pt]
        [--max-scenes N] [--seed S] [--device cuda|cpu]

--ckpt (default best) names a checkpoint under <outdir>/ckpts, as the port's
train CLI writes them; --outdir defaults to the config's directory. When the
checkpoint is absent, the run prints a WARNING and evaluates the random
init from --seed. Nothing is created under <outdir>/ckpts. --state-dict
loads a torch file holding the port's state_dict instead (a converted
reference `model.pt`, README "Weights"). LPIPS-VGG is computed when
`LPIPS_WEIGHTS` names an npz of exported weights
(scripts/export_lpips_weights.py); otherwise the run says so and reports
PSNR / SSIM / MSE only. `lpips_alex` is not ported: the JAX package
computes it only through the `lpips` package. The positional `datapath`
overrides the config's `data.path` and the test split is read from it
(CLEVR-TR, RealEstate10K / ACID, or the MSN-Hard stream, which needs
`sunds`); with --synthetic, or without a data path, synthetic scenes of the
config's shapes are evaluated instead.

The result line (also written to <outdir>/eval_results.json) has the JAX
keys psnr, ssim, mse, n_scenes and lpips_vgg (when computed), plus device,
dtype (the compute dtype from `training.mixed_prec`) and ckpt (what was
loaded; null for the random init). The device defaults to CUDA and the run
fails without it unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str)
    parser.add_argument("datapath", type=str, nargs="?", default=None)
    parser.add_argument("--ckpt", type=str, default="best", help="latest | best | step_N under <outdir>/ckpts")
    parser.add_argument("--outdir", type=str, default=None, help="default: the config's directory")
    parser.add_argument("--state-dict", type=str, default=None, help="torch file with the port's state_dict")
    parser.add_argument("--seed", type=int, default=0, help="init seed when no checkpoint is loaded")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    parser.add_argument("--max-scenes", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true")
    args = parser.parse_args(argv)

    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.registry import get_dataset
    from gta_tpu_torch.data.synthetic import collate
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.trainer import Trainer
    from gta_tpu_torch.utils.lpips import LPIPSVGG
    from gta_tpu_torch.utils.metrics import ssim

    cfg = load_config(args.config)
    if args.datapath:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, path=args.datapath))
    if args.synthetic or (cfg.data.dataset != "synthetic" and not cfg.data.path):
        print("No datapath — evaluating on synthetic scenes.")
        # keep the native height/width AND `downsample`: inputs render at the
        # downsampled training resolution, full-scale targets at native size
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))

    out_dir = args.outdir or os.path.dirname(args.config) or "."
    trainer = Trainer(cfg, device=args.device, seed=args.seed)
    loaded = None
    if args.state_dict:
        trainer.model.load_state_dict(torch.load(args.state_dict, map_location="cpu", weights_only=True))
        loaded = args.state_dict
        print(f"Loaded state_dict {args.state_dict}")
    else:
        ckpt = Checkpointer(out_dir)
        if ckpt.exists(args.ckpt):
            ckpt.restore(args.ckpt, trainer)
            loaded = args.ckpt
            print(f"Loaded checkpoint {args.ckpt}")
        else:
            print(f"WARNING: checkpoint '{args.ckpt}' not found in {out_dir}/ckpts — "
                  f"evaluating random init (seed {args.seed})")

    lpips_vgg = None
    try:
        lpips_vgg = LPIPSVGG(device=trainer.device)
        print("Using LPIPS (VGG) with exported weights.")
    except RuntimeError as e:
        print(f"LPIPS unavailable ({e}); reporting PSNR/SSIM/MSE only")

    dataset = get_dataset("test", cfg.data, full_scale=True, max_len=args.max_scenes)
    # full-scale targets at the dataset's native resolution (CLEVR-TR:
    # 240x320 whatever `downsample`); else its own h/w, else the config's
    H = getattr(dataset, "target_h", None) or getattr(dataset, "h", cfg.data.height)
    W = getattr(dataset, "target_w", None) or getattr(dataset, "w", cfg.data.width)

    n = len(dataset) if args.max_scenes is None else min(args.max_scenes, len(dataset))
    print(f"Evaluating {n} scenes of {type(dataset).__name__} (test split) at {H}x{W} full-scale views")
    items = (dataset[i] for i in range(n)) if hasattr(dataset, "__getitem__") else iter(dataset)
    psnrs, ssims, mses, lp_v = [], [], [], []
    for i, item in enumerate(items):
        if i >= n:
            break
        batch = collate([item])
        transform_mode = batch.target_transforms is not None
        # non-transform items are flat [1, Nt*H*W, 3] in view order
        n_views = batch.target_transforms.shape[1] if transform_mode else batch.target_rays.shape[1] // (H * W)
        for v in range(n_views):
            if transform_mode:
                pred = trainer.render_image(
                    batch,
                    H,
                    W,
                    target_transform=batch.target_transforms[:, v].numpy(),
                    chunk=16384,
                    rays=batch.target_rays[:, v].numpy(),
                    cam=batch.target_camera_pos[:, v].numpy(),
                )
                gt = batch.target_pixels[:, v].numpy().reshape(1, H, W, 3)
            else:
                sl = slice(v * H * W, (v + 1) * H * W)
                pred = trainer.render_rays(
                    batch,
                    batch.target_rays[:, sl].numpy(),
                    batch.target_camera_pos[:, sl].numpy(),
                    chunk=16384,
                ).reshape(1, H, W, 3)
                gt = batch.target_pixels[:, sl].numpy().reshape(1, H, W, 3)
            mse = float(np.mean((pred - gt) ** 2))
            mses.append(mse)
            psnrs.append(-10.0 * np.log10(mse))
            pred_d, gt_d = (torch.from_numpy(x).to(trainer.device) for x in (pred, gt))
            ssims.append(float(ssim(pred_d, gt_d)))
            if lpips_vgg is not None:
                lp_v.append(lpips_vgg(pred_d, gt_d))
        if (i + 1) % 10 == 0:
            print(f"scene {i + 1}/{n}: psnr={np.mean(psnrs):.3f} ssim={np.mean(ssims):.4f}")

    results = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "mse": float(np.mean(mses)),
        "n_scenes": n,
    }
    if lp_v:
        results["lpips_vgg"] = float(np.mean(lp_v))
    results.update(device=str(trainer.device), dtype=str(trainer.dtype).replace("torch.", ""), ckpt=loaded)
    print(json.dumps(results))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
