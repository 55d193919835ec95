"""Standalone evaluation of the port: PSNR / MSE on full-scale frames.

Protocol as the JAX package's evaluate.py (reference evaluate.py:81-145):
batch-1 full-scale test split, render every target view's full frame and
score it per view: transform-mode models through `render_image(chunk=16384)`
from the native-resolution canonical ray grid and the view's transform,
non-transform models (the SRT baseline) through `render_rays(chunk=16384)`
on the view's own rays. CLEVR-TR configs score 240x320 frames
from 120x160 inputs. SSIM and LPIPS come with the evaluation slice.

Usage:
    python -m gta_tpu_torch.evaluate <config.yaml> --synthetic [--max-scenes N]
        [--ckpt model.pt] [--seed S] [--device cuda|cpu]

--ckpt is a torch file holding the port's state_dict; without it the model
is randomly initialised from --seed. The config's `training.mixed_prec`
picks the compute dtype (bf16 or fp32), named in the result line. The
device defaults to CUDA and the run fails without it unless --device cpu
is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str)
    parser.add_argument("--ckpt", type=str, default=None, help="torch file with the port's state_dict")
    parser.add_argument("--seed", type=int, default=0, help="init seed when no --ckpt is given")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    parser.add_argument("--max-scenes", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true")
    args = parser.parse_args(argv)

    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.registry import get_dataset
    from gta_tpu_torch.data.synthetic import collate
    from gta_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    if args.synthetic or (cfg.data.dataset != "synthetic" and not cfg.data.path):
        print("No datapath — evaluating on synthetic scenes.")
        # keep the native height/width AND `downsample`: inputs render at the
        # downsampled training resolution, full-scale targets at native size
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))

    trainer = Trainer(cfg, device=args.device, seed=args.seed)
    if args.ckpt:
        trainer.model.load_state_dict(torch.load(args.ckpt, map_location="cpu", weights_only=True))
        print(f"Loaded checkpoint {args.ckpt}")
    else:
        print(f"No --ckpt: evaluating random init (seed {args.seed})")
    dataset = get_dataset("test", cfg.data, full_scale=True, max_len=args.max_scenes)
    H, W = dataset.target_h, dataset.target_w

    n = len(dataset) if args.max_scenes is None else min(args.max_scenes, len(dataset))
    psnrs, mses = [], []
    for i in range(n):
        batch = collate([dataset[i]])
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
        if (i + 1) % 10 == 0:
            print(f"scene {i + 1}/{n}: psnr={np.mean(psnrs):.3f}")

    results = {
        "psnr": float(np.mean(psnrs)),
        "mse": float(np.mean(mses)),
        "n_scenes": n,
        "device": str(trainer.device),
        "dtype": str(trainer.dtype).replace("torch.", ""),
        "not_computed": "ssim, lpips (evaluation slice, ROADMAP queue 1)",
    }
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
