"""Training entry point of the port (the JAX package's train.py, single device).

Usage:
    python -m gta_tpu_torch.train <config.yaml> [datapath] [--synthetic]
        [--outdir DIR] [--exit-after N] [--evalnow] [--visnow] [--max-eval N]
        [--seed S] [--batch-size B] [--bf16] [--device cuda|cpu]

Trains on the config's dataset (`data.dataset`: clevrtr, msn, re10k or
acid) read from `datapath`, which overrides `data.path`, as train.py does.
With --synthetic, or without a data path, it trains on synthetic
CLEVR-TR-shaped scenes at the config's input resolution instead. On a
resume over an iterable dataset (MSN-Hard's stream) it skips the items of
the current epoch already consumed, and prints how many. Every
`print_every` steps it prints the loss and lr, every `validate_every` it
evaluates on the val split (--max-eval scenes) and keeps `best` by
`model_selection_metric`, every `checkpoint_every` it writes the rolling
checkpoint and every `backup_every` a stamped backup, all under
<outdir>/ckpts/. Every `visualize_every` steps (and at the first step
under --visnow) it renders one val batch of min(6, batch size) scenes
(drawn once, then reused) from 6 angles about the world z-axis into
<outdir>/renders-val.png. A rerun with the same outdir resumes from the newest
checkpoint and prints "Resumed from checkpoint at it=N". --exit-after N
stops after step N (N + 1 steps from scratch) and saves `latest`. The
device defaults to CUDA and the run fails without it unless --device cpu
is given. The config's `training.mixed_prec` picks the compute dtype (bf16
or fp32; parameters stay fp32); --bf16 forces bf16 (train.py:101-103,
176-178). The loaders read with the config's `training.num_workers`
threads (2 for the render batch), prefetching 2 batches. Not ported yet:
host sharding, gradient accumulation and multi-device flags (ROADMAP
queue 1 item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a NVS model (PyTorch/CUDA port)")
    parser.add_argument("config", type=str, help="Path to config file")
    parser.add_argument("datapath", type=str, nargs="?", default=None, help="Dataset dir")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--outdir", type=str, default=None)
    parser.add_argument("--exit-after", type=int, default=None)
    parser.add_argument("--evalnow", action="store_true")
    parser.add_argument("--visnow", action="store_true")
    parser.add_argument("--max-eval", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true", help="use synthetic scenes")
    parser.add_argument("--batch-size", type=int, default=None, help="override the batch size")
    parser.add_argument(
        "--bf16", action="store_true", help="force training.mixed_prec (bf16 compute policy) regardless of config"
    )
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    args = parser.parse_args(argv)
    if not os.path.exists(args.config):
        parser.error(f"config file not found: {args.config}")

    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.loader import Loader
    from gta_tpu_torch.data.registry import get_dataset
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    if args.datapath:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, path=args.datapath))
    if args.synthetic or (cfg.data.dataset != "synthetic" and not cfg.data.path):
        print("No datapath given — falling back to synthetic scenes.")
        h, w, ds = cfg.data.height, cfg.data.width, cfg.data.downsample
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(
                cfg.data,
                dataset="synthetic",
                height=h // (2**ds) if ds else h,
                width=w // (2**ds) if ds else w,
                downsample=0,
            ),
        )
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.batch_size is not None:
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, batch_size=args.batch_size))
    if args.bf16:
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, mixed_prec=True))
    t_cfg = cfg.training
    max_it = args.exit_after if args.exit_after is not None else t_cfg.max_it
    out_dir = args.outdir or os.path.dirname(args.config)
    if args.seed is not None:
        out_dir = os.path.join(out_dir, f"seed{args.seed}")
    os.makedirs(out_dir, exist_ok=True)
    sel_sign = 1 if t_cfg.model_selection_mode == "maximize" else -1
    sel_metric = t_cfg.model_selection_metric

    print(f"Loading training set ({cfg.data.dataset})...")
    train_ds = get_dataset("train", cfg.data, seed=cfg.seed)
    eval_ds = get_dataset("val", cfg.data, max_len=args.max_eval)
    train_loader = Loader(train_ds, t_cfg.batch_size, shuffle=True, seed=cfg.seed, num_workers=t_cfg.num_workers)
    val_loader = Loader(eval_ds, max(1, t_cfg.batch_size // 8), shuffle=False, num_workers=t_cfg.num_workers)
    # --max-eval can cut the eval split below the vis batch size, and a
    # loader that drops its last partial batch would then yield none
    vis_n = max(1, min(6, t_cfg.batch_size, len(eval_ds)))
    data_vis = None

    trainer = Trainer(cfg, device=args.device)
    ckpt = Checkpointer(out_dir)
    counts = trainer.param_counts()
    print(
        f"Number of parameters: encoder {counts['encoder']:,}, "
        f"decoder {counts['decoder']:,}, total {counts['total']:,}; compute dtype "
        f"{str(trainer.dtype).replace('torch.', '')}"
    )
    restored, scalars = ckpt.try_restore_latest(trainer, max_it)
    if restored:
        print(f"Resumed from checkpoint at it={trainer.step}")
    epoch_it = scalars.get("epoch_it", -1)
    time_elapsed = scalars.get("t", 0.0)
    metric_val_best = scalars.get("loss_val_best", -sel_sign * np.inf)

    # Stream-position resume for iterable datasets (reference
    # multishapenet.py:316-320): skip the items already consumed in the
    # current epoch so resume does not replay from scene 0.
    if restored and hasattr(train_ds, "skip"):
        consumed = (trainer.step - max(epoch_it, 0) * len(train_loader)) * t_cfg.batch_size
        if consumed > 0:
            train_ds.skip(consumed)
            print(f"Skipping {consumed} already-consumed stream items.")

    it = trainer.step - 1
    evalnow, visnow = args.evalnow, args.visnow
    t_resumed = time_elapsed
    session_start = time.perf_counter()
    while True:
        epoch_it += 1
        train_loader.set_epoch(epoch_it)
        for batch in train_loader:
            it += 1
            time_elapsed = t_resumed + time.perf_counter() - session_start
            scalars_out = {
                "epoch_it": epoch_it,
                "it": it,
                "t": time_elapsed,
                "loss_val_best": float(metric_val_best),
            }
            if t_cfg.checkpoint_every > 0 and it % t_cfg.checkpoint_every == 0 and it > 0:
                ckpt.save("latest", trainer, scalars_out)
                print("Checkpoint saved.")
            if t_cfg.backup_every > 0 and it % t_cfg.backup_every == 0 and it > 0:
                ckpt.save(f"step_{it}", trainer, scalars_out)
                print("Backup checkpoint saved.")

            if visnow or (it > 0 and t_cfg.visualize_every > 0 and it % t_cfg.visualize_every == 0):
                if data_vis is None:
                    data_vis = next(iter(Loader(eval_ds, vis_n, shuffle=True, num_workers=2)))
                print("Visualizing...")
                trainer.visualize(data_vis, os.path.join(out_dir, "renders-val"))
                visnow = False

            if evalnow or (it > 0 and t_cfg.validate_every > 0 and it % t_cfg.validate_every == 0):
                print("Evaluating...")
                eval_dict = trainer.evaluate(iter(val_loader))
                print("Evaluation results:", eval_dict)
                metric_val = eval_dict[sel_metric]
                if sel_sign * (metric_val - metric_val_best) > 0:
                    metric_val_best = metric_val
                    print(f"New best model ({sel_metric} {metric_val_best:.6f})")
                    scalars_out["loss_val_best"] = float(metric_val_best)
                    ckpt.save("best", trainer, scalars_out)
                evalnow = False

            metrics = trainer.train_step(batch)

            if t_cfg.print_every > 0 and it % t_cfg.print_every == 0:
                loss, lr = float(metrics["loss"]), float(metrics["lr"])
                elapsed = str(datetime.timedelta(seconds=int(time_elapsed)))
                print(f"{out_dir} t={elapsed} [Epoch {epoch_it:02d}] it={it}, loss={loss:.4f} lr={lr:.3e}")

            if it >= max_it:
                print("Iteration limit reached. Exiting.")
                ckpt.save("latest", trainer, scalars_out)
                return


if __name__ == "__main__":
    main()
