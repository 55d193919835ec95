"""Training entry point of the DiT family (the JAX package's train_dit.py).

Usage:
    python -m gta_tpu_torch.train_dit <config.yaml> [datapath]
        [--seed S] [--outdir DIR] [--exit-after N] [--batch-size B]
        [--max-eval N] [--samplenow] [--sample-steps K] [--guidance G]
        [--device cuda|cpu]
    python -m torch.distributed.run --nproc_per_node G -m gta_tpu_torch.train_dit <config.yaml> ...

Without an ImageNet datapath (neither the config's `data.path` nor the
positional one) it trains on the procedural class-conditional images
(data/images.SyntheticImages) and says so, as train_dit.py does; the
ImageNet reader is not ported (it raises). Batches come through `Loader`
with `collate_images` and the config's `training.num_workers` threads.
Every `print_every` steps it prints the loss and mse and appends them to
<outdir>/metrics.jsonl, every `validate_every` it evaluates the val split
(--max-eval images) and logs that too, every `checkpoint_every` it writes
the rolling checkpoint and every `backup_every` a stamped backup under
<outdir>/ckpts/, and every `visualize_every` steps (and at the first step
under --samplenow) it writes a grid of CFG + DDIM samples of min(8,
num_classes) labels to <outdir>/samples_<it>.png. A rerun with the same
outdir resumes from the newest checkpoint and prints "Resumed from
checkpoint at it=N". --exit-after N stops after step N and saves `latest`.
The device defaults to CUDA and the run fails without it unless --device
cpu is given. --device-data (procedural images made on the device) is not
ported yet (ROADMAP queue 1 item 6). There is no --accum, and the config's
`training.grad_accum` has no effect, as in the JAX package.

Data parallel, as train_dit.py runs it: under torchrun every process
trains on its shard of each global batch (the batch over the world size;
the val batch a quarter of that) on `cuda:LOCAL_RANK` over NCCL (gloo with
--device cpu), the gradients averaged once per step (parallel/dist.py);
each rank draws its own timesteps, noise and label dropout. Rank 0 alone
prints, writes metrics.jsonl and the sample grids and saves checkpoints;
evaluation stays per rank, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train DiT-2DGTA (PyTorch/CUDA port)")
    parser.add_argument("config", type=str)
    parser.add_argument("datapath", type=str, nargs="?", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--outdir", type=str, default=None)
    parser.add_argument("--exit-after", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--max-eval", type=int, default=64)
    parser.add_argument("--samplenow", action="store_true")
    parser.add_argument("--device-data", action="store_true",
                        help="procedural images made on the device (not ported yet)")
    parser.add_argument("--sample-steps", type=int, default=50)
    parser.add_argument("--guidance", type=float, default=4.0)
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    args = parser.parse_args(argv)
    if not os.path.exists(args.config):
        parser.error(f"config file not found: {args.config}")
    if args.device_data:
        raise NotImplementedError("--device-data (DeviceSyntheticImages, data/device_synth.py) is not ported yet "
                                  "(ROADMAP queue 1 item 6)")

    from gta_tpu_torch.parallel import dist as pdist

    device = pdist.init_from_env(args.device)
    try:
        _train(args, device)
    finally:
        pdist.destroy()


def _train(args, device):
    import numpy as np

    from gta_tpu_torch.data.images import ImageNetTFDS, SyntheticImages, collate_images
    from gta_tpu_torch.data.loader import Loader
    from gta_tpu_torch.parallel import dist as pdist
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.dit_trainer import DiTTrainer, load_dit_config
    from gta_tpu_torch.utils.visualize import draw_visualization_grid

    cfg = load_dit_config(args.config)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.batch_size is not None:
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, batch_size=args.batch_size))
    t_cfg, mcfg = cfg.training, cfg.model
    max_it = args.exit_after if args.exit_after is not None else t_cfg.max_it
    out_dir = args.outdir or os.path.dirname(args.config)
    is_main = pdist.is_main()
    say = print if is_main else (lambda *a, **k: None)
    if pdist.initialized():
        say(pdist.describe(), flush=True)
    if is_main:
        os.makedirs(out_dir, exist_ok=True)
    host_batch = t_cfg.batch_size // pdist.world()

    datapath = args.datapath or cfg.data.path
    if cfg.data.dataset == "imagenet" and datapath:
        train_ds = ImageNetTFDS(mcfg.input_size, "train", datapath)
        val_ds = ImageNetTFDS(mcfg.input_size, "val", datapath)
    else:
        if cfg.data.dataset == "imagenet":
            say("No ImageNet datapath — falling back to procedural images.")
        train_ds = SyntheticImages(mcfg.input_size, mcfg.num_classes, "train", cfg.data.num_images, cfg.seed)
        val_ds = SyntheticImages(mcfg.input_size, mcfg.num_classes, "val", args.max_eval, cfg.seed)
    loader_kw = dict(num_workers=t_cfg.num_workers, collate_fn=collate_images, shard_index=pdist.rank(),
                     shard_count=pdist.world())
    train_loader = Loader(train_ds, host_batch, shuffle=True, seed=cfg.seed, **loader_kw)
    val_loader = Loader(val_ds, max(1, host_batch // 4), shuffle=False, **loader_kw)

    trainer = DiTTrainer(cfg, device=device)
    ckpt = Checkpointer(out_dir)
    say(f"DiT parameters: {trainer.param_count():,}; compute dtype {str(trainer.dtype).replace('torch.', '')}")
    restored, _ = ckpt.try_restore_latest(trainer, max_it)
    if restored:
        say(f"Resumed from checkpoint at it={trainer.step}")

    metrics_path = os.path.join(out_dir, "metrics.jsonl")

    def log_metrics(kind, payload, it):
        if is_main:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"kind": kind, "it": it, **payload}) + "\n")

    def sample_grid(it):
        n = min(8, mcfg.num_classes)
        labels = np.arange(n) % mcfg.num_classes
        imgs = trainer.sample(labels, seed=it, steps=args.sample_steps, guidance=args.guidance)
        cols = [(f"class {int(lab)}", (imgs[i:i + 1] + 1.0) / 2.0) for i, lab in enumerate(labels)]
        draw_visualization_grid(cols, os.path.join(out_dir, f"samples_{it}"))
        print(f"Sample grid written: samples_{it}.png")

    it = trainer.step - 1
    epoch = -1
    samplenow = args.samplenow
    while True:
        epoch += 1
        train_loader.set_epoch(epoch)
        for batch in train_loader:
            it += 1
            scalars_out = {"it": it}
            if t_cfg.checkpoint_every > 0 and it > 0 and it % t_cfg.checkpoint_every == 0:
                ckpt.save("latest", trainer, scalars_out)
            if t_cfg.backup_every > 0 and it > 0 and it % t_cfg.backup_every == 0:
                ckpt.save(f"step_{it}", trainer, scalars_out)
            if samplenow or (t_cfg.visualize_every > 0 and it > 0 and it % t_cfg.visualize_every == 0):
                if is_main:
                    sample_grid(it)
                samplenow = False
            if t_cfg.validate_every > 0 and it > 0 and it % t_cfg.validate_every == 0:
                eval_dict = trainer.evaluate(iter(val_loader), seed=cfg.seed)
                say(f"it={it} eval:", eval_dict)
                log_metrics("eval", eval_dict, it)

            metrics = trainer.train_step(batch)

            if t_cfg.print_every > 0 and it % t_cfg.print_every == 0:
                loss, mse = float(metrics["loss"]), float(metrics["mse"])
                say(f"{out_dir} it={it} loss={loss:.4f} mse={mse:.4f}", flush=True)
                log_metrics("train", {"loss": loss, "mse": mse}, it)

            if it >= max_it:
                ckpt.save("latest", trainer, {"it": it})
                say("Iteration limit reached. Exiting.")
                return


if __name__ == "__main__":
    main()
