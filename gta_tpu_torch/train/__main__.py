"""Training entry point of the port (the JAX package's train.py).

Usage:
    python -m gta_tpu_torch.train <config.yaml> [datapath] [--synthetic]
        [--outdir DIR] [--exit-after N] [--evalnow] [--visnow] [--max-eval N]
        [--test] [--full-scale] [--seed S] [--batch-size B] [--bf16]
        [--accum K] [--validate-every N] [--print-model] [--debug-nans] [--device-data]
        [--speed_test N] [--profile N] [--wandb] [--rtpt INITIALS]
        [--device cuda|cpu] [--n-model N] [--n-seq S] [--zero] [--dist-backend nccl|gloo]
    python -m torch.distributed.run --nproc_per_node G -m gta_tpu_torch.train <config.yaml> ...

Trains on the config's dataset (`data.dataset`: clevrtr, msn, re10k or
acid) read from `datapath`, which overrides `data.path`, as train.py does.
With --synthetic, or without a data path, it trains on synthetic
CLEVR-TR-shaped scenes at the config's input resolution instead. Every
`print_every` steps it prints the loss and lr, every `validate_every`
(--validate-every overrides it) it evaluates the val split (the test split
under --test, full-scale views under --full-scale; --max-eval scenes) and
keeps `best` by `model_selection_metric`, every `checkpoint_every` it
writes the rolling checkpoint and every `backup_every` a stamped backup,
all under <outdir>/ckpts/. Train and eval lines are appended to
<outdir>/metrics.jsonl ({"kind": "train"|"eval", "it", "t", and "loss" /
"lr" or the eval dict}, scripts/plot_metrics.py's schema) across
resumed runs. Every `visualize_every` steps (and at the first step under
--visnow) it renders one val batch of min(6, batch size) scenes (drawn
once, then reused) from 6 angles about the world z-axis into
<outdir>/renders-val.png. A rerun with the same outdir resumes from the
newest checkpoint and prints "Resumed from checkpoint at it=N"; on a resume
over an iterable dataset (MSN-Hard's stream) it skips the items of the
current epoch already consumed. --exit-after N stops after step N (N + 1
steps from scratch) and saves `latest`. SIGTERM or SIGINT finishes the
current step, saves `latest`, prints "Preemption checkpoint saved.
Exiting." and exits with 0.

--accum K splits every step's batch into K strided microbatches
(training.grad_accum; the batch must divide by K). --speed_test N divides
the batch by N, chains 100 steps between two host syncs, prints "chained
mean step time" and writes the mean ms to <outdir>/time.npy. --profile N
writes a torch.profiler trace of N steps (CUDA activity included on the
card; it raises if none was recorded) into <outdir>/trace. --debug-nans
turns on autograd's anomaly mode and raises FloatingPointError on a NaN in
the backward or a non-finite loss or gradient norm. --print-model prints
every state_dict key with its shape. --wandb and --rtpt run when their
packages import, and otherwise say "... unavailable (...); continuing
without"; the wandb run id is kept in the checkpoints' scalars.

Parallel training: under torchrun (`python -m torch.distributed.run`)
the world's W ranks form a D x S x N mesh (W = D x S x N; parallel/dist.py),
each rank on `cuda:LOCAL_RANK` over NCCL (gloo with --device cpu, or on
CUDA with --dist-backend gloo, which lets two ranks share one card; the
run prints its backend). Each of the D data ranks trains on its shard of
each global batch (--batch-size / the config's batch over D), and the
gradients are averaged over the data ranks once per optimizer step.
--n-model N splits the heads of every attention layer (whatever its
method) and the hidden units of every FeedForward over N model ranks where
N divides them, and runs the others whole on every model rank
(parallel/tp.py). --n-seq S splits the input views over S seq ranks in
each module that rings GTA's keys between them (the production GTA variant
with a static softmax, S dividing the views, and N its heads), and runs the
other modules whole on every seq rank (parallel/ring.py); these are the
JAX package's rules, and each rank prints which layers split and which
modules ring before its first step. --zero shards the AdamW moments over
the data ranks (parallel/zero.py). All three compose with --accum; the run
stops at start where the world size is not data x seq x model. Checkpoints
are whole whatever the layout: one written under --n-model 2 --zero
resumes in one process and the other way round. Rank 0 alone prints
progress, writes metrics.jsonl, checkpoints and renders and logs to wandb;
a stop signal on any rank stops every rank after the same step.

--device-data makes the synthetic scenes on the device
(data/device_synth.DeviceSynthetic), as train.py does: only where the
dataset is `synthetic` after the --synthetic rewrite (otherwise the flag
is ignored). Step `it` trains on batch `it` of the generator (this data
rank's shard), so a resumed run feeds the scenes an unbroken one would; an epoch
is 10000 // global batch steps; evaluation runs over max(1, --max-eval
(default 256) // (batch // 8)) fixed val batches made once, and the
visualisation on val batch 0 of min(6, batch) scenes. The device
defaults to CUDA and the run fails without it unless --device cpu is
given; the generator makes its scenes on the run's device. The config's
`training.mixed_prec` picks the compute dtype (bf16 or fp32; parameters
stay fp32); --bf16 forces bf16.
The loaders read with the config's `training.num_workers` threads (2 for
the render batch), prefetching 2 batches.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import signal
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a NVS model (PyTorch/CUDA port)")
    parser.add_argument("config", type=str, help="Path to config file")
    parser.add_argument("datapath", type=str, nargs="?", default=None, help="Dataset dir")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--outdir", type=str, default=None)
    parser.add_argument("--exit-after", type=int, default=None)
    parser.add_argument("--test", action="store_true", help="eval on test split")
    parser.add_argument("--evalnow", action="store_true")
    parser.add_argument("--visnow", action="store_true")
    parser.add_argument("--max-eval", type=int, default=None)
    parser.add_argument("--full-scale", action="store_true")
    parser.add_argument("--print-model", action="store_true", help="print every state_dict key and its shape")
    parser.add_argument("--synthetic", action="store_true", help="use synthetic scenes")
    parser.add_argument("--device-data", action="store_true",
                        help="make the synthetic scenes on the device (zero per-step host work and copies)")
    parser.add_argument("--batch-size", type=int, default=None, help="override global batch size")
    parser.add_argument("--speed_test", type=int, default=0,
                        help="time 100 train steps (batch divided by this value), chained between two host "
                             "syncs -> mean ms in time.npy")
    parser.add_argument("--n-model", type=int, default=1,
                        help="tensor parallel: attention heads and FFN units over this many model ranks, in every "
                             "layer whose heads or units they divide (the others run whole on each)")
    parser.add_argument("--n-seq", type=int, default=1,
                        help="sequence parallel: input views over this many seq ranks, GTA's keys ringed, in each "
                             "module that rings (production GTA, static softmax, views divided; the others run "
                             "whole on each)")
    parser.add_argument("--zero", action="store_true", help="ZeRO-1: the AdamW moments sharded over the data ranks")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="process group backend (default: nccl on CUDA, gloo on the CPU)")
    parser.add_argument("--profile", type=int, default=0,
                        help="capture a torch.profiler trace of this many steps into <outdir>/trace")
    parser.add_argument("--wandb", action="store_true", help="log to Weights & Biases")
    parser.add_argument("--rtpt", type=str, default=None, help="set process title via rtpt with these initials")
    parser.add_argument("--debug-nans", action="store_true",
                        help="anomaly mode; raise FloatingPointError on a NaN or a non-finite loss / grad norm")
    parser.add_argument("--bf16", action="store_true",
                        help="force training.mixed_prec (bf16 compute policy) regardless of config")
    parser.add_argument("--validate-every", type=int, default=None,
                        help="override training.validate_every (eval cadence in steps)")
    parser.add_argument("--accum", type=int, default=None,
                        help="gradient accumulation: this many equal strided microbatches per optimizer step")
    parser.add_argument("--device", type=str, default=None, help="default: cuda (cuda:LOCAL_RANK under torchrun)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not os.path.exists(args.config):
        parser.error(f"config file not found: {args.config}")
    if args.accum is not None and args.accum < 1:
        parser.error(f"--accum must be >= 1, got {args.accum}")
    if args.n_model < 1 or args.n_seq < 1:
        parser.error(f"--n-model and --n-seq must be >= 1, got {args.n_model} and {args.n_seq}")
    from gta_tpu_torch.parallel import dist as pdist

    device = pdist.init_from_env(args.device, args.dist_backend)
    previous = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        try:
            mesh = pdist.init_mesh(args.n_model, args.n_seq)
        except ValueError as e:
            parser.error(str(e))
        _train(args, device, mesh)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        pdist.destroy()


def _train(args, device, mesh):
    import torch

    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.loader import Loader
    from gta_tpu_torch.data.registry import get_dataset
    from gta_tpu_torch.parallel import dist as pdist
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.trainer import Trainer

    is_main = pdist.is_main()
    say = print if is_main else (lambda *a, **k: None)
    if pdist.initialized():
        say(pdist.describe(), flush=True)
    if mesh.seq.size > 1 or mesh.model.size > 1 or args.zero:
        say(f"{mesh.describe()}; ZeRO-1 {'on' if args.zero and mesh.data.size > 1 else 'off'}", flush=True)

    cfg = load_config(args.config)
    if args.datapath:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, path=args.datapath))
    if args.synthetic or (cfg.data.dataset != "synthetic" and not cfg.data.path):
        say("No datapath given — falling back to synthetic scenes.")
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
    training = {}
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.batch_size is not None:
        training["batch_size"] = args.batch_size
    if args.bf16:
        training["mixed_prec"] = True
    if args.validate_every is not None:
        training["validate_every"] = args.validate_every
    if args.accum is not None:
        training["grad_accum"] = args.accum
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, **training))
    t_cfg = cfg.training
    max_it = args.exit_after if args.exit_after is not None else t_cfg.max_it
    out_dir = args.outdir or os.path.dirname(args.config)
    if args.seed is not None:
        out_dir = os.path.join(out_dir, f"seed{args.seed}")
    if is_main:
        os.makedirs(out_dir, exist_ok=True)
    global_batch = t_cfg.batch_size
    if args.speed_test:
        global_batch = max(1, global_batch // args.speed_test)
    host_batch = global_batch // mesh.data.size
    sel_sign = 1 if t_cfg.model_selection_mode == "maximize" else -1
    sel_metric = t_cfg.model_selection_metric

    eval_split = "test" if args.test else "val"
    trainer = Trainer(cfg, device=device, zero=args.zero, mesh=mesh)
    for line in trainer.layout():  # every rank: what it holds
        print(f"rank {pdist.rank()}: {line}", flush=True)
    use_device_data = args.device_data and cfg.data.dataset == "synthetic"
    if use_device_data:
        from gta_tpu_torch.data.device_synth import DeviceSynthetic

        say("Loading training set (synthetic, on-device generation)...")
        dev_train = DeviceSynthetic(cfg.data, "train", seed=cfg.seed, device=trainer.device)
        dev_val = DeviceSynthetic(cfg.data, eval_split, seed=cfg.seed, full_scale=args.full_scale,
                                  device=trainer.device)
        train_ds = eval_ds = None
        val_batches = dev_val.val_batches(args.max_eval or 256, max(1, host_batch // 8))
        steps_per_epoch = 10000 // global_batch or 1
        vis_n = min(6, host_batch) or 1
    else:
        say(f"Loading training set ({cfg.data.dataset})...")
        train_ds = get_dataset("train", cfg.data, seed=cfg.seed)
        eval_ds = get_dataset(eval_split, cfg.data, full_scale=args.full_scale, max_len=args.max_eval)
        shard = dict(shard_index=mesh.data.index, shard_count=mesh.data.size, num_workers=t_cfg.num_workers)
        train_loader = Loader(train_ds, host_batch, shuffle=True, seed=cfg.seed, **shard)
        val_loader = Loader(eval_ds, max(1, host_batch // 8), shuffle=False, **shard)
        # --max-eval can cut the eval split below the vis batch size, and a
        # loader that drops its last partial batch would then yield none
        vis_n = max(1, min(6, host_batch, len(eval_ds)))
    data_vis = None

    ckpt = Checkpointer(out_dir)
    counts = trainer.param_counts()
    say(
        f"Number of parameters: encoder {counts['encoder']:,}, "
        f"decoder {counts['decoder']:,}, total {counts['total']:,}; compute dtype "
        f"{str(trainer.dtype).replace('torch.', '')}"
    )
    if args.print_model:
        for key, value in trainer.model_state_dict().items():
            say(key, tuple(value.shape))
    restored, scalars = ckpt.try_restore_latest(trainer, max_it)
    if restored:
        say(f"Resumed from checkpoint at it={trainer.step}")
    epoch_it = scalars.get("epoch_it", -1)
    time_elapsed = scalars.get("t", 0.0)
    metric_val_best = scalars.get("loss_val_best", -sel_sign * np.inf)
    run_id = scalars.get("run_id") or None

    # Stream-position resume for iterable datasets (reference
    # multishapenet.py:316-320): skip the items this rank already consumed
    # in the current epoch so resume does not replay from scene 0.
    if restored and hasattr(train_ds, "skip"):
        consumed = (trainer.step - max(epoch_it, 0) * len(train_loader)) * host_batch
        if consumed > 0:
            train_ds.skip(consumed)
            say(f"Skipping {consumed} already-consumed stream items.")

    # Preemption-safe save: on SIGTERM / SIGINT finish the current step,
    # write the rolling checkpoint, then exit
    stop_requested = {"flag": False}

    def on_signal(signum, frame):
        print(f"Signal {signum} received — checkpointing before exit.", flush=True)
        stop_requested["flag"] = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    rtpt = None
    if args.rtpt is not None:
        try:
            from rtpt import RTPT

            rtpt = RTPT(name_initials=args.rtpt, experiment_name=os.path.basename(out_dir) or "gta-tpu",
                        max_iterations=max_it)
            rtpt.start()
        except Exception as e:
            print(f"rtpt unavailable ({e}); continuing without")
    wandb_run = None
    if args.wandb and is_main:
        # a kept run_id makes a resume attach to the same wandb run
        try:
            import wandb

            if run_id is None:
                run_id = wandb.util.generate_id()
                print(f"Sampled new wandb run_id {run_id}.")
            else:
                print(f"Resuming wandb with existing run_id {run_id}.")
            wandb_run = wandb.init(project="gta-tpu", name=out_dir, id=run_id, resume="allow")
        except Exception as e:
            print(f"wandb unavailable ({e}); continuing without")

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    it = trainer.step - 1
    speed_times = []
    profiler, profile_stop_at = None, None
    evalnow, visnow = args.evalnow, args.visnow
    metrics_path = os.path.join(out_dir, "metrics.jsonl")

    def log_metrics(kind, payload):
        if is_main:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"kind": kind, "it": it, "t": time_elapsed, **payload}) + "\n")

    def step(batch):
        try:
            metrics = trainer.train_step(batch, stop=stop_requested["flag"])
        except RuntimeError as e:  # anomaly mode's "returned nan values"
            if args.debug_nans and "nan" in str(e).lower():
                raise FloatingPointError(f"--debug-nans at it={it}: {e}") from e
            raise
        if args.debug_nans and not (torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])):
            raise FloatingPointError(f"--debug-nans at it={it}: loss {float(metrics['loss'])}, "
                                     f"grad_norm {float(metrics['grad_norm'])}")
        return metrics

    def train_epoch():
        """One epoch of batches: the loader's, or the device generator's
        batch `it` (read as each step starts: a resume continues the ids)."""
        if not use_device_data:
            train_loader.set_epoch(epoch_it)
            yield from train_loader
            return
        for _ in range(steps_per_epoch):
            yield dev_train.batch(it + 1, host_batch, mesh.data.index, mesh.data.size)

    t_resumed = time_elapsed
    session_start = time.perf_counter()
    try:
        while True:
            epoch_it += 1
            for batch in train_epoch():
                it += 1
                time_elapsed = t_resumed + time.perf_counter() - session_start
                scalars_out = {
                    "epoch_it": epoch_it,
                    "it": it,
                    "t": time_elapsed,
                    "loss_val_best": float(metric_val_best),
                }
                if run_id is not None:
                    scalars_out["run_id"] = run_id
                if t_cfg.checkpoint_every > 0 and it % t_cfg.checkpoint_every == 0 and it > 0:
                    ckpt.save("latest", trainer, scalars_out)
                    say("Checkpoint saved.")
                if t_cfg.backup_every > 0 and it % t_cfg.backup_every == 0 and it > 0:
                    ckpt.save(f"step_{it}", trainer, scalars_out)
                    say("Backup checkpoint saved.")

                if visnow or (it > 0 and t_cfg.visualize_every > 0 and it % t_cfg.visualize_every == 0):
                    if mesh.data.index == 0:  # rank 0 writes; the ranks of its data rank render with it
                        if data_vis is None:
                            data_vis = (dev_val.batch(0, vis_n) if use_device_data
                                        else next(iter(Loader(eval_ds, vis_n, shuffle=True, num_workers=2))))
                        print("Visualizing...")
                        trainer.visualize(data_vis, os.path.join(out_dir, "renders-val"))
                    visnow = False

                if evalnow or (it > 0 and t_cfg.validate_every > 0 and it % t_cfg.validate_every == 0):
                    say("Evaluating...")
                    eval_dict = trainer.evaluate(iter(val_batches) if use_device_data else iter(val_loader))
                    say("Evaluation results:", eval_dict)
                    log_metrics("eval", eval_dict)
                    if wandb_run is not None:
                        wandb_run.log(eval_dict, step=it)
                    metric_val = eval_dict[sel_metric]
                    if sel_sign * (metric_val - metric_val_best) > 0:
                        metric_val_best = metric_val
                        say(f"New best model ({sel_metric} {metric_val_best:.6f})")
                        scalars_out["loss_val_best"] = float(metric_val_best)
                        ckpt.save("best", trainer, scalars_out)
                    evalnow = False

                if args.profile and profile_stop_at is None:
                    from torch.profiler import ProfilerActivity, profile

                    activities = [ProfilerActivity.CPU]
                    if trainer.device.type == "cuda":
                        activities.append(ProfilerActivity.CUDA)
                    profiler = profile(activities=activities)
                    profiler.start()
                    profile_stop_at = it + args.profile - 1

                metrics = step(batch)

                if profiler is not None:
                    if trainer.device.type == "cuda":
                        torch.cuda.synchronize(trainer.device)
                    if it >= profile_stop_at:
                        profiler.stop()
                        _write_trace(profiler, trainer.device, os.path.join(out_dir, "trace"), pdist.rank())
                        say(f"Profiler trace written to {out_dir}/trace")
                        profiler = None

                if args.speed_test:
                    # chained: the steps stay queued back to back; a host
                    # fetch of the loss closes each edge of the window
                    speed_times.append(time.perf_counter())
                    if len(speed_times) in (1, 101):
                        float(metrics["loss"])
                        speed_times[-1] = time.perf_counter()
                    if len(speed_times) == 101:
                        mean_ms = (speed_times[-1] - speed_times[0]) / 100 * 1e3
                        say(f"chained mean step time: {mean_ms:.2f} ms")
                        if is_main:
                            np.save(os.path.join(out_dir, "time.npy"), np.asarray([mean_ms]))
                        return

                if t_cfg.print_every > 0 and it % t_cfg.print_every == 0:
                    if rtpt is not None:
                        rtpt.step()
                    loss, lr = float(metrics["loss"]), float(metrics["lr"])
                    elapsed = str(datetime.timedelta(seconds=int(time_elapsed)))
                    say(f"{out_dir} t={elapsed} [Epoch {epoch_it:02d}] it={it}, loss={loss:.4f} lr={lr:.3e}",
                        flush=True)
                    log_metrics("train", {"loss": loss, "lr": lr})
                    if wandb_run is not None:
                        wandb_run.log({"loss": loss, "lr": lr, "t": time_elapsed}, step=it)

                if bool(metrics["stop"]):  # one host sync per step under data parallel
                    ckpt.save("latest", trainer, scalars_out)
                    say("Preemption checkpoint saved. Exiting.", flush=True)
                    return

                if it >= max_it:
                    say("Iteration limit reached. Exiting.")
                    ckpt.save("latest", trainer, scalars_out)
                    return
    finally:
        if profiler is not None:
            profiler.stop()
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(False)


def _write_trace(profiler, device, trace_dir, rank):
    """Export `profiler`'s chrome trace into trace_dir; on the card, raise
    (writing nothing) when it recorded no CUDA activity."""
    if device.type == "cuda" and not sum(e.device_time_total for e in profiler.key_averages()) > 0:
        raise RuntimeError("torch.profiler recorded no CUDA activity (CUPTI); no trace written")
    os.makedirs(trace_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(trace_dir, f"rank{rank}.json"))


if __name__ == "__main__":
    main()
