#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gta_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Twenty-nine configurations under runs/ and the seven under experiments/
at full width and depth (but for msn_so3's fp32 paths, below), random
weights from the config's seed, synthetic scenes of each dataset's shapes
(the host renderer, the default, or since phase 8 the device generator)
or procedural images (the DiT), and then (phase 6) batches the dataset
readers make from files written here:
  - GTA, the flagship (runs/clevrtr/GTA/gta): fused GTA attention in every
    layer (kernels gta_fused_fwd, gta_fused_bwd) at head width 64;
  - SRT, the baseline (runs/clevrtr/otherPEs/srt): plain softmax attention
    in every layer (kernels flash_core_fwd, flash_core_bwd), ray input
    embeddings, non-transform batches;
  - msn_so3, the MSN-Hard GTA-SO(3) model (runs/msn/GTA/gta_so3): 5 views
    of 128x128, 8 heads of 96 (se3 48, so3 24 Wigner-D, so2 24), batch 64,
    the fused GTA kernels' fp32 C = 96 instances (its mixed_prec
    overridden); its kernel phases at the full shapes, its serving, train
    and gradient paths at one attention block a side (the run's time);
  - CLEVR-TR gta_so3 (runs/clevrtr/GTA/gta_so3): 6 heads of 64 (se3 32,
    so3 16, so2 16);
  - msn_so3 as published (bf16: its mixed_prec), through the bf16
    instances of the fused GTA kernels at C = 96;
  - the MSN-Hard SRT baseline as published (runs/msn/otherPEs/srt; bf16,
    12 heads of 64, `ray` embeddings, 5 views of 128x128, batch 64),
    through the bf16 instances of flash_core;
  - msn gta, the MSN-Hard GTA model as published (runs/msn/GTA/gta; bf16,
    8 heads of 96: se3 48, so2 48; batch 64), and its four variants
    gta_novtrnsfm (no value transform), gta_sharedfreqs (shared so2
    frequencies), gta_no3demb (an SO(2)-only encoder, so2 96) and
    gta_no2demb (an SE(3)-only encoder, se3 96), whose decoders recompute
    so2: all through the bf16 C = 96 instances of the fused GTA kernels
    that msn_so3 uses, the variants at batch VARIANT_BATCH;
  - GTA's t2 ablation, CLEVR-TR gta_t2 (fp32, 6 heads of 64: triv 2, se3
    32, t2 30; batch 32) and msn gta_t2 as published (bf16, 8 heads of 96:
    se3 48, t2 48; batch 64): the sliced rep transforms in torch around
    flash_core (kernels flash_core_fwd, flash_core_bwd; at C = 96 for msn),
    as the JAX package's GTA layers run t2 on a TPU;
  - the other attention methods' configs (OTHER_METHODS: gta_euclid,
    elementwise_mul, ape, mln, gbt, repast, repast_cnoise0.1, rpe,
    frustum_posemb_dmax20 and ftl_rope of CLEVR-TR; msn gta_so3_euclid and
    repast, bf16) at batch VARIANT_BATCH: frustum_posemb through flash_core,
    ftl_rope's decoder through the fused GTA kernels (once per target
    view), every other attention in torch eager with no kernel, as JAX
    computes them with XLA (`side_kernel`);
  - the DiT family as published (runs/imagenet/DiT; bf16, DiT-S/2: 32x32x3
    images in patches of 2, 256 tokens, hidden 384, depth 12, 6 heads of
    64, 1000 classes, T = 1000, batch 256): dit_gta's 2D GTA (triv 32 +
    so2 32, rotor tables only, one view) through the bf16 fused GTA
    kernels, dit_base (a frozen sin/cos table, plain attention) through the
    bf16 flash_core kernels.
The fp32 instances of all four kernels run one attention core
(gta_tpu_torch/csrc/attn_core.cuh: a forward, a query pass and a key pass;
3xTF32 mma.sync on the tensor cores, P*V, dP and dq taken about centre
rows: the fused GTA kernels' transformed rows centred on the rows' means,
flash_core's raw token-major q, k, v on the key and value rows' means, taken
by a first launch). The bf16
instances of all four run another (gta_tpu_torch/csrc/attn_sm90.cuh: wgmma
fed by TMA, bf16 operands with fp32 accumulation; the fused GTA kernels'
transformed kt, vt centred in fp32 before their rounding, raw bf16 rows as
they are; flash_core's bf16 gradients stored straight from the fp32
accumulators).

Phases (any failure exits non-zero and prints no result line):
  1. The card's name and power limit; build every CUDA kernel of the port
     from gta_tpu_torch/csrc with nvcc, all at once (ptxas registers and
     spills printed for every kernel of each library, so the shared core
     shows once in each instantiation).
  2. Each kernel against its plain PyTorch version on the card.
     - gta_fused_fwd at the flagship shapes, with rep tables from the
       port's encoder_reps/decoder_reps on a synthetic batch and
       trans_coeff 0.01: encoder self-attention B=32 x 600 tokens (2 views
       of 300), decoder eval B=32 x 3x856 queries and render chunk
       B=1 x 16384 queries, against 600 keys; then with its training
       residuals (z, log-sum-exp) at the two train shapes;
     - gta_fused_bwd at encoder_train_b32 (Tq = Tk = 600) and
       decoder_train_b32 (Tq = 3x856, Tk = 600); both on every flag branch
       at B=2, and at the edge shapes B=2, one view per side, Tq in
       {1, 17, 601}, Tk in {1, 33, 2100}, with every transform and with
       none;
     - both again at C = 96 with msn_so3's tables: forward at encoder
       B=64 x 1280 tokens (5 views of 256), decoder eval B=64 x 5x512
       queries and a render chunk B=1 x 16384 queries, against 1280 keys;
       with residuals and the backward at the two train shapes; the edge
       shapes with 8 heads of 96, every transform and none;
     - flash_core_fwd at the SRT shapes (encoder B=32 x 600 x 600, decoder
       eval B=32 x 2560 x 600, render chunk B=1 x 16384 x 600), then with
       its training residual (log-sum-exp) at the two train shapes;
       flash_core_bwd at encoder_train_b32 and decoder_train_b32; both at
       the edge shapes B=2, Tq in {1, 601}, Tk in {1, 33, 2100};
     - both flash_core kernels again at C = 96, msn gta_t2's shapes (its
       mixed_prec overridden: B=64, 8 heads of 96, encoder 1280 x 1280,
       decoder eval 2560 x 1280, render chunk 16384 x 1280, the two train
       shapes);
     - every fp32 flash_core shape also against the plain version in fp64
       at B=2: each output (out, lse, dq, dk, dv) within 1e-5 relative L2.
     Pass: forward max|kernel - plain| <= 1e-4; backward, for each output,
     max|kernel - plain| <= 1e-4 * max(1, max|plain|) (fp32; the order of
     summation over keys, queries or rows x heads differs). Times: CUDA
     events, median of 7 after 2 warm-up runs. Yardsticks, timed here only
     and never called by the port: F.scaled_dot_product_attention (on
     pre-transformed q/k/v for GTA) forward, and its backward alone.
     Bounds: `bound_ms` at the fp32 CUDA-core peak (67 TFLOP/s),
     `bound_tc_ms` at the fp32-accurate tensor-core rate (3xTF32,
     495 / 3 TFLOP/s), both with bytes at 3.35 TB/s.
     - each bf16 instance at the published msn configs' shapes (B=64,
       1280 keys: encoder, decoder eval, render chunk B=1 x 16384, and the
       two train shapes with the backward; flash_core's at MSN SRT's C = 64
       and, writing fp32 as GTA's sliced path does, msn gta_t2's C = 96),
       the fused GTA ones also at
       CLEVR-TR gta's decoder shapes under --bf16 (B=32, 3x856 queries,
       600 keys, C = 64; eval and train): each output's relative L2
       error against its plain version (fp32 inside) on the same bf16
       inputs at most 1.5x the bf16 emulation's (the plain version with
       mxu_dtype=bf16, the TPU kernel's rounding), and the same rule
       against fp64 at each shape cut to B=2. Yardstick:
       F.scaled_dot_product_attention on the same bf16 operands; bound at
       the dense bf16 peak (989 TFLOP/s) and 3.35 TB/s.
  3. Each configuration's serving path: Trainer(cfg) on cuda, eval_step on
     a synthetic val batch of its batch size (the msn configs 64, the
     others 32),
     one full-scale target view at chunk 16384 (240x320 or 128x128;
     render_image for the GTA configs, render_rays on the view's rays for
     SRT; one warm-up, then the median of 3), with every kernel's launch
     count asserted (its attention kernel's forward, in the config's compute
     dtype: 5 per encode, 2 per decode chunk; every other instance: none;
     the kernel of each side by `side_kernel`)
     and peak memory printed; then a B=2 forward (the bf16 configs at one
     attention block a side) on the card against the
     same weights on the CPU (plain versions), atol 1e-4 (fp32 configs), or
     for the bf16 configs: the card's bf16 pixels no further (relative L2)
     from the CPU's fp32 ones than 1.5x the CPU's bf16 pixels with the TPU
     kernel's rounding in the attention (see bf16_card_vs_cpu_phase).
     Then the metrics (metrics_phase): SSIM and LPIPS-VGG (random weights,
     seed 0) of the flagship's 240x320 frame and msn gta's 128x128 frame on
     the card against the same call on the CPU, with TF32 on around the
     calls (the metrics turn it off themselves), held to SSIM_TOL and
     LPIPS_RTOL, and the card's ms per frame beside the render's.
  4. Each configuration's train path: train_step on synthetic train
     batches of its batch size (one cold step, then the median of 3 warm
     steps; the so3 and msn configs cycle two distinct batches), with
     7 forward and 7 backward launches of its attention kernels per step
     and none of the other configuration's asserted, and a finite loss and
     finite gradients; then, with dropout 0, a B=2 step's gradients on the
     card and on the CPU against a float64 step on the card (GTA, SRT,
     msn_so3 at one block a side; see grads_phase): every attention call's
     q, k, v cotangents, and a fused GTA call's cotangents of its rep
     matrices, against the call's fp64 VJP (1e-5 + 10x the plain fp32
     version's error), the whole gradient's error at most 1e-4 above
     that of the same step through the plain attention, each trans_coeff
     scalar's error at most 1e-4 x the sum of its terms' absolute values;
     card vs CPU printed. The four msn GTA variants and the other attention
     methods' configs take one cold eval_step and one cold train_step each
     (variant_phase), the launch counts of both paths asserted (zero for
     the torch-eager methods) and peak memory printed.
  5. The CLIs as subprocesses, each into a temporary directory (nothing
     under runs/ may change): `python -m gta_tpu_torch.train <GTA>
     --synthetic --evalnow --visnow` for 3 steps, and again to step 4,
     which must resume; renders-val.png must decode to its grid; then
     `python -m gta_tpu_torch.evaluate <GTA> --synthetic --ckpt best` on
     that run with LPIPS_WEIGHTS naming a random-weight npz, which must
     restore `best` and report finite psnr, ssim and lpips_vgg on the card
     and write eval_results.json; the same evaluate on msn gta (bf16, no
     checkpoint: the random init); CLEVR-TR gta_so3, 2 train steps;
     `python -m gta_tpu_torch.evaluate <SRT> --synthetic --max-scenes 1`,
     which must report a finite PSNR; the gbt baseline (non-transform
     batches, torch-eager attention) trained one step with --evalnow and
     evaluated --ckpt best; the SRT baseline's reference model.pt (one
     train step of a B=2 batch here, exported with its AdamW moments)
     through `python -m gta_tpu_torch.scripts.import_reference_checkpoint`,
     then the train CLI, which must resume at it=1 and train at B=32
     through flash_core to step 2 (after msn gta's evaluate, in its chain).
  5a. Reference checkpoints (ref_ckpt_phase), the flagship (fp32, B=32)
     and msn_so3 as published (bf16, B=64; the so3 sign map at head width
     96): two train steps, saved; the port's export to a reference
     model.pt, weights only (the order template) and then with the AdamW
     moments; the import into a new run directory; a fresh trainer
     restored from it equal to the saved one bit for bit (weights,
     moments, AdamW steps, hyperparameter groups, scheduler state, LR,
     step); then one more step in each on the same batch (cuDNN's
     deterministic algorithms on): bit-equal losses and weights, the fused
     GTA launches of two steps asserted; export and import seconds
     printed.
  5b. The train runtime (runtime_phase), on the flagship at B=32: the
     gradient of loss_and_grads at grad_accum 2 against grad_accum 1 from
     the same weights and batch (relative L2 <= 1e-5; the fused GTA
     launches doubled, asserted; the accumulated peak memory lower), and
     at B=4 both against one fp64 step (small_batch_accum: accum 2 no
     further from it than SMALL_ACCUM_RULE x accum 1), warm
     train_steps of both and of accum 1 in a one-rank NCCL group; the
     train CLI on a config copy with print_every 1 under --validate-every
     2 --profile 2 stopped by SIGTERM after step 1 (exit 0, `latest`, a
     trace naming the fused GTA kernels), beside it `python -m
     torch.distributed.run --nproc_per_node 1` of the train CLI (NCCL,
     world size 1, its first loss that of the plain run) and of train_dit
     on dit_gta, 2 steps; then, once those end, the stopped run resumed
     (in a cli_worker started beside them)
     under --accum 2 --speed_test 4 (the saved it + 1, time.npy,
     metrics.jsonl in plot_metrics' schema over both runs). NCCL refuses
     two ranks on one card: two ranks run in gloo (phase 4c) and on the CPU
     (tests/test_torch_distributed.py).
  6. The host data plane and the dataset readers (disk_phase), on fixtures
     written into a temporary directory by the port's PNG encoder, every
     scanline filter row by row: CLEVR-TR (256 train scenes over 64
     distinct image sets, 2 test scenes, 5 views of 240x320) and a
     RealEstate10K dump (2 train videos and 1 test video of 40 frames of
     240x320). The host library (gta_tpu_torch/data/native.py: the PNG
     decoder over zlib and the sphere renderer, built with g++) is held to
     its plain versions: every file decodes to the array written, natively
     and through the numpy codec; decode ms per frame, the two in turns,
     one file and 5 a call (native at least 5x faster, or the phase
     fails); the synthetic render of 5 views, native and numpy. A CLEVRTR
     item's host time by part, and items/s through Loader at 1 and 4
     worker threads. The flagship at its config's B=32 fed from the dump
     through Loader(4 workers, prefetch 2): 7 train steps (wall and
     wait-on-loader ms each) between synthetic B=32 steps, then one
     eval_step on the first disk batch and one on the synthetic batch,
     launch counts asserted for each run; msn gta (bf16) on 16 prep_scene items from seeded raw
     10x128x128 scenes: eval_step and train_step beside a synthetic batch
     of the same shapes, launch counts asserted. The train CLI on the
     positional datapath, then evaluate --ckpt best, for the flagship
     (CLEVR-TR reader, 240x320 full-scale views) and re10k gta (bf16;
     RealEstate10K reader); in process, one evaluate each of the re10k SRT
     (bf16) and the CLEVR-TR SRT (fp32), the readers' non-transform
     branches, launch counts asserted.
  4b. The DiT family (each config as published, the trainer's seeded
     init): dit_kernel_phase, each bf16 instance at the DiT's shapes (the
     train batch 256 forward and backward, the sampler's CFG batch 16
     forward) as in phase 2's bf16 rule, against plain and fp64;
     dit_path_phase through DiTTrainer: a cold and 3 warm train_steps, 4
     more fed by Loader(4 worker threads, collate_images) with the wait on
     the loader beside each step, evaluate on two val batches of 64, and
     sample of 8 labels (CFG, guidance 4, 50 DDIM steps), every path's
     launch counts asserted (12 forward + 12 backward of its kernel per
     train step, 12 forward per evaluated batch and per sampler step, none
     of any other instance); dit_card_vs_cpu_phase, B=2 outputs at nonzero
     random weights, the card's bf16 within 1.5x the emulated TPU
     rounding's gap from the CPU's fp32; dit_cli_phase, `python -m
     gta_tpu_torch.train_dit` at batch 256 with --samplenow: dit_gta 2
     steps, then resumed for a third, then `python -m
     gta_tpu_torch.scripts.eval_dit_samples --per-class 1` on the run;
     dit_base one step (the run's time).
  8. Device-made data (device_data_phase): data/device_synth.DeviceSynthetic
     for the flagship (fp32, B=32), msn_so3 as published (bf16, B=64) and
     re10k gta and srt as published (runs/re10k; bf16, B=32, 2 + 2 views of
     120x160), data/images.DeviceSyntheticImages for dit_gta (B=256): each
     generator's batch() under torch.cuda.set_sync_debug_mode("error"),
     timed (CUDA events, median of 7 after 2 warm-ups) with its own peak
     memory, and held against the same ids made on the CPU (sceneid,
     target_coord and labels equal; cameras, rays and transforms within
     1e-5; images within 1e-4 on 99.9 % of the pixels, the share beyond
     printed); a cold and 3 warm train_steps on device batches (the
     generator's time included) beside the same on a ready host-made batch
     on the card, launch counts asserted for both; dit_gta's step fed by
     Loader's threads beside them; re10k gta and srt's serving path
     (serving_path_phase at B=32, a 240x320 view at chunk 16384) and one
     re10k gta train step under torch.profiler, device ms by kernel name.
     Then the seven experiments/ configs (the flagship in bf16 on three
     schedules, msn_so3_40k, re10k_quality20k, dit_metric_base and _gta at
     10 classes and B=128), a cold and a warm --device-data step each at
     full width, launch counts asserted; and the CLIs: `python -m
     gta_tpu_torch.train experiments/clevrtr_long150k/config.yaml
     --device-data` for 2 steps, beside `python -m gta_tpu_torch.train_dit
     experiments/dit_metric_gta/config.yaml --device-data --samplenow` and
     a one-rank `python -m torch.distributed.run` of the train CLI, and the
     first resumed for a third step as soon as it ends, whose scene ids
     must be the generator's batch 2 (an unbroken run's).
  4c. The JAX package's other parallelism (parallel_phase), in gloo groups
     on the card (NCCL refuses two ranks on one card). Two ranks: the
     flagship (fp32, B=32, dropout 0) under --n-model 2 (3 heads a rank),
     --n-seq 2 (one view a rank, GTA's keys ringed) and ZeRO-1 over two
     data ranks, msn_so3 as published (bf16, B=64) under --n-model 2; gbt
     and repast (fp32, B=32) and msn gta_so3_euclid (bf16, B=16) under
     --n-model 2, their attention in torch eager on the rank's heads; SRT
     (fp32, B=32) and msn_so3 (bf16, B=64, 5 views) under --n-seq 2, every
     module whole on each seq rank. Four ranks: the flagship under
     --n-model 4 (6 heads: its attention layers whole, its FeedForwards
     split). All at full width and depth; each mode's first step against
     the one-process step from the same weights on the same batch (fp32:
     weights within 1e-5 relative L2, the gradient's error against an
     fp64 step no more than 1e-5 above the one-process step's, each
     trans_coeff within 1e-4 of its terms; bf16: the gradient from fp32
     within 1.5x the one-process bf16 step's), the kernels' launches per
     rank asserted (7 + 7 fused GTA under TP, ZeRO-1 and --n-model 4,
     none under the ring or on an eager route, flash_core 7 + 7 for SRT
     and fused GTA 7 + 7 for msn_so3 under --n-seq 2), which modules rang
     asserted from what the ranks print, the warm step beside the
     one-process step's. It runs beside the DiT CLIs, the gradient checks
     (phase 4's grads_phase) in this process meanwhile.
  4d. Every head width from 32 to 128 and the model options no published
     config reaches (slice 20). In phase 2, width_phase: the kernels'
     instances at head widths 32 and 128 (NEW_WIDTHS), fp32 and bf16, both
     kernels of each pair, at DiT-XL/2's train shape (B=256, 256 tokens,
     hidden 1152 in 1152 / C heads) and CLEVR-TR's decoder train shape
     (B=32, hidden 384), against plain and fp64 as the other instances,
     with ms, SDPA's ms and the bound; padding_phase, what the copies of a
     width between two instances cost (C = 72 in the instance of 96 at
     DiT-XL/2's shapes). After the other methods, option_phase (B=16, one
     cold eval_step and train_step each, launch counts asserted by
     instance width): the SRT baseline with its decoder's dim_head at 32
     and 128, the flagship at head width 32 and 128 on both sides
     (at_width), each fp32 and bf16, so every new instance runs on a
     path; the flagship with planar and with camera_planar embeddings in
     encoder and decoder; the SRT baseline with a one-head decoder that
     returns its last attention map (launching no kernel in the decoder),
     the last three also card against CPU at B=2 (pixels, and the masks
     summing to 1). After the DiT family, both DiT configs at DiT-XL/2's
     width (dit_xl: hidden 1152, 16 heads of 72, which run in the
     instances of 96, depth cut from 28 to 4): dit_kernel_phase at its
     shapes, dit_xl_path_phase (one train_step at B=256, evaluate on a val
     batch of 64, a 2-step DDIM sample of 8 labels under CFG, launches
     asserted) and dit_card_vs_cpu_grads_phase (B=2 loss and whole
     gradient at depth 1 within 1.5x the emulated TPU rounding's gap from
     the CPU's fp32).
  9. One JSON line of kernel numbers, an entry per kernel instance (fp32
     and bf16; the instances at head widths 64 and 96 one entry a kernel
     and dtype, those at 32 and 128 one each, `<kernel>[_bf16]_c<C>`;
     launches by path, the attention core it runs and that core's ptxas
     registers and spills in its libraries), then the device JSON as the
     last line.

Each phase prints its wall seconds ("phase seconds: <name> <s>", and all
of them on a line before the kernels line). The time budget: half the
1200 s limit is the aim. Measured on one NVIDIA H100 80GB HBM3 at 700 W
before phase 8 was added (PERF.md, section 6): the subprocess CLIs, run
one after another, took 146 s (phase 5), 84 s (the DiT CLIs) and 76 s
(the disk phase's four), most of it process start; OTHER_METHODS' cold
steps 7.9 s and the msn variants 3.3 s. So the CLIs run side by side
(side_by_side: phase 5 as four chains, the DiT CLIs and the disk phase's
train -> evaluate as two each); no check and no launch assertion was
dropped, and no path's depth was cut. To make room for phase 4c:
the bf16 card-vs-CPU forwards run at one attention block a side (on one
H100 80GB HBM3 at 700 W, 36.5 s -> 19.6 s), the gradient checks (19.4
s there) run while the DiT CLIs and phase 4c's ranks do, and the runtime
and device-data phases start each resumed CLI as the run it resumes
ends. Since then each chain's CLIs run in one long-lived process
(run_cli's cli_worker; phase 5 146 s -> 35 s with the chains side by
side), and phase 4c's two ranks start during the DiT phases
(start_parallel). bf16_layer_phase holds each bf16 layer kind, chain and
cotangent at full width, card against CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GTA_CONFIG = os.path.join(ROOT, "runs", "clevrtr", "GTA", "gta", "config.yaml")
SRT_CONFIG = os.path.join(ROOT, "runs", "clevrtr", "otherPEs", "srt", "config.yaml")
CLEVR_SO3_CONFIG = os.path.join(ROOT, "runs", "clevrtr", "GTA", "gta_so3", "config.yaml")
MSN_SO3_CONFIG = os.path.join(ROOT, "runs", "msn", "GTA", "gta_so3", "config.yaml")
MSN_SRT_CONFIG = os.path.join(ROOT, "runs", "msn", "otherPEs", "srt", "config.yaml")
MSN_GTA_CONFIG = os.path.join(ROOT, "runs", "msn", "GTA", "gta", "config.yaml")
GBT_CONFIG = os.path.join(ROOT, "runs", "clevrtr", "otherPEs", "gbt", "config.yaml")
# the other attention methods (ROADMAP queue 1 item 7): GTA's t2 ablation at
# full paths, and every other config at one eval_step and train step
T2_CONFIG = os.path.join(ROOT, "runs", "clevrtr", "GTA", "gta_t2", "config.yaml")
MSN_T2_CONFIG = os.path.join(ROOT, "runs", "msn", "GTA", "gta_t2", "config.yaml")
OTHER_METHODS = ("clevrtr/GTA/gta_euclid", "clevrtr/otherPEs/elementwise_mul", "clevrtr/otherPEs/ape",
                 "clevrtr/otherPEs/mln", "clevrtr/otherPEs/gbt", "clevrtr/otherPEs/repast",
                 "clevrtr/otherPEs/repast_cnoise0.1", "clevrtr/otherPEs/rpe", "clevrtr/otherPEs/frustum_posemb_dmax20",
                 "clevrtr/otherPEs/ftl_rope", "msn/GTA/gta_so3_euclid", "msn/otherPEs/repast")
# the DiT family (runs/imagenet/DiT): DiT-S/2 with 2D GTA and the stock baseline
DIT_GTA_CONFIG = os.path.join(ROOT, "runs", "imagenet", "DiT", "dit_gta", "config.yaml")
DIT_BASE_CONFIG = os.path.join(ROOT, "runs", "imagenet", "DiT", "dit_base", "config.yaml")
# the other msn GTA variants: no value transform, shared frequencies, an
# SO(2)-only and an SE(3)-only encoder (their decoders recompute so2)
MSN_VARIANTS = ("gta_novtrnsfm", "gta_sharedfreqs", "gta_no3demb", "gta_no2demb")
TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, fp32-accurate products on the tensor cores (3xTF32: three dense
# TF32 products per fp32 product), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12
BF16_RULE = 1.5  # a bf16 kernel's error at most this many times the TPU rounding's (the bf16 emulation)
TIMED_RUNS, WARMUP = 7, 2
EVAL_BATCH = 32  # the CLEVR-TR configs' batch size
MSN_BATCH = 64  # the msn configs' batch size
VARIANT_BATCH = 16  # the four msn GTA variants' batch here (the run's time)
RENDER_CHUNK = 16384  # the evaluation protocol's chunk
RENDER_RUNS = 3  # timed full-frame renders, after one warm-up
TRAIN_RUNS = 3  # timed warm train steps, after one cold step


PHASE_SECONDS = {}  # wall seconds of each phase (summed where a name repeats), printed as they end


def timed(name, fn, *args, **kwargs):
    """fn(*args, **kwargs), its wall seconds added to PHASE_SECONDS[name]
    and printed."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    finally:
        close_cli_worker()  # the phase's CLIs run in this thread, if any
    dt = time.perf_counter() - t0
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + dt
    print(f"phase seconds: {name} {dt:.1f}", flush=True)
    return out


def time_ms(fn, runs=TIMED_RUNS, warmup=WARMUP) -> float:
    """Median CUDA-event time of `fn` in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@functools.lru_cache(maxsize=None)
def synthetic_batch(data, mode, start, stop, seed=0):
    """Items start..stop-1 of a synthetic split, collated (a host batch),
    made once per run: the msn configs share one data config."""
    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate

    ds = SyntheticScenes(data, mode, seed=seed)
    return collate([ds[i] for i in range(start, stop)])


def fused_cost(t, B, H, Tq, Tk, C, elem=4):
    """(flops, bytes) the fused forward must do and move: matmul flops of
    the core and the per-view transforms; each input read once, the output
    written once; q, k, v and out of `elem` bytes (the tables fp32)."""
    flops = 4.0 * Tq * Tk * C
    flops += 2.0 * Tq * C * C * ((t.mq is not None) + (t.mo is not None and t.v_transform))
    flops += 2.0 * Tk * C * C * (t.mk is not None) * (1 + t.v_transform)
    flops *= B * H
    tables = [t.mq, t.mk, t.mo, t.cq, t.sq, t.ck, t.sk]
    n_bytes = elem * (2.0 * B * Tq * H * C + 2 * B * Tk * H * C) + 4.0 * sum(x.numel() for x in tables if x is not None)
    return flops, n_bytes


def bwd_cost(t, B, H, Tq, Tk, C, elem=4):
    """(flops, bytes) the fused backward must do and move: the JAX package's
    operation count (gta_tpu/ops/gta_fused.py:87 _kernel_flops: 5 core
    products, s, dp, dqt, dkt, dvt, plus two C x C products per transform
    chain); q, k, v, g, z and the tables read once, dq, dk, dv and the
    matrix cotangents written once; operands and their gradients of `elem`
    bytes (the tables and their cotangents fp32)."""
    flops = 5 * 2.0 * Tq * Tk * C
    flops += 2 * 2.0 * Tq * C * C * ((t.mq is not None) + (t.mo is not None and t.v_transform))
    flops += 2 * 2.0 * Tk * C * C * (t.mk is not None) * (1 + t.v_transform)
    flops *= B * H
    tables = [t.mq, t.mk, t.mo, t.cq, t.sq, t.ck, t.sk]
    mats = [t.mq, t.mk, t.mo]
    n_bytes = (elem * (4.0 * B * Tq * H * C + 4 * B * Tk * H * C)
               + 4.0 * sum(x.numel() for x in tables + mats if x is not None))
    return flops, n_bytes


def bound(flops, n_bytes, peak=PEAK_FP32_FLOPS):
    """(bound ms, what bounds it) at the fp32 CUDA-core peak (`bound_ms`),
    or at another peak (`bound_tc_ms`: PEAK_TF32X3_FLOPS)."""
    t_ops, t_bytes = flops / peak * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bounds(flops, n_bytes):
    """The kernels-line bound keys of one shape."""
    bound_ms, bound_by = bound(flops, n_bytes)
    bound_tc_ms, bound_tc_by = bound(flops, n_bytes, PEAK_TF32X3_FLOPS)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bound_tc_ms": bound_tc_ms, "bound_tc_by": bound_tc_by}


def gta_calls(cfg, device, batch=EVAL_BATCH, prefix=""):
    """Rep tables of a GTA config's attention calls on a synthetic batch
    (and one full-scale render chunk): name -> (args, reps, B, Tq, Tk)."""
    import torch

    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.geometry.coords import make_2dcoord
    from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps

    enc_cfg, dec_cfg = cfg.model.encoder, cfg.model.decoder
    b32 = synthetic_batch(cfg.data, "val", 0, batch).to(device)
    enc32 = encoder_reps(enc_cfg.attn.gta, b32.input_coord, b32.input_transforms)
    dec32 = decoder_reps(
        dec_cfg.attn.gta, target_coord=b32.target_coord, target_transforms=b32.target_transforms,
        input_coord=b32.input_coord, input_transforms=b32.input_transforms, enc=enc32,
    )
    full = collate([SyntheticScenes(cfg.data, "test", full_scale=True)[0]]).to(device)
    enc1 = encoder_reps(enc_cfg.attn.gta, full.input_coord, full.input_transforms)
    coord = make_2dcoord(cfg.data.height, cfg.data.width).reshape(1, 1, -1, 2)[:, :, :RENDER_CHUNK]
    coord = torch.from_numpy(coord).to(device)
    dec1 = decoder_reps(
        dec_cfg.attn.gta, target_coord=coord, target_transforms=full.target_transforms[:, :1],
        input_coord=full.input_coord, input_transforms=full.input_transforms, enc=enc1,
    )
    Tk = b32.input_coord.shape[1] * b32.input_coord.shape[2]
    Tq_dec = b32.target_coord[0].numel() // 2
    return {
        f"{prefix}encoder_self_b{batch}": (enc_cfg.attn.gta, enc32, batch, Tk, Tk),
        f"{prefix}decoder_eval_b{batch}": (dec_cfg.attn.gta, dec32, batch, Tq_dec, Tk),
        f"{prefix}render_chunk_b1": (dec_cfg.attn.gta, dec1, 1, coord.shape[2], Tk),
        f"{prefix}encoder_train_b{batch}": (enc_cfg.attn.gta, enc32, batch, Tk, Tk),
        f"{prefix}decoder_train_b{batch}": (dec_cfg.attn.gta, dec32, batch, Tq_dec, Tk),
    }


def kernel_phase(cfg, calls, device):
    """Forward kernel vs plain at a GTA config's serving shapes; returns
    per-shape numbers."""
    import torch
    import torch.nn.functional as F

    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.gta import gta_transform_qkv

    enc_cfg = cfg.model.encoder
    H, C = enc_cfg.heads, enc_cfg.attdim // enc_cfg.heads
    scale = C**-0.5
    tc = torch.tensor([0.01], device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name in [n for n in calls if "_self_" in n or "_eval_" in n or "render_chunk" in n]:
        args, reps, B, Tq, Tk = calls[name]
        qB = torch.randn((B, Tq, H * C), generator=gen, device=device)
        kB = torch.randn((B, Tk, H * C), generator=gen, device=device)
        vB = torch.randn((B, Tk, H * C), generator=gen, device=device)
        with torch.no_grad():
            tgf.check_supported(reps, args, Tq, Tk)
            t = tgf.fused_tables(reps, args, tc)
            got = tgf.gta_fused_fwd(qB, kB, vB, t, H, scale)
            torch.cuda.synchronize()
            want = tgf.gta_fused_fwd_plain(qB, kB, vB, t, H, scale)
            err = (got - want).abs().max().item()
            ms = time_ms(lambda: tgf.gta_fused_fwd(qB, kB, vB, t, H, scale))
            plain_ms = time_ms(lambda: tgf.gta_fused_fwd_plain(qB, kB, vB, t, H, scale), runs=5)

            def heads(x):
                return x.reshape(B, x.shape[1], H, C).transpose(1, 2)

            qt, kt, vt = (x.contiguous() for x in gta_transform_qkv(heads(qB), heads(kB), heads(vB), reps, args, tc))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        flops, n_bytes = fused_cost(t, B, H, Tq, Tk, C)
        bd = bounds(flops, n_bytes)
        results[name] = {
            "B": B, "Tq": Tq, "Tk": Tk, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bd, "gflop": flops / 1e9, "mbytes": n_bytes / 1e6,
        }
        print(f"kernel gta_fused_fwd {name}: B={B} Tq={Tq} Tk={Tk} max|d|={err:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
              f"bound_ms={bd['bound_ms']:.4f} ({bd['bound_by']}) bound_tc_ms={bd['bound_tc_ms']:.4f}", flush=True)
        if not err <= TOL:
            raise AssertionError(f"gta_fused_fwd {name}: max|kernel - plain| = {err} > {TOL}")
        del qB, kB, vB, got, want, qt, kt, vt
        torch.cuda.empty_cache()
    return results


def check_bwd(label, got, want, kernel="gta_fused_bwd") -> float:
    """Each backward output within 1e-4 * max(1, max|plain|); returns the
    largest max|kernel - plain| over the outputs."""
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"{kernel} {label}: {name} present in only one version")
        if b is None:
            continue
        err, scale = (a - b).abs().max().item(), max(1.0, b.abs().max().item())
        if not err <= TOL * scale:
            raise AssertionError(f"{kernel} {label} {name}: max|kernel - plain| = {err} > {TOL} * {scale}")
        worst = max(worst, err)
    return worst


def branch_phase(device):
    """Every flag branch of both kernels (C = 64, B = 2, 2 views of 300
    tokens) against the plain versions; returns the worst (fwd, bwd)
    max|kernel - plain|."""
    import torch

    from gta_tpu_torch.config import FDims, GTAArgs
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.reps import encoder_reps

    rng = np.random.RandomState(0)
    coord = torch.from_numpy(rng.rand(2, 2, 300, 2).astype(np.float32)).to(device)
    ang = rng.rand(2, 2) * 6.28
    tf = np.tile(np.eye(4, dtype=np.float32), (2, 2, 1, 1))
    tf[..., 0, 0], tf[..., 0, 1], tf[..., 1, 0], tf[..., 1, 1] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
    tf[..., :3, 3] = rng.randn(2, 2, 3)
    tf = torch.from_numpy(tf).to(device)
    worst_fwd = worst_bwd = 0.0
    for fd, so2, vt in [
        (dict(se3=64), 0, True),
        (dict(so2=64), 16, True),
        (dict(triv=16, se3=16, so2=32), 8, False),
        (dict(triv=16, se3=16, so2=32), 8, True),
    ]:
        args = GTAArgs(f_dims=FDims(**fd), so2=so2, v_transform=vt)
        reps = encoder_reps(args, coord, tf)
        q, k, v, g = (torch.from_numpy(rng.randn(2, 600, 384).astype(np.float32)).to(device) for _ in range(4))
        with torch.no_grad():
            t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=device))
            got = tgf.gta_fused_fwd(q, k, v, t, 6, 0.125)
            torch.cuda.synchronize()
            err = (got - tgf.gta_fused_fwd_plain(q, k, v, t, 6, 0.125)).abs().max().item()
            _, res = tgf.gta_fused_fwd(q, k, v, t, 6, 0.125, residuals=True)
            bwd = tgf.gta_fused_bwd(q, k, v, t, 6, 0.125, g, res)
            torch.cuda.synchronize()
            bwd_err = check_bwd(f"branch {fd}", bwd, tgf.gta_fused_bwd_plain(q, k, v, t, 6, 0.125, g, res.z))
        print(f"kernel gta_fused_fwd / gta_fused_bwd branch {fd} so2={so2} v_transform={vt}: "
              f"max|d| fwd={err:.3e} bwd={bwd_err:.3e}", flush=True)
        if not err <= TOL:
            raise AssertionError(f"gta_fused_fwd branch {fd}: max|kernel - plain| = {err} > {TOL}")
        worst_fwd, worst_bwd = max(worst_fwd, err), max(worst_bwd, bwd_err)
    return worst_fwd, worst_bwd


def gta_edge_phase(device, mixes=None, heads=6):
    """Both fused GTA kernels at B=2, one view per side, on the ragged
    shapes Tq in {1, 17, 601}, Tk in {1, 33, 2100} (one row, a ragged last
    16-row warp tile or key tile, more keys than the Pallas kernel holds in
    VMEM), for each GTAArgs of `mixes` (default C = 64, 6 heads: every
    transform, se3 32 + so2 32, and none, raw token-major q, k, v); returns
    the worst (fwd, bwd) max|kernel - plain|."""
    import torch

    from gta_tpu_torch.config import FDims, GTAArgs
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps

    rng = np.random.RandomState(4)

    def transforms():
        ang = rng.rand(2, 1) * 6.28
        tf = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1, 1))
        tf[..., 0, 0], tf[..., 0, 1], tf[..., 1, 0], tf[..., 1, 1] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
        tf[..., :3, 3] = rng.randn(2, 1, 3)
        return torch.from_numpy(tf).to(device)

    if mixes is None:
        mixes = [GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8), GTAArgs(f_dims=FDims(triv=64))]
    worst_fwd = worst_bwd = 0.0
    for args in mixes:
        C = args.f_dims.total
        scale = C**-0.5
        fd = {name: ed - st for name, st, ed in args.f_dims.slices()}
        for Tq in (1, 17, 601):
            for Tk in (1, 33, 2100):
                coord, t_coord = (torch.from_numpy(rng.rand(2, 1, T, 2).astype(np.float32)).to(device) for T in (Tk, Tq))
                tf, t_tf = transforms(), transforms()
                reps = decoder_reps(args, target_coord=t_coord, target_transforms=t_tf, input_coord=coord,
                                    input_transforms=tf, enc=encoder_reps(args, coord, tf))
                q, k, v, g = (torch.from_numpy(rng.randn(2, T, heads * C).astype(np.float32)).to(device)
                              for T in (Tq, Tk, Tk, Tq))
                with torch.no_grad():
                    t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=device))
                    out, res = tgf.gta_fused_fwd(q, k, v, t, heads, scale, residuals=True)
                    got = tgf.gta_fused_bwd(q, k, v, t, heads, scale, g, res)
                    torch.cuda.synchronize()
                    want, want_z = tgf.gta_fused_fwd_plain(q, k, v, t, heads, scale, store_z=True)
                    err = max((out - want).abs().max().item(), (res.z - want_z).abs().max().item())
                    berr = check_bwd(f"edge {fd} Tq={Tq} Tk={Tk}", got,
                                     tgf.gta_fused_bwd_plain(q, k, v, t, heads, scale, g, res.z))
                print(f"kernel gta_fused_fwd / gta_fused_bwd edge {fd} H={heads} B=2 Tq={Tq} Tk={Tk}: "
                      f"max|d| fwd={err:.3e} bwd={berr:.3e}", flush=True)
                if not err <= TOL:
                    raise AssertionError(f"gta_fused_fwd edge {fd} Tq={Tq} Tk={Tk}: max|kernel - plain| = {err} > {TOL}")
                worst_fwd, worst_bwd = max(worst_fwd, err), max(worst_bwd, berr)
    return worst_fwd, worst_bwd


def train_kernel_phase(cfg, calls, device, geometry=None):
    """Both kernels at a GTA config's train shapes: the forward with its
    training residuals, and the backward, each against its plain version;
    returns ({shape: fwd numbers}, {shape: bwd numbers}). `geometry`
    (heads, head width) in place of the config's encoder's (cfg None: the
    width phase's calls)."""
    import torch
    import torch.nn.functional as F

    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.gta import gta_transform_qkv

    if geometry is None:
        H, C = cfg.model.encoder.heads, cfg.model.encoder.attdim // cfg.model.encoder.heads
    else:
        H, C = geometry
    scale = C**-0.5
    tc = torch.tensor([0.01], device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    fwd, bwd = {}, {}
    for name in [n for n in calls if "_train_" in n]:
        args, reps, B, Tq, Tk = calls[name]
        qB, kB, vB = (torch.randn((B, T, H * C), generator=gen, device=device) for T in (Tq, Tk, Tk))
        g = torch.randn((B, Tq, H * C), generator=gen, device=device)
        with torch.no_grad():
            t = tgf.fused_tables(reps, args, tc)
            out, res = tgf.gta_fused_fwd(qB, kB, vB, t, H, scale, residuals=True)
            torch.cuda.synchronize()
            want_out, want_z = tgf.gta_fused_fwd_plain(qB, kB, vB, t, H, scale, store_z=True)
            fwd_err = max((out - want_out).abs().max().item(), (res.z - want_z).abs().max().item())
            del want_out, want_z
            fwd_ms = time_ms(lambda: tgf.gta_fused_fwd(qB, kB, vB, t, H, scale, residuals=True))
            fwd_plain_ms = time_ms(lambda: tgf.gta_fused_fwd_plain(qB, kB, vB, t, H, scale, store_z=True), runs=5)
            got = tgf.gta_fused_bwd(qB, kB, vB, t, H, scale, g, res)
            torch.cuda.synchronize()
            bwd_err = check_bwd(name, got, tgf.gta_fused_bwd_plain(qB, kB, vB, t, H, scale, g, res.z))
            del got
            ms = time_ms(lambda: tgf.gta_fused_bwd(qB, kB, vB, t, H, scale, g, res))
            plain_ms = time_ms(lambda: tgf.gta_fused_bwd_plain(qB, kB, vB, t, H, scale, g, res.z), runs=5)

            def heads(x):
                return x.reshape(B, x.shape[1], H, C).transpose(1, 2)

            qkv = [x.contiguous() for x in gta_transform_qkv(heads(qB), heads(kB), heads(vB), reps, args, tc)]
            gh = heads(g).contiguous()
            sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(*qkv, scale=scale))
        # yardstick: the backward alone of SDPA on the pre-transformed q/k/v
        leaves = [x.requires_grad_() for x in qkv]
        sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
        library_ms = time_ms(lambda: sdpa_out.backward(gh, retain_graph=True))
        del leaves, sdpa_out, qkv
        f_flops, f_bytes = fused_cost(t, B, H, Tq, Tk, C)
        f_bytes += 4.0 * (B * Tq * H * C + B * H * Tq)  # z and lse written
        fb = bounds(f_flops, f_bytes)
        fwd[name] = {
            "B": B, "Tq": Tq, "Tk": Tk, "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
            "library_ms": sdpa_fwd_ms, **fb, "residuals": True,
        }
        b_flops, b_bytes = bwd_cost(t, B, H, Tq, Tk, C)
        bb = bounds(b_flops, b_bytes)
        bwd[name] = {
            "B": B, "Tq": Tq, "Tk": Tk, "max_abs_err": bwd_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bb, "gflop": b_flops / 1e9, "mbytes": b_bytes / 1e6,
        }
        print(f"kernel gta_fused_fwd (training residuals) {name}: B={B} Tq={Tq} Tk={Tk} max|d|={fwd_err:.3e} "
              f"ms={fwd_ms:.4f} plain_ms={fwd_plain_ms:.4f} sdpa_ms={sdpa_fwd_ms:.4f} bound_ms={fb['bound_ms']:.4f} "
              f"({fb['bound_by']}) bound_tc_ms={fb['bound_tc_ms']:.4f}", flush=True)
        print(f"kernel gta_fused_bwd {name}: B={B} Tq={Tq} Tk={Tk} max|d|={bwd_err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_bwd_ms={library_ms:.4f} bound_ms={bb['bound_ms']:.4f} ({bb['bound_by']}, "
              f"{b_flops / 1e9:.1f} GFLOP) bound_tc_ms={bb['bound_tc_ms']:.4f}", flush=True)
        if not fwd_err <= TOL:
            raise AssertionError(f"gta_fused_fwd residuals {name}: max|kernel - plain| = {fwd_err} > {TOL}")
        del qB, kB, vB, g, out, res
        torch.cuda.empty_cache()
    return fwd, bwd


def srt_shapes(cfg, batch=EVAL_BATCH):
    """The SRT baseline's attention calls: name -> (B, Tq, Tk). Keys are the
    encoder's patch tokens over all input views; decoder queries are the
    config's rays per item, or one render chunk."""
    d, enc = cfg.data, cfg.model.encoder
    h, w = d.height // 2**d.downsample, d.width // 2**d.downsample
    Tk = d.num_input_views * (h >> enc.num_conv_blocks) * (w >> enc.num_conv_blocks)
    return {
        f"encoder_self_b{batch}": (batch, Tk, Tk),
        f"decoder_eval_b{batch}": (batch, d.num_points, Tk),
        "render_chunk_b1": (1, RENDER_CHUNK, Tk),
        f"encoder_train_b{batch}": (batch, Tk, Tk),
        f"decoder_train_b{batch}": (batch, d.num_points, Tk),
    }


def flash_cost(B, H, Tq, Tk, C, backward=False, elem=4, out_elem=None):
    """(flops, bytes) flash_core must do and move: 2 products of
    2*Tq*Tk*C flops per (b, h) forward, 5 backward (s, dp, dq, dk, dv);
    q, k, v (and g) read once, each element of `elem` bytes, out (dq, dk,
    dv) written once, of `out_elem` bytes (`elem` by default)."""
    D = H * C
    out_elem = elem if out_elem is None else out_elem
    if backward:
        return 10.0 * B * H * Tq * Tk * C, B * (elem * (2.0 * Tq * D + 2 * Tk * D) + out_elem * (Tq * D + 2 * Tk * D))
    return 4.0 * B * H * Tq * Tk * C, B * (elem * (Tq * D + 2 * Tk * D) + out_elem * Tq * D)


# flash_core's fp32 instances against fp64 at each shape cut to B=2: each
# output's relative L2 error within FP64_TOL (fp32 accuracy; the plain
# version's own fp32 error on the card is printed beside it)
FP64_TOL = 1e-5


def fp64_check(label, got, plain32, ref, names):
    """Each output's relative L2 error against fp64 within FP64_TOL; returns
    {output: (kernel, plain fp32)}."""
    errs = {}
    for name, a, p, r in zip(names, got, plain32, ref):
        errs[name] = (rel_l2(a, r), rel_l2(p, r))
        if not errs[name][0] <= FP64_TOL:
            raise AssertionError(f"{label} {name}: relative L2 from fp64 {errs[name][0]:.3e} > {FP64_TOL} (the "
                                 f"plain fp32 version's {errs[name][1]:.3e})")
    return errs


def flash_kernel_phase(cfg, device, batch=EVAL_BATCH, prefix="", geometry=None):
    """flash_core forward and backward (fp32 instances) against their plain
    versions at the shapes of a config's attention (`srt_shapes`: the
    encoder's heads and head width; the SRT baseline's, or msn gta_t2's
    after its sliced transforms), and against fp64 at each shape cut to
    B=2 (`fp64_check`); returns ({shape: fwd numbers}, {shape: bwd
    numbers}). `geometry` (heads, head width, {shape: (B, Tq, Tk)}) in
    place of the config's (cfg None: the width phase's shapes)."""
    import torch
    import torch.nn.functional as F

    from gta_tpu_torch.ops import flash_core as fc

    if geometry is None:
        enc = cfg.model.encoder
        H, C, shapes = enc.heads, enc.attdim // enc.heads, srt_shapes(cfg, batch)
    else:
        H, C, shapes = geometry
    scale = C**-0.5
    gen = torch.Generator(device=device).manual_seed(2)
    fwd, bwd = {}, {}
    for name, (B, Tq, Tk) in shapes.items():
        name = prefix + name
        train = "_train_" in name
        q, k, v, g = (torch.randn((B, T, H * C), generator=gen, device=device) for T in (Tq, Tk, Tk, Tq))
        qh, kh, vh, gh = (x.reshape(B, x.shape[1], H, C).transpose(1, 2).contiguous() for x in (q, k, v, g))
        with torch.no_grad():
            out, lse = fc.flash_core_fwd(q, k, v, H, scale, residuals=True)
            torch.cuda.synchronize()
            want, want_lse = fc.flash_core_fwd_plain(q, k, v, H, scale, lse=True)
            err = (out - want).abs().max().item()
            if train:
                err = max(err, (lse - want_lse).abs().max().item())
            del want, want_lse
            small = [x[:2].contiguous() for x in (q, k, v, g)]
            got2 = fc.flash_core_fwd(*small[:3], H, scale, residuals=True)
            got2 += fc.flash_core_bwd(*small[:3], H, scale, small[3], *got2) if train else ()
            p32 = fc.flash_core_fwd_plain(*small[:3], H, scale, lse=True)
            p32 += fc.flash_core_bwd_plain(*small[:3], H, scale, small[3]) if train else ()
            small = [x.double() for x in small]
            ref = fc.flash_core_fwd_plain(*small[:3], H, scale, lse=True)
            ref += fc.flash_core_bwd_plain(*small[:3], H, scale, small[3]) if train else ()
            errs64 = fp64_check(f"flash_core {name}[:2]", got2, p32, ref, ("out", "lse", "dq", "dk", "dv"))
            del small, got2, p32, ref
            ms = time_ms(lambda: fc.flash_core_fwd(q, k, v, H, scale, residuals=train))
            plain_ms = time_ms(lambda: fc.flash_core_fwd_plain(q, k, v, H, scale, lse=train), runs=5)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        flops, n_bytes = flash_cost(B, H, Tq, Tk, C)
        n_bytes += 4.0 * B * H * Tq * train  # lse written
        bd = bounds(flops, n_bytes)
        fwd[name] = {
            "B": B, "Tq": Tq, "Tk": Tk, "C": C, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bd, "residuals": train, "rel_l2_vs_fp64": errs64,
        }
        print(f"kernel flash_core_fwd{' (training residual)' if train else ''} {name}: B={B} Tq={Tq} Tk={Tk} C={C} "
              f"max|d|={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
              f"bound_ms={bd['bound_ms']:.4f} ({bd['bound_by']}) bound_tc_ms={bd['bound_tc_ms']:.4f}; at B=2 "
              "relative L2 from fp64 kernel / plain fp32 "
              + ", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in errs64.items()), flush=True)
        if not err <= TOL:
            raise AssertionError(f"flash_core_fwd {name}: max|kernel - plain| = {err} > {TOL}")
        if train:
            with torch.no_grad():
                got = fc.flash_core_bwd(q, k, v, H, scale, g, out, lse)
                torch.cuda.synchronize()
                berr = check_bwd(name, got, fc.flash_core_bwd_plain(q, k, v, H, scale, g), "flash_core_bwd")
                del got
                ms = time_ms(lambda: fc.flash_core_bwd(q, k, v, H, scale, g, out, lse))
                plain_ms = time_ms(lambda: fc.flash_core_bwd_plain(q, k, v, H, scale, g), runs=5)
            # yardstick: the backward alone of SDPA on the same q/k/v
            leaves = [x.requires_grad_() for x in (qh, kh, vh)]
            sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
            library_ms = time_ms(lambda: sdpa_out.backward(gh, retain_graph=True))
            del leaves, sdpa_out
            flops, n_bytes = flash_cost(B, H, Tq, Tk, C, backward=True)
            bd = bounds(flops, n_bytes)
            bwd[name] = {
                "B": B, "Tq": Tq, "Tk": Tk, "C": C, "max_abs_err": berr, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, **bd,
            }
            print(f"kernel flash_core_bwd {name}: B={B} Tq={Tq} Tk={Tk} max|d|={berr:.3e} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} sdpa_bwd_ms={library_ms:.4f} bound_ms={bd['bound_ms']:.4f} "
                  f"({bd['bound_by']}) bound_tc_ms={bd['bound_tc_ms']:.4f}", flush=True)
        del q, k, v, g, qh, kh, vh, gh, out, lse
        torch.cuda.empty_cache()
    return fwd, bwd


def flash_edge_phase(device):
    """Both flash_core kernels at B=2, H=6, C=64 on the ragged shapes
    Tq in {1, 601}, Tk in {1, 33, 2100} (one row, a ragged last tile on
    either side, more keys than the Pallas kernel holds in VMEM); returns
    the worst (fwd, bwd) max|kernel - plain|."""
    import torch

    from gta_tpu_torch.ops import flash_core as fc

    gen = torch.Generator(device=device).manual_seed(3)
    worst_fwd = worst_bwd = 0.0
    for Tq in (1, 601):
        for Tk in (1, 33, 2100):
            q, k, v, g = (torch.randn((2, T, 384), generator=gen, device=device) for T in (Tq, Tk, Tk, Tq))
            with torch.no_grad():
                out, lse = fc.flash_core_fwd(q, k, v, 6, 0.125, residuals=True)
                got = fc.flash_core_bwd(q, k, v, 6, 0.125, g, out, lse)
                torch.cuda.synchronize()
                want, want_lse = fc.flash_core_fwd_plain(q, k, v, 6, 0.125, lse=True)
                err = max((out - want).abs().max().item(), (lse - want_lse).abs().max().item())
                berr = check_bwd(f"Tq={Tq} Tk={Tk}", got, fc.flash_core_bwd_plain(q, k, v, 6, 0.125, g),
                                 "flash_core_bwd")
            print(f"kernel flash_core_fwd / flash_core_bwd edge B=2 Tq={Tq} Tk={Tk}: "
                  f"max|d| fwd={err:.3e} bwd={berr:.3e}", flush=True)
            if not err <= TOL:
                raise AssertionError(f"flash_core_fwd Tq={Tq} Tk={Tk}: max|kernel - plain| = {err} > {TOL}")
            worst_fwd, worst_bwd = max(worst_fwd, err), max(worst_bwd, berr)
    return worst_fwd, worst_bwd


def rel_l2(a, r) -> float:
    """Relative L2 error of a against r (the norm of a where r is zero)."""
    den = r.double().norm().item()
    diff = (a.double() - r.double()).norm().item()
    return diff / den if den > 0 else diff


def bf16_rule(kind, label, got, emu, ref, names):
    """Each output's relative L2 error against `ref` at most BF16_RULE x the
    bf16 emulation's (the plain version with mxu_dtype=bf16, the TPU
    kernel's rounding); returns {output: (kernel, emulation)} errors."""
    errs = {}
    for name, a, e, r in zip(names, got, emu, ref):
        if r is None:
            continue
        errs[name] = (rel_l2(a, r), rel_l2(e, r))
        if not errs[name][0] <= BF16_RULE * errs[name][1]:
            raise AssertionError(f"{kind} {label} {name}: relative L2 {errs[name][0]:.3e} > {BF16_RULE} x the "
                                 f"bf16 emulation's {errs[name][1]:.3e}")
    return errs


def bf16_kernel_phase(cfg, label, device, batch=MSN_BATCH, prefix="msn_", names=None, flash=False, geometry=None):
    """The bf16 instances of a config's kernels (fused GTA for msn_so3 and
    CLEVR-TR gta under --bf16, flash_core for the MSN SRT baseline) at its
    shapes (`names` of them, all by default): encoder self-attention and
    decoder eval (msn: B=64, 1280 keys) and a render chunk (B=1 x 16384
    rays) forward, the encoder and decoder train shapes forward (residuals)
    and backward. Each output held to its plain version
    (fp32 inside) on the same bf16 inputs: relative L2 at most BF16_RULE x
    the bf16 emulation's; and, at the same shape cut to B=2, to the plain
    version in fp64 by the same rule. Times: the kernel, the plain version,
    F.scaled_dot_product_attention on the same bf16 operands (forward; its
    backward alone), CUDA events. Returns ({shape: fwd numbers},
    {shape: bwd numbers}). With `flash`, flash_core's instances at a GTA
    config's shapes (msn gta_t2's attention after its sliced transforms),
    as that path calls them: bf16 operands, the output and gradients in
    fp32 (ops/gta_pallas.py). `geometry` (heads, head width, shapes) gives
    the shapes of a model that is no NVS config (the DiT) in place of
    `cfg`'s: GTA calls as `gta_calls` returns them, or (with `flash`)
    flash_core shapes as `srt_shapes` does, taken as bf16 rows."""
    import torch
    import torch.nn.functional as F

    from gta_tpu_torch.ops import flash_core as fc
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.gta import gta_transform_qkv

    bf = torch.bfloat16
    if geometry is None:
        enc = cfg.model.encoder
        H, C = enc.heads, enc.attdim // enc.heads
        gta, sliced = enc.attn.is_gta and not flash, enc.attn.is_gta
    else:
        H, C, given = geometry
        gta, sliced = not flash, False
    scale = C**-0.5
    if gta:
        calls = gta_calls(cfg, device, batch, prefix=prefix) if geometry is None else given
        shapes = {name: (B, Tq, Tk) for name, (_, _, B, Tq, Tk) in calls.items() if names is None or name in names}
        tc = torch.tensor([0.01], device=device).to(bf)
    else:
        shapes = {f"{prefix}{n}": v for n, v in (srt_shapes(cfg, batch) if geometry is None else given).items()}
    kind = "gta_fused" if gta else "flash_core"
    gen = torch.Generator(device=device).manual_seed(5)
    fwd, bwd = {}, {}
    for name, (B, Tq, Tk) in shapes.items():
        train = "_train_" in name
        q, k, v, g = (torch.randn((B, T, H * C), generator=gen, device=device).to(bf) for T in (Tq, Tk, Tk, Tq))
        if gta:
            args, reps = calls[name][:2]
            t = tgf.fused_tables(reps, args, tc)

            def run(q, k, v, g, mode, t=t):
                """(outputs, names) of the kernel ('kernel'), the plain
                version ('plain', fp32 inside; 'emu', bf16 operands) or the
                plain version in fp64 ('fp64')."""
                if mode == "kernel":
                    out, res = tgf.gta_fused_fwd(q, k, v, t, H, scale, residuals=True)
                    z = res.z
                    grads = tgf.gta_fused_bwd(q, k, v, t, H, scale, g, res) if train else ()
                else:
                    mxu = bf if mode == "emu" else None
                    if mode == "fp64":
                        q, k, v, g = (x.double() for x in (q, k, v, g))
                        t = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)], t.nq,
                                            t.nk, t.v_transform)
                    out, z = tgf.gta_fused_fwd_plain(q, k, v, t, H, scale, store_z=True, mxu_dtype=mxu)
                    grads = tgf.gta_fused_bwd_plain(q, k, v, t, H, scale, g, z, mxu_dtype=mxu) if train else ()
                return (out, z, *grads), ("out", "z", "dq", "dk", "dv", "dmq", "dmk", "dmo")

            def heads(x):
                return x.reshape(B, x.shape[1], H, C).transpose(1, 2)

            qkv = [x.contiguous() for x in gta_transform_qkv(heads(q), heads(k), heads(v), reps, args, tc)]
            time_fwd = lambda: tgf.gta_fused_fwd(q, k, v, t, H, scale, residuals=train)  # noqa: E731
            time_plain_fwd = lambda: tgf.gta_fused_fwd_plain(q, k, v, t, H, scale, store_z=train)  # noqa: E731
            f_flops, f_bytes = fused_cost(t, B, H, Tq, Tk, C, elem=2)
            b_flops, b_bytes = bwd_cost(t, B, H, Tq, Tk, C, elem=2)
        else:
            od = torch.float32 if sliced else None  # GTA's sliced path: fp32 out and gradients

            def run(q, k, v, g, mode):
                if mode == "kernel":
                    out, lse = fc.flash_core_fwd(q, k, v, H, scale, residuals=True, out_dtype=od)
                    grads = fc.flash_core_bwd(q, k, v, H, scale, g, out, lse, out_dtype=od) if train else ()
                else:
                    mxu, o = (bf if mode == "emu" else None), od
                    if mode == "fp64":
                        q, k, v, g = (x.double() for x in (q, k, v, g))
                        o = None
                    out = fc.flash_core_fwd_plain(q, k, v, H, scale, mxu_dtype=mxu, out_dtype=o)
                    grads = fc.flash_core_bwd_plain(q, k, v, H, scale, g, mxu_dtype=mxu, out_dtype=o) if train else ()
                return (out, *grads), ("out", "dq", "dk", "dv")

            qkv = [x.reshape(B, x.shape[1], H, C).transpose(1, 2).contiguous() for x in (q, k, v)]
            time_fwd = lambda: fc.flash_core_fwd(q, k, v, H, scale, residuals=train, out_dtype=od)  # noqa: E731
            time_plain_fwd = lambda: fc.flash_core_fwd_plain(q, k, v, H, scale, lse=train, out_dtype=od)  # noqa: E731
            out_elem = 2 if od is None else 4
            f_flops, f_bytes = flash_cost(B, H, Tq, Tk, C, elem=2, out_elem=out_elem)
            b_flops, b_bytes = flash_cost(B, H, Tq, Tk, C, backward=True, elem=2, out_elem=out_elem)
        with torch.no_grad():
            got, names = run(q, k, v, g, "kernel")
            torch.cuda.synchronize()
            plain, _ = run(q, k, v, g, "plain")
            emu, _ = run(q, k, v, g, "emu")
            errs = bf16_rule(f"{kind} bf16", name, got, emu, plain, names)
            worst = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, plain) if b is not None)
            del plain, emu
            # the same shape at B=2 against fp64
            small = [x[:2].contiguous() for x in (q, k, v, g)]
            kw = {"t": tgf.FusedTables(*[None if x is None else x[:2].contiguous() for x in tgf._tables(t)],
                                       t.nq, t.nk, t.v_transform)} if gta else {}
            errs64 = bf16_rule(f"{kind} bf16 fp64", f"{name}[:2]", run(*small, "kernel", **kw)[0],
                               run(*small, "emu", **kw)[0], run(*small, "fp64", **kw)[0], names)
            del got
            ms = time_ms(time_fwd)
            plain_ms = time_ms(time_plain_fwd, runs=3)
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(*qkv, scale=scale))
        n_out = 2 if gta else 1  # outputs compared per forward
        f_bytes += (2.0 * B * Tq * H * C * gta + 4.0 * B * H * Tq) * train  # z (bf16) and lse written
        fb = bf16_bounds(f_flops, f_bytes)
        fwd[name] = {"B": B, "Tq": Tq, "Tk": Tk, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": sdpa_ms, **fb, "residuals": train,
                     "rel_l2_vs_plain": {n: e[0] for n, e in list(errs.items())[:n_out]},
                     "rel_l2_vs_fp64": {n: e for n, e in list(errs64.items())[:n_out]}}
        print(f"kernel {kind}_fwd bf16{' (training residuals)' if train else ''} {name}: B={B} Tq={Tq} Tk={Tk} "
              f"max|d plain|={worst:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_bf16_ms={sdpa_ms:.4f} "
              f"bound_bf16_ms={fb['bound_ms']:.4f} ({fb['bound_by']}); relative L2 vs plain / emulation "
              + ", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in errs.items())
              + "; at B=2 vs fp64 " + ", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in errs64.items()),
              flush=True)
        if train:
            with torch.no_grad():
                if gta:
                    _, res = tgf.gta_fused_fwd(q, k, v, t, H, scale, residuals=True)
                    ms = time_ms(lambda: tgf.gta_fused_bwd(q, k, v, t, H, scale, g, res))
                    plain_ms = time_ms(lambda: tgf.gta_fused_bwd_plain(q, k, v, t, H, scale, g, res.z), runs=3)
                else:
                    out, lse = fc.flash_core_fwd(q, k, v, H, scale, residuals=True, out_dtype=od)
                    ms = time_ms(lambda: fc.flash_core_bwd(q, k, v, H, scale, g, out, lse, out_dtype=od))
                    plain_ms = time_ms(lambda: fc.flash_core_bwd_plain(q, k, v, H, scale, g, out_dtype=od), runs=3)
            gh = g.reshape(B, Tq, H, C).transpose(1, 2).contiguous()
            leaves = [x.requires_grad_() for x in qkv]
            sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
            sdpa_bwd_ms = time_ms(lambda: sdpa_out.backward(gh, retain_graph=True))
            del leaves, sdpa_out
            bb = bf16_bounds(b_flops, b_bytes)
            bwd[name] = {"B": B, "Tq": Tq, "Tk": Tk, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": sdpa_bwd_ms, **bb,
                         "rel_l2_vs_plain": {n: e[0] for n, e in list(errs.items())[n_out:]},
                         "rel_l2_vs_fp64": {n: e for n, e in list(errs64.items())[n_out:]}}
            print(f"kernel {kind}_bwd bf16 {name}: B={B} Tq={Tq} Tk={Tk} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"sdpa_bf16_bwd_ms={sdpa_bwd_ms:.4f} bound_bf16_ms={bb['bound_ms']:.4f} ({bb['bound_by']}, "
                  f"{b_flops / 1e9:.1f} GFLOP)", flush=True)
        del q, k, v, g, qkv
        torch.cuda.empty_cache()
    return fwd, bwd


def bf16_bounds(flops, n_bytes):
    """The kernels-line bound keys of a bf16 instance: operations at the
    dense bf16 tensor-core peak, bytes at HBM3's rate."""
    bound_ms, bound_by = bound(flops, n_bytes, PEAK_BF16_FLOPS)
    return {"bound_ms": bound_ms, "bound_by": bound_by}


def one_block(cfg):
    """`cfg` at one attention block a side (its widths as they are)."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, num_att_blocks=1),
        decoder=dataclasses.replace(m.decoder, num_att_blocks=1)))


def bf16_card_vs_cpu_phase(cfg, label):
    """A published bf16 config's B=2 forward on the card against the same
    weights on the CPU. The kernels round like the TPU kernel (bf16 P, dS
    and operands), the CPU's plain versions compute in fp32 inside: that
    alone moves the pixels by about bf16's whole error (msn SRT: 3.26e-3
    relative L2, against 3.34e-3 between the CPU's bf16 and fp32 pixels).
    So the card's bf16 pixels are held to the CPU's fp32 ones: their
    relative L2 gap at most BF16_RULE x the gap of the CPU's bf16 pixels
    with the TPU's rounding in the attention (the plain versions with
    mxu_dtype=bf16) — the kernel rule, end to end. The card-vs-CPU-bf16 and
    CPU bf16-vs-fp32 gaps are printed beside it. The model runs at one
    attention block a side (`one_block`: the CPU's three forwards at full
    depth took 11-16 s a config). Returns (card vs CPU fp32, emulated CPU
    bf16 vs CPU fp32, card vs CPU bf16, CPU bf16 vs fp32)."""
    import torch

    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.train.trainer import Trainer

    cfg = one_block(cfg)
    card = Trainer(cfg)
    weights = {k: v.cpu() for k, v in card.model.state_dict().items()}
    fp32 = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, mixed_prec=False))
    cpu16, cpu32 = Trainer(cfg, device="cpu"), Trainer(fp32, device="cpu")
    for t in (cpu16, cpu32):
        t.model.load_state_dict(weights)
    val = SyntheticScenes(cfg.data, "val")
    small = collate([val[i] for i in range(2)])
    with torch.no_grad():
        px_card = card.model(small.to(card.device))[0].cpu()
        px16, px32 = cpu16.model(small)[0], cpu32.model(small)[0]
        restore = swap_entries(functools.partial(plain_gta_attention, mxu_dtype=torch.bfloat16),
                               functools.partial(plain_flash_attention, mxu_dtype=torch.bfloat16))
        try:
            px_emu = cpu16.model(small)[0]
        finally:
            restore()
    card_err, emu_err = rel_l2(px_card, px32), rel_l2(px_emu, px32)
    gap, own = rel_l2(px_card, px16), rel_l2(px16, px32)
    print(f"{label} bf16: B=2 pixels, relative L2 against the CPU's fp32 ones: card {card_err:.3e}, CPU bf16 "
          f"with the TPU's rounding {emu_err:.3e} (rule: at most {BF16_RULE}x), CPU bf16 {own:.3e}; card vs "
          f"CPU bf16 {gap:.3e}", flush=True)
    if not (torch.isfinite(px_card).all() and card_err <= BF16_RULE * emu_err):
        raise AssertionError(f"{label} bf16: card pixels {card_err} from fp32, above {BF16_RULE} x the "
                             f"emulated TPU rounding's {emu_err}")
    return card_err, emu_err, gap, own


# tests/test_torch_bf16_layers.py's per-layer rules, card against CPU:
# LAYER_RULES[kind] = (the largest share of an output's or cotangent's
# elements unequal, the largest difference in ulps (of its precision) of
# the larger of the CPU's element and the tensor's RMS). Forward bounds
# beside the measurements (one H100 80GB HBM3 at 700 W; PERF.md, section
# 6): a Linear or Conv with a bias 2 ulps (measured 2: the product
# alone is within one ulp of the exact one on the card and on the CPU; a
# one-ulp flip of a product near 4 is two ulps of the result the bias
# takes below 4, on the CPU against the exact product too); the pixels'
# fp32 sigmoid 0.3 and 4 fp32 ulps (measured 0.149 and 2: CUDA's exp
# against the CPU's); the rest the CPU check's own (measured up to 1.35e-3
# for the convs, 4.2e-4 for Linear). The backward's, "<kind> d<name>" (an
# operand's or a parameter's cotangent, an operand without a key of its
# own under "<kind> dx"; a cast parameter's compared in fp32 at bf16's
# precision, LayerNorm's affine at fp32's), beside the
# measurements (the same card, PERF.md section 6): Linear
# dx 3e-3 (1.33e-3), dweight 3e-3 (1.49e-3: cuBLAS's fp32 sums over 2560
# rows against the CPU's), dbias 2e-3 (6.5e-4); the convs' dx 3e-3
# (1.93e-3), dweight 1.2e-2 (6.1e-3: cuDNN's fp32 sums over 2 x 128 x 128
# positions, one ulp at most: no sum in bf16), dbias 2e-3 (0); LayerNorm dx
# 2e-3 (4.0e-5), its fp32 scale and offset sums 32 and 4 fp32 ulps (17.5
# and 2, most elements); the chains 2e-3 (GELU 1.1e-4, the DiT's 0); the
# pixels' dh 2e-3 (0); msn gta_so3_euclid's transforms ("euclid": fp32 out
# and the output's fp32 cotangent, the operands' bf16 ones, trans_coeff's)
# 1e-3 / 2e-3 and one ulp (measured 0: the card's bits equal the CPU's).
# The CPU computes each output's first LAYER_ITEMS items (rows, images); a
# parameter's cotangent sums over the batch, so the card's and the CPU's
# are both taken over those items (the operands' from the card's whole
# batch's backward).
LAYER_RULES = {"linear": (2e-3, 2), "conv": (2e-3, 2), "layernorm": (2e-3, 1), "embedding": (0.0, 0),
               "chain": (2e-3, 1), "pixels": (0.3, 4),
               "linear dx": (3e-3, 1), "linear dweight": (3e-3, 1), "linear dbias": (2e-3, 1),
               "conv dx": (3e-3, 1), "conv dweight": (1.2e-2, 1), "conv dbias": (2e-3, 1),
               "layernorm dx": (2e-3, 1), "layernorm dweight": (1.0, 32), "layernorm dbias": (1.0, 4),
               "embedding dweight": (0.0, 0), "chain dx": (2e-3, 1), "pixels dx": (2e-3, 1),
               "euclid": (1e-3, 1), "euclid dx": (2e-3, 1), "euclid dout": (1e-3, 1), "euclid dtrans_coeff": (1.0, 1)}
LAYER_ITEMS = {"tokens": 2, "images": 2, "dit": 8}
CAST_PARAMS = ("weight", "bias", "trans_coeff")  # but LayerNorm's: cast to bf16 by the layer


def layer_gap(got, want, bits=None):
    """(share of unequal elements, the largest difference in ulps of want's
    dtype, or of a `bits`-bit mantissa, at the larger of want's element and
    its RMS)."""
    import torch

    if bits is None:
        bits = 7 if want.dtype == torch.bfloat16 else 23
    w = want.double()
    mag = torch.maximum(w.abs(), w.square().mean().sqrt())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    return (got.double() != w).double().mean().item(), ((got.double() - w).abs() / ulp).max().item()


def nonzero_weights(model, gen):
    """Every parameter of `model` redrawn nonzero from the CPU generator
    `gen`: weights N(0, 1/fan_in), biases N(0, 0.1^2), LayerNorm scales
    1 + N(0, 0.1^2) (no bias add or affine is trivial); returns the
    model."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=gen)
            if name.endswith("bias"):
                p.copy_(0.1 * draw)
            elif p.dim() == 1:
                p.copy_(1 + 0.1 * draw)
            else:
                p.copy_(draw * p[0].numel() ** -0.5)
    return model


def first_items(reps, n, device=None):
    """GeomReps `reps` of its batch's first n items (on `device`)."""
    def cut(t):
        if isinstance(t, tuple):
            return tuple(cut(x) for x in t)
        return t if t is None else t[:n].to(device or t.device)

    return dataclasses.replace(reps, **{f.name: cut(getattr(reps, f.name)) for f in dataclasses.fields(reps)})


def _euclid_module():
    import torch

    from gta_tpu_torch.ops.gta import gta_transform_qkv, gta_untransform_out, sliced_operand

    class EuclidTransforms(torch.nn.Module):
        """msn gta_so3_euclid's eager transforms of q, k, v (or, `inverse`,
        of the attention's output) over a batch's first items' reps, with
        the layer's trans_coeff cast to bf16 and promoted once, as
        models/layers.Attention._eager -> ops/gta.gta_attention runs
        them."""

        def __init__(self, args, reps, trans_coeff, inverse):
            super().__init__()
            self.args, self.reps, self.inverse = args, reps, inverse
            self.trans_coeff = torch.nn.Parameter(trans_coeff.clone())

        def forward(self, *x):
            reps = first_items(self.reps, x[0].shape[0])
            tc = sliced_operand(self.trans_coeff.to(torch.bfloat16), reps)
            if self.inverse:
                return gta_untransform_out(x[0], reps, self.args, tc)
            return torch.cat(gta_transform_qkv(*x, reps, self.args, tc), -1)

    return EuclidTransforms


def euclid_chain_args(cfg, gen, batch=MSN_BATCH):
    """msn gta_so3_euclid's encoder attention at its published shapes: the
    GTA args, rep tables [batch, N views] (so2 rotors of the 16 x 16 patch
    grid, random rigid cameras, their so3 blocks; fp32, on the card) and
    the tokens, heads and head width."""
    import torch

    from gta_tpu_torch.ops.reps import encoder_reps

    enc = cfg.model.encoder
    N, side = cfg.data.num_input_views, 16  # 128 x 128 views, an 8x stem
    grid = (torch.arange(side, device="cuda", dtype=torch.float32) + 0.5) / side
    coord = torch.stack(torch.meshgrid(grid, grid, indexing="ij"), -1).reshape(1, 1, side * side, 2)
    rot, _ = torch.linalg.qr(torch.randn(batch, N, 3, 3, generator=gen, device="cuda"))
    cams = torch.eye(4, device="cuda").repeat(batch, N, 1, 1)
    cams[..., :3, :3], cams[..., :3, 3] = rot, torch.randn(batch, N, 3, generator=gen, device="cuda")
    reps = encoder_reps(enc.attn.gta, input_coord=coord.expand(batch, N, -1, -1), input_transforms=cams)
    return enc.attn.gta, reps, N * side * side, enc.heads, enc.attdim // enc.heads


def bf16_layer_phase(msn_so3, msn_srt, dit_cfg, msn_euclid):
    """Each bf16 layer kind and elementwise chain at full width, forward and
    backward, on the card and on the CPU from the same bf16 inputs and
    output cotangents (drawn on the card, seed 0) and weights (seed 0,
    every parameter nonzero), held to the CPU per-layer check's rules
    (LAYER_RULES; tests/test_torch_bf16_layers.py holds the CPU to JAX):
    msn_so3's encoder LayerNorm, to_qkv, to_out, FeedForward and its erf
    GELU (B=64, 1280 tokens of 768), its decoder's to_q, to_kv (2560
    queries of 180 against 1280 of 768), FeedForward and render MLP ends
    and the pixels' fp32 sigmoid; MSN SRT's conv stem in bf16 (cuDNN: 320
    images of 128x128 with the 180 ray channels; each conv fed the card's
    ReLU of the one before); dit_gta's layers and chains at B=256, 256
    tokens of 384 (the patch conv, t_embed, the label table, block 0's
    LayerNorms, Linears, SiLU, modulations, gated residuals and tanh GELU,
    the final layer); msn gta_so3_euclid's eager GTA transforms of q, k, v
    and the inverse one of the output (B=64, 8 heads of 96, 1280 tokens:
    euclid's se3, so3, so2; fp32 out, bf16 operands and trans_coeff in).
    Each output's cotangents: its operands' (the card's whole batch) and
    its parameters' (the first items, on both). cuBLAS reduces in fp32, as
    a Trainer sets it (`allow_bf16_reduced_precision_reduction` off): a
    reduction in bf16, or any rounding other than the CPU's, is the
    card-only fault this sees. Returns {layer or cotangent: (share, ulps)}."""
    import copy

    import torch
    import torch.nn.functional as F

    from gta_tpu_torch.models import decoder as t_decoder, dit as t_dit
    from gta_tpu_torch.models.dit import build_dit
    from gta_tpu_torch.models.srt import build_model

    EuclidTransforms = _euclid_module()
    bf = torch.bfloat16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out, failed = {}, []

    def draw(*shape, scale=1.0, dtype=bf):  # on the card: the CPU takes its first items
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    def judge(label, rule, got, want, bits=None, shape=""):
        share, ulps = layer_gap(got, want, bits)
        most, most_ulps = LAYER_RULES[rule]
        ok = got.dtype == want.dtype and share <= most and ulps <= most_ulps
        print(f"bf16 layer {label}: {shape}{str(want.dtype)[6:]}, card vs CPU unequal {share:.3e} (at most "
              f"{most:g}), largest {ulps:.3f} ulp (at most {most_ulps}){'' if ok else ' FAILED'}", flush=True)
        out[label] = (share, ulps)
        if not ok:
            failed.append(label)

    def hold(label, kind, cpu_fn, card_fn, args, items, names=("x",)):
        """card_fn on the whole args on the card against cpu_fn on their
        first `items` on the CPU, forward and backward from one output
        cotangent drawn on the card: the operands' cotangents (named
        `names`, None for integer labels) and, where the two are modules
        with parameters, the parameters'; returns the card's output,
        detached."""
        modules = isinstance(cpu_fn, torch.nn.Module) and any(True for _ in cpu_fn.parameters())
        card_in = [a.detach().requires_grad_() if n else a for a, n in zip(args, names)]
        full = card_fn(*card_in)
        ct = draw(*full.shape, dtype=full.dtype)
        cpu_in = [a[:items].cpu().requires_grad_() if n else a[:items].cpu() for a, n in zip(args, names)]
        want = cpu_fn(*cpu_in)
        judge(label, kind, full[:items].detach().cpu(), want.detach(),
              shape=f"{tuple(args[0].shape)} -> {tuple(full.shape)} ")
        if modules:
            cpu_fn.zero_grad(set_to_none=True)
        full.backward(ct)
        want.backward(ct[:items].cpu())
        for a, b, n in zip(card_in, cpu_in, names):
            if n:
                rule = f"{kind} d{n}" if f"{kind} d{n}" in LAYER_RULES else f"{kind} dx"
                judge(f"{label} d{n}", rule, a.grad[:items].cpu(), b.grad)
        if modules:  # a parameter's cotangent sums over the batch: the card's over the CPU's items too
            card_fn.zero_grad(set_to_none=True)
            card_fn(*(a.detach()[:items] for a in args)).backward(ct[:items])
            for (n, p), q in zip(cpu_fn.named_parameters(), card_fn.parameters()):
                leaf = n.rsplit(".", 1)[-1]
                judge(f"{label} d{n}", f"{kind} d{leaf}", q.grad.cpu(), p.grad,
                      bits=7 if kind != "layernorm" and leaf in CAST_PARAMS else 23)
        torch.cuda.synchronize()
        return full.detach()

    def pair(model):
        """(the CPU model, a card copy) with the same nonzero weights."""
        model = nonzero_weights(model, torch.Generator().manual_seed(0)).eval()
        return model, copy.deepcopy(model).cuda()

    # msn_so3: the encoder's and decoder's first block, the render MLP
    cpu, card = pair(build_model(one_block(msn_so3).model, bf))

    def both(name):
        return cpu.get_submodule(name), card.get_submodule(name)

    B, T, Tq = MSN_BATCH, 1280, 2560  # 5 views of 16 x 16 patches; 5 x 512 target rays
    items = LAYER_ITEMS["tokens"]
    for side, tokens, width in (("encoder", T, 768), ("decoder", Tq, 180)):
        tr = "encoder.transformer" if side == "encoder" else "decoder.allocation_transformer.transformer"
        attn, ff = f"{tr}.layers.0.0", f"{tr}.layers.0.1"
        x = draw(B, tokens, width)
        hold(f"msn_so3 {side} LayerNorm", "layernorm", *both(f"{attn}.norm"), (x,), items)
        if side == "encoder":
            hold("msn_so3 encoder to_qkv", "linear", *both(f"{attn}.fn.to_qkv"), (x,), items)
        else:
            hold("msn_so3 decoder to_q", "linear", *both(f"{attn}.fn.to_q"), (x,), items)
            hold("msn_so3 decoder to_kv", "linear", *both(f"{attn}.fn.to_kv"), (draw(B, T, 768),), items)
        hold(f"msn_so3 {side} to_out", "linear", *both(f"{attn}.fn.to_out.0"), (draw(B, tokens, 768),), items)
        hidden = cpu.get_submodule(f"{ff}.fn.net.0").out_features
        hold(f"msn_so3 {side} FeedForward net.0", "linear", *both(f"{ff}.fn.net.0"), (x,), items)
        h = draw(B, tokens, hidden)
        hold(f"msn_so3 {side} GELU (erf)", "chain", *both(f"{ff}.fn.net.1"), (h,), items)
        hold(f"msn_so3 {side} FeedForward net.3", "linear", *both(f"{ff}.fn.net.3"), (h,), items)
    for i in (0, 8):
        name = f"decoder.render_mlp.{i}"
        hold(f"msn_so3 render_mlp.{i}", "linear", *both(name), (draw(B, Tq, cpu.get_submodule(name).in_features),),
             items)
    hold("msn_so3 pixels (sigmoid, fp32)", "pixels", t_decoder.render_pixels, t_decoder.render_pixels,
         (draw(B, Tq, 3),), items)
    del cpu, card

    # MSN SRT's conv stem, each conv fed the card's ReLU of the one before
    cpu, card = pair(build_model(one_block(msn_srt).model, bf))
    items = LAYER_ITEMS["images"]
    convs = [(f"conv_blocks.{b}.layers.{j}", getattr(cpu.encoder.conv_blocks[b].layers, str(j)),
              getattr(card.encoder.conv_blocks[b].layers, str(j))) for b in range(len(cpu.encoder.conv_blocks))
             for j in (0, 2)]
    convs.append(("per_patch_linear", cpu.encoder.per_patch_linear, card.encoder.per_patch_linear))
    n, side = msn_srt.data.num_input_views * MSN_BATCH, 128
    x = draw(n, convs[0][1].in_channels, side, side)
    for name, c_cpu, c_card in convs:
        x = F.relu(hold(f"msn SRT stem {name}", "conv", c_cpu, c_card, (x,), items))
    del cpu, card, x

    # dit_gta at its train shapes: block 0, the embedders, the final layer
    cpu, card = pair(build_dit(dit_cfg.model, bf))
    items, B, T, C = LAYER_ITEMS["dit"], DIT_BATCH, dit_cfg.model.num_patches, dit_cfg.model.hidden_size
    blk, blk_card = cpu.block_0, card.block_0
    m = dit_cfg.model

    hold("dit_gta patch_embed", "conv", cpu.patch_embed, card.patch_embed,
         (draw(B, m.in_channels, m.input_size, m.input_size),), items)
    hold("dit_gta t_embed.fc1", "linear", cpu.t_embed.fc1, card.t_embed.fc1, (draw(B, 256),), items)
    labels = torch.randint(0, m.num_classes + 1, (B,), generator=gen, device="cuda")
    hold("dit_gta y_embed", "embedding", cpu.y_embed, card.y_embed, (labels,), items, names=(None,))
    c = draw(B, C)
    hold("dit_gta SiLU", "chain", F.silu, F.silu, (c,), items)
    hold("dit_gta ada_mod", "linear", blk.ada_mod, blk_card.ada_mod, (c,), items)
    x, h = draw(B, T, C), draw(B, T, C)
    shift, scale, gate = (draw(B, C, scale=0.1) for _ in range(3))
    hold("dit_gta norm1", "layernorm", blk.norm1, blk_card.norm1, (x,), items)
    hold("dit_gta modulate", "chain", t_dit._modulate, t_dit._modulate, (x, shift, scale), items,
         names=("x", "shift", "scale"))
    hold("dit_gta to_qkv", "linear", blk.attn.to_qkv, blk_card.attn.to_qkv, (x,), items)
    hold("dit_gta to_out", "linear", blk.attn.to_out, blk_card.attn.to_out, (x,), items)
    hold("dit_gta gated residual", "chain", t_dit._gated, t_dit._gated, (x, gate, h), items, names=("x", "gate", "h"))
    hold("dit_gta mlp_fc1", "linear", blk.mlp_fc1, blk_card.mlp_fc1, (x,), items)

    def gelu(h):
        return F.gelu(h, approximate="tanh")

    hold("dit_gta GELU (tanh)", "chain", gelu, gelu, (draw(B, T, blk.mlp_fc1.out_features),), items)
    hold("dit_gta mlp_fc2", "linear", blk.mlp_fc2, blk_card.mlp_fc2, (draw(B, T, blk.mlp_fc2.in_features),), items)
    hold("dit_gta final_norm", "layernorm", cpu.final_norm, card.final_norm, (x,), items)
    hold("dit_gta final_proj", "linear", cpu.final_proj, card.final_proj, (x,), items)
    del cpu, card

    # msn gta_so3_euclid's eager GTA transforms (ops/gta.py's sliced form,
    # as Attention._eager -> gta_attention runs them)
    args, reps, T, H, Cd = euclid_chain_args(msn_euclid, gen)
    items = LAYER_ITEMS["tokens"]
    tc = torch.full((1,), 0.5)
    for label, inverse, ops, names in (("transforms (q, k, v)", False, [bf] * 3, ("q", "k", "v")),
                                       ("inverse transform (output)", True, [torch.float32], ("out",))):
        c, g = EuclidTransforms(args, first_items(reps, items, "cpu"), tc, inverse), \
            EuclidTransforms(args, reps, tc, inverse).cuda()
        hold(f"msn gta_so3_euclid {label}", "euclid", c, g, tuple(draw(MSN_BATCH, H, T, Cd, dtype=d) for d in ops),
             items, names=names)
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"bf16 layers off the CPU's rounding on the card: {failed}")
    return out


def kernel_wrappers():
    """Every kernel's wrapper, by kernel name; each counts the launches of
    its fp32 instances (`launches`, `launches_by_width`) and of its bf16
    ones (`launches_bf16`, `launches_bf16_by_width`)."""
    from gta_tpu_torch.ops import _cuda, flash_core, gta_fused

    return {name: getattr(flash_core if name.startswith("flash") else gta_fused, name) for name in _cuda.KERNELS}


# the head widths whose instances the kernels line names by their width
# (`<kernel>[_bf16]_c<C>`); the instances at 64 and 96, the earlier slices',
# keep one entry a kernel and dtype
NEW_WIDTHS = (32, 128)


def instance_name(kernel, bf16, width):
    """A kernel instance's name in the launch counts and the kernels line."""
    return kernel + ("_bf16" if bf16 else "") + (f"_c{width}" if width in NEW_WIDTHS else "")


def launch_counts():
    """{instance: launches}: `<kernel>` for the fp32 instances at head widths
    64 and 96, `<kernel>_bf16` for the bf16 ones, `<kernel>[_bf16]_c32` and
    `_c128` for those at 32 and 128."""
    counts = {}
    for name, fn in kernel_wrappers().items():
        for bf16, by_width in ((False, fn.launches_by_width), (True, fn.launches_bf16_by_width)):
            for width, n in by_width.items():
                key = instance_name(name, bf16, width)
                counts[key] = counts.get(key, 0) + n
    return counts


def nonzero(counts):
    """The instances of a launch-count dict that launched (for the log)."""
    return {k: n for k, n in counts.items() if n}


def reset_launch_counts():
    from gta_tpu_torch.ops import _cuda

    for fn in kernel_wrappers().values():
        _cuda.launch_counters(fn)


def side_kernel(attn):
    """The kernel a side's attention layers launch, by the JAX package's
    routing on a TPU (gta_tpu/models/layers.py:192-209,
    gta_tpu/config.py:137-144, gta_tpu/ops/gta_pallas.py:63-72): GTA with a
    static tau and neither euclid_sim nor elementwise_mul takes the fused
    GTA kernel where its reps are block-diagonal ('gta_fused'), else the
    sliced transforms and flash_core ('flash_core'); another method takes
    flash_core where it is flash_eligible; everything else (an adjustable
    tau, euclid, elementwise_mul, gbt, repast, rpe) launches no kernel
    (None): JAX computes it with XLA."""
    static = attn.softmax == "standard" and not attn.rpe
    if not attn.is_gta:
        return "flash_core" if static and attn.flash_eligible else None
    g = attn.gta
    if not static or g.euclid_sim or g.elementwise_mul:
        return None
    spans = g.f_dims.slices()
    odd = any(name == "so2" for name, _, _ in spans) and any((ed - st) % 2 for _, st, ed in spans)
    return "flash_core" if g.f_dims.t2 > 0 or g.ray_to_se3 or odd else "gta_fused"


def expected_launches(cfg, encodes, decodes, backward_steps=0, target_views=1, rings=(False, False)):
    """Launch counts of a run of `encodes` encoder and `decodes` decoder
    passes, `backward_steps` of them with a backward: each attention layer
    launches its side's kernel (side_kernel; none on a side that returns
    its last attention map, which attends eagerly, or that rings over the
    seq axis, `rings` (encoder, decoder): its fold is plain torch) in the
    config's compute dtype (bf16 under mixed_prec), in the instance of its
    head width, once forward and once backward, and FTL's decoder once per
    target view (`target_views`); every other instance stays at 0."""
    from gta_tpu_torch.ops import _cuda

    want = dict.fromkeys(launch_counts(), 0)
    bf16 = cfg.training.mixed_prec
    enc, dec = cfg.model.encoder, cfg.model.decoder
    for side, n, C, ring in ((enc, encodes, enc.attdim // enc.heads, rings[0]),
                             (dec, decodes, dec.head_dim, rings[1])):
        kernel = None if getattr(side, "return_last_attmap", False) or ring else side_kernel(side.attn)
        if kernel is None:
            continue
        width = _cuda.kernel_head_dim(kernel, C)
        per_pass = side.num_att_blocks * (target_views if cfg.model.ftl and side is dec else 1)
        want[instance_name(f"{kernel}_fwd", bf16, width)] += n * per_pass
        want[instance_name(f"{kernel}_bwd", bf16, width)] += backward_steps * per_pass
    return want


def serving_path_phase(cfg, label, batch_size=EVAL_BATCH):
    """Full-width serving path through the kernels; returns the launch
    counts {kernel: n} of the run and its full-scale frame (rendered image,
    ground truth, median render ms)."""
    import torch

    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)  # default device: cuda
    batch = synthetic_batch(cfg.data, "val", 0, batch_size)
    test = SyntheticScenes(cfg.data, "test", full_scale=True)
    item = collate([test[0]])
    Hf, Wf, chunk = test.target_h, test.target_w, RENDER_CHUNK
    n_rays = Hf * Wf
    n_chunks = -(-n_rays // chunk)
    transform_mode = item.target_transforms is not None

    def render():
        if transform_mode:
            return trainer.render_image(
                item, Hf, Wf, target_transform=item.target_transforms[:, 0].numpy(), chunk=chunk,
                rays=item.target_rays[:, 0].numpy(), cam=item.target_camera_pos[:, 0].numpy(),
            )
        # non-transform items are flat [1, Nt*H*W, 3]: the first view's rays
        return trainer.render_rays(
            item, item.target_rays[:, :n_rays].numpy(), item.target_camera_pos[:, :n_rays].numpy(), chunk=chunk,
        ).reshape(1, Hf, Wf, 3)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = trainer.eval_step(batch)
        psnr = m["psnr"].mean().item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    rays = batch.target_pixels[..., 0].numel()
    img = render()  # warm-up for the render shapes
    render_ms = []
    for _ in range(RENDER_RUNS):
        t0 = time.perf_counter()
        img = render()
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    renders = 1 + RENDER_RUNS
    want = expected_launches(cfg, 3 + renders, 3 + renders * n_chunks)
    print(f"{label} serving: eval_step B={batch_size} ({rays} rays) psnr={psnr:.4f} ms(cold,warm,warm)="
          f"{', '.join(f'{x:.2f}' for x in step_ms)} rays/s={rays / (min(step_ms[1:]) / 1e3):.0f} "
          f"peak_mem_gb(eval_step and renders)={peak_gb:.2f}", flush=True)
    gt = (item.target_pixels[:, 0] if transform_mode else item.target_pixels[:, :n_rays]).numpy()
    gt = gt.reshape(1, Hf, Wf, 3)
    render_psnr = float(-10.0 * np.log10(np.mean((img - gt) ** 2)))
    median_ms = float(np.median(render_ms))
    print(f"{label} serving: {'render_image' if transform_mode else 'render_rays'} {Hf}x{Wf} chunk={chunk} "
          f"psnr={render_psnr:.4f} ms(median of {RENDER_RUNS} after 1 warm-up)={median_ms:.2f} "
          f"[{', '.join(f'{x:.2f}' for x in render_ms)}] rays/s={n_rays / (median_ms / 1e3):.0f}", flush=True)
    print(f"{label} serving: launches {nonzero(launches)}, expected {nonzero(want)} (5 per encode, 2 per decode chunk; "
          "a launch counts one call of the C entry point, however many kernels it runs)", flush=True)
    if launches != want:
        raise AssertionError(f"{label} serving path launches {launches}, expected {want}")
    if img.shape != (1, Hf, Wf, 3) or not np.isfinite(img).all() or not np.isfinite(psnr):
        raise AssertionError(f"{label} serving path output is not finite / of the expected shape")

    frame = (img, gt, median_ms)
    if cfg.training.mixed_prec:  # bf16: card against CPU in bf16_card_vs_cpu_phase
        return launches, frame
    # the same weights on the CPU through the plain versions
    cpu = Trainer(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    small = synthetic_batch(cfg.data, "val", 0, 2)
    with torch.no_grad():
        got, _ = trainer.model(small.to(trainer.device))
        want_px, _ = cpu.model(small)
    err = (got.cpu() - want_px).abs().max().item()
    print(f"{label} serving: B=2 forward cuda vs cpu max|d pixels|={err:.3e}", flush=True)
    if not err <= TOL:
        raise AssertionError(f"{label}: card vs CPU pixels differ by {err} > {TOL}")
    return launches, frame


def train_path_phase(cfg, label, batch_size=EVAL_BATCH, distinct=1 + TRAIN_RUNS):
    """Full-width train steps through the kernels, one cold then TRAIN_RUNS
    warm, over `distinct` synthetic batches in turn; returns the launch
    counts {kernel: n} of the run and the step numbers."""
    import torch

    from gta_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)  # default device: cuda
    made = [synthetic_batch(cfg.data, "train", n * batch_size, (n + 1) * batch_size, cfg.seed)
            for n in range(distinct)]
    batches = [made[n % distinct] for n in range(1 + TRAIN_RUNS)]
    rays = batches[0].target_pixels[..., 0].numel()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms, losses = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    launches = launch_counts()

    warm = float(np.median(step_ms[1:]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite_grads = all(bool(torch.isfinite(p.grad).all()) for p in trainer.model.parameters())
    print(f"{label} train: train_step B={batch_size} ({rays} rays) losses={', '.join(f'{x:.6f}' for x in losses)} "
          f"grad_norm={m['grad_norm'].item():.6f} lr={m['lr']:.3e} ms(cold)={step_ms[0]:.2f} "
          f"ms(warm)=[{', '.join(f'{x:.2f}' for x in step_ms[1:])}] median_warm_ms={warm:.2f} "
          f"rays/s={rays / (warm / 1e3):.0f} peak_mem_gb={peak_gb:.2f}", flush=True)
    want = expected_launches(cfg, len(batches), len(batches), backward_steps=len(batches))
    print(f"{label} train: launches {nonzero(launches)}, expected {nonzero(want)}", flush=True)
    if launches != want:
        raise AssertionError(f"{label} train path launches {launches}, expected {want}")
    if not (np.isfinite(losses).all() and finite_grads):
        raise AssertionError(f"{label} train path: loss or gradients not finite")
    return launches, {"batch": batch_size, "median_warm_ms": warm, "cold_ms": step_ms[0], "warm_ms": step_ms[1:],
                      "rays_per_s": rays / (warm / 1e3), "rays_per_step": rays, "peak_mem_gb": peak_gb}


def variant_phase(cfg, label, batch_size=VARIANT_BATCH):
    """A config at full width through one eval_step and one train_step (both
    cold) at `batch_size`, each path's launch counts asserted (zero where
    the config's attention launches no kernel, side_kernel), the peak
    memory of each printed; returns the launch counts {kernel: n} of the
    serving and of the train path, and {eval_ms, train_ms, eval_gb,
    train_gb} (cold times, peak GB)."""
    import torch

    from gta_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)  # default device: cuda
    val = synthetic_batch(cfg.data, "val", 0, batch_size)
    train = synthetic_batch(cfg.data, "train", 0, batch_size, cfg.seed)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    psnr = trainer.eval_step(val)["psnr"].mean().item()
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_gb = torch.cuda.max_memory_allocated() / 1e9
    serving = launch_counts()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = trainer.train_step(train)
    loss = m["loss"].item()
    train_ms = (time.perf_counter() - t0) * 1e3
    train_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    finite = np.isfinite([psnr, loss]).all() and all(bool(torch.isfinite(p.grad).all()) for p in trainer.model.parameters())
    kernels = {k: n for k, n in {**serving, **launches}.items() if n}
    print(f"{label}: B={batch_size} eval_step psnr={psnr:.4f} ms(cold)={eval_ms:.2f} peak_mem_gb={eval_gb:.2f}; "
          f"train_step loss={loss:.6f} grad_norm={m['grad_norm'].item():.6f} ms(cold)={train_ms:.2f} "
          f"peak_mem_gb={train_gb:.2f}; launches serving {nonzero(serving)}, train {nonzero(launches)}"
          + ("" if kernels else " (no kernel: the JAX package computes this attention with XLA)"), flush=True)
    nt = val.target_transforms.shape[1] if val.target_transforms is not None else 1
    for path, got, want in (("serving", serving, expected_launches(cfg, 1, 1, target_views=nt)),
                            ("train", launches, expected_launches(cfg, 1, 1, backward_steps=1, target_views=nt))):
        if got != want:
            raise AssertionError(f"{label} {path} path launches {got}, expected {want}")
    if not finite:
        raise AssertionError(f"{label}: psnr, loss or gradients not finite")
    del trainer
    torch.cuda.empty_cache()
    return serving, launches, {"batch": batch_size, "eval_ms": eval_ms, "train_ms": train_ms, "eval_gb": eval_gb,
                               "train_gb": train_gb}


# Card against CPU for the metrics on a rendered frame, fp32 sums in other
# orders on each device (SSIM's variances are filt(x^2) - mu^2). Measured on
# one NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6): SSIM's absolute
# difference 1.2e-7 (240x320) and 6.0e-8 (128x128), two and one fp32 ulps
# of the value; LPIPS's relative one 9.4e-8 and 6.0e-8. Held with a margin
# of 8-17x:
SSIM_TOL = 1e-6
LPIPS_RTOL = 1e-6
METRIC_RUNS = 10  # timed metric calls per frame, after WARMUP


def metrics_phase(frames):
    """SSIM and LPIPS-VGG (random weights: the port's random_params, seed 0)
    of each rendered full-scale frame {label: (image, ground truth, render
    ms)} on the card against the same call on the CPU, with TF32 on around
    the calls (PyTorch's cuDNN default), so the metrics must turn it off
    themselves. Prints each difference beside its tolerance and the card's
    ms per frame; returns {label: numbers}."""
    import torch

    from gta_tpu_torch.utils import lpips
    from gta_tpu_torch.utils.metrics import ssim

    params = lpips.random_params(np.random.RandomState(0))
    nets = {dev: lpips.VGG16LPIPS.from_params(params).to(dev) for dev in ("cpu", "cuda")}
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    out = {}
    try:
        for label, (img, gt, render_ms) in frames.items():
            pred = {dev: torch.from_numpy(img).to(dev) for dev in nets}
            target = {dev: torch.from_numpy(gt).to(dev) for dev in nets}
            s = {dev: ssim(pred[dev], target[dev]).item() for dev in nets}
            lp = {dev: lpips.lpips_distance(pred[dev], target[dev], nets[dev]).item() for dev in nets}
            d_ssim = abs(s["cuda"] - s["cpu"])
            d_lpips = abs(lp["cuda"] - lp["cpu"]) / abs(lp["cpu"])
            ssim_ms = time_ms(lambda: ssim(pred["cuda"], target["cuda"]), runs=METRIC_RUNS)
            lpips_ms = time_ms(lambda: lpips.lpips_distance(pred["cuda"], target["cuda"], nets["cuda"]),
                               runs=METRIC_RUNS)
            shape = "x".join(map(str, img.shape[1:3]))
            print(f"metrics {label} {shape}: ssim card {s['cuda']:.8f} cpu {s['cpu']:.8f} |d|={d_ssim:.3e} "
                  f"(tolerance {SSIM_TOL:.0e}); lpips_vgg card {lp['cuda']:.8f} cpu {lp['cpu']:.8f} "
                  f"|d|/|cpu|={d_lpips:.3e} (tolerance {LPIPS_RTOL:.0e})", flush=True)
            print(f"metrics {label} {shape}: per full-scale view, ms: render {render_ms:.3f}, ssim {ssim_ms:.4f}, "
                  f"lpips_vgg {lpips_ms:.4f} (CUDA events, median of {METRIC_RUNS} after {WARMUP} warm-ups)",
                  flush=True)
            if not (np.isfinite([s["cuda"], lp["cuda"]]).all() and d_ssim <= SSIM_TOL and d_lpips <= LPIPS_RTOL):
                raise AssertionError(f"metrics {label}: card vs CPU ssim {d_ssim} (tolerance {SSIM_TOL}), "
                                     f"lpips {d_lpips} (tolerance {LPIPS_RTOL})")
            out[label] = {"render_ms": render_ms, "ssim_ms": ssim_ms, "lpips_ms": lpips_ms,
                          "ssim_diff": d_ssim, "lpips_rel_diff": d_lpips}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return out


# The flagship's per-layer trans_coeff scalars. Each one's gradient is a
# sum over the entries of its layer's rep matrices (Mq, Mk, Mo) of terms
# dL/dM * dM/dtc that cancel heavily: the sum is near zero on some scenes
# while its terms are not (kappa = sum |terms| / |sum| up to ~5000 on
# CLEVR-TR scenes; PERF.md, section 6), so its relative error says
# nothing about the arithmetic. A scalar is held instead to an error
# scaled by its conditioning: |g - g_fp64| <= TC_TOL * sum |terms|, the
# terms taken in the float64 step (fp32 rounding of each term, ~1e-7 of
# it, and of the cotangents that reach it: TC_TOL leaves the same room as
# TOL does for a tensor's relative L2 error).
TC_TOL = 1e-4
# an attention call's q, k, v cotangents in a step against the call's fp64
# VJP: each within CALL_TOL (the card tests' limit for the fp32 kernels
# against fp64) plus CALL_RULE x the plain version's own fp32 error on the
# same call. A call's dq can be a sum that cancels (near-uniform attention
# at a random init), which fp32 itself leaves ~1e-5 from fp64; the kernels'
# 3xTF32 products err up to ~10x fp32's (at the SRT shapes, forward out
# 6.7x and dq 9.3x the plain version's error against fp64; PERF.md,
# section 6). A fault of 1e-3 in one cotangent stays far outside.
CALL_TOL = 1e-5
CALL_RULE = 10.0
# the rep matrices of a fused GTA call whose cotangents the per-call check
# holds as it holds dq, dk, dv (the fused backward kernel's dMq, dMk, dMo)
MATS = ("mq", "mk", "mo")


def swap_entries(gta, flash):
    """Point the layers' attention entries (the NVS layers' and the DiT's)
    at `gta` (the fused GTA kernels' entry, behind
    ops/gta_pallas.fused_gta_attention) and `flash` (flash attention, for
    method '' and behind the sliced GTA path); returns a function that
    restores them."""
    from gta_tpu_torch.models import dit, layers
    from gta_tpu_torch.ops import gta_pallas

    saved = (gta_pallas.fused_gta_attention_tokens, gta_pallas.flash_attention, layers.flash_attention,
             dit.flash_attention)
    (gta_pallas.fused_gta_attention_tokens, gta_pallas.flash_attention, layers.flash_attention,
     dit.flash_attention) = gta, flash, flash, flash

    def restore():
        (gta_pallas.fused_gta_attention_tokens, gta_pallas.flash_attention, layers.flash_attention,
         dit.flash_attention) = saved
    return restore


def tables_in(reps, args, trans_coeff, dtype):
    """fused_tables (fp32 whatever the operands) with every table in
    `dtype` (an fp64 step's tables in fp64)."""
    import torch

    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.gta import _blockdiag_mat, _fw_rotors

    t = tgf.fused_tables(reps, args, trans_coeff)
    if dtype == torch.float32:
        return t
    mats = {f: None if getattr(t, f) is None else
            _blockdiag_mat(reps, args, trans_coeff, side, dtype).transpose(-1, -2).contiguous()
            for f, side in (("mq", "q"), ("mk", "k"), ("mo", "out"))}
    rot = {}
    for c, s_, r in (("cq", "sq", reps.so2_q), ("ck", "sk", reps.so2_k)):
        if r is not None:
            cos, sin = _fw_rotors(r, args.f_dims, dtype)
            rot[c], rot[s_] = cos.repeat_interleave(2, -1), sin.repeat_interleave(2, -1)
    return dataclasses.replace(t, **mats, **rot)


def plain_gta_attention(qB, kB, vB, heads, reps, args, trans_coeff, scale, mxu_dtype=None, terms=None):
    """fused_gta_attention_tokens through the plain forward and torch
    autograd, on any device (the comparisons in grads_phase and, with
    mxu_dtype=bf16, bf16_card_vs_cpu_phase only); fp64 operands take fp64
    tables. With `terms` (called once per call in the forward, it returns
    the sink of that call's trans_coeff), each rep matrix's cotangent
    reports sum |dL/dM * dM/dtc| to the sink when the backward reaches it
    (M is linear in trans_coeff: dM/dtc = M(1) - M(0))."""
    import torch

    from gta_tpu_torch.ops import gta_fused as tgf

    tgf.check_supported(reps, args, qB.shape[1], kB.shape[1])
    dtype = torch.float64 if qB.dtype == torch.float64 else torch.float32
    t = tables_in(reps, args, trans_coeff, dtype)
    if terms is not None and trans_coeff is not None:
        sink = terms()
        with torch.no_grad():
            one, zero = (tables_in(reps, args, torch.full_like(trans_coeff, x), dtype) for x in (1.0, 0.0))
        for f in ("mq", "mk", "mo"):
            M = getattr(t, f)
            if M is not None and M.requires_grad:
                d = getattr(one, f) - getattr(zero, f)
                M.register_hook(lambda g, d=d: sink((g * d).abs().sum().item()))
    return tgf.gta_fused_fwd_plain(qB.contiguous(), kB.contiguous(), vB.contiguous(), t, heads, scale,
                                   mxu_dtype=mxu_dtype)


def plain_flash_attention(q, k, v, heads, scale, mxu_dtype=None):
    """flash_attention through the plain forward and torch autograd, on any
    device (as plain_gta_attention)."""
    from gta_tpu_torch.ops import flash_core as fc

    return fc.flash_core_fwd_plain(q.contiguous(), k.contiguous(), v.contiguous(), heads, scale,
                                   mxu_dtype=mxu_dtype)


def grads_phase(cfg, label, items=(0, 1), trainers=None, card_entry=None, native=True):
    """A B=2 full-width step's gradients (dropout 0; training items `items`)
    on the card, through the kernels, against a float64 step on the card
    through the plain attention (which agrees with a float64 step on the
    CPU to ~1e-14), fed the same fp32 ray encodings as the fp32 steps, so
    that it differs from them in arithmetic alone. Three checks:

      * per attention call: the cotangents that reached the call's q, k
        and v in the step, and in a fused GTA call those of its rep
        matrices (MATS: the backward kernel's dMq, dMk, dMo, which reach
        trans_coeff), against the float64 VJP of the same call (the plain
        version on the call's own inputs and output cotangent, fp64
        tables): each one's relative L2 within CALL_TOL + CALL_RULE x the
        plain version's fp32 error on the card. This holds the kernels,
        their wrappers and whatever sits between them and the layer;
      * the whole gradient, every parameter tensor concatenated: its
        relative L2 error against fp64 may exceed that of the same step on
        the card through the plain attention by at most TOL. Both steps
        share the card's cuDNN and cuBLAS rounding (a conv stem's weight
        gradient moves by up to ~5e-4 from fp64 on some scenes), so the
        excess is the kernels' own; per tensor it is not a statistic: a
        tensor whose gradient is a sum that cancels (a last layer's to_q
        weight) turns the kernels' ~1e-6 into ~1e-4 (PERF.md, section 6);
      * each trans_coeff scalar: |g_card - g_fp64| <= TC_TOL x sum |terms|
        (see TC_TOL).
    Card vs CPU, and the card with plain attention vs CPU, are printed.
    Returns (the whole gradient's excess, the largest trans_coeff error
    over its terms, the largest per-call error over its limit).

    `trainers` (card, CPU) reuse two Trainers of `cfg` across calls;
    `card_entry` wraps the card's fp32 fused GTA entry for its kernel step
    (a planted fault: gta_tpu_torch/scripts/probe_grad_scenes.py);
    `native` picks the synthetic renderer (the host one by default)."""
    import torch

    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.models import decoder, encoder, layers
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops import gta_pallas
    from gta_tpu_torch.train.trainer import Trainer

    m = cfg.model
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, dropout=0.0), decoder=dataclasses.replace(m.decoder, dropout=0.0)))
    if trainers is None:
        trainers = Trainer(cfg), Trainer(cfg, device="cpu")
        trainers[1].model.load_state_dict({k: v.cpu() for k, v in trainers[0].model.state_dict().items()})
    card, cpu = trainers
    train = SyntheticScenes(cfg.data, "train", seed=cfg.seed, use_native=native)
    batch = collate([train[i] for i in items])
    names = [name for name, _ in cpu.model.named_parameters()]

    # the trans_coeff each GTA call belongs to, and its terms' absolute sum
    # in the float64 step
    sums, current = {}, {}
    hooks = [mod.register_forward_pre_hook(lambda mod, args, n=name: current.update(name=n))
             for name, mod in card.model.named_modules() if isinstance(mod, layers.Attention)]

    def add_terms():
        """The sink of the running call's trans_coeff (the backward runs
        after every forward: the name is taken now)."""
        name = f"{current['name']}.trans_coeff"

        def add(x):
            sums[name] = sums.get(name, 0.0) + x
        return add

    calls = []

    def capture(entry, kind):
        """`entry` recording each call's inputs, the cotangent of its output
        and the cotangents that reach its q, k, v and, in a fused GTA call,
        its rep matrices (the tables `fused_tables` builds inside the call:
        the fused backward kernel's dMq, dMk, dMo)."""
        def run(q, k, v, heads, *rest, **kw):
            call = dict(kind=kind, layer=current["name"], inputs=[x.detach() for x in (q, k, v)], heads=heads,
                        rest=rest, kw=kw, grads=[None] * (3 + len(MATS)))

            def hook(x, i):
                if x is not None and x.requires_grad:
                    x.register_hook(lambda g: call["grads"].__setitem__(i, g.detach()))
            for i, x in enumerate((q, k, v)):
                hook(x, i)
            build = tgf.fused_tables

            def tables(*a):
                t = build(*a)
                for i, f in enumerate(MATS):
                    hook(getattr(t, f), 3 + i)
                return t
            tgf.fused_tables = tables
            try:
                out = entry(q, k, v, heads, *rest, **kw)
            finally:
                tgf.fused_tables = build
            out.register_hook(lambda g, call=call: call.update(g=g.detach()))
            calls.append(call)
            return out
        return run

    def grads(trainer, b=batch):
        loss, _, g = trainer.loss_and_grads(b)
        return loss.item(), [x.detach().cpu().double() for x in g]

    def rel(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    def worst_rel(g, ref):
        return max((rel(a, b), n) for n, a, b in zip(names, g, ref) if not n.endswith("trans_coeff"))

    def plain_attention(terms=None):
        """Swap the layers' attention entries for the plain versions and the
        ray encodings for fp32 ones (a no-op in fp32); returns a function
        that swaps them back."""
        restore_entries = swap_entries(functools.partial(plain_gta_attention, terms=terms), plain_flash_attention)
        posenc = encoder.ray_posenc

        def posenc_fp32(pos, rays, *args):
            return posenc(pos.float(), rays.float(), *args).to(pos.dtype)

        encoder.ray_posenc = decoder.ray_posenc = posenc_fp32

        def restore():
            restore_entries()
            encoder.ray_posenc = decoder.ray_posenc = posenc
        return restore

    try:
        kernel_gta, kernel_flash = gta_pallas.fused_gta_attention_tokens, gta_pallas.flash_attention
        inner = kernel_gta if card_entry is None else card_entry(kernel_gta)
        restore = swap_entries(capture(inner, "gta"), capture(kernel_flash, "flash"))
        try:
            loss_card, g_card = grads(card)
        finally:
            restore()
        loss_cpu, g_cpu = grads(cpu)
        restore = plain_attention()
        try:
            _, g_card_plain = grads(card)
        finally:
            restore()
        restore = plain_attention(add_terms)
        card.model.double()
        batch64 = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name).double() for f in dataclasses.fields(batch)
            if getattr(batch, f.name) is not None and getattr(batch, f.name).is_floating_point()})
        try:
            _, g_ref = grads(card, batch64)
        finally:
            card.model.float()
            restore()
    finally:
        for h in hooks:
            h.remove()

    def call_vjp(c, dtype):
        """The plain version's VJP of call `c` on its inputs and output
        cotangent, in `dtype` (tables too): the cotangents of q, k, v and,
        in a GTA call, of its rep matrices (None where there is none)."""
        xs = [x.to(dtype).detach().contiguous().requires_grad_() for x in c["inputs"]]
        mats = [None] * len(MATS)
        if c["kind"] == "gta":
            reps, args, tc, scale = c["rest"]
            reps = dataclasses.replace(reps, **{
                f.name: (tuple(t.to(dtype) for t in getattr(reps, f.name)) if isinstance(getattr(reps, f.name), tuple)
                         else getattr(reps, f.name).to(dtype)) for f in dataclasses.fields(reps)
                if getattr(reps, f.name) is not None})
            t = tables_in(reps, args, None if tc is None else tc.to(dtype), dtype)
            mats = [None if getattr(t, f) is None else getattr(t, f).detach().requires_grad_() for f in MATS]
            t = dataclasses.replace(t, **dict(zip(MATS, mats)))
            out = tgf.gta_fused_fwd_plain(*xs, t, c["heads"], scale)
        else:
            out = plain_flash_attention(*xs, c["heads"], *c["rest"], **c["kw"])
        leaves = [x for x in xs + mats if x is not None]
        got = iter(torch.autograd.grad(out, leaves, c["g"].to(dtype)))
        return [None if x is None else next(got) for x in xs + mats]

    # per call: the step's cotangents of q, k, v (and a GTA call's rep
    # matrices) against the fp64 VJP, beside the plain fp32 VJP's error;
    # each row (ratio to the limit, error, plain error, output, layer, kind)
    call_rows = []
    for c in calls:
        want, plain32 = call_vjp(c, torch.float64), call_vjp(c, torch.float32)
        for name, a, p, r in zip(("q", "k", "v") + MATS, c["grads"], plain32, want):
            if a is not None:
                err, err32 = rel(a.double(), r), rel(p.double(), r)
                call_rows.append((err / (CALL_TOL + CALL_RULE * err32), err, err32, f"d{name}", c["layer"], c["kind"]))
    call_worst = max(call_rows, default=(0.0, 0.0, 0.0, None, None, None))

    flat = lambda g: torch.cat([x.flatten() for n, x in zip(names, g)])  # noqa: E731
    err_kernels, err_plain, err_cpu = (rel(flat(g), flat(g_ref)) for g in (g_card, g_card_plain, g_cpu))
    excess = err_kernels - err_plain
    worst, plain = worst_rel(g_card, g_cpu), worst_rel(g_card_plain, g_cpu)
    print(f"{label} train: B=2 items {tuple(items)} grads cuda vs cpu, loss {loss_card:.7f} vs {loss_cpu:.7f}, "
          f"max |g_cuda - g_cpu| / |g_cpu|: {worst[0]:.3e} ({worst[1]}); the card with plain attention vs cpu: "
          f"{plain[0]:.3e} ({plain[1]})", flush=True)
    per_tensor = max((rel(a, r), n) for n, a, r in zip(names, g_card, g_ref) if not n.endswith("trans_coeff"))
    print(f"{label} train: against fp64, {len(calls)} attention calls' q/k/v and rep-matrix cotangents: closest to "
          f"its limit {call_worst[3]} of the {call_worst[5]} call in {call_worst[4]}, relative L2 {call_worst[1]:.3e} (the plain "
          f"version's fp32 {call_worst[2]:.3e}; limit {CALL_TOL} + {CALL_RULE} x that); largest "
          f"{max((r[1] for r in call_rows), default=0.0):.3e}; the whole gradient's "
          f"relative L2: card through the kernels {err_kernels:.3e}, through the plain attention {err_plain:.3e}, "
          f"cpu {err_cpu:.3e}: excess {excess:.3e} (tolerance {TOL}); largest per tensor on the card "
          f"{per_tensor[0]:.3e} ({per_tensor[1]})", flush=True)
    tc = [(abs(a.item() - r.item()) / sums[n], abs(c.item() - r.item()) / sums[n], n, r.item(), sums[n])
          for n, a, c, r in zip(names, g_card, g_cpu, g_ref) if n.endswith("trans_coeff")]
    tc_worst = max(tc, default=(0.0, 0.0, None, 0.0, 1.0))
    if tc:
        print(f"{label} train: trans_coeff against fp64, largest |g_card - g_fp64| / sum |terms| {tc_worst[0]:.3e} "
              f"({tc_worst[2]}: fp64 {tc_worst[3]:.3e}, sum |terms| {tc_worst[4]:.3e}, kappa "
              f"{tc_worst[4] / max(abs(tc_worst[3]), 1e-300):.1f}; cpu {tc_worst[1]:.3e}; over all scalars the cpu's "
              f"largest {max(row[1] for row in tc):.3e}); tolerance {TC_TOL}", flush=True)
    if not call_worst[0] <= 1.0:
        raise AssertionError(f"{label}: {call_worst[3]} of a {call_worst[5]} call in {call_worst[4]} is "
                             f"{call_worst[1]} (relative L2) from the call's fp64 VJP > {CALL_TOL} + {CALL_RULE} x "
                             f"the plain fp32 version's {call_worst[2]}")
    if not excess <= TOL:
        raise AssertionError(f"{label}: the gradient through the kernels is {excess} (relative L2) further from "
                             f"fp64 than through the plain attention > {TOL}")
    if not tc_worst[0] <= TC_TOL:
        raise AssertionError(f"{label}: the card's gradient of {tc_worst[2]} is {tc_worst[0]} x the sum of its terms' "
                             f"absolute values from fp64 > {TC_TOL}")
    return excess, tc_worst[0], call_worst[0]


CLI_TIMEOUT = 600  # seconds a CLI may take
CLI_CHAINS = 4  # cli_phase's chains of CLIs side by side


def cli_worker() -> int:
    """A process that runs `python -m` CLIs one after another, each as
    `__main__` in its main thread (`python3 -c "import chip_smoke;
    chip_smoke.cli_worker()"` from the root): a job is a line of JSON on
    stdin, {"args": [module, *argv] or ["-c", code, *argv], "env": {...},
    "out": path, "err": path}, run with `env` added to the environment and
    its stdout and stderr (file descriptors 1 and 2) in those files; a
    line with its exit code answers it. It takes the card and loads the
    port before its first job (a worker started ahead is warm when its
    job comes), and run_cli's CLIs of one chain share one: each skips the
    process start (~8 s to reach the card) and the imports."""
    import gc
    import runpy
    import traceback

    import torch
    import torch.nn.functional as F

    import gta_tpu_torch.evaluate  # noqa: F401
    import gta_tpu_torch.train.trainer  # noqa: F401
    import gta_tpu_torch.train_dit  # noqa: F401
    from gta_tpu_torch.ops import _cuda

    if torch.cuda.is_available():  # the context, cuBLAS, cuDNN and the kernels' libraries, before the first job
        x = torch.ones(4, 4, device="cuda")
        F.conv2d((x @ x)[None, None], x[None, None, :1, :1])
        _cuda.build()
        torch.cuda.synchronize()
    reply = os.fdopen(os.dup(1), "w")
    for line in sys.stdin:
        job = json.loads(line)
        env, argv = dict(os.environ), sys.argv
        os.environ.update(job["env"])
        fds = os.dup(1), os.dup(2)
        code = 0
        with open(job["out"], "w") as out, open(job["err"], "w") as err:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(out.fileno(), 1)
            os.dup2(err.fileno(), 2)
            try:
                args = job["args"]
                if args[0] == "-c":
                    sys.argv = ["-c", *args[2:]]
                    exec(compile(args[1], "<string>", "exec"), {"__name__": "__main__"})
                else:
                    sys.argv = list(args)
                    runpy.run_module(args[0], run_name="__main__", alter_sys=True)
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else int(e.code is not None)
            except Exception:  # a CLI's failure is its exit code; the worker goes on to the next
                traceback.print_exc()
                code = 1
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os.dup2(fds[0], 1)
                os.dup2(fds[1], 2)
                os.close(fds[0])
                os.close(fds[1])
                sys.argv = argv
                os.environ.clear()
                os.environ.update(env)
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()  # the card's memory back between CLIs
        print(code, file=reply, flush=True)
    return 0


_CLI_WORKERS = {}  # thread id -> its cli_worker process
_WARM_CLI_WORKERS = []  # cli_workers started ahead (warm_cli_workers), for threads' first CLIs


def start_cli_worker():
    """A cli_worker process, started now (it warms up on its own)."""
    return subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.cli_worker())"],
                            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def warm_cli_workers(n):
    """Start n cli_workers now, to warm up while this process works; the
    next threads to run a CLI each take one."""
    _WARM_CLI_WORKERS.extend(start_cli_worker() for _ in range(n))


def stop_cli_worker(proc):
    """End a cli_worker: it exits at the end of its input."""
    proc.stdin.close()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def close_cli_worker():
    """End this thread's cli_worker, if it has one."""
    import threading

    proc = _CLI_WORKERS.pop(threading.get_ident(), None)
    if proc is not None:
        stop_cli_worker(proc)


def run_cli(args, label, env=None, worker=None):
    """Run `python -m <args>` (`python -c <code> ...` where args[0] is
    "-c") from the repository root, with `env` added to the environment,
    in the cli_worker `worker`, or else in this thread's (a warm one where
    one was started ahead, else a new one, at its first CLI); returns its
    stdout."""
    import select
    import threading

    t0 = time.perf_counter()
    proc = worker or _CLI_WORKERS.get(threading.get_ident())
    if proc is None or proc.poll() is not None:
        proc = _CLI_WORKERS[threading.get_ident()] = (_WARM_CLI_WORKERS.pop() if _WARM_CLI_WORKERS
                                                      else start_cli_worker())
    with tempfile.TemporaryDirectory() as tmp:
        out, err = os.path.join(tmp, "stdout"), os.path.join(tmp, "stderr")
        proc.stdin.write(json.dumps({"args": list(args), "env": env or {}, "out": out, "err": err}) + "\n")
        proc.stdin.flush()
        ready, _, _ = select.select([proc.stdout], [], [], CLI_TIMEOUT)
        answer = proc.stdout.readline().strip() if ready else ""
        if not answer:
            proc.kill()
            proc.wait()
            if proc is _CLI_WORKERS.get(threading.get_ident()):
                del _CLI_WORKERS[threading.get_ident()]
        code = int(answer) if answer else "none (the worker died or timed out)"
        with open(out) as f, open(err) as g:
            stdout, stderr = f.read(), g.read()
    print(f"{label}: exit {code} in {time.perf_counter() - t0:.1f} s", flush=True)
    if code != 0:
        raise AssertionError(f"{label} failed:\n{stdout}\n{stderr}")
    return stdout


def side_by_side(*chains, meanwhile=None):
    """Run the chains (functions of no argument; each runs its CLIs one
    after another, in one cli_worker) in threads side by side: a CLI's
    time is mostly its process start, and the card has room for all.
    `meanwhile` (a function of no argument) runs in this thread while they
    do. Re-raises the first failure once all have ended; returns the
    chains' results (and meanwhile's, where given)."""
    from concurrent.futures import ThreadPoolExecutor

    def closing(chain):
        try:
            return chain()
        finally:
            close_cli_worker()

    with ThreadPoolExecutor(len(chains)) as pool:
        futures = [pool.submit(closing, chain) for chain in chains]
        try:
            here = meanwhile() if meanwhile is not None else None
        finally:
            results = [f.exception() or f.result() for f in futures]
    for f in futures:
        f.result()
    return results if meanwhile is None else (results, here)


def runs_listing():
    """Every file under runs/ with its size and modification time."""
    listing = {}
    for dirpath, _, files in os.walk(os.path.join(ROOT, "runs")):
        for name in files:
            st = os.stat(os.path.join(dirpath, name))
            listing[os.path.join(dirpath, name)] = (st.st_size, st.st_mtime_ns)
    return listing


def check_eval_result(log, label, out_dir, loaded, dtype):
    """The evaluate CLI's result line: JAX's keys, finite metrics (lpips_vgg
    included), on the card, and the same object in <out_dir>/eval_results.json."""
    result = json.loads(log.strip().splitlines()[-1])
    print(f"  {json.dumps(result)}", flush=True)
    with open(os.path.join(out_dir, "eval_results.json")) as f:
        written = json.load(f)
    keys = ["psnr", "ssim", "mse", "n_scenes", "lpips_vgg", "device", "dtype", "ckpt"]
    if (list(result) != keys or written != result or result["n_scenes"] != 1 or result["ckpt"] != loaded
            or not result["device"].startswith("cuda") or result["dtype"] != dtype
            or not np.isfinite([result[k] for k in ("psnr", "ssim", "mse", "lpips_vgg")]).all()):
        raise AssertionError(f"{label}: unexpected result {result} (written: {written})")
    if os.path.exists(os.path.join(out_dir, "ckpts")) != (loaded is not None):
        raise AssertionError(f"{label}: evaluate created or lost {out_dir}/ckpts")


def cli_phase():
    """The CLIs as subprocesses, each into a temporary directory (runs/ is
    left as it was): `python -m gta_tpu_torch.train` on the flagship, 3
    steps (exit after step 2) under --evalnow --visnow, then resume to step
    4; `python -m gta_tpu_torch.evaluate --ckpt best` on that run (LPIPS-VGG
    from a random-weight npz); the same evaluate on msn gta as published
    (bf16, no checkpoint: the random init); on CLEVR-TR gta_so3, 2 train
    steps; the SRT baseline's evaluate, one full-scale scene; gbt trained
    with --evalnow and evaluated --ckpt best; the SRT baseline's reference
    model.pt (srt_reference_file) imported and resumed (srt_ref_chain).
    Four chains of CLIs (gta_chain, msn_chain then srt_ref_chain,
    so3_srt_chain, gbt_chain) side by side: a fifth, with the other three
    trainings, filled the card's memory."""
    import torch

    from gta_tpu_torch.utils.lpips import random_params

    runs_before = runs_listing()
    with tempfile.TemporaryDirectory() as tmp:
        lp = os.path.join(tmp, "lpips_vgg_random.npz")
        np.savez(lp, **random_params(np.random.RandomState(0)))
        srt_ref = srt_reference_file(os.path.join(tmp, "srt_ref"))
        torch.cuda.empty_cache()  # the card's memory to the CLIs, which train side by side

        def msn_then_srt_ref():
            msn_chain(os.path.join(tmp, "msn"), lp)
            srt_ref_chain(srt_ref, os.path.join(tmp, "srt_ref", "run"))

        side_by_side(lambda: gta_chain(os.path.join(tmp, "gta"), lp), msn_then_srt_ref,
                     lambda: so3_srt_chain(os.path.join(tmp, "so3")), lambda: gbt_chain(os.path.join(tmp, "gbt"), lp))
    if runs_listing() != runs_before:
        raise AssertionError("a CLI wrote under runs/")


def gta_chain(out, lp):
    """The flagship's train CLI, 3 steps under --evalnow --visnow, resumed to
    step 4, then evaluate --ckpt best (cli_phase)."""
    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.utils.visualize import GAP, read_png

    logs = []
    for exit_after, extra in ((2, ["--evalnow", "--visnow", "--max-eval", "8"]), (4, [])):
        log = run_cli(["gta_tpu_torch.train", GTA_CONFIG, "--synthetic", "--outdir", out,
                       "--exit-after", str(exit_after), *extra], f"GTA train CLI --exit-after {exit_after} {extra}")
        logs.append(log)
        for line in log.splitlines():
            if any(w in line for w in ("it=", "Resumed", "parameters", "limit", "best", "Visualizing")):
                print(f"  {line}", flush=True)
        if "Iteration limit reached" not in log:
            raise AssertionError(f"train CLI did not reach its limit:\n{log}")
    if "Resumed" in logs[0] or "Resumed from checkpoint at it=3" not in logs[1]:
        raise AssertionError("train CLI did not start fresh, then resume at it=3")
    if "Visualizing..." not in logs[0] or "New best model" not in logs[0]:
        raise AssertionError("train CLI --evalnow --visnow did not visualize and save the best model")
    # min(6, batch, --max-eval 8) val scenes, the input columns and 6
    # render columns at the training resolution (240x320 downsampled once)
    cfg = load_config(GTA_CONFIG)
    rows, cols = min(6, cfg.training.batch_size, 8), cfg.data.num_input_views + 6
    h, w = cfg.data.height >> cfg.data.downsample, cfg.data.width >> cfg.data.downsample
    grid, text = read_png(os.path.join(out, "renders-val.png"))
    want = (rows * (h + GAP) - GAP, cols * (w + GAP) - GAP, 3)
    print(f"  renders-val.png: {grid.shape} uint8, columns {text.get('Columns')!r}", flush=True)
    if grid.shape != want or len(text.get("Columns", "").split(" | ")) != cols:
        raise AssertionError(f"renders-val.png is {grid.shape} with {text}, expected {want} and {cols} columns")
    log = run_cli(["gta_tpu_torch.evaluate", GTA_CONFIG, "--synthetic", "--outdir", out, "--ckpt", "best",
                   "--max-scenes", "1"], "GTA evaluate CLI --ckpt best", env={"LPIPS_WEIGHTS": lp})
    if "Loaded checkpoint best" not in log:
        raise AssertionError(f"GTA evaluate CLI did not restore best:\n{log}")
    check_eval_result(log, "GTA evaluate CLI", out, "best", "float32")


def msn_chain(out, lp):
    """evaluate on msn gta as published (bf16), without a checkpoint."""
    log = run_cli(["gta_tpu_torch.evaluate", MSN_GTA_CONFIG, "--synthetic", "--outdir", out, "--max-scenes", "1"],
                  "msn gta evaluate CLI (no checkpoint)", env={"LPIPS_WEIGHTS": lp})
    if "WARNING: checkpoint 'best' not found" not in log:
        raise AssertionError(f"msn gta evaluate CLI did not warn of the absent checkpoint:\n{log}")
    check_eval_result(log, "msn gta evaluate CLI", out, None, "bfloat16")


def so3_srt_chain(out):
    """CLEVR-TR gta_so3's train CLI for 2 steps, then the SRT baseline's
    evaluate (random init) on one full-scale scene."""
    log = run_cli(["gta_tpu_torch.train", CLEVR_SO3_CONFIG, "--synthetic", "--outdir", out, "--exit-after", "1"],
                  "CLEVR-TR gta_so3 train CLI --exit-after 1")
    for line in log.splitlines():
        if "it=" in line or "parameters" in line:
            print(f"  {line}", flush=True)
    if "Iteration limit reached" not in log or "it=0, loss=" not in log:
        raise AssertionError(f"gta_so3 train CLI did not take its steps:\n{log}")
    log = run_cli(["gta_tpu_torch.evaluate", SRT_CONFIG, "--synthetic", "--outdir", out, "--max-scenes", "1"],
                  "SRT evaluate CLI")
    result = json.loads(log.strip().splitlines()[-1])
    print(f"  {json.dumps(result)}", flush=True)
    if result["n_scenes"] != 1 or not result["device"].startswith("cuda") or not np.isfinite(result["psnr"]):
        raise AssertionError(f"SRT evaluate CLI: unexpected result {result}")


def gbt_chain(out, lp):
    """A baseline of the other attention methods (torch eager, its Plücker
    bias) on non-transform batches: train with --evalnow, then evaluate
    --ckpt best."""
    log = run_cli(["gta_tpu_torch.train", GBT_CONFIG, "--synthetic", "--outdir", out, "--exit-after", "1",
                   "--evalnow", "--max-eval", "8"], "gbt train CLI --exit-after 1 --evalnow")
    for line in log.splitlines():
        if any(w in line for w in ("it=", "parameters", "best")):
            print(f"  {line}", flush=True)
    if "Iteration limit reached" not in log or "New best model" not in log:
        raise AssertionError(f"gbt train CLI did not take its steps and save the best model:\n{log}")
    log = run_cli(["gta_tpu_torch.evaluate", GBT_CONFIG, "--synthetic", "--outdir", out, "--ckpt", "best",
                   "--max-scenes", "1"], "gbt evaluate CLI --ckpt best", env={"LPIPS_WEIGHTS": lp})
    if "Loaded checkpoint best" not in log:
        raise AssertionError(f"gbt evaluate CLI did not restore best:\n{log}")
    check_eval_result(log, "gbt evaluate CLI", out, "best", "float32")


def srt_reference_file(out):
    """A reference model.pt of the SRT baseline at full width, in `out`:
    one train step of a B=2 batch (the AdamW moments), saved, then the
    port's export with the moments by a weights-only template. Returns
    its path."""
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.trainer import Trainer
    from gta_tpu_torch.utils import ref_import

    cfg = as_synthetic(SRT_CONFIG)
    trainer = Trainer(cfg)
    trainer.train_step(synthetic_batch(cfg.data, "train", 0, 2, cfg.seed))
    made, template, model_pt = (os.path.join(out, n) for n in ("made", "template.pt", "model.pt"))
    Checkpointer(made).save("latest", trainer, {"epoch_it": 0, "it": trainer.step, "t": 0.5})
    ref_import.export_reference_checkpoint(SRT_CONFIG, made, template)
    ref_import.export_reference_checkpoint(SRT_CONFIG, made, model_pt, optimizer_order_from=template)
    return model_pt


def srt_ref_chain(model_pt, run):
    """The SRT baseline's reference model.pt (srt_reference_file) through
    `python -m gta_tpu_torch.scripts.import_reference_checkpoint` into
    `run`, then the train CLI on it, which must resume at the file's it=1
    and train through flash_core at B=32 to step 2 (cli_phase). The
    export runs in process here and in ref_ckpt_phase."""
    logs = [run_cli(["gta_tpu_torch.scripts.import_reference_checkpoint", SRT_CONFIG, model_pt, run],
                    "SRT import_reference_checkpoint CLI"),
            run_cli(["gta_tpu_torch.train", SRT_CONFIG, "--synthetic", "--outdir", run, "--exit-after", "2"],
                    "SRT train CLI on the imported run --exit-after 2")]
    for log in logs:
        for line in log.splitlines():
            if any(w in line for w in ("Imported", "Resumed", "limit")):
                print(f"  {line}", flush=True)
    if (f"Imported {model_pt} -> {run}/ckpts/latest (it=1, params: encoder " not in logs[0]
            or "Resumed from checkpoint at it=1" not in logs[1] or "Iteration limit reached" not in logs[1]):
        raise AssertionError("SRT reference checkpoint CLIs: the import and the resume at it=1 not both seen:\n"
                             + "\n".join(logs))


RUNTIME_ACCUM = 2  # the runtime phase's --accum
SPEED_TEST = 4  # --speed_test: the flagship's batch of 32 over 4, in 2 microbatches of 4
ACCUM_TOL = 1e-5  # relative L2 of the accumulated gradient from the unaccumulated one
SMALL_ACCUM_RULE = 1.5  # B=4: the accumulated gradient's distance from fp64 over the unaccumulated one's


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_cli(args, log_path, env=None):
    """Start `python -m <args>` (`python -c <code> ...` where args[0] is
    "-c") from the repository root, with `env` added to the environment,
    its output into `log_path`; returns the process (`finish_cli` waits for
    it)."""
    out = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, *(args if args[0] == "-c" else ["-m", *args])], cwd=ROOT, stdout=out,
                            stderr=subprocess.STDOUT, text=True, env={**os.environ, **(env or {})})
    proc.log_path, proc.t0 = log_path, time.perf_counter()
    out.close()
    return proc


def finish_cli(proc, label):
    """Wait for a `start_cli` process (600 s at most); returns its output."""
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(proc.log_path) as f:
        log = f.read()
    print(f"{label}: exit {proc.returncode} in {time.perf_counter() - proc.t0:.1f} s", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"{label} failed:\n{log}")
    return log


def logged(out_dir):
    """<out_dir>/metrics.jsonl, each line held to scripts/plot_metrics.py's
    schema (kind, it, t, and loss / lr or the eval dict with psnr)."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    for d in lines:
        need = {"train": {"kind", "it", "t", "loss", "lr"}, "eval": {"kind", "it", "t", "psnr", "mse"}}[d["kind"]]
        if set(d) != need or not np.isfinite([d[k] for k in need - {"kind"}]).all():
            raise AssertionError(f"metrics.jsonl line {d} is not in plot_metrics' schema")
    return lines


SMALL_ACCUM_BATCH = 4  # the small-batch accumulation check's batch (a cut of the flagship's 32)


def small_batch_accum(cfg0, batch, weights):
    """The flagship's gradient at B=SMALL_ACCUM_BATCH (the batch's first
    items; dropout 0; `weights`) through the kernels at grad_accum 1 and
    RUNTIME_ACCUM, each against one fp64 step on the card (`fp64_grads`:
    the plain attention in fp64): the whole gradient's relative L2 from
    fp64 of each, their gap, and the tensors furthest from fp64. Fails
    where the accumulated gradient's is above SMALL_ACCUM_RULE x the
    unaccumulated one's. Returns the numbers."""
    import torch

    from gta_tpu_torch.train.trainer import Trainer

    n = SMALL_ACCUM_BATCH
    small = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:n] for f in dataclasses.fields(batch)
                                          if isinstance(getattr(batch, f.name), torch.Tensor)})
    grads, trainer = {}, None
    for accum in (1, RUNTIME_ACCUM):
        cfg = dataclasses.replace(cfg0, training=dataclasses.replace(cfg0.training, grad_accum=accum))
        trainer = Trainer(cfg)
        trainer.model.load_state_dict(weights)
        trainer.loss_and_grads(small)
        grads[accum] = {k: p.grad.detach().double().cpu() for k, p in trainer.model.named_parameters()}
    trainer.model.load_state_dict(weights)
    g64, _ = fp64_grads(trainer, small)
    names = sorted(g64)

    def flat(g):
        return torch.cat([g[k].reshape(-1).double() for k in names])

    def gap(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    ref = flat(g64)
    out = {f"accum{a}_from_fp64": gap(flat(grads[a]), ref) for a in (1, RUNTIME_ACCUM)}
    out["accum_gap"] = gap(flat(grads[RUNTIME_ACCUM]), flat(grads[1]))
    worst = sorted(((max(gap(grads[a][k], g64[k]) for a in grads), k) for k in names if g64[k].abs().sum() > 0))
    out["furthest"] = {k: [gap(grads[a][k], g64[k]) for a in (1, RUNTIME_ACCUM)] for _, k in worst[-3:]}
    print(f"GTA runtime B={n}: relative L2 from one fp64 step: accum 1 {out['accum1_from_fp64']:.3e}, accum "
          f"{RUNTIME_ACCUM} {out[f'accum{RUNTIME_ACCUM}_from_fp64']:.3e} (rule: at most {SMALL_ACCUM_RULE}x accum "
          f"1's); accum {RUNTIME_ACCUM} vs accum 1 {out['accum_gap']:.3e}; furthest tensors (accum 1, "
          f"{RUNTIME_ACCUM}): {json.dumps({k: [float(f'{x:.3e}') for x in v] for k, v in out['furthest'].items()})}",
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    if not out[f"accum{RUNTIME_ACCUM}_from_fp64"] <= SMALL_ACCUM_RULE * out["accum1_from_fp64"]:
        raise AssertionError(f"B={n}: the accumulated gradient is further from fp64 than {SMALL_ACCUM_RULE} x "
                             f"the unaccumulated one's: {out}")
    return out


def runtime_phase(gta_cfg, paths):
    """The train runtime on the flagship (fp32, B=32, full width):
    (a) in process, dropout 0, the same weights and batch: loss_and_grads
    at grad_accum 1 and RUNTIME_ACCUM (the whole gradient within ACCUM_TOL
    relative L2, the fused GTA launches doubled, the accumulated peak
    memory lower; launches under paths gta_accum{1,2}_grads), then a cold
    and 3 warm train_steps of each, and at accum 1 three more in a
    one-rank NCCL group (the gradient all_reduce), and the gradients of
    the batch's first SMALL_ACCUM_BATCH items against an fp64 step
    (small_batch_accum); (b) the train CLI as subprocesses: --accum 2
    --speed_test 4 (time.npy), a run of a config copy with print_every 1
    under --validate-every 2 --profile 2 that gets SIGTERM once step 1 has
    printed (exit 0, `latest` saved, a trace naming the fused GTA kernels)
    and its resume (printing the saved it + 1; metrics.jsonl holds both
    runs); (c) `python -m torch.distributed.run --nproc_per_node 1` of
    the train CLI (NCCL, world size 1; its first loss equal to the plain
    run's from the same seed) and of train_dit on dit_gta (2 steps).
    Returns its numbers."""
    import signal
    import threading

    import torch
    import yaml

    from gta_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    m = gta_cfg.model
    cfg0 = dataclasses.replace(gta_cfg, model=dataclasses.replace(
        m, encoder=dataclasses.replace(m.encoder, dropout=0.0), decoder=dataclasses.replace(m.decoder, dropout=0.0)))
    batch = synthetic_batch(cfg0.data, "train", 0, EVAL_BATCH, cfg0.seed)
    numbers, grads, weights = {}, {}, None
    for accum in (1, RUNTIME_ACCUM):
        cfg = dataclasses.replace(cfg0, training=dataclasses.replace(cfg0.training, grad_accum=accum))
        trainer = Trainer(cfg)
        if weights is None:
            weights = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
        trainer.model.load_state_dict(weights)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        _, _, g = trainer.loss_and_grads(batch)
        torch.cuda.synchronize()
        paths[f"gta_accum{accum}_grads"] = launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = expected_launches(cfg, accum, accum, backward_steps=accum)
        if launches != want:
            raise AssertionError(f"accum {accum} loss_and_grads launches {launches}, expected {want}")
        grads[accum] = torch.cat([x.reshape(-1) for x in g]).double().cpu()
        step_ms = []
        for _ in range(1 + TRAIN_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        numbers[f"accum{accum}"] = {"peak_mem_gb": peak_gb, "cold_step_ms": step_ms[0], "warm_step_ms": step_ms[1:],
                                    "median_warm_step_ms": float(np.median(step_ms[1:])),
                                    "loss": out["loss"].item()}
        if accum == 1:  # the same steps in a one-rank NCCL group: the gradient all_reduce's cost
            import torch.distributed as tdist

            tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
            try:
                nccl_ms = []  # a cold step (NCCL's communicator starts at the first all_reduce), then warm ones
                for _ in range(1 + TRAIN_RUNS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = trainer.train_step(batch)
                    torch.cuda.synchronize()
                    nccl_ms.append((time.perf_counter() - t0) * 1e3)
                if tdist.get_backend() != "nccl" or not isinstance(out["stop"], torch.Tensor):
                    raise AssertionError("the NCCL group's step did not take the all_reduce")
            finally:
                tdist.destroy_process_group()
            numbers["nccl_world1_step_ms"] = nccl_ms
            numbers["nccl_world1_median_warm_step_ms"] = float(np.median(nccl_ms[1:]))
            print(f"GTA runtime: train_step in a one-rank NCCL group ms(cold, warm)=[{', '.join(f'{x:.2f}' for x in nccl_ms)}] "
                  f"beside the plain step's median {numbers['accum1']['median_warm_step_ms']:.2f}", flush=True)
        print(f"GTA runtime accum {accum}: loss_and_grads B={EVAL_BATCH} launches gta_fused_fwd "
              f"{launches['gta_fused_fwd']} / bwd {launches['gta_fused_bwd']} peak_mem_gb={peak_gb:.3f}; "
              f"train_step ms(cold)={step_ms[0]:.2f} ms(warm)=[{', '.join(f'{x:.2f}' for x in step_ms[1:])}]",
              flush=True)
        del trainer, g, out
        torch.cuda.empty_cache()
    err = float(np.linalg.norm(grads[RUNTIME_ACCUM] - grads[1]) / np.linalg.norm(grads[1]))
    numbers["accum_grad_rel_l2"] = err
    print(f"GTA runtime: accum {RUNTIME_ACCUM} gradient vs accum 1, relative L2 {err:.3e} (limit {ACCUM_TOL})",
          flush=True)
    if not err <= ACCUM_TOL:
        raise AssertionError(f"accumulated gradient {err} from the unaccumulated one > {ACCUM_TOL}")
    if not numbers[f"accum{RUNTIME_ACCUM}"]["peak_mem_gb"] < numbers["accum1"]["peak_mem_gb"]:
        raise AssertionError(f"accum {RUNTIME_ACCUM} peak memory is not below accum 1's: {numbers}")
    numbers["small_batch"] = small_batch_accum(cfg0, batch, weights)

    # the speed test's process, started now: warm when the runs before it end
    warm = start_cli_worker()
    with tempfile.TemporaryDirectory() as tmp:
        # three runs side by side on the card (none of them timed): the
        # SIGTERM run and the two one-rank torchrun runs
        with open(GTA_CONFIG) as f:
            raw = yaml.safe_load(f)
        raw["training"]["print_every"] = 1
        copy = os.path.join(tmp, "config.yaml")
        with open(copy, "w") as f:
            yaml.safe_dump(raw, f)
        run, dp, dit = (os.path.join(tmp, name) for name in ("run", "dp", "dit"))
        torchrun = ["torch.distributed.run", "--nproc_per_node", "1", "--master_addr", "localhost", "--master_port"]
        side = {label: start_cli(args, os.path.join(tmp, f"{key}.log")) for key, label, args in (
            ("dp", "torchrun GTA train CLI (1 process)",
             torchrun + [str(free_port()), "-m", "gta_tpu_torch.train", GTA_CONFIG, "--synthetic", "--outdir", dp,
                         "--exit-after", "3", "--evalnow", "--max-eval", "8"]),
            ("dit", "torchrun dit_gta train_dit (1 process)",
             torchrun + [str(free_port()), "-m", "gta_tpu_torch.train_dit", DIT_GTA_CONFIG, "--outdir", dit,
                         "--exit-after", "1"]))}
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "gta_tpu_torch.train", copy, "--synthetic", "--outdir", run,
                                 "--exit-after", "1000", "--validate-every", "2", "--profile", "2", "--max-eval", "8"],
                                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "PYTHONUNBUFFERED": "1"})
        watchdog = threading.Timer(600, proc.kill)
        watchdog.start()
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if "it=1, loss=" in line:
                    proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log = "".join(lines)
        print(f"GTA train CLI SIGTERM after it=1: exit {rc} in {time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0 or "Preemption checkpoint saved. Exiting." not in log:
            raise AssertionError(f"SIGTERM run exited {rc}:\n{log}")
        stopped = max(int(x) for x in re.findall(r"it=(\d+), loss=", log))
        with open(os.path.join(run, "ckpts", "latest", "scalars.json")) as f:
            if json.load(f)["it"] != stopped:
                raise AssertionError(f"latest was saved at another it than the last step, {stopped}")
        with open(os.path.join(run, "trace", "rank0.json")) as f:
            kernels = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
        fused = sorted(k for k in kernels if "gta_rows" in k or "gta_bwd" in k)
        print(f"  stopped after it={stopped}; trace: {len(kernels)} kernel names, fused GTA: {fused[:4]}", flush=True)
        if not any("gta_rows" in k for k in fused) or not any("gta_bwd" in k for k in fused):
            raise AssertionError(f"the profiler trace names no fused GTA forward / backward kernel: {sorted(kernels)}")
        first = logged(run)  # before the resumed run appends to it
        ref = next(d["loss"] for d in first if d["kind"] == "train" and d["it"] == 0)

        # the speed test resumes the stopped run (the published config:
        # print_every 100, no host sync between steps) once the torchrun
        # runs end, so its chained window has the card alone, in the worker
        # warmed meanwhile (no process start on the phase's path)
        logs = {label: finish_cli(p, label) for label, p in side.items()}

        log, label = logs["torchrun GTA train CLI (1 process)"], "torchrun GTA train CLI"
        got = next(d["loss"] for d in logged(dp) if d["kind"] == "train" and d["it"] == 0)
        numbers["torchrun_first_loss"], numbers["plain_first_loss"] = got, ref
        said = next((line for line in log.splitlines() if line.startswith("Data parallel:")), None)
        print(f"  {label}: {said}; first loss {got!r} vs the plain run's {ref!r}", flush=True)
        if (said != "Data parallel: backend nccl, world size 1, rank 0" or "Iteration limit reached" not in log
                or abs(got - ref) > 1e-6 * abs(ref)):
            raise AssertionError(f"{label}: first loss {got} vs {ref}\n{log}")
        log = logs["torchrun dit_gta train_dit (1 process)"]
        with open(os.path.join(dit, "ckpts", "latest", "scalars.json")) as f:
            saved = json.load(f)["it"]
        if ("Data parallel: backend nccl, world size 1, rank 0" not in log or "it=0 loss=" not in log
                or "Iteration limit reached" not in log or saved != 1):
            raise AssertionError(f"torchrun train_dit (latest at it={saved}):\n{log}")

        speed_label = f"GTA train CLI --accum {RUNTIME_ACCUM} --speed_test {SPEED_TEST}, resumed"
        try:
            log = run_cli(["gta_tpu_torch.train", GTA_CONFIG, "--synthetic", "--outdir", run, "--accum",
                           str(RUNTIME_ACCUM), "--speed_test", str(SPEED_TEST)], speed_label, worker=warm)
        finally:
            stop_cli_worker(warm)
        numbers["speed_test_ms"] = float(np.load(os.path.join(run, "time.npy"))[0])
        print(f"  chained mean step time (B={EVAL_BATCH // SPEED_TEST}, accum {RUNTIME_ACCUM}): "
              f"{numbers['speed_test_ms']:.3f} ms", flush=True)
        if (f"chained mean step time: {numbers['speed_test_ms']:.2f} ms" not in log
                or f"Resumed from checkpoint at it={stopped + 1}" not in log):
            raise AssertionError(f"the speed test did not resume at it={stopped + 1} and print its time:\n{log}")
        written = [(d["kind"], d["it"]) for d in logged(run)]
        if ([it for kind, it in written if kind == "train" and it <= stopped] != list(range(stopped + 1))
                or ("eval", 2) not in written or not any(it > stopped for _, it in written)):
            raise AssertionError(f"metrics.jsonl of the two runs: {written}")
    numbers["seconds"] = time.perf_counter() - t_phase
    print(f"runtime phase: {numbers['seconds']:.1f} s {json.dumps(numbers)}", flush=True)
    return numbers


RE10K_GTA_CONFIG = os.path.join(ROOT, "runs", "re10k", "GTA", "gta", "config.yaml")
RE10K_SRT_CONFIG = os.path.join(ROOT, "runs", "re10k", "otherPEs", "srt", "config.yaml")
DISK_H, DISK_W, DISK_VIEWS = 240, 320, 5  # the CLEVR-TR layout; RealEstate10K frames of the same size
# CLEVR-TR train scenes (the reader's 90 % train split holds 230, 7 batches
# of 32 in one epoch) and test scenes; the train scenes' frames and masks
# are CLEVR_IMAGE_SETS distinct sets written once, scene s hard-linking set
# s % CLEVR_IMAGE_SETS (every scene has its own cameras), so writing stays
# short while the reader decodes 10 files an item as on a real dump
CLEVR_SCENES = {"train": range(256), "test": range(256, 258)}
CLEVR_IMAGE_SETS = 64
RE10K_VIDEOS = {"train": 2, "test": 1}
RE10K_FRAMES = 40
MSN_DISK_BATCH = 16
ROW_FILTERS = np.arange(DISK_H) % 5  # every scanline filter, row by row
DECODE_TURNS = 16  # scenes timed in turns, numpy and native
LOADER_PREFETCH = 2  # batches the loader keeps ready (its default)
DISK_STEPS, SYNTHETIC_STEPS = 1 + 6, 3  # disk-fed steps (one cold); synthetic steps before and after them


def write_clevr_fixture(root, rng, written):
    """CLEVR-TR in the JAX layout (metadata/<n>.json, imgs/img_<n>_<v>.png,
    masks/masks_<n>_<v>.png): cameras on a ring (tests/test_data.py), seeded
    noise frames, gray mask indices 0-6, every PNG written by the port's
    encoder through all five filters ({path: array} of each file written
    into `written`); train scenes past CLEVR_IMAGE_SETS link the files of
    scene s % CLEVR_IMAGE_SETS."""
    from gta_tpu_torch.data.png import write_png

    for split, scenes in CLEVR_SCENES.items():
        d = os.path.join(root, split)
        for sub in ("metadata", "imgs", "masks"):
            os.makedirs(os.path.join(d, sub))
        for s in scenes:
            qs, ps = [], []
            for v in range(DISK_VIEWS):
                az = 2 * np.pi * v / DISK_VIEWS + 0.3 * s
                qs.append([np.cos(az / 2), 0.0, 0.0, np.sin(az / 2)])
                ps.append([7 * np.cos(az), 7 * np.sin(az), 4.0])
                for kind, name, shape, high in (("imgs", "img", (DISK_H, DISK_W, 3), 256),
                                                ("masks", "masks", (DISK_H, DISK_W), 7)):
                    path = os.path.join(d, kind, f"{name}_{s}_{v}.png")
                    if split == "train" and s >= CLEVR_IMAGE_SETS:
                        os.link(os.path.join(d, kind, f"{name}_{s % CLEVR_IMAGE_SETS}_{v}.png"), path)
                        continue
                    arr = rng.randint(0, high, shape).astype(np.uint8)
                    write_png(path, arr, filter=ROW_FILTERS)
                    written[path] = arr
            with open(os.path.join(d, "metadata", f"{s}.json"), "w") as f:
                json.dump({"camera": {"quaternions": qs, "positions": ps}}, f)


def write_re10k_fixture(root, rng, written):
    """A RealEstate10K dump ({split}/<video>.txt camera files, frames/<video>/
    <timestamp>.png): dolly trajectories as tests/test_re10k.py writes them,
    frames of a colour ramp under seeded noise."""
    from gta_tpu_torch.data.png import write_png

    for split, n_videos in RE10K_VIDEOS.items():
        for vid in range(n_videos):
            vdir = os.path.join(root, split, "frames", f"vid{vid}")
            os.makedirs(vdir)
            lines = [f"https://example.com/watch?v=vid{vid}"]
            for i in range(RE10K_FRAMES):
                ang = 0.01 * i
                R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
                t = -R @ np.asarray([0.05 * i, 0.01 * vid, -0.02 * i])
                nums = [0.9, 1.2, 0.5, 0.5, 0.0, 0.0] + np.concatenate([R, t[:, None]], 1).reshape(-1).tolist()
                lines.append(str(1000 * i) + " " + " ".join(f"{v:.9f}" for v in nums))
                img = rng.randint(0, 64, (DISK_H, DISK_W, 3)).astype(np.uint8)
                img[..., 0] += np.uint8(191 * i // RE10K_FRAMES)
                img[..., 1] += np.linspace(0, 191, DISK_W).astype(np.uint8)[None]
                path = os.path.join(vdir, f"{1000 * i}.png")
                write_png(path, img, filter=ROW_FILTERS)
                written[path] = img
            with open(os.path.join(root, split, f"vid{vid}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")


def raw_msn_scene(rng, nv=10, size=128):
    """A raw MSN-Hard scene as sunds yields it (no sunds exists here): uint8
    colour, ray origins and directions of look-at cameras on a ring, and
    instance ids."""
    from gta_tpu_torch.geometry.rays import camera_rays_from_extrinsic, lookat_extrinsic

    origins = np.zeros((nv, size, size, 3), np.float32)
    dirs = np.zeros((nv, size, size, 3), np.float32)
    for v in range(nv):
        az = 2 * np.pi * v / nv + rng.uniform(0, 0.5)
        pos = np.array([6 * np.cos(az), 6 * np.sin(az), 2.0 + rng.uniform(0, 2)])
        origins[v] = pos
        dirs[v] = camera_rays_from_extrinsic(lookat_extrinsic(pos), pos, size, size)
    color = rng.randint(0, 256, (nv, size, size, 3)).astype(np.uint8)
    return color, origins, dirs, rng.randint(0, 40, (nv, size, size, 1)).astype(np.int32)


def timed_ms(fn, *args, **kwargs):
    """(fn's result, its wall ms on the host)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, (time.perf_counter() - t0) * 1e3


def decode_phase(clevr_dir, written):
    """Every distinct file written decodes to its array through the host
    decoder (data/native.py) and through the numpy codec (data/png.py), five
    files of one directory a call. Then the decode ms per 240x320 RGB frame,
    the two in turns (the first to run alternating) on the frames of
    DECODE_TURNS scenes: one file a call and a scene's 5 a call, as uint8
    (what `imread` returns); and the float32 RGB the CLEVR-TR reader asks
    for, on one thread as it does."""
    from gta_tpu_torch.data import native
    from gta_tpu_torch.data.png import imread, imread_stack

    by_dir = {}
    for p in sorted(written):
        by_dir.setdefault(os.path.dirname(p), []).append(p)
    checked = 0
    for ps in by_dir.values():
        for i in range(0, len(ps), DISK_VIEWS):
            group = ps[i : i + DISK_VIEWS]
            want = np.stack([written[p] for p in group])
            for route, got in (("native", native.decode_pngs_u8(group)),
                               ("numpy", imread_stack(group))):
                if got.dtype != np.uint8 or got.shape != want.shape or got.tobytes() != want.tobytes():
                    raise AssertionError(f"disk: {route} decode of {group} differs from the arrays written")
            checked += len(group)
    if checked != len(written):
        raise AssertionError(f"disk: checked {checked} of {len(written)} files")
    times = {k: [] for k in ("numpy_1", "native_1", "numpy_5", "native_5", "reader_rgb_5")}
    for s in range(DECODE_TURNS):
        ps = [os.path.join(clevr_dir, "train", "imgs", f"img_{s}_{v}.png") for v in range(DISK_VIEWS)]
        runs = [("numpy_1", lambda p=ps: [imread(x) for x in p]),
                ("numpy_5", lambda p=ps: imread_stack(p)),
                ("native_1", lambda p=ps: [native.decode_pngs_u8([x]) for x in p]),
                ("native_5", lambda p=ps: native.decode_pngs_u8(p)),
                ("reader_rgb_5", lambda p=ps: native.decode_pngs_rgb(p, DISK_H, DISK_W, threads=1))]
        for key, fn in (runs if s % 2 else runs[::-1]):
            times[key].append(timed_ms(fn)[1] / DISK_VIEWS)
    out = {f"decode_ms_per_frame_{k}": float(np.median(v)) for k, v in times.items()}
    out["decode_speedup_1"] = out["decode_ms_per_frame_numpy_1"] / out["decode_ms_per_frame_native_1"]
    out["decode_speedup_5"] = out["decode_ms_per_frame_numpy_5"] / out["decode_ms_per_frame_native_5"]
    print(f"disk: {checked} files decode to the arrays written, native and numpy; decode ms per "
          f"{DISK_H}x{DISK_W} RGB frame (host; median of {DECODE_TURNS} scenes, in turns): one file a call "
          f"numpy {out['decode_ms_per_frame_numpy_1']:.3f} native {out['decode_ms_per_frame_native_1']:.3f} "
          f"({out['decode_speedup_1']:.1f}x); 5 a call numpy {out['decode_ms_per_frame_numpy_5']:.3f} native "
          f"{out['decode_ms_per_frame_native_5']:.3f} ({out['decode_speedup_5']:.1f}x); float32 RGB as CLEVRTR "
          f"decodes (1 thread) {out['decode_ms_per_frame_reader_rgb_5']:.3f}", flush=True)
    if out["decode_speedup_1"] < 5 or out["decode_speedup_5"] < 5:
        raise AssertionError(f"disk: the native decoder is less than 5x the numpy codec's speed: {out}")
    return out


def reader_phase(clevr, collate, workers):
    """Where a CLEVRTR item's host time goes, one thread (decode, the whole
    item natively and through the numpy codec, collating a batch of 32),
    and the reader's items/s through Loader at 1 and `workers` workers: the
    first 64 items of an epoch, from the first `next`."""
    from gta_tpu_torch.data import clevrtr
    from gta_tpu_torch.data.loader import Loader
    from gta_tpu_torch.data.native import decode_pngs_gray, decode_pngs_rgb

    d = clevr.dir
    decode, native_item, numpy_item = [], [], []
    plain = clevrtr.CLEVRTR(clevr.cfg, clevr.mode, seed=0, native=False)
    for i in range(6):
        s = int(os.path.basename(clevr.metadata_paths[i]).split(".")[0])
        imgs = [os.path.join(d, "imgs", f"img_{s}_{v}.png") for v in range(DISK_VIEWS)]
        masks = [os.path.join(d, "masks", f"masks_{s}_{v}.png") for v in range(DISK_VIEWS)]
        t0 = time.perf_counter()
        decode_pngs_rgb(imgs, DISK_H, DISK_W, threads=1)
        decode_pngs_gray(masks, DISK_H, DISK_W, threads=1)
        decode.append((time.perf_counter() - t0) * 1e3)
        item, ms = timed_ms(clevr.__getitem__, i)
        native_item.append(ms)
        if i < 3:
            ref, ms = timed_ms(plain.__getitem__, i)
            numpy_item.append(ms)
            if any(ref[k].tobytes() != item[k].tobytes() for k in item):
                raise AssertionError(f"disk: CLEVRTR item {i} differs between the native and numpy decoders")
    items = [clevr[i] for i in range(32)]
    _, collate_ms = timed_ms(collate, items)
    out = {"item_ms_native": float(np.median(native_item)), "item_ms_numpy": float(np.median(numpy_item)),
           "item_decode_ms": float(np.median(decode)), "collate_b32_ms": collate_ms}
    out["item_assembly_ms"] = out["item_ms_native"] - out["item_decode_ms"]
    for n_workers in (1, workers):
        loader = Loader(clevr, 32, shuffle=True, seed=1, num_workers=n_workers, prefetch=LOADER_PREFETCH)
        t0 = time.perf_counter()
        it = iter(loader)
        n = sum(next(it).input_images.shape[0] for _ in range(2))
        out[f"clevrtr_items_per_s_w{n_workers}"] = n / (time.perf_counter() - t0)
        it.close()
    print(f"disk: CLEVRTR item on one host thread: {out['item_ms_native']:.1f} ms native "
          f"({out['item_decode_ms']:.1f} ms decoding its 10 PNGs, {out['item_assembly_ms']:.1f} ms the rest: rays, "
          f"masks, sampling), {out['item_ms_numpy']:.1f} ms through the numpy codec; collate of 32 "
          f"{collate_ms:.1f} ms; items/s through Loader (workers): "
          + ", ".join(f"{k.split('_s_')[1]} {v:.2f}" for k, v in out.items() if k.startswith("clevrtr_items")),
          flush=True)
    return out


def render_phase():
    """The synthetic scenes' renderer, native (data/native.py) and numpy
    (data/synthetic.py), in turns on one seeded scene of 5 views at
    240x320: ms each, and their agreement (rays within 1e-4, >= 99.5 % of
    pixels within 1e-3: float32 against float64)."""
    from gta_tpu_torch.data.native import render_views
    from gta_tpu_torch.data.synthetic import _render
    from gta_tpu_torch.geometry.rays import camera_rays_from_extrinsic, lookat_extrinsic

    rng = np.random.RandomState(0)
    k = 6
    spheres = (np.stack([rng.uniform(-3, 3, k), rng.uniform(-3, 3, k), rng.uniform(0.3, 1.8, k)], -1),
               rng.uniform(0.4, 1.1, k), rng.uniform(0.1, 1.0, (k, 3)))
    az, el, r = rng.uniform(0, 2 * np.pi, DISK_VIEWS), rng.uniform(0.25, 0.9, DISK_VIEWS), rng.uniform(7, 10, DISK_VIEWS)
    cam_pos = np.stack([r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el), r * np.sin(el)], -1).astype(np.float32)
    ext = np.stack([lookat_extrinsic(p) for p in cam_pos])

    def plain():
        rays = np.stack([camera_rays_from_extrinsic(e, p, DISK_W, DISK_H) for e, p in zip(ext, cam_pos)])
        return np.stack([_render(p, ray, spheres) for p, ray in zip(cam_pos, rays)]), rays

    times = {"native": [], "numpy": []}
    for turn in range(3):
        for key, fn in ((("numpy", plain), ("native", lambda: render_views(cam_pos, ext, *spheres, DISK_H, DISK_W)))
                        [:: 1 if turn % 2 else -1]):
            result, ms = timed_ms(fn)
            times[key].append(ms)
            if key == "native":
                native_out = result
            else:
                numpy_out = result
    rays_err = float(np.abs(native_out[1] - numpy_out[1]).max())
    close = float((np.abs(native_out[0] - numpy_out[0]).max(-1) < 1e-3).mean())
    out = {f"render_{k}_ms": float(np.median(v)) for k, v in times.items()}
    print(f"disk: synthetic render of {DISK_VIEWS}x{DISK_H}x{DISK_W} (host, median of 3 in turns): native "
          f"{out['render_native_ms']:.2f} ms, numpy {out['render_numpy_ms']:.2f} ms; rays |d| {rays_err:.2e}, "
          f"pixels within 1e-3 {close:.5f}", flush=True)
    if rays_err > 1e-4 or close < 0.995:
        raise AssertionError(f"disk: native render disagrees with numpy: rays {rays_err}, close {close}")
    return out


def disk_train_phase(cfg, clevr, paths):
    """The flagship's train step at its config's batch fed from the CLEVR-TR
    dump as the train CLI feeds it: Loader(shuffle, the config's
    num_workers, prefetch 2), DISK_STEPS steps in one epoch (the first
    waits for the pipeline to fill), between two blocks of SYNTHETIC_STEPS
    steps on a synthetic batch of the same shapes (the first step cold).
    Per step: the wall ms, and the ms it waited on `next(loader)`. Then one
    eval_step on the first disk batch and one on the synthetic batch (the
    serving path). Launch counts asserted for each run (a train step 7
    forward, 7 backward; an eval_step 7 forward)."""
    import torch

    from gta_tpu_torch.data.loader import Loader
    from gta_tpu_torch.train.trainer import Trainer

    B = cfg.training.batch_size
    trainer = Trainer(cfg)  # default device: cuda
    synthetic = synthetic_batch(cfg.data, "train", 0, B, cfg.seed)
    loader = Loader(clevr, B, shuffle=True, seed=cfg.seed, num_workers=cfg.training.num_workers,
                    prefetch=LOADER_PREFETCH)
    if len(loader) < DISK_STEPS:
        raise AssertionError(f"disk: {len(loader)} batches of {B} in the CLEVR-TR split, need {DISK_STEPS}")

    def step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch)["loss"].item()
        torch.cuda.synchronize()
        if not np.isfinite(loss):
            raise AssertionError(f"disk: B={B} train step loss {loss}")
        return (time.perf_counter() - t0) * 1e3

    reset_launch_counts()
    synthetic_ms = [step(synthetic) for _ in range(SYNTHETIC_STEPS)]
    synthetic_counts = launch_counts()
    reset_launch_counts()
    wait_ms, disk_ms, first = [], [], None
    it = iter(loader)
    for _ in range(DISK_STEPS):
        batch, ms = timed_ms(next, it)
        if batch.input_images.shape[0] != B:
            raise AssertionError(f"disk: a batch of {batch.input_images.shape[0]}, expected {B}")
        if first is None:
            first = batch
        wait_ms.append(ms)
        disk_ms.append(step(batch))
    it.close()
    disk_counts = paths["clevr_gta_b32_disk_train"] = launch_counts()
    reset_launch_counts()
    synthetic_ms += [step(synthetic) for _ in range(SYNTHETIC_STEPS)]
    synthetic_counts = paths["clevr_gta_b32_synthetic_train"] = {
        k: n + synthetic_counts[k] for k, n in launch_counts().items()}
    for kind, counts, n in (("disk", disk_counts, DISK_STEPS), ("synthetic", synthetic_counts, 2 * SYNTHETIC_STEPS)):
        want = expected_launches(cfg, n, n, backward_steps=n)
        if counts != want:
            raise AssertionError(f"disk: B={B} {kind} train launches {counts}, expected {want}")
    psnr = {}
    for kind, batch in (("disk", first), ("synthetic", synthetic)):
        reset_launch_counts()
        psnr[kind] = trainer.eval_step(batch)["psnr"].mean().item()
        counts = paths[f"clevr_gta_{kind}_serving"] = launch_counts()
        want = expected_launches(cfg, 1, 1)
        if counts != want or not np.isfinite(psnr[kind]):
            raise AssertionError(f"disk: B={B} {kind} eval_step launches {counts}, expected {want}; psnr {psnr[kind]}")
    walls = [w + s for w, s in zip(wait_ms, disk_ms)]
    out = {"b32_disk_wall_ms": float(np.median(walls[1:])), "b32_disk_wait_ms": float(np.median(wait_ms[1:])),
           "b32_disk_step_ms": float(np.median(disk_ms[1:])), "b32_disk_first_wait_ms": wait_ms[0],
           "b32_synthetic_step_ms": float(np.median(synthetic_ms[1:]))}
    print(f"CLEVR-TR gta B={B} train from the dump (Loader: {cfg.training.num_workers} workers, prefetch "
          f"{LOADER_PREFETCH}), per step wall ms = wait on next(loader) + train_step: "
          + "; ".join(f"{w + s:.1f} = {w:.1f} + {s:.1f}" for w, s in zip(wait_ms, disk_ms))
          + f"; synthetic B={B} steps ms (before, after): {', '.join(f'{x:.1f}' for x in synthetic_ms)}; "
          f"launches disk {disk_counts['gta_fused_fwd']} / {disk_counts['gta_fused_bwd']}, synthetic "
          f"{synthetic_counts['gta_fused_fwd']} / {synthetic_counts['gta_fused_bwd']} (fwd / bwd); eval_step psnr "
          f"disk {psnr['disk']:.4f}, synthetic {psnr['synthetic']:.4f}, launches "
          f"{paths['clevr_gta_disk_serving']['gta_fused_fwd']} / {paths['clevr_gta_synthetic_serving']['gta_fused_fwd']}",
          flush=True)
    print(f"CLEVR-TR gta B={B}: warm medians, disk-fed wall {out['b32_disk_wall_ms']:.1f} ms (waited "
          f"{out['b32_disk_wait_ms']:.1f}, step {out['b32_disk_step_ms']:.1f}), synthetic step "
          f"{out['b32_synthetic_step_ms']:.1f} ms: {out['b32_disk_wall_ms'] / out['b32_synthetic_step_ms']:.2f}x",
          flush=True)
    return out


def disk_steps(cfg, label, key, disk, synthetic, paths):
    """eval_step and train_step of `cfg` on a batch its reader made from disk
    and, in the same process, on a synthetic batch of the same shapes (one
    cold call, then two warm each): the device work is the same. Each run's
    launch counts are asserted and kept in paths[<key>_<disk|synthetic>_
    <serving|train>]; returns the warm times."""
    import torch

    from gta_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)  # default device: cuda
    times = {}
    for kind, batch in (("disk", disk), ("synthetic", synthetic)):
        for path, step, backward in (("serving", trainer.eval_step, 0), ("train", trainer.train_step, 3)):
            reset_launch_counts()
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(batch)
                value = (m["psnr"].mean() if path == "serving" else m["loss"]).item()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            counts = paths[f"{key}_{kind}_{path}"] = launch_counts()
            want = expected_launches(cfg, 3, 3, backward_steps=backward)
            if counts != want or not np.isfinite(value):
                raise AssertionError(f"{label} {kind} {path}: launches {counts}, expected {want}; value {value}")
            times[f"{kind}_{path}"] = ms
    B = disk.input_images.shape[0]
    print(f"{label} B={B}, disk-read batch vs synthetic batch of the same shapes, ms (cold, warm, warm): "
          + "; ".join(f"{k} {', '.join(f'{x:.2f}' for x in v)}" for k, v in times.items()), flush=True)
    return {k: float(np.median(v[1:])) for k, v in times.items()}


def check_disk_eval(result, label, dtype):
    print(f"  {json.dumps(result)}", flush=True)
    if (result["n_scenes"] != 1 or not result["device"].startswith("cuda") or result["dtype"] != dtype
            or not np.isfinite([result["psnr"], result["ssim"], result["mse"]]).all()):
        raise AssertionError(f"{label}: unexpected result {result}")


def disk_phase(gta_cfg, msn_gta, srt_cfg, paths):
    """The host data plane and the dataset readers on fixtures written here
    with the port's PNG encoder (every scanline filter): CLEVR-TR (256
    train scenes over 64 distinct image sets, 2 test scenes, 5 views of
    240x320) and a RealEstate10K dump (2 train videos, 1 test video, 40
    frames of 240x320).
      1. decode_phase: every distinct file decodes to the array written,
         natively and through the numpy codec; decode ms per frame, the two
         in turns. render_phase: the synthetic renderer, native and numpy.
         reader_phase: a CLEVRTR item's host time by part, and items/s
         through Loader at 1 and 4 workers; RealEstate10K and prep_scene
         items/s.
      2. disk_train_phase: the flagship (fp32) at its config's B=32 fed from
         the dump through Loader(4 workers, prefetch 2), beside synthetic
         B=32 steps; msn gta (bf16) on 16 prep_scene items from seeded raw
         10x128x128 scenes: eval_step and train_step beside the same
         config's synthetic batch (disk_steps). Launch counts asserted.
      3. The CLIs on the positional datapath: train the flagship 3 steps
         (--exit-after 2 --batch-size 8 --evalnow --max-eval 2) then
         evaluate --ckpt best on one test scene (the CLEVR-TR reader, 240x320
         full-scale views); re10k gta (bf16), 2 steps at batch 1 (its split
         holds one train video) then evaluate --ckpt best on one scene.
      4. In process: evaluate the re10k SRT (bf16) on the dump and the
         CLEVR-TR SRT (fp32) on its fixture, one scene each (the readers'
         non-transform branches), launch counts asserted.
    Returns the numbers it printed."""
    from gta_tpu_torch import evaluate
    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.clevrtr import CLEVRTR
    from gta_tpu_torch.data.msn import prep_scene
    from gta_tpu_torch.data.re10k import RealEstate10K
    from gta_tpu_torch.data.synthetic import collate
    from gta_tpu_torch.geometry.coords import make_2dcoord

    out = {}
    runs_before = runs_listing()
    with tempfile.TemporaryDirectory() as tmp:
        clevr_dir, re10k_dir = os.path.join(tmp, "clevrtr"), os.path.join(tmp, "re10k")
        rng, written = np.random.RandomState(0), {}
        t0 = time.perf_counter()
        write_clevr_fixture(clevr_dir, rng, written)
        write_re10k_fixture(re10k_dir, rng, written)
        print(f"disk: wrote {len(written)} PNGs (filters 0-4 row by row; {len(CLEVR_SCENES['train'])} CLEVR-TR train "
              f"scenes over {CLEVR_IMAGE_SETS} image sets) in {time.perf_counter() - t0:.1f} s", flush=True)

        out.update(decode_phase(clevr_dir, written))
        out.update(render_phase())
        clevr = CLEVRTR(dataclasses.replace(load_config(GTA_CONFIG).data, path=clevr_dir), "train", seed=0)
        out.update(reader_phase(clevr, collate, gta_cfg.training.num_workers))
        re10k_data = dataclasses.replace(load_config(RE10K_GTA_CONFIG).data, path=re10k_dir)
        re10k = RealEstate10K(re10k_data, "train")
        t0 = time.perf_counter()
        for epoch in range(4):
            re10k.set_epoch(epoch)
            item = re10k[0]
        out["re10k_items_per_s"] = 4 / (time.perf_counter() - t0)
        if item["input_images"].shape != (2, 120, 160, 3):
            raise AssertionError(f"re10k item input_images {item['input_images'].shape}")
        raw = [raw_msn_scene(np.random.RandomState(100 + i)) for i in range(MSN_DISK_BATCH)]
        coord = make_2dcoord(128, 128)
        t0 = time.perf_counter()
        items = [prep_scene(msn_gta.data, *scene, i, np.random.RandomState(i), coord) for i, scene in enumerate(raw)]
        out["prep_scene_items_per_s"] = MSN_DISK_BATCH / (time.perf_counter() - t0)
        msn_disk = collate(items)
        print(f"disk: reader items/s on the host, one thread: RealEstate10K {out['re10k_items_per_s']:.2f} (4 frames "
              f"of {DISK_H}x{DISK_W} resampled to 120x160 each), prep_scene {out['prep_scene_items_per_s']:.2f} "
              f"(10 views of 128x128)", flush=True)

        out.update(disk_train_phase(gta_cfg, clevr, paths))
        out["msn_gta_bf16"] = disk_steps(msn_gta, "msn gta bf16 (prep_scene)", "msn_gta_bf16", msn_disk,
                                         synthetic_batch(msn_gta.data, "train", 0, MSN_DISK_BATCH, msn_gta.seed),
                                         paths)

        def datapath_chain(config, data_dir, label, train_args, dtype):
            run = os.path.join(tmp, label.replace(" ", "_"))
            log = run_cli(["gta_tpu_torch.train", config, data_dir, "--outdir", run, "--evalnow", *train_args],
                          f"{label} train CLI on the datapath")
            for line in log.splitlines():
                if any(w in line for w in ("Loading", "it=", "best", "limit")):
                    print(f"  {line}", flush=True)
            dataset = "clevrtr" if "CLEVR" in label else "re10k"
            if (f"Loading training set ({dataset})" not in log or "synthetic" in log
                    or "Iteration limit reached" not in log or "New best model" not in log):
                raise AssertionError(f"{label} train CLI did not train from the datapath:\n{log}")
            log = run_cli(["gta_tpu_torch.evaluate", config, data_dir, "--outdir", run, "--ckpt", "best",
                           "--max-scenes", "1"], f"{label} evaluate CLI on the datapath --ckpt best")
            views = "240x320" if "CLEVR" in label else "120x160"
            reader = "CLEVRTR" if "CLEVR" in label else "RealEstate10K"
            line = f"Evaluating 1 scenes of {reader} (test split) at {views} full-scale views"
            if "Loaded checkpoint best" not in log or line not in log or "synthetic" in log:
                raise AssertionError(f"{label} evaluate CLI: not '{line}' from best:\n{log}")
            print(f"  {line}", flush=True)
            check_disk_eval(json.loads(log.strip().splitlines()[-1]), f"{label} evaluate CLI", dtype)

        # the two train -> evaluate chains side by side
        side_by_side(
            lambda: datapath_chain(GTA_CONFIG, clevr_dir, "CLEVR-TR gta",
                                   ["--exit-after", "2", "--batch-size", "8", "--max-eval", "2"], "float32"),
            lambda: datapath_chain(RE10K_GTA_CONFIG, re10k_dir, "re10k gta",
                                   ["--exit-after", "1", "--batch-size", "1", "--max-eval", "1"], "bfloat16"))

        re10k_srt = load_config(RE10K_SRT_CONFIG)
        for cfg, config, data_dir, label, shape in (
                (re10k_srt, RE10K_SRT_CONFIG, re10k_dir, "re10k SRT bf16", (2, 2 * 2)),
                (srt_cfg, SRT_CONFIG, clevr_dir, "CLEVR-TR SRT", (3, 3 * 5))):
            reset_launch_counts()
            t0 = time.perf_counter()
            result = evaluate.main([config, data_dir, "--outdir", os.path.join(tmp, label.replace(" ", "_")),
                                    "--max-scenes", "1"])
            key = "re10k_srt_bf16_disk_eval" if "re10k" in label else "clevr_srt_disk_eval"
            counts = paths[key] = launch_counts()
            # per target view: one encode, and a decode per 16384-ray chunk
            want = expected_launches(cfg, *shape)
            print(f"{label} evaluate on the datapath, in process ({time.perf_counter() - t0:.1f} s): launches "
                  f"{counts}", flush=True)
            if counts != want:
                raise AssertionError(f"{label} evaluate: launches {counts}, expected {want}")
            check_disk_eval(result, f"{label} evaluate", "bfloat16" if "bf16" in label else "float32")
    if runs_listing() != runs_before:
        raise AssertionError("the disk phase wrote under runs/")
    return out


DIT_BATCH = 256  # the DiT configs' batch size
DIT_VAL_BATCH = DIT_BATCH // 4  # the train CLI's val batches (train_dit.py)
DIT_SAMPLE_LABELS = 8  # the sample grid's labels: 2 x 8 rows under CFG
DIT_SAMPLE_STEPS = 50  # DDIM steps (the train CLI's default)
DIT_GUIDANCE = 4.0
DIT_LOADER_STEPS = 4  # warm steps fed by the loader's 4 worker threads


def dit_kernel_phase(cfg, label, device, prefix=""):
    """The DiT config's bf16 kernel instances at its shapes: self-attention
    over one view of 16 x 16 patch tokens, 6 heads of 64, at the train
    batch (forward with residuals, backward) and at the sampler's CFG batch
    (2 x DIT_SAMPLE_LABELS, forward); the fused GTA kernels with dit_gta's
    rotor-only tables (models/dit.grid_reps: no per-view matrix, a trivial
    span beside the rotors), flash_core on raw bf16 rows for dit_base.
    Numbers as bf16_kernel_phase's."""
    from gta_tpu_torch.models.dit import grid_reps

    m = cfg.model
    T, sample_b = m.num_patches, 2 * DIT_SAMPLE_LABELS
    names = {f"{prefix}dit_train_b{DIT_BATCH}": DIT_BATCH, f"{prefix}dit_sample_b{sample_b}": sample_b}
    if m.attn.is_gta:
        given = {n: (m.attn.gta, grid_reps(m, b, device), b, T, T) for n, b in names.items()}
    else:
        given = {n: (b, T, T) for n, b in names.items()}
    return bf16_kernel_phase(None, label, device, prefix="", flash=not m.attn.is_gta,
                             geometry=(m.heads, m.hidden_size // m.heads, given))


def dit_launches(cfg, forwards, backwards):
    """`forwards` and `backwards` launches of the instance the DiT config's
    attention launches (the fused GTA kernels for method 'gta', flash_core
    for ''; bf16 under mixed_prec; the instance of its head width), none of
    any other."""
    from gta_tpu_torch.ops import _cuda

    kernel = "gta_fused" if cfg.model.attn.is_gta else "flash_core"
    m, bf16 = cfg.model, cfg.training.mixed_prec
    width = _cuda.kernel_head_dim(kernel, m.hidden_size // m.heads)
    want = dict.fromkeys(launch_counts(), 0)
    want[instance_name(f"{kernel}_fwd", bf16, width)] = forwards
    want[instance_name(f"{kernel}_bwd", bf16, width)] = backwards
    return want


def check_dit_launches(label, cfg, forwards, backwards):
    """The launch counts since the last reset against dit_launches. Returns
    them."""
    launches, want = launch_counts(), dit_launches(cfg, forwards, backwards)
    print(f"{label}: launches {nonzero(launches)}, expected {nonzero(want)}", flush=True)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return launches


def dit_path_phase(cfg, label):
    """A published DiT config as it is (bf16, batch 256, the trainer's
    seeded init) on the card, through its entry points (DiTTrainer):
    train_step on procedural images, a cold step and TRAIN_RUNS warm ones
    (CUDA-synchronised host time), then DIT_LOADER_STEPS steps fed by
    Loader(4 worker threads, collate_images) with the wait on next(loader)
    beside each step; evaluate on two val batches of DIT_VAL_BATCH; sample
    of DIT_SAMPLE_LABELS labels (CFG, DDIM, DIT_SAMPLE_STEPS steps). Each
    path's launch counts asserted: depth forward + depth backward launches
    of its kernel per train step, depth forward per evaluated batch and per
    sampler step, none of any other instance. Returns ({path: launches},
    numbers)."""
    import torch

    from gta_tpu_torch.data.images import SyntheticImages, collate_images
    from gta_tpu_torch.data.loader import Loader
    from gta_tpu_torch.train.dit_trainer import DiTTrainer

    m, depth = cfg.model, cfg.model.depth
    trainer = DiTTrainer(cfg)  # default device: cuda
    ds = SyntheticImages(m.input_size, m.num_classes, "train", cfg.data.num_images, cfg.seed)
    made = [collate_images([ds[i] for i in range(n * DIT_BATCH, (n + 1) * DIT_BATCH)]) for n in range(2)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms, losses = [], []
    for n in range(1 + TRAIN_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(made[n % 2])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append([out[k].item() for k in ("loss", "mse", "vb")])
    loader = Loader(ds, DIT_BATCH, shuffle=True, seed=cfg.seed, num_workers=cfg.training.num_workers,
                    collate_fn=collate_images)
    batches = iter(loader)
    wait_ms, fed_ms = [], []
    for _ in range(DIT_LOADER_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        out = trainer.train_step(batch)
        torch.cuda.synchronize()
        wait_ms.append((t1 - t0) * 1e3)
        fed_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append([out[k].item() for k in ("loss", "mse", "vb")])
    batches.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = 1 + TRAIN_RUNS + DIT_LOADER_STEPS
    paths = {"train": check_dit_launches(f"{label} train ({steps} steps)", cfg, depth * steps, depth * steps)}
    finite = np.isfinite(losses).all() and all(bool(torch.isfinite(p.grad).all()) for p in trainer.model.parameters())
    if not finite or out["grad_norm"].item() <= 0:
        raise AssertionError(f"{label} train: losses {losses}, grad_norm {out['grad_norm'].item()}")
    warm = float(np.median(step_ms[1:]))
    print(f"{label} train: train_step B={DIT_BATCH} (loss, mse, vb)={losses} lr={out['lr']:.3e} "
          f"grad_norm={out['grad_norm'].item():.6f} ms(cold)={step_ms[0]:.2f} ms(warm)=[{', '.join(f'{x:.2f}' for x in step_ms[1:])}] "
          f"median_warm_ms={warm:.2f} images/s={DIT_BATCH / (warm / 1e3):.0f} peak_mem_gb={peak_gb:.2f}; loader-fed "
          f"(4 workers): wait ms=[{', '.join(f'{x:.2f}' for x in wait_ms)}] step ms=[{', '.join(f'{x:.2f}' for x in fed_ms)}]",
          flush=True)

    val = SyntheticImages(m.input_size, m.num_classes, "val", 2 * DIT_VAL_BATCH, cfg.seed)
    val_batches = [collate_images([val[i] for i in range(n * DIT_VAL_BATCH, (n + 1) * DIT_VAL_BATCH)]) for n in range(2)]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = trainer.evaluate(val_batches, seed=cfg.seed)
    eval_ms = (time.perf_counter() - t0) * 1e3
    paths["evaluate"] = check_dit_launches(f"{label} evaluate", cfg, 2 * depth, 0)
    if sorted(ev) != ["loss", "mse", "vb"] or not np.isfinite(list(ev.values())).all():
        raise AssertionError(f"{label} evaluate: {ev}")

    labels = np.arange(DIT_SAMPLE_LABELS) % m.num_classes
    trainer.sample(labels[:1], seed=1, steps=1, guidance=DIT_GUIDANCE)  # warm-up
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = trainer.sample(labels, seed=0, steps=DIT_SAMPLE_STEPS, guidance=DIT_GUIDANCE)
    sample_ms = (time.perf_counter() - t0) * 1e3
    paths["sample"] = check_dit_launches(f"{label} sample", cfg, depth * DIT_SAMPLE_STEPS, 0)
    if imgs.shape != (DIT_SAMPLE_LABELS, m.input_size, m.input_size, m.in_channels) or not (
            np.isfinite(imgs).all() and imgs.min() >= -1.0 and imgs.max() <= 1.0):
        raise AssertionError(f"{label} sample: shape {imgs.shape}, range {imgs.min()}..{imgs.max()}")
    print(f"{label} evaluate: 2 batches of {DIT_VAL_BATCH} in {eval_ms:.2f} ms {json.dumps(ev)}; sample: "
          f"{DIT_SAMPLE_LABELS} labels x {DIT_SAMPLE_STEPS} DDIM steps (CFG batch {2 * DIT_SAMPLE_LABELS}, guidance "
          f"{DIT_GUIDANCE}) in {sample_ms:.2f} ms ({sample_ms / DIT_SAMPLE_STEPS:.3f} ms per step)", flush=True)
    numbers = {"batch": DIT_BATCH, "median_warm_ms": warm, "cold_ms": step_ms[0], "warm_ms": step_ms[1:],
               "images_per_s": DIT_BATCH / (warm / 1e3), "peak_mem_gb": peak_gb, "loader_wait_ms": wait_ms,
               "loader_fed_step_ms": fed_ms, "median_loader_wait_ms": float(np.median(wait_ms)),
               "evaluate_ms": eval_ms, "sample_ms": sample_ms, "sample_step_ms": sample_ms / DIT_SAMPLE_STEPS}
    del trainer
    torch.cuda.empty_cache()
    return paths, numbers


def dit_card_vs_cpu_phase(cfg, label):
    """A DiT config's B=2 forward on the card against the same weights on
    the CPU: every parameter redrawn nonzero (adaLN-Zero would give exact
    zeros: N(0, 1/fan_in) weights, N(0, 0.1^2) biases, seed 0); the card's
    bf16 output at most BF16_RULE x as far (relative L2) from the CPU's
    fp32 one as the CPU's bf16 output with the TPU's rounding in the
    attention (the plain versions with mxu_dtype=bf16), as
    bf16_card_vs_cpu_phase holds the NVS configs. Returns (card vs CPU
    fp32, emulation vs CPU fp32, card vs CPU bf16, CPU bf16 vs fp32)."""
    import torch

    from gta_tpu_torch.data.images import SyntheticImages, collate_images
    from gta_tpu_torch.train.dit_trainer import DiTTrainer

    gen = torch.Generator().manual_seed(0)
    cpu32 = DiTTrainer(dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, mixed_prec=False)),
                       device="cpu")
    weights = nonzero_weights(cpu32.model, gen).state_dict()
    card, cpu16 = DiTTrainer(cfg), DiTTrainer(cfg, device="cpu")
    for t in (card, cpu16):
        t.model.load_state_dict(weights)
    m = cfg.model
    val = SyntheticImages(m.input_size, m.num_classes, "val", 2, cfg.seed)
    x = torch.from_numpy(collate_images([val[0], val[1]])["image"])
    t_, y = torch.tensor([10, 700]), torch.tensor([3, m.num_classes - 1])
    with torch.no_grad():
        out_card = card.model(x.cuda(), t_.cuda(), y.cuda()).cpu()
        out16, out32 = cpu16.model(x, t_, y), cpu32.model(x, t_, y)
        restore = swap_entries(functools.partial(plain_gta_attention, mxu_dtype=torch.bfloat16),
                               functools.partial(plain_flash_attention, mxu_dtype=torch.bfloat16))
        try:
            out_emu = cpu16.model(x, t_, y)
        finally:
            restore()
    card_err, emu_err = rel_l2(out_card, out32), rel_l2(out_emu, out32)
    gap, own = rel_l2(out_card, out16), rel_l2(out16, out32)
    print(f"{label} bf16: B=2 outputs, relative L2 against the CPU's fp32 ones: card {card_err:.3e}, CPU bf16 with "
          f"the TPU's rounding {emu_err:.3e} (rule: at most {BF16_RULE}x), CPU bf16 {own:.3e}; card vs CPU bf16 "
          f"{gap:.3e}", flush=True)
    if not (torch.isfinite(out_card).all() and out32.abs().max() > 0.1 and card_err <= BF16_RULE * emu_err):
        raise AssertionError(f"{label} bf16: card output {card_err} from fp32, above {BF16_RULE} x the emulated TPU "
                             f"rounding's {emu_err}")
    return card_err, emu_err, gap, own


def dit_cli_phase(path, label, steps=2, resume=True, evaluate=True, sample_steps=10):
    """The DiT CLIs as subprocesses into a temporary directory, at the
    config's batch (256) through the loader's worker threads: `python -m
    gta_tpu_torch.train_dit <config> --exit-after steps-1 --samplenow`
    (the procedural fallback printed, a sample grid that decodes, the loss
    printed, metrics.jsonl), optionally (`resume`) again to step `steps`,
    which must resume; then (`evaluate`) `python -m
    gta_tpu_torch.scripts.eval_dit_samples --per-class 1` on the run, whose
    JSON line must hold JAX's fields with finite numbers and be written to
    dit_sample_eval.json."""
    from gta_tpu_torch.data.png import imread

    with tempfile.TemporaryDirectory() as out:
        base = ["gta_tpu_torch.train_dit", path, "--outdir", out, "--sample-steps", str(sample_steps)]
        first = run_cli(base + ["--exit-after", str(steps - 1), "--samplenow"], f"{label} train_dit")
        grid = imread(os.path.join(out, "samples_0.png"))
        if ("No ImageNet datapath — falling back to procedural images." not in first or "it=0 loss=" not in first
                or "Sample grid written: samples_0.png" not in first or grid.ndim != 3):
            raise AssertionError(f"{label} train_dit: unexpected output\n{first}")
        if resume:
            second = run_cli(base + ["--exit-after", str(steps)], f"{label} train_dit resume")
            if f"Resumed from checkpoint at it={steps}" not in second:
                raise AssertionError(f"{label} train_dit did not resume:\n{second}")
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        if logged[0]["kind"] != "train" or not np.isfinite(logged[0]["loss"]):
            raise AssertionError(f"{label} train_dit: metrics.jsonl {logged}")
        if not evaluate:
            return
        log = run_cli(["gta_tpu_torch.scripts.eval_dit_samples", path, "--outdir", out, "--per-class", "1",
                       "--steps", str(sample_steps), "--max-eval", "16"], f"{label} eval_dit_samples")
        result = json.loads(log.strip().splitlines()[-2])
        with open(os.path.join(out, "dit_sample_eval.json")) as f:
            written = json.load(f)
    keys = ["config", "it", "per_class_n", "sample_class_accuracy", "per_class_accuracy", "per_class_eval_loss",
            "eval_loss_mean", "steps", "guidance"]
    if (list(result) != keys or written != result or result["it"] != steps + resume
            or len(result["per_class_accuracy"]) != 1000 or not np.isfinite(result["eval_loss_mean"])):
        raise AssertionError(f"{label} eval_dit_samples: {result} (written {written})")
    print(f"  {label} eval_dit_samples: it={result['it']} sample_class_accuracy={result['sample_class_accuracy']} "
          f"eval_loss_mean={result['eval_loss_mean']}", flush=True)


# Device-made data (data/device_synth.py, DeviceSyntheticImages): the
# configs the JAX package's --device-data runs trained, at published shapes
EXPERIMENTS = ("clevrtr_decay20k", "clevrtr_decay50k", "clevrtr_long150k", "msn_so3_40k", "re10k_quality20k",
               "dit_metric_base", "dit_metric_gta")
DEVICE_CPU_TOL = 1e-5  # camera positions and transforms, card against CPU
DEVICE_CPU_PIXEL_TOL = 1e-4  # images, card against CPU ...
DEVICE_CPU_PIXEL_SHARE = 0.999  # ... on at least this share of the pixels (silhouettes may flip)
DEVICE_STEP_RUNS = 3  # warm steps timed, after one cold step
PROFILE_TOP = 12  # kernels listed by device time in the profiled step
SCENE_ID_SHIM = (  # the train CLI with every DeviceSynthetic.batch call's scene ids printed
    "import runpy, sys; from gta_tpu_torch.data.device_synth import DeviceSynthetic as D; f = D.batch\n"
    "def batch(self, *a, **k):\n"
    "    b = f(self, *a, **k); print('scene ids', self.mode, a[0], b.sceneid.tolist(), flush=True); return b\n"
    "D.batch = batch; sys.argv = ['gta_tpu_torch.train', *sys.argv[1:]]\n"
    "runpy.run_module('gta_tpu_torch.train', run_name='__main__', alter_sys=True)")


def as_synthetic(path):
    """A config with dataset `synthetic` and its data shapes as published
    (the train CLI's --synthetic makes the same input views; `downsample`
    kept, so a full-scale view is the dataset's native size)."""
    from gta_tpu_torch.config import load_config

    cfg = load_config(path)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))


def sync_checked(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any host sync
    inside raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def card_against_cpu(label, got, want, exact, close, pixels):
    """A batch made on the card against the same ids made on the CPU:
    `exact` fields equal, `close` within DEVICE_CPU_TOL, `pixels` within
    DEVICE_CPU_PIXEL_TOL on DEVICE_CPU_PIXEL_SHARE of their pixels.
    Returns {field: max |d|} and the share of pixels beyond the tolerance."""
    import torch

    errs, flips = {}, {}
    for name in exact:
        if not torch.equal(got[name].cpu(), want[name]):
            raise AssertionError(f"{label}: {name} differs between the card and the CPU")
    for name in close + pixels:
        d = (got[name].cpu() - want[name]).abs()
        errs[name] = float(d.max())
        if name in pixels:  # a pixel is beyond where any of its channels is
            flips[name] = float((d.amax(-1) > DEVICE_CPU_PIXEL_TOL).float().mean())
            if flips[name] > 1 - DEVICE_CPU_PIXEL_SHARE:
                raise AssertionError(f"{label}: {name} beyond {DEVICE_CPU_PIXEL_TOL} on {flips[name]:.2e} of pixels")
        elif errs[name] > DEVICE_CPU_TOL:
            raise AssertionError(f"{label}: {name} card vs CPU {errs[name]:.3e} > {DEVICE_CPU_TOL}")
    return errs, flips


def generator_check(label, make, batch_size, fields):
    """One generator (make(device) -> it; it.batch(step, B) -> fields) on
    the card: batch() under the sync check, its CUDA-event ms (median of
    TIMED_RUNS after WARMUP) and its own peak memory, and the same ids made
    on the CPU held against the card's (card_against_cpu; `fields` =
    (exact, close, pixels)). Returns the generator and its numbers."""
    import torch

    gen, cpu = make("cuda"), make("cpu")
    got = sync_checked(lambda: gen.batch(1, batch_size))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: gen.batch(1, batch_size))
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    t0 = time.perf_counter()
    want = cpu.batch(1, batch_size)
    cpu_s = time.perf_counter() - t0
    view = (lambda b: b) if isinstance(got, dict) else (lambda b: {f.name: getattr(b, f.name)
                                                                   for f in dataclasses.fields(b)})
    errs, flips = card_against_cpu(label, view(got), view(want), *fields)
    print(f"{label} generator: batch B={batch_size} ms={ms:.4f} (CUDA events, median of {TIMED_RUNS}) own peak "
          f"{peak_gb:.3f} GB, no host sync; CPU {cpu_s:.2f} s; card vs CPU max|d| {json.dumps(errs)}, share beyond "
          f"{DEVICE_CPU_PIXEL_TOL} {json.dumps(flips)}", flush=True)
    return gen, {"batch": batch_size, "gen_ms": ms, "gen_peak_gb": peak_gb, "cpu_s": cpu_s, "card_vs_cpu": errs,
                 "pixels_beyond_tol": flips}


def timed_steps(step, batches):
    """Host ms of step(batches[i]) each, CUDA-synchronised (the first cold)."""
    import torch

    out = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def step_numbers(ms):
    return {"cold_ms": ms[0], "warm_ms": ms[1:], "median_warm_ms": float(np.median(ms[1:]))}


def device_steps(label, trainer, gen, batch_size, ready, want, first=2):
    """train_step on device batches (batch `first + i` made as each step
    starts, its time included: what --device-data does) and on a ready
    batch already on the card, a cold and DEVICE_STEP_RUNS warm each, the
    launch counts of each run asserted equal to `want`. Returns
    ({"device": launches, "ready": launches}, numbers)."""
    import torch

    runs, launches = {}, {}
    for kind, make in (("device", lambda i: gen.batch(first + i, batch_size)), ("ready", lambda i: ready)):
        reset_launch_counts()
        losses = []
        ms = timed_steps(lambda i: losses.append(float(trainer.train_step(make(i))["loss"])),
                         range(1 + DEVICE_STEP_RUNS))
        launches[kind] = launch_counts()
        if launches[kind] != want or not np.isfinite(losses).all():
            raise AssertionError(f"{label} {kind} steps: launches {launches[kind]}, expected {want}; losses {losses}")
        runs[kind] = step_numbers(ms)
    print(f"{label} train_step B={batch_size}: device batches {json.dumps(runs['device'])}; ready batch on the card "
          f"{json.dumps(runs['ready'])}; launches {launches['device']} each", flush=True)
    return launches, runs


def nvs_device_data(label, cfg, paths, key):
    """An NVS config with --device-data's batches: the generator
    (generator_check), then device_steps beside the host-made batch."""
    from gta_tpu_torch.data.device_synth import DeviceSynthetic
    from gta_tpu_torch.train.trainer import Trainer

    transform = cfg.data.return_transform
    fields = (("sceneid", "target_coord") if transform else ("sceneid",),
              ("input_camera_pos", "target_camera_pos", "input_transforms", "transform", "input_rays", "target_rays")
              + (("target_transforms",) if transform else ()), ("input_images", "target_pixels"))
    B = cfg.training.batch_size
    gen, numbers = generator_check(label, lambda device: DeviceSynthetic(cfg.data, "train", cfg.seed,
                                                                         device=device), B, fields)
    trainer = Trainer(cfg)  # default device: cuda
    ready = synthetic_batch(cfg.data, "train", 0, B, cfg.seed).to("cuda")
    launches, numbers["steps"] = device_steps(label, trainer, gen, B, ready, expected_launches(
        cfg, 1 + DEVICE_STEP_RUNS, 1 + DEVICE_STEP_RUNS, backward_steps=1 + DEVICE_STEP_RUNS))
    paths[f"{key}_device_train"], paths[f"{key}_ready_train"] = launches["device"], launches["ready"]
    return trainer, gen, numbers


def profile_step(label, trainer, batch):
    """One train_step under torch.profiler: the device ms of each CUDA
    kernel (and copy) by name, the PROFILE_TOP largest printed, and their
    sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.device_time_total / 1e3) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.device_time_total > 0
                      and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")),
                     key=lambda r: -r[1])
    if not kernels:
        raise AssertionError(f"{label}: torch.profiler recorded no device time (CUPTI)")
    total = sum(ms for _, ms in kernels)
    print(f"{label} profiled train_step: device ms {total:.3f} over {len(kernels)} kernel names; largest: "
          + "; ".join(f"{name[:90]} {ms:.3f}" for name, ms in kernels[:PROFILE_TOP]), flush=True)
    return {"device_ms": total, "top": kernels[:PROFILE_TOP]}


def experiment_steps(name, paths):
    """An experiments/ config in process as `--device-data` trains it, at
    full width and its batch: a cold and a warm train step on device
    batches 0 and 1, the launch counts asserted. Returns its numbers."""
    import torch

    from gta_tpu_torch.data.device_synth import DeviceSynthetic
    from gta_tpu_torch.data.images import DeviceSyntheticImages
    from gta_tpu_torch.train.dit_trainer import DiTTrainer, load_dit_config
    from gta_tpu_torch.train.trainer import Trainer

    path = os.path.join(ROOT, "experiments", name, "config.yaml")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    if name.startswith("dit_"):
        cfg = load_dit_config(path)
        m = cfg.model
        trainer = DiTTrainer(cfg)
        gen = DeviceSyntheticImages(m.input_size, m.num_classes, "train", cfg.data.num_images, cfg.seed,
                                    device=trainer.device)
        ms = timed_steps(lambda i: trainer.train_step(gen.batch(i, cfg.training.batch_size)), range(2))
        launches = check_dit_launches(f"experiments/{name}", cfg, 2 * m.depth, 2 * m.depth)
    else:
        cfg = as_synthetic(path)
        trainer = Trainer(cfg)
        gen = DeviceSynthetic(cfg.data, "train", cfg.seed, device=trainer.device)
        ms = timed_steps(lambda i: trainer.train_step(gen.batch(i, cfg.training.batch_size)), range(2))
        launches, want = launch_counts(), expected_launches(cfg, 2, 2, backward_steps=2)
        if launches != want:
            raise AssertionError(f"experiments/{name}: launches {launches}, expected {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = all(bool(torch.isfinite(p.grad).all()) for p in trainer.model.parameters())
    if not finite:
        raise AssertionError(f"experiments/{name}: gradients not finite")
    print(f"experiments/{name} --device-data: B={cfg.training.batch_size} "
          f"{'bf16' if cfg.training.mixed_prec else 'fp32'} train_step ms cold {ms[0]:.2f} warm {ms[1]:.2f} "
          f"peak_mem_gb={peak_gb:.2f}; launches {launches}", flush=True)
    paths[f"exp_{name}_train"] = launches
    del trainer
    torch.cuda.empty_cache()
    return {"batch": cfg.training.batch_size, "cold_ms": ms[0], "warm_ms": ms[1], "peak_mem_gb": peak_gb}


def scene_ids(log):
    """{(mode, step): ids} of a SCENE_ID_SHIM run's output."""
    out = {}
    for line in log.splitlines():
        if line.startswith("scene ids "):
            mode, step, ids = line[len("scene ids "):].split(" ", 2)
            out[(mode, int(step))] = json.loads(ids)
    return out


def device_data_cli(paths):
    """The CLIs with --device-data as subprocesses, each into a temporary
    directory: experiments/clevrtr_long150k for 2 steps (through
    SCENE_ID_SHIM, which prints each batch's scene ids), beside
    train_dit on experiments/dit_metric_gta for 2 steps with --samplenow and
    a one-rank `python -m torch.distributed.run` of the train CLI (NCCL);
    the first run resumed for a third step as soon as it ends (in a
    cli_worker started with them), whose scene ids must be the
    generator's batch 2: an unbroken run's."""
    from gta_tpu_torch.data.device_synth import DeviceSynthetic

    long_cfg = os.path.join(ROOT, "experiments", "clevrtr_long150k", "config.yaml")
    dit_cfg = os.path.join(ROOT, "experiments", "dit_metric_gta", "config.yaml")
    warm = start_cli_worker()  # the resumed run's process, warm when the first run ends
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "long")
        shim = ["-c", SCENE_ID_SHIM, long_cfg, "--device-data", "--outdir", run_dir, "--exit-after"]
        procs = {label: start_cli(args, os.path.join(tmp, f"{key}.log")) for key, label, args in (
            ("long", "train --device-data (2 steps)", shim + ["1"]),
            ("dit", "train_dit --device-data", ["gta_tpu_torch.train_dit", dit_cfg, "--device-data", "--outdir",
                                                os.path.join(tmp, "dit"), "--exit-after", "1", "--samplenow"]),
            ("ddp", "torchrun train --device-data", [
                "torch.distributed.run", "--nproc_per_node", "1", "--master_addr", "localhost", "--master_port",
                str(free_port()), "-m", "gta_tpu_torch.train", long_cfg, "--device-data", "--outdir",
                os.path.join(tmp, "ddp"), "--exit-after", "1"]))}
        # the resumed run starts as the first one ends, beside the others' ends
        first_label = "train --device-data (2 steps)"
        logs = {first_label: finish_cli(procs.pop(first_label), first_label)}
        try:
            resumed = run_cli(shim + ["2"], "train --device-data resumed", worker=warm)
        finally:
            stop_cli_worker(warm)
        logs.update({label: finish_cli(proc, label) for label, proc in procs.items()})
    cfg = as_synthetic(long_cfg)
    gen = DeviceSynthetic(cfg.data, "train", cfg.seed, device="cuda")
    first, again = scene_ids(logs["train --device-data (2 steps)"]), scene_ids(resumed)
    want = {("train", s): gen.ids(s, cfg.training.batch_size).tolist() for s in range(3)}
    checks = {
        "first run's steps are batches 0 and 1": all(first.get(("train", s)) == want[("train", s)] for s in (0, 1)),
        "resumed step is batch 2": again.get(("train", 2)) == want[("train", 2)] and ("train", 1) not in again,
        "resumed": "Resumed from checkpoint at it=2" in resumed,
        "on-device generation": all("Loading training set (synthetic, on-device generation)..." in log
                                    for log in (logs["train --device-data (2 steps)"], resumed,
                                                logs["torchrun train --device-data"])),
        "dit": all(s in logs["train_dit --device-data"] for s in ("Procedural images, on-device generation.",
                                                                   "Sample grid written: samples_0.png",
                                                                   "Iteration limit reached")),
        "nccl": "Data parallel: backend nccl, world size 1, rank 0" in logs["torchrun train --device-data"],
    }
    print(f"device-data CLIs: {json.dumps(checks)}; resumed step's scene ids {again.get(('train', 2))}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"device-data CLIs: {checks}\n" + "\n".join(list(logs.values()) + [resumed]))
    return checks


def device_data_phase(gta_cfg, paths, dit_gta, card):
    """Device-made data (data/device_synth.DeviceSynthetic and
    data/images.DeviceSyntheticImages) on the card, at published shapes:
    the flagship (fp32, B=32), msn_so3 (bf16, B=64), re10k gta and srt
    (bf16, B=32; 2 + 2 views of 120x160) and dit_gta (B=256). Each
    generator under the sync check, timed, with its peak memory, and held
    against the CPU's batch of the same ids; warm train steps on device
    batches beside a ready host-made batch on the card, launch counts
    asserted; for dit_gta the loader-fed step too. re10k gta and srt also
    serve (serving_path_phase: eval_step at B=32, a 240x320 view at chunk
    16384), and one re10k gta step is profiled. Then the seven
    experiments/ configs (experiment_steps) and the CLIs
    (device_data_cli). Returns the numbers, the card's name and power
    limit (`card`, as nvidia-smi gives them) among them."""
    import torch

    from gta_tpu_torch.data.images import DeviceSyntheticImages, SyntheticImages, collate_images
    from gta_tpu_torch.data.loader import Loader
    from gta_tpu_torch.train.dit_trainer import DiTTrainer

    out = {"card": card}
    print(f"device data phase on {card}", flush=True)
    configs = (("flagship fp32", gta_cfg, "gta"), ("msn_so3 bf16", as_synthetic(MSN_SO3_CONFIG), "msn_so3_bf16"),
               ("re10k gta bf16", as_synthetic(RE10K_GTA_CONFIG), "re10k_gta_bf16"),
               ("re10k srt bf16", as_synthetic(RE10K_SRT_CONFIG), "re10k_srt_bf16"))
    for label, cfg, key in configs:
        trainer, gen, out[key] = nvs_device_data(label, cfg, paths, key)
        if key == "re10k_gta_bf16":
            out[key]["profile"] = profile_step(label, trainer, gen.batch(9, cfg.training.batch_size))
        del trainer, gen
        torch.cuda.empty_cache()
        if key.startswith("re10k"):
            paths[f"{key}_serving"], frame = serving_path_phase(cfg, label, cfg.training.batch_size)
            out[key]["render_ms"] = frame[2]

    m = dit_gta.model
    B = dit_gta.training.batch_size
    gen, out["dit_gta"] = generator_check(
        "dit_gta", lambda device: DeviceSyntheticImages(m.input_size, m.num_classes, "train", dit_gta.data.num_images,
                                                        dit_gta.seed, device=device),
        B, (("label",), (), ("image",)))
    trainer = DiTTrainer(dit_gta)
    ds = SyntheticImages(m.input_size, m.num_classes, "train", dit_gta.data.num_images, dit_gta.seed)
    ready = {k: torch.as_tensor(v).cuda() for k, v in collate_images([ds[i] for i in range(B)]).items()}
    steps = 1 + DEVICE_STEP_RUNS
    launches, out["dit_gta"]["steps"] = device_steps("dit_gta", trainer, gen, B, ready,
                                                     dit_launches(dit_gta, m.depth * steps, m.depth * steps))
    paths["dit_gta_device_train"], paths["dit_gta_ready_train"] = launches["device"], launches["ready"]
    batches = iter(Loader(ds, B, shuffle=True, seed=dit_gta.seed, num_workers=dit_gta.training.num_workers,
                          collate_fn=collate_images))
    fed = timed_steps(lambda i: trainer.train_step(next(batches)), range(steps))
    batches.close()
    out["dit_gta"]["steps"]["loader_fed"] = step_numbers(fed)
    print(f"dit_gta train_step B={B} fed by Loader({dit_gta.training.num_workers} threads), next(loader) included: "
          f"{json.dumps(out['dit_gta']['steps']['loader_fed'])}", flush=True)
    del trainer, gen
    torch.cuda.empty_cache()

    out["experiments"] = {name: experiment_steps(name, paths) for name in EXPERIMENTS}
    out["cli"] = device_data_cli(paths)
    return out


def state_mismatches(a, b):
    """Names of what differs between two trainers' states, bit for bit:
    weights, AdamW moments and steps (by parameter name), the optimizer's
    hyperparameter groups (lr included), the scheduler's state and the
    step."""
    import torch

    bad = []
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    if list(pa) != list(pb):
        return ["parameter names"]
    for name in pa:
        if not torch.equal(pa[name], pb[name]):
            bad.append(name)
        sa, sb = a.optimizer.state[pa[name]], b.optimizer.state[pb[name]]
        if sorted(sa) != sorted(sb) or any(
                not (x.dtype == y.dtype and x.device == y.device and torch.equal(x, y))
                for x, y in ((sa[k], sb[k]) for k in sa)):
            bad.append(f"{name} (AdamW state)")
    ga, gb = (o.state_dict()["param_groups"] for o in (a.optimizer, b.optimizer))
    if ga != gb:
        bad.append("optimizer param_groups")
    if a.scheduler.state_dict() != b.scheduler.state_dict() or a.scheduler.get_last_lr() != b.scheduler.get_last_lr():
        bad.append("scheduler")
    if (a.step, a.seed) != (b.step, b.seed):
        bad.append("step / seed")
    return bad


def ref_round_trip(path, label, key, paths):
    """One config (its YAML as published, full width) through the reference
    format on the card: a trainer takes two train steps and is saved; the
    port's export writes a weights-only reference model.pt (the order
    template), then one with the AdamW moments by that template; the
    import makes a new run directory of it; a fresh trainer restores that
    and must equal the saved one bit for bit (state_mismatches). Then one
    more step in each on the same batch (cuDNN's deterministic algorithms
    on for the two): bit-equal losses and weights, its attention kernel's
    launches (expected_launches: two steps) under paths
    `ref_<key>_train`. Returns its numbers."""
    import torch

    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.trainer import Trainer
    from gta_tpu_torch.utils import ref_import

    cfg = as_synthetic(path)
    B = cfg.training.batch_size
    batches = [synthetic_batch(cfg.data, "train", n * B, (n + 1) * B, cfg.seed) for n in range(2)]  # train_path_phase's
    saved = Trainer(cfg)
    for batch in batches:
        saved.train_step(batch)
    out = {"batch": B}
    with tempfile.TemporaryDirectory() as tmp:
        run, imported = os.path.join(tmp, "run"), os.path.join(tmp, "imported")
        template, model_pt = os.path.join(tmp, "template.pt"), os.path.join(tmp, "model.pt")
        Checkpointer(run).save("latest", saved, {"epoch_it": 0, "it": saved.step, "t": 1.5, "run_id": "chip"})
        t0 = time.perf_counter()
        ref_import.export_reference_checkpoint(path, run, template)
        t1 = time.perf_counter()
        ref_import.export_reference_checkpoint(path, run, model_pt, optimizer_order_from=template)
        t2 = time.perf_counter()
        scalars, _ = ref_import.import_reference_checkpoint(path, model_pt, imported)
        t3 = time.perf_counter()
        out.update(export_weights_s=t1 - t0, export_s=t2 - t1, import_s=t3 - t2,
                   file_mb=os.path.getsize(model_pt) / 1e6)
        restored = Trainer(cfg)
        Checkpointer(imported).restore("latest", restored)
    flips = len(ref_import.so3_sign_map(cfg))
    bad = state_mismatches(saved, restored)
    print(f"{label} reference round trip: export (weights only) {out['export_weights_s']:.2f} s, export with "
          f"moments {out['export_s']:.2f} s ({out['file_mb']:.1f} MB), import {out['import_s']:.2f} s; "
          f"{flips} so3-signed weights; scalars {scalars}; mismatches {bad}", flush=True)
    if bad or scalars["it"] != saved.step:
        raise AssertionError(f"{label}: the imported trainer differs from the saved one: {bad}, {scalars}")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launch_counts()
        ma, mb = saved.train_step(batches[0]), restored.train_step(batches[0])
        torch.cuda.synchronize()
        paths[f"ref_{key}_train"] = launches = launch_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = expected_launches(cfg, 2, 2, backward_steps=2)
    la, lb = ma["loss"].item(), mb["loss"].item()
    bad = state_mismatches(saved, restored)
    print(f"{label} resumed step: losses {la!r} / {lb!r}, lr {ma['lr']!r} / {mb['lr']!r}, mismatches {bad}, "
          f"launches {launches}", flush=True)
    if la != lb or ma["lr"] != mb["lr"] or bad or not np.isfinite(la):
        raise AssertionError(f"{label}: the resumed steps differ: {la} vs {lb}, {bad}")
    if launches != want:
        raise AssertionError(f"{label} resumed steps launches {launches}, expected {want}")
    return out


def ref_ckpt_phase(paths):
    """Reference checkpoints across frameworks (gta_tpu_torch/utils/
    ref_import.py) on the card: ref_round_trip for the flagship (fp32,
    B=32) and msn_so3 as published (bf16, B=64; so3 signs at head width
    96). The CLIs' resume through flash_core runs in cli_phase
    (srt_ref_chain). Returns the numbers."""
    import torch

    out = {}
    for path, label, key in ((GTA_CONFIG, "flagship fp32", "gta"), (MSN_SO3_CONFIG, "msn_so3 bf16", "msn_so3_bf16")):
        out[key] = ref_round_trip(path, label, key, paths)
        torch.cuda.empty_cache()
    return out


PARALLEL_WARM = 1  # timed warm steps of each mode and one-process step, after the compared cold one
PARALLEL_TOL = 1e-5  # fp32: the gradient's excess error over one process's (trans_coeff aside), the weights
MSN_FP32_ACCUM = 4  # msn_so3's fp32 reference gradient in microbatches (its one-process fp32 step needs 50 GB)
FP64_ACCUM = 4  # the fp32 modes' fp64 reference steps in microbatches (the plain attention holds its scores)
REPAST_CONFIG = os.path.join(ROOT, "runs", "clevrtr", "otherPEs", "repast", "config.yaml")
MSN_SO3_EUCLID_CONFIG = os.path.join(ROOT, "runs", "msn", "GTA", "gta_so3_euclid", "config.yaml")
EUCLID_BATCH = 16  # msn gta_so3_euclid's eager attention holds its maps: its batch cut 64 -> 16 (widths as published)


@dataclasses.dataclass(frozen=True)
class ParallelMode:
    """One of parallel_phase's modes: its config (at full width and depth;
    `batch` cuts its batch where given), the layout, and (where the seq
    axis has ranks) which of (encoder, decoder) ring."""

    path: str
    mixed_prec: bool
    n_model: int = 1
    n_seq: int = 1
    zero: bool = False
    rings: tuple = (False, False)
    batch: int = 0  # 0: the config's

    @property
    def world(self) -> int:
        return self.n_model * self.n_seq * (2 if self.zero else 1)

    @property
    def ref(self) -> str:
        """The one-process reference step's key (`parallel_refs`)."""
        base = {GTA_CONFIG: "gta", GBT_CONFIG: "gbt", REPAST_CONFIG: "repast", SRT_CONFIG: "srt",
                MSN_SO3_CONFIG: "msn_so3", MSN_SO3_EUCLID_CONFIG: "msn_so3_euclid"}[self.path]
        return base + ("_bf16" if self.mixed_prec else "")


def parallel_modes():
    """parallel_phase's modes, at full width and depth, their configs'
    batches (but msn gta_so3_euclid's), dropout 0 (two data ranks draw
    their own masks, and the fp64 and fp32 references run in microbatches,
    which draw others; tests/test_torch_parallel.py holds TP and the ring
    with dropout), in the order they run: the two-rank world's (the flagship's
    layouts, msn_so3's TP, then the others), then the four-rank world's. Under tensor
    parallel the eager routes (gbt, repast, msn gta_so3_euclid) split their
    heads and launch no kernel, the flagship's 6 heads over 4 model ranks
    run whole (its FeedForwards split); under --n-seq 2 SRT and msn_so3's
    5 views run whole on each seq rank."""
    return {
        "gta_tp2": ParallelMode(GTA_CONFIG, False, n_model=2),
        "gta_ring2": ParallelMode(GTA_CONFIG, False, n_seq=2, rings=(True, True)),
        "gta_zero2": ParallelMode(GTA_CONFIG, False, zero=True),
        "msn_so3_bf16_tp2": ParallelMode(MSN_SO3_CONFIG, True, n_model=2),
        "gbt_tp2": ParallelMode(GBT_CONFIG, False, n_model=2),
        "repast_tp2": ParallelMode(REPAST_CONFIG, False, n_model=2),
        "msn_so3_euclid_bf16_tp2": ParallelMode(MSN_SO3_EUCLID_CONFIG, True, n_model=2, batch=EUCLID_BATCH),
        "srt_seq2": ParallelMode(SRT_CONFIG, False, n_seq=2),
        "msn_so3_bf16_seq2": ParallelMode(MSN_SO3_CONFIG, True, n_seq=2),
        "gta_tp4": ParallelMode(GTA_CONFIG, False, n_model=4),
    }


def parallel_refs():
    """The one-process references each rank of the two-rank world makes
    after its modes: key -> (config path, mixed_prec, grad_accum, batch, an
    fp64 gradient too). Rank 0 the fp32 configs' (each with its fp64
    gradient in FP64_ACCUM microbatches), rank 1 the bf16 configs' (each
    with its fp32 gradient in MSN_FP32_ACCUM microbatches, the bf16 rule's
    ground)."""
    fp32 = {key: (path, False, 1, 0, True) for key, path in
            (("gta", GTA_CONFIG), ("gbt", GBT_CONFIG), ("repast", REPAST_CONFIG), ("srt", SRT_CONFIG))}
    bf16 = {}
    for key, path, batch in (("msn_so3", MSN_SO3_CONFIG, 0), ("msn_so3_euclid", MSN_SO3_EUCLID_CONFIG, EUCLID_BATCH)):
        bf16[f"{key}_bf16"] = (path, True, 1, batch, False)
        bf16[f"{key}_fp32"] = (path, False, MSN_FP32_ACCUM, batch, False)
    return fp32, bf16


def parallel_config(path, mixed_prec=None, batch=0, **training):
    """A published config on synthetic scenes, dropout 0, lr_warmup 0 (the
    first step moves the weights), its batch `batch` where given,
    `training` over its training settings."""
    from gta_tpu_torch.config import load_config

    cfg = load_config(path)
    if mixed_prec is not None:
        training["mixed_prec"] = mixed_prec
    if batch:
        training["batch_size"] = batch
    m = cfg.model
    m = dataclasses.replace(m, encoder=dataclasses.replace(m.encoder, dropout=0.0),
                            decoder=dataclasses.replace(m.decoder, dropout=0.0))
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"), model=m,
                               training=dataclasses.replace(cfg.training, lr_warmup=0, **training))


# the geometry the models compute from the batch alone (no parameter
# reaches it): an fp64 step takes it as the fp32 step computes it, so both
# see one input (posenc octaves up to 2^9 pi turn an fp32 rounding of a
# Plücker coordinate or a rigid transform into ~1e-3 of an embedding)
FP32_GEOMETRY = ("ray_posenc", "plucker_params", "plucker_posenc", "plucker_dist", "rigid_transform")


def fp32_geometry(fn):
    """`fn` computed on fp32 operands, its result in the operands' dtype."""
    import torch

    def run(*args):
        dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
        return fn(*(a.float() if isinstance(a, torch.Tensor) else a for a in args)).to(dtype)
    return run


def fp64_grads(trainer, batch):
    """The gradient of `trainer`'s step on `batch` in float64, by name on the
    CPU (the plain attention, fp64 tables: grads_phase's fp64 step; the
    batch's geometry as the fp32 step computes it, FP32_GEOMETRY), and
    each trans_coeff's terms' absolute sums (grads_phase's conditioning)."""
    import torch

    from gta_tpu_torch.models import decoder, encoder
    from gta_tpu_torch.models.layers import Attention

    sums, current = {}, {}
    handles = [m.register_forward_pre_hook(lambda mod, a, name=name: current.update(name=name))
               for name, m in trainer.model.named_modules() if isinstance(m, Attention) and m.trans_coeff is not None]

    def terms():
        name = f"{current['name']}.trans_coeff"
        return lambda x: sums.__setitem__(name, sums.get(name, 0.0) + x)

    restore = swap_entries(functools.partial(plain_gta_attention, terms=terms), plain_flash_attention)
    saved = {(m, f): getattr(m, f) for m in (encoder, decoder) for f in FP32_GEOMETRY if hasattr(m, f)}
    for (m, f), fn in saved.items():
        setattr(m, f, fp32_geometry(fn))
    trainer.model.double()
    batch64 = dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).double() for f in dataclasses.fields(batch)
        if getattr(batch, f.name) is not None and getattr(batch, f.name).is_floating_point()})
    try:
        trainer.loss_and_grads(batch64)
    finally:
        restore()
        for (m, f), fn in saved.items():
            setattr(m, f, fn)
        for h in handles:
            h.remove()
    return {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()}, sums


def parallel_steps(trainer, batch, runs):
    """`runs` train steps on `batch` (synchronised, wall ms each); the
    first's gradients (by name, the model ranks' blocks gathered, on the
    CPU), the whole weights after it, its loss and launch counts."""
    import torch

    from gta_tpu_torch.parallel import tp

    ms, first = [], None
    reset_launch_counts()
    for n in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if n == 0:
            launches = launch_counts()
            grads = {}
            for name, p in trainer.model.named_parameters():
                g = p.grad
                if name in trainer.tp_specs:
                    g = tp.gather_tensor(g, trainer.tp_specs[name], trainer.mesh.model)
                grads[name] = g.detach().float().cpu().clone()
            first = {"loss": m["loss"].item(), "grads": grads, "launches": launches,
                     "weights": {k: v.detach().float().cpu().clone() for k, v in trainer.model_state_dict().items()}}
    first["ms"] = ms
    return first


def parallel_worker(rank, port, out_dir, world=2, go=None) -> int:
    """One rank of one of parallel_phase's worlds (`python3 -c "import
    chip_smoke; chip_smoke.parallel_worker(RANK, PORT, OUT, WORLD, GO)"`
    from the root): every mode of that world in a gloo group on the card
    (one cold step compared, PARALLEL_WARM timed; with `go`, each mode's
    trainer and batch are made, and the steps wait for that file), the
    layout it printed; then, in the two-rank world, with the
    group gone, the one-process references (parallel_refs: rank 0 the fp32
    configs' with their fp64 gradients, rank 1 the bf16 configs' with their
    fp32 gradients); saves <out>/world<w>_rank<r>.pt (the modes' gradients
    and weights rank 0's alone: the ranks hold the same whole ones). Its
    host threads are the cores over the world's ranks."""
    import torch

    sys.path.insert(0, ROOT)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from gta_tpu_torch.parallel import dist as pdist
    from gta_tpu_torch.train.trainer import Trainer

    parent = os.getppid()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def batch_of(cfg):
        return synthetic_batch(cfg.data, "train", 0, cfg.training.batch_size, cfg.seed).to("cuda")

    def done(what):
        print(f"rank {rank}: {what} at {time.perf_counter() - t_start:.1f} s", flush=True)

    out = {"refs": {}, "modes": {}, "layouts": {}}
    pdist.init_from_env(None, "gloo")
    out["describe"] = pdist.describe()
    done("group joined")
    for name, mode in parallel_modes().items():
        if mode.world != world:
            continue
        cfg = parallel_config(mode.path, mode.mixed_prec, mode.batch)
        mesh = pdist.init_mesh(mode.n_model, mode.n_seq)
        trainer = Trainer(cfg, zero=mode.zero, mesh=mesh)
        out["layouts"][name] = trainer.layout()
        for line in out["layouts"][name]:
            done(f"{name}: {line}")
        batch = batch_of(cfg)
        d, D, b = mesh.data.index, mesh.data.size, cfg.training.batch_size
        batch = type(batch)(**{f.name: None if (x := getattr(batch, f.name)) is None else x[d * b // D:(d + 1) * b // D]
                               for f in dataclasses.fields(batch)})
        while go is not None and not os.path.exists(go):  # built on the host; step when the card is free
            if os.getppid() != parent:  # chip_smoke ended before opening the gate
                return 1
            time.sleep(0.1)
        torch.cuda.reset_peak_memory_stats()
        out["modes"][name] = parallel_steps(trainer, batch, 1 + PARALLEL_WARM)
        out["modes"][name]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if rank > 0:
            del out["modes"][name]["grads"], out["modes"][name]["weights"]
        del trainer
        torch.cuda.empty_cache()
        done(name)
    pdist.destroy()
    if rank == 0:  # the modes are done (the next world may start)
        open(os.path.join(out_dir, f"world{world}_modes"), "w").close()
    refs = parallel_refs()[rank] if world == 2 else {}
    for key, (path, mixed_prec, accum, batch_size, fp64) in refs.items():
        cfg = parallel_config(path, mixed_prec, batch_size, grad_accum=accum)
        trainer = Trainer(cfg)
        torch.cuda.reset_peak_memory_stats()
        out["refs"][key] = parallel_steps(trainer, batch_of(cfg), 1 + (PARALLEL_WARM if accum == 1 else 0))
        out["refs"][key]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del trainer
        torch.cuda.empty_cache()
        done(f"one-process {key}")
        if fp64:
            cfg = parallel_config(path, mixed_prec, batch_size, grad_accum=FP64_ACCUM)
            trainer = Trainer(cfg)
            out["refs"][f"{key}_fp64"] = dict(zip(("grads", "terms"), fp64_grads(trainer, batch_of(cfg))))
            del trainer
            torch.cuda.empty_cache()
            done(f"one-process {key} in fp64")
    torch.save(out, os.path.join(out_dir, f"world{world}_rank{rank}.pt"))
    done("saved")
    return 0


def memory_line() -> str:
    """This process's allocated and reserved card memory."""
    import torch

    return (f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
            "reserved")


def flat(tensors, names=None):
    """A name-keyed dict of tensors as one flat tensor, in name order
    (`names` only, where given)."""
    import torch

    return torch.cat([tensors[n].reshape(-1) for n in sorted(names if names is not None else tensors)])


def start_world(world, tmp, go=None):
    """Start parallel_worker's `world` ranks on the card side by side (the
    ranks allocate in expandable segments: they share the card with the
    DiT CLIs), gated on the file `go` where given; `finish_world` waits."""
    port = free_port()
    return [start_cli(["-c", "import sys, chip_smoke; sys.exit(chip_smoke.parallel_worker("
                             f"{r}, {port}, {tmp!r}, {world}, {go!r}))"],
                      os.path.join(tmp, f"world{world}_rank{r}.log"),
                      env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
            for r in range(world)]


def finish_world(procs, tmp):
    """Wait for a world's ranks; returns what each saved."""
    import torch

    world = len(procs)
    logs = [finish_cli(p, f"parallel world {world} rank {r}") for r, p in enumerate(procs)]
    for r, log in enumerate(logs):
        print("\n".join(f"  {line}" for line in log.splitlines() if line.startswith(f"rank {r}:")), flush=True)
    return [torch.load(os.path.join(tmp, f"world{world}_rank{r}.pt"), weights_only=False) for r in range(world)]


def start_parallel():
    """parallel_phase's two-rank world, started ahead of it: its ranks
    import, join their group and make their first mode's trainer and batch
    on the host while this process runs the phases before (the DiT's), and
    step once parallel_phase opens their gate (the process start and host
    work, ~30 s, off the run's path). Returns what parallel_phase takes."""
    tmp = tempfile.mkdtemp()
    go = os.path.join(tmp, "go2")
    return tmp, go, start_world(2, tmp, go)


def parallel_phase(paths, started):
    """The port's other parallelism on the card, in gloo groups (NCCL
    refuses two ranks on one card: "Duplicate GPU detected"): two ranks,
    then four (parallel_modes), each mode at full width and depth, lr_warmup
    0, dropout 0. The two-rank world: the flagship (fp32, B=32, 6 heads of
    64) under --n-model 2 (3 heads a rank), --n-seq 2 (one view a rank) and
    ZeRO-1 over 2 data ranks (B=16 a rank); msn_so3 as published (bf16,
    B=64, 8 heads of 96) under --n-model 2; gbt and repast (fp32, B=32)
    and msn gta_so3_euclid (bf16, B=EUCLID_BATCH) under --n-model 2, their
    attention in torch eager on the rank's heads; SRT (fp32, B=32) and
    msn_so3 (bf16, B=64, 5 views) under --n-seq 2, every module whole on
    each seq rank. The four-rank world: the flagship under --n-model 4 (its
    attention layers whole, its FeedForwards split). Each mode's first step
    against the one-process step on the same batch from the same weights.
    fp32: the updated weights' relative L2 at most PARALLEL_TOL; the
    gradient (every tensor but the trans_coeff scalars) no further from the
    fp64 step than the one-process step is, by more than PARALLEL_TOL
    (relative L2: the conv stem's weight gradients are sums that cancel,
    which move 3-4e-5 of their norms between two fp32 orders of summation;
    ROADMAP queue 3); each trans_coeff within TC_TOL x the sum of its
    terms' absolute values of the fp64 step's (grads_phase's rules). bf16,
    the bf16 rule: the gradient's relative L2 from the one-process fp32
    gradient (MSN_FP32_ACCUM microbatches) at most BF16_RULE x the
    one-process bf16 step's. Per rank, the kernels' launches of that step
    are asserted (expected_launches: each whole or split module's kernel
    forward and backward, none on the eager routes or in a module that
    rings) and added to `paths`; which modules rang is asserted; the
    layout each rank printed, the backend and each mode's warm step time
    beside the one-process step's are printed."""
    import shutil

    t0 = time.perf_counter()
    tmp, go2, two = started
    four = []
    try:
        open(go2, "w").close()
        # the four ranks start while the two make their references (imports,
        # group and trainers beside them, on the card's host) and step after
        # them
        go = os.path.join(tmp, "go4")
        while not os.path.exists(os.path.join(tmp, "world2_modes")) and all(p.poll() is None for p in two):
            time.sleep(0.2)
        four = start_world(4, tmp, go)
        ranks = {2: finish_world(two, tmp)}
        open(go, "w").close()
        warm_cli_workers(CLI_CHAINS)  # cli_phase's chains' processes warm up while the four ranks step
        ranks[4] = finish_world(four, tmp)
    finally:
        for p in two + four:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    t_worlds = time.perf_counter() - t0
    print(f"parallel: {ranks[2][0]['describe']}; {ranks[4][0]['describe']}", flush=True)
    refs = {**ranks[2][0]["refs"], **ranks[2][1]["refs"]}
    summary, failed = {}, []
    for name, mode in parallel_modes().items():
        cfg = parallel_config(mode.path, mode.mixed_prec, mode.batch)
        got = ranks[mode.world][0]["modes"][name]
        ref = refs[mode.ref]
        tcs = [n for n in ref["grads"] if n.endswith("trans_coeff")]
        rest = [n for n in ref["grads"] if n not in tcs]
        grad_dist = rel_l2(flat(got["grads"], rest), flat(ref["grads"], rest))
        weight_err = rel_l2(flat(got["weights"]), flat(ref["weights"]))
        worst = sorted(((rel_l2(got["grads"][n], ref["grads"][n]), n) for n in rest), reverse=True)[:3]
        want = expected_launches(cfg, 1, 1, backward_steps=1, rings=mode.rings)
        launches = [r["modes"][name]["launches"] for r in ranks[mode.world]]
        for r, counts in enumerate(launches):
            paths[f"{name}_train_rank{r}"] = counts
        layout = ranks[mode.world][0]["layouts"][name]
        if layout:
            print(f"parallel {name}: {'; '.join(layout)}", flush=True)
        if mode.n_seq > 1:
            said = {True: "rings", False: "whole"}
            ring_line = (f"sequence parallel over {mode.n_seq} seq ranks: encoder {said[mode.rings[0]]}, "
                         f"decoder {said[mode.rings[1]]}")
            if ring_line not in layout:
                failed.append(f"{name}: the ranks said {layout}, not {ring_line!r}")
        warm, ref_warm = float(np.median(got["ms"][1:])), float(np.median(ref["ms"][1:]))
        line = (f"parallel {name} (model {mode.n_model}, seq {mode.n_seq}, zero {mode.zero}, B="
                f"{cfg.training.batch_size}): loss {got['loss']:.6f} (one process {ref['loss']:.6f}); gradient from "
                f"one process's, relative L2, trans_coeff aside, {grad_dist:.3e} (worst "
                f"{', '.join(f'{n} {e:.2e}' for e, n in worst)}); weights {weight_err:.3e}; warm step {warm:.1f} ms "
                f"beside one process's {ref_warm:.1f} ms (cold {got['ms'][0]:.1f}); peak {got['peak_gb']:.2f} GB a "
                f"rank (one process {ref['peak_gb']:.2f})")
        if mode.mixed_prec:
            fp32 = flat(refs[mode.ref.replace("_bf16", "_fp32")]["grads"])
            tp_err, own = rel_l2(flat(got["grads"]), fp32), rel_l2(flat(ref["grads"]), fp32)
            line += f"; whole gradient from fp32: {tp_err:.3e}, one-process bf16 {own:.3e} (rule: at most {BF16_RULE}x)"
            ok, excess = tp_err <= BF16_RULE * own, None
        else:
            fp64 = refs[f"{mode.ref}_fp64"]
            exact = flat(fp64["grads"], rest)
            err, own = rel_l2(flat(got["grads"], rest).double(), exact), rel_l2(flat(ref["grads"], rest).double(), exact)
            excess = err - own
            tc_worst = max(((abs(got["grads"][n].double() - fp64["grads"][n]).item() / fp64["terms"][n], n)
                            for n in tcs), default=(0.0, "none"))
            line += (f"; from fp64 {err:.3e}, one process {own:.3e}: excess {excess:.3e} (rule {PARALLEL_TOL}); "
                     f"trans_coeff from fp64 over the sum of its terms at most {tc_worst[0]:.3e} ({tc_worst[1]}; rule "
                     f"{TC_TOL})")
            ok = excess <= PARALLEL_TOL and weight_err <= PARALLEL_TOL and tc_worst[0] <= TC_TOL
        print(line, flush=True)
        print(f"parallel {name}: launches per rank {[nonzero(c) for c in launches]}, expected {nonzero(want)}",
              flush=True)
        if any(counts != want for counts in launches):
            failed.append(f"{name}: launches {launches}, expected {want}")
        if not ok:
            failed.append(line)
        summary[name] = {"warm_ms": warm, "one_process_warm_ms": ref_warm, "cold_ms": got["ms"][0],
                         "grad_rel_l2_from_one_process": grad_dist, "grad_excess_over_one_process_from_fp64": excess,
                         "weights_rel_l2": weight_err, "peak_gb": got["peak_gb"]}
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s (the worlds {t_worlds:.1f} s)", flush=True)
    if failed:
        raise AssertionError("parallel phase outside its bounds:\n" + "\n".join(failed))
    return summary


# ---------------------------------------------------------------------------
# Every head width from 32 to 128, and the model options no published config
# reaches
# ---------------------------------------------------------------------------

# DiT-XL/2's width (Peebles & Xie 2023: hidden 1152, 16 heads of 72), its
# depth cut from 28 to 4 (the run's time)
DIT_XL = dict(hidden_size=1152, heads=16, depth=4)
DIT_XL_SAMPLE_STEPS = 2  # DDIM steps of its sample (CFG batch 2 x DIT_SAMPLE_LABELS)
OPTION_BATCH = 16  # the width and option configs' batch (one cold eval_step and train_step each)


def gta_mix(C, dit=False):
    """(f_dims, so2 frequencies) of the flagship's GTA split at head width C
    (SE(3) and SO(2) halves, a quarter of the SO(2) channels as
    frequencies), or of dit_gta's (a trivial half beside the SO(2) one)."""
    from gta_tpu_torch.config import FDims

    half = C // 2 // 4 * 4
    return (FDims(triv=half, so2=C - half) if dit else FDims(se3=half, so2=C - half)), (C - half) // 4


def at_width(cfg, C, **training):
    """A GTA NVS config (the flagship) at head width C on both sides: its
    widths kept, width / C heads, f_dims scaled (gta_mix); `training`
    fields replaced."""
    m = cfg.model
    fd, so2 = gta_mix(C)

    def side(s, width):
        attn = dataclasses.replace(s.attn, gta=dataclasses.replace(s.attn.gta, f_dims=fd, so2=so2))
        return dataclasses.replace(s, heads=width // C, attn=attn)

    model = dataclasses.replace(m, encoder=side(m.encoder, m.encoder.attdim), decoder=side(m.decoder, m.decoder.z_dim))
    return dataclasses.replace(cfg, model=model, training=dataclasses.replace(cfg.training, **training))


def dit_xl(cfg):
    """A DiT config at DiT-XL/2's width (DIT_XL); dit_gta's f_dims scaled to
    its head width of 72 (gta_mix: triv 36, so2 36 with 9 frequencies, the
    published half-and-half split)."""
    m = cfg.model
    attn = m.attn
    if attn.is_gta:
        fd, so2 = gta_mix(DIT_XL["hidden_size"] // DIT_XL["heads"], dit=True)
        attn = dataclasses.replace(attn, gta=dataclasses.replace(attn.gta, f_dims=fd, so2=so2))
    return dataclasses.replace(cfg, model=dataclasses.replace(m, attn=attn, **DIT_XL))


def merged(*pairs):
    """({shape: fwd numbers}, {shape: bwd numbers}) of several phases."""
    fwd, bwd = {}, {}
    for f, b in pairs:
        fwd.update(f)
        bwd.update(b)
    return fwd, bwd


def width_phase(gta_cfg, srt_cfg, device):
    """The kernel instances at head widths 32 and 128 (NEW_WIDTHS), fp32 and
    bf16, both kernels of each pair, at two shapes: DiT-XL/2's train shape
    (hidden 1152 in 1152 / C heads; one view of 16 x 16 patch tokens, batch
    256; the fused GTA kernels with dit_gta's rotor-only tables at width C)
    and CLEVR-TR's decoder train shape (batch 32; hidden 384 in 384 / C
    heads: the flagship's geometry at width C, `at_width`, for the fused
    GTA kernels, the SRT baseline's shape for flash_core). Each against its
    plain version and, cut to B=2, fp64 (fp32: train_kernel_phase and
    flash_kernel_phase; bf16: bf16_kernel_phase), with its ms, the plain
    version's, SDPA's and the bound. Returns {forward instance:
    ({shape: fwd numbers}, {shape: bwd numbers})}."""
    from gta_tpu_torch.config import AttnConfig, GTAArgs
    from gta_tpu_torch.models.dit import DiTConfig, grid_reps

    out = {}
    dit_T = 256
    srt_B, srt_Tq, srt_Tk = srt_shapes(srt_cfg)[f"decoder_train_b{EVAL_BATCH}"]
    for C in NEW_WIDTHS:
        nvs, dit = f"c{C}_decoder_train_b{EVAL_BATCH}", f"c{C}_dit_xl_train_b{DIT_BATCH}"
        h_nvs, h_dit = gta_cfg.model.decoder.z_dim // C, DIT_XL["hidden_size"] // C
        calls = gta_calls(at_width(gta_cfg, C), device, EVAL_BATCH, prefix=f"c{C}_")
        fd, so2 = gta_mix(C, dit=True)
        dit_cfg = DiTConfig(hidden_size=DIT_XL["hidden_size"], heads=h_dit,
                            attn=AttnConfig(method="gta", gta=GTAArgs(f_dims=fd, so2=so2)))
        assert dit_cfg.num_patches == dit_T
        gta_nvs = {nvs: calls[nvs]}
        gta_dit = {dit: (dit_cfg.attn.gta, grid_reps(dit_cfg, DIT_BATCH, device), DIT_BATCH, dit_T, dit_T)}
        flash_nvs, flash_dit = {nvs: (srt_B, srt_Tq, srt_Tk)}, {dit: (DIT_BATCH, dit_T, dit_T)}
        out[instance_name("gta_fused_fwd", False, C)] = merged(
            train_kernel_phase(None, gta_nvs, device, geometry=(h_nvs, C)),
            train_kernel_phase(None, gta_dit, device, geometry=(h_dit, C)))
        out[instance_name("flash_core_fwd", False, C)] = merged(
            flash_kernel_phase(None, device, geometry=(h_nvs, C, flash_nvs)),
            flash_kernel_phase(None, device, geometry=(h_dit, C, flash_dit)))
        out[instance_name("gta_fused_fwd", True, C)] = merged(
            bf16_kernel_phase(None, f"C={C} CLEVR-TR", device, prefix="", geometry=(h_nvs, C, gta_nvs)),
            bf16_kernel_phase(None, f"C={C} DiT-XL/2", device, prefix="", geometry=(h_dit, C, gta_dit)))
        out[instance_name("flash_core_fwd", True, C)] = merged(
            bf16_kernel_phase(None, f"C={C} CLEVR-TR", device, prefix="", flash=True, geometry=(h_nvs, C, flash_nvs)),
            bf16_kernel_phase(None, f"C={C} DiT-XL/2", device, prefix="", flash=True, geometry=(h_dit, C, flash_dit)))
    return out


def padding_phase(device):
    """The copies a head width between the instances costs (ops/_cuda.py
    pad_heads / unpad_heads): at DiT-XL/2's shapes (B=256, 256 tokens, 16
    heads of 72 in the instance of 96, bf16) q, k and v padded for the
    forward, its output cut back; the backward pads g too and cuts dq, dk,
    dv. Returns {forward_ms, backward_ms}."""
    import torch

    from gta_tpu_torch.ops import _cuda

    H, C = DIT_XL["heads"], DIT_XL["hidden_size"] // DIT_XL["heads"]
    width = _cuda.kernel_head_dim("padding", C)
    gen = torch.Generator(device=device).manual_seed(21)
    x = [torch.randn((DIT_BATCH, 256, H * C), generator=gen, device=device).to(torch.bfloat16) for _ in range(4)]
    wide = [_cuda.pad_heads(t, H, width) for t in x]

    def fwd():
        for t in x[:3]:
            _cuda.pad_heads(t, H, width)
        _cuda.unpad_heads(wide[0], H, C)

    def bwd():
        for t in x:
            _cuda.pad_heads(t, H, width)
        for t in wide[:3]:
            _cuda.unpad_heads(t, H, C)

    numbers = {"forward_ms": time_ms(fwd), "backward_ms": time_ms(bwd), "C": C, "instance": width}
    print(f"padding copies at DiT-XL/2's shapes (B={DIT_BATCH}, T=256, H={H}, C={C} in the C={width} instance, "
          f"bf16): forward (pad q, k, v; cut out) {numbers['forward_ms']:.4f} ms, backward (pad q, k, v, g; cut "
          f"dq, dk, dv) {numbers['backward_ms']:.4f} ms", flush=True)
    return numbers


def dit_xl_path_phase(cfg, label):
    """A DiT config at DiT-XL/2's width (dit_xl: 16 heads of 72, which run in
    the instances of 96, padded) through its entry points: one train_step
    at B=256 on procedural images, evaluate on one val batch of
    DIT_VAL_BATCH, and a DIT_XL_SAMPLE_STEPS-step DDIM sample of
    DIT_SAMPLE_LABELS labels under CFG (batch 16); each path's launch
    counts asserted (dit_launches). Returns ({path: launches}, numbers)."""
    import torch

    from gta_tpu_torch.data.images import SyntheticImages, collate_images
    from gta_tpu_torch.train.dit_trainer import DiTTrainer

    m, depth = cfg.model, cfg.model.depth
    trainer = DiTTrainer(cfg)  # default device: cuda
    ds = SyntheticImages(m.input_size, m.num_classes, "train", DIT_BATCH, cfg.seed)
    batch = collate_images([ds[i] for i in range(DIT_BATCH)])
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.train_step(batch)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    paths = {"train": check_dit_launches(f"{label} train (1 step)", cfg, depth, depth)}
    losses = [out[k].item() for k in ("loss", "mse", "vb")]
    if not (np.isfinite(losses).all() and all(bool(torch.isfinite(p.grad).all()) for p in trainer.model.parameters())):
        raise AssertionError(f"{label} train: losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    val = SyntheticImages(m.input_size, m.num_classes, "val", DIT_VAL_BATCH, cfg.seed)
    reset_launch_counts()
    t0 = time.perf_counter()
    ev = trainer.evaluate([collate_images([val[i] for i in range(DIT_VAL_BATCH)])], seed=cfg.seed)
    eval_ms = (time.perf_counter() - t0) * 1e3
    paths["evaluate"] = check_dit_launches(f"{label} evaluate", cfg, depth, 0)
    if sorted(ev) != ["loss", "mse", "vb"] or not np.isfinite(list(ev.values())).all():
        raise AssertionError(f"{label} evaluate: {ev}")
    labels = np.arange(DIT_SAMPLE_LABELS) % m.num_classes
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = trainer.sample(labels, seed=0, steps=DIT_XL_SAMPLE_STEPS, guidance=DIT_GUIDANCE)
    sample_ms = (time.perf_counter() - t0) * 1e3
    paths["sample"] = check_dit_launches(f"{label} sample", cfg, depth * DIT_XL_SAMPLE_STEPS, 0)
    if imgs.shape != (DIT_SAMPLE_LABELS, m.input_size, m.input_size, m.in_channels) or not (
            np.isfinite(imgs).all() and imgs.min() >= -1.0 and imgs.max() <= 1.0):
        raise AssertionError(f"{label} sample: shape {imgs.shape}, range {imgs.min()}..{imgs.max()}")
    numbers = {"batch": DIT_BATCH, "train_ms": train_ms, "peak_mem_gb": peak_gb, "losses": losses,
               "evaluate_ms": eval_ms, "sample_ms": sample_ms}
    print(f"{label} (hidden {m.hidden_size}, {m.heads} heads of {m.hidden_size // m.heads}, depth {depth}): "
          f"train_step B={DIT_BATCH} (loss, mse, vb)={losses} ms(cold)={train_ms:.2f} peak_mem_gb={peak_gb:.2f}; "
          f"evaluate B={DIT_VAL_BATCH} {json.dumps(ev)} in {eval_ms:.2f} ms; sample {DIT_SAMPLE_LABELS} labels x "
          f"{DIT_XL_SAMPLE_STEPS} DDIM steps (CFG batch {2 * DIT_SAMPLE_LABELS}) in {sample_ms:.2f} ms", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return paths, numbers


def card_vs_cpu_pixels(cfg, label):
    """An fp32 NVS config's B=2 forward on the card against the same weights
    on the CPU (the plain versions): pixels within TOL, and with
    return_last_attmap the masks too, summing to 1 over the keys. Returns
    (max|d pixels|, max|d masks| or None)."""
    import torch

    from gta_tpu_torch.train.trainer import Trainer

    card, cpu = Trainer(cfg), Trainer(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    small = synthetic_batch(cfg.data, "val", 0, 2)
    with torch.no_grad():
        px, aux = card.model(small.to(card.device))
        want_px, want_aux = cpu.model(small)
    err = (px.cpu() - want_px).abs().max().item()
    mask_err = None
    if cfg.model.decoder.return_last_attmap:
        masks = aux["masks"].cpu()
        mask_err = (masks - want_aux["masks"]).abs().max().item()
        sums = (masks.sum(-1) - 1).abs().max().item()
        print(f"{label}: B=2 masks {tuple(masks.shape)} card vs cpu max|d|={mask_err:.3e}, max|sum - 1|={sums:.3e}",
              flush=True)
        if not (mask_err <= TOL and sums <= 1e-5):
            raise AssertionError(f"{label}: masks differ from the CPU's by {mask_err} or sum to 1 within {sums}")
    print(f"{label}: B=2 forward cuda vs cpu max|d pixels|={err:.3e}", flush=True)
    if not err <= TOL:
        raise AssertionError(f"{label}: card vs CPU pixels differ by {err} > {TOL}")
    del card, cpu
    torch.cuda.empty_cache()
    return err, mask_err


def dit_card_vs_cpu_grads_phase(cfg, label):
    """A DiT config's B=2 loss and whole gradient on the card (bf16) against
    the same weights on the CPU, as dit_card_vs_cpu_phase holds its output:
    every parameter redrawn nonzero; loss = mean(out * w) for a fixed w; the
    card's gradient (every parameter's, concatenated) at most BF16_RULE x
    as far (relative L2) from the CPU's fp32 one as the CPU's bf16 gradient
    with the TPU's rounding in the attention. The model runs at depth 1
    (its width as it is), as bf16_card_vs_cpu_phase cuts the NVS configs
    to one block a side: the CPU's three passes at depth 4 took 8-13 s a
    config. Returns (card, emulation) relative L2 gaps of the gradient and
    of the loss."""
    import torch

    from gta_tpu_torch.data.images import SyntheticImages, collate_images
    from gta_tpu_torch.train.dit_trainer import DiTTrainer

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, depth=1))

    gen = torch.Generator().manual_seed(0)
    cpu32 = DiTTrainer(dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, mixed_prec=False)),
                       device="cpu")
    weights = nonzero_weights(cpu32.model, gen).state_dict()
    card, cpu16 = DiTTrainer(cfg), DiTTrainer(cfg, device="cpu")
    for t in (card, cpu16):
        t.model.load_state_dict(weights)
    m = cfg.model
    val = SyntheticImages(m.input_size, m.num_classes, "val", 2, cfg.seed)
    x = torch.from_numpy(collate_images([val[0], val[1]])["image"])
    t_, y = torch.tensor([10, 700]), torch.tensor([3, m.num_classes - 1])
    w = torch.randn((2, m.input_size, m.input_size, m.out_channels), generator=gen)

    def loss_and_grad(trainer):
        dev = next(trainer.model.parameters()).device
        trainer.model.zero_grad(set_to_none=True)
        loss = (trainer.model(x.to(dev), t_.to(dev), y.to(dev)).float() * w.to(dev)).mean()
        loss.backward()
        return loss.item(), torch.cat([p.grad.float().flatten().cpu() for p in trainer.model.parameters()])

    card_loss, card_g = loss_and_grad(card)
    loss32, g32 = loss_and_grad(cpu32)
    restore = swap_entries(functools.partial(plain_gta_attention, mxu_dtype=torch.bfloat16),
                           functools.partial(plain_flash_attention, mxu_dtype=torch.bfloat16))
    try:
        emu_loss, emu_g = loss_and_grad(cpu16)
    finally:
        restore()
    card_err, emu_err = rel_l2(card_g, g32), rel_l2(emu_g, g32)
    print(f"{label} bf16: B=2 loss card {card_loss:.6e} / CPU fp32 {loss32:.6e} / CPU bf16 with the TPU's rounding "
          f"{emu_loss:.6e}; whole gradient ({card_g.numel()} values) relative L2 from the CPU's fp32: card "
          f"{card_err:.3e}, emulation {emu_err:.3e} (rule: at most {BF16_RULE}x)", flush=True)
    if not (np.isfinite(card_loss) and torch.isfinite(card_g).all() and card_err <= BF16_RULE * emu_err):
        raise AssertionError(f"{label} bf16: card gradient {card_err} from fp32, above {BF16_RULE} x the emulated "
                             f"TPU rounding's {emu_err}")
    return card_err, emu_err, abs(card_loss - loss32) / abs(loss32), abs(emu_loss - loss32) / abs(loss32)


def option_configs(gta_cfg, srt_cfg):
    """{key: (config, label)} of this slice's paths beyond the published
    configs: the SRT baseline with its decoder's dim_head at 32 and 128 and
    the flagship at head width 32 and 128 on both sides (at_width), fp32
    and bf16 (the new instances); the flagship with planar and with
    camera_planar embeddings in encoder and decoder; the SRT baseline with
    a one-head decoder that returns its last attention map."""
    def emb(cfg, e):
        m = cfg.model
        return dataclasses.replace(cfg, model=dataclasses.replace(
            m, encoder=dataclasses.replace(m.encoder, emb=e), decoder=dataclasses.replace(m.decoder, emb=e)))

    def decoder(cfg, mixed_prec=False, **kw):
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, decoder=dataclasses.replace(
            cfg.model.decoder, **kw)), training=dataclasses.replace(cfg.training, mixed_prec=mixed_prec))

    out = {}
    for C in NEW_WIDTHS:
        for bf16 in (False, True):
            tag = "_bf16" if bf16 else ""
            dtype = "bf16" if bf16 else "fp32"
            out[f"srt_c{C}{tag}"] = (decoder(srt_cfg, bf16, dim_head=C), f"SRT decoder dim_head {C} {dtype}")
            out[f"gta_c{C}{tag}"] = (at_width(gta_cfg, C, mixed_prec=bf16), f"GTA at head width {C} {dtype}")
    out["gta_planar"] = (emb(gta_cfg, "planar"), "GTA emb planar")
    out["gta_camera_planar"] = (emb(gta_cfg, "camera_planar"), "GTA emb camera_planar")
    out["srt_attmap"] = (decoder(srt_cfg, heads=1, return_last_attmap=True), "SRT return_last_attmap (1 head)")
    return out


def option_phase(cfg, label, key):
    """One config of option_configs: variant_phase at OPTION_BATCH (launch
    counts asserted: none in a decoder that returns its map), then, for the
    embeddings and the map, card against CPU at B=2 (card_vs_cpu_pixels).
    Returns (serving launches, train launches, numbers)."""
    serving, train, numbers = variant_phase(cfg, label, OPTION_BATCH)
    if key in ("gta_planar", "gta_camera_planar", "srt_attmap"):
        numbers["card_vs_cpu_pixels"], numbers["card_vs_cpu_masks"] = card_vs_cpu_pixels(cfg, label)
    return serving, train, numbers


def kernel_entry(name, replaces, launches, main, shapes, worst_edge, source=None, widths=(64, 96)):
    """One kernel instance's line in the kernels JSON: numbers at its main
    shape, launches by path, every shape's numbers, the attention core it
    runs (`core`: attn_sm90.cuh for the bf16 instances, attn_core.cuh for
    the fp32 ones) and that core's kernels' ptxas registers and spills in
    the instance's libraries (the source's at each of `widths`;
    `core_registers`, from this run's build; empty where a library was built
    before the run). fp32 instances carry `bound_tc_ms` beside `bound_ms`
    (fp32 CUDA-core peak); bf16 instances' `bound_ms` is at the dense bf16
    peak."""
    from gta_tpu_torch.ops import _cuda

    library = source or name
    bf16 = "_bf16" in name
    core = "attn_sm90.cuh" if bf16 else "attn_core.cuh"
    mark = "sm90::attn_sm90_" if bf16 else "attn::attn_"
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"gta_tpu_torch/csrc/{library}.cu",
        "core": f"gta_tpu_torch/csrc/{core}",
        "widths": list(widths),
        "core_registers": [f"C={w} {line}" for w in widths
                           for line in ptxas_report(_cuda.BUILD_LOGS.get(_cuda.library(library, w), ""))
                           if line.startswith(mark)],
        "replaces": replaces,
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max([worst_edge] + [s["max_abs_err"] for s in shapes.values()]),
        "ms": shapes[main]["ms"],
        "plain_ms": shapes[main]["plain_ms"],
        "bound_ms": shapes[main]["bound_ms"],
        "bound_by": shapes[main]["bound_by"],
        "library_ms": shapes[main]["library_ms"],
        "shape": main,
        "shapes": shapes,
    }
    if "bound_tc_ms" in shapes[main]:
        entry["bound_tc_ms"] = shapes[main]["bound_tc_ms"]
    return entry


def kernel_label(mangled: str) -> str:
    """A short name of an Itanium-mangled kernel symbol: its namespaces and
    name with its template arguments (`attn::attn_bwd_q_kernel<96>`,
    `sm90::attn_sm90_bwd_q<Cfg<64, 64>, __nv_bfloat16>`); the symbol
    as it is where it is not a nested name."""
    if not mangled.startswith("_ZN"):
        return mangled
    builtins = {"f": "float", "d": "double", "i": "int", "b": "bool"}

    def ident(i):  # the length-prefixed identifier at i, and the index past it
        n = re.match(r"\d+", mangled[i:]).group()
        return mangled[i + len(n):i + len(n) + int(n)], i + len(n) + int(n)

    def template_args(i):  # the arguments of the list that opens at i ('I'), and the index past its 'E'
        args, i = [], i + 1
        while mangled[i] != "E":
            c = mangled[i]
            if c == "L":  # an integer or bool literal
                m = re.match(r"L[a-z](\d+)E", mangled[i:])
                args.append(m.group(1))
                i += len(m.group(0))
            elif c == "N":  # a nested type name: its last part, with its own arguments
                i, last = i + 1, None
                while mangled[i] != "E":
                    if mangled[i] == "S":
                        i = mangled.index("_", i) + 1
                    elif mangled[i] == "I":
                        inner, i = template_args(i)
                        last = f"{last}<{', '.join(inner)}>"
                    else:
                        last, i = ident(i)
                args.append(last)
                i += 1
            elif c.isdigit():
                arg, i = ident(i)
                args.append(arg)
            elif c == "S":  # a substitution: here, a type argument repeated
                i = mangled.index("_", i) + 1
                args.append(next((a for a in reversed(args) if not a.isdigit()), "?"))
            elif c in builtins:
                args.append(builtins[c])
                i += 1
            else:
                raise ValueError(c)
        return args, i + 1

    i, parts = 3, []
    while mangled[i:i + 1].isdigit():
        part, i = ident(i)
        parts.append(part)
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL__N"))
    if mangled[i:i + 1] != "I":
        return name
    try:
        args, _ = template_args(i)
    except (ValueError, AttributeError, IndexError):
        return name
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log: str):
    """One line per kernel of nvcc's -Xptxas -v output (its registers and
    spills), and every line that reports an error."""
    kernel, spills = "?", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel, spills = kernel_label(entry.group(1)), ""
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield f"{kernel}: {line.split(':', 1)[-1].strip()}; {spills}"
        elif "error" in line:
            yield line.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gta_tpu_torch.config import FDims, GTAArgs, load_config
    from gta_tpu_torch.ops import _cuda
    from gta_tpu_torch.train.dit_trainer import load_dit_config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    t_start = t0 = time.perf_counter()
    _cuda.build()
    print(f"built kernels {list(_cuda.KERNELS)} at head widths {list(_cuda.KERNEL_HEAD_DIMS)} "
          f"({len(_cuda.instances())} libraries) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _cuda.BUILD_LOGS.items():
        for line in ptxas_report(log):
            print(f"nvcc {name}: {line}", flush=True)

    def synthetic(path, **training):
        cfg = load_config(path)
        return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"),
                                   training=dataclasses.replace(cfg.training, **training))

    gta_cfg, srt_cfg, so3_cfg = synthetic(GTA_CONFIG), synthetic(SRT_CONFIG), synthetic(CLEVR_SO3_CONFIG)
    # the two published msn configs as they are (bf16: mixed_prec), and
    # msn_so3 at fp32 (mixed_prec overridden) for the fp32 instances at C = 96
    msn_bf16, msn_srt = synthetic(MSN_SO3_CONFIG), synthetic(MSN_SRT_CONFIG)
    # msn gta (the paper's MSN-Hard GTA row) and its four variants, bf16 as
    # published, through the bf16 C = 96 instances msn_so3 uses
    msn_gta = synthetic(MSN_GTA_CONFIG)
    variants = {name: synthetic(os.path.join(ROOT, "runs", "msn", "GTA", name, "config.yaml"))
                for name in MSN_VARIANTS}
    assert all(c.training.mixed_prec for c in (msn_bf16, msn_srt, msn_gta, *variants.values()))
    msn_cfg = synthetic(MSN_SO3_CONFIG, mixed_prec=False)
    # its serving, train and gradient paths at one attention block a side
    # (the run's time budget; its kernel phases keep the full shapes)
    msn_cut = one_block(msn_cfg)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_kernels = time.perf_counter()
    calls = gta_calls(gta_cfg, device)
    shapes = timed("kernels gta fp32", kernel_phase, gta_cfg, calls, device)
    train_fwd, train_bwd = timed("kernels gta fp32", train_kernel_phase, gta_cfg, calls, device)
    calls = gta_calls(msn_cfg, device, MSN_BATCH, prefix="msn_")
    msn_shapes = timed("kernels msn_so3 fp32", kernel_phase, msn_cfg, calls, device)
    msn_train_fwd, msn_train_bwd = timed("kernels msn_so3 fp32", train_kernel_phase, msn_cfg, calls, device)
    del calls
    branch_fwd, branch_bwd = timed("kernels edges", branch_phase, device)
    gta_edge_fwd, gta_edge_bwd = timed("kernels edges", gta_edge_phase, device)
    msn_edge_fwd, msn_edge_bwd = timed("kernels edges", gta_edge_phase, device, [
        msn_cfg.model.decoder.attn.gta, GTAArgs(f_dims=FDims(triv=96))], heads=msn_cfg.model.decoder.heads)
    flash_fwd, flash_bwd = timed("kernels flash fp32", flash_kernel_phase, srt_cfg, device)
    edge_fwd, edge_bwd = timed("kernels edges", flash_edge_phase, device)
    gta_bf16_fwd, gta_bf16_bwd = timed("kernels bf16", bf16_kernel_phase, msn_bf16, "msn_so3", device)
    clevr_bf16_fwd, clevr_bf16_bwd = timed("kernels bf16", bf16_kernel_phase,
        synthetic(GTA_CONFIG, mixed_prec=True), "CLEVR-TR gta --bf16", device, EVAL_BATCH, "clevr_bf16_",
        ("clevr_bf16_decoder_eval_b32", "clevr_bf16_decoder_train_b32"))
    flash_bf16_fwd, flash_bf16_bwd = timed("kernels bf16", bf16_kernel_phase, msn_srt, "msn SRT", device)
    # flash_core at head width 96, at msn gta_t2's shapes (its attention
    # after the sliced transforms): fp32 (mixed_prec overridden) and bf16
    t2_cfg, msn_t2 = synthetic(T2_CONFIG), synthetic(MSN_T2_CONFIG)
    assert msn_t2.training.mixed_prec and not t2_cfg.training.mixed_prec
    flash96_fwd, flash96_bwd = timed("kernels flash fp32", flash_kernel_phase, synthetic(MSN_T2_CONFIG,
                                     mixed_prec=False), device, MSN_BATCH, prefix="msn_t2_")
    flash96_bf16_fwd, flash96_bf16_bwd = timed("kernels bf16", bf16_kernel_phase, msn_t2, "msn gta_t2", device,
                                               prefix="msn_t2_", flash=True)
    # the instances at head widths 32 and 128, and what a width between
    # two instances costs in padding copies
    widths = timed("kernels widths", width_phase, gta_cfg, srt_cfg, device)
    padding = timed("kernels widths", padding_phase, device)
    print(f"phase seconds: kernels (all) {time.perf_counter() - t_kernels:.1f}", flush=True)
    # the rest of the script allocates in expandable segments, so that
    # empty_cache hands a phase's unused pages back to the card: otherwise
    # this process held 24 GB reserved of 2 GB allocated by the DiT CLIs,
    # and dit_gta's resumed CLI ran out beside parallel_phase's two ranks.
    # Not the kernel phases, which they slowed by ~13 s.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")

    serving = {
        "gta": timed("serving", serving_path_phase, gta_cfg, "GTA"),
        "srt": timed("serving", serving_path_phase, srt_cfg, "SRT"),
        "msn_so3": timed("serving", serving_path_phase, msn_cut, "msn_so3 (1 + 1 blocks)", MSN_BATCH),
        "clevr_so3": timed("serving", serving_path_phase, so3_cfg, "CLEVR-TR gta_so3"),
        "msn_so3_bf16": timed("serving", serving_path_phase, msn_bf16, "msn_so3 bf16", MSN_BATCH),
        "msn_srt_bf16": timed("serving", serving_path_phase, msn_srt, "msn SRT bf16", MSN_BATCH),
        "msn_gta_bf16": timed("serving", serving_path_phase, msn_gta, "msn gta bf16", MSN_BATCH),
        "clevr_t2": timed("serving", serving_path_phase, t2_cfg, "CLEVR-TR gta_t2"),
        "msn_t2_bf16": timed("serving", serving_path_phase, msn_t2, "msn gta_t2 bf16", MSN_BATCH),
    }
    paths = {}
    for key, (launches, _) in serving.items():
        paths[f"{key}_serving"], paths[f"{key}_train"] = launches, None
    eval_metrics = timed("metrics", metrics_phase, {"GTA": serving["gta"][1],
                                                    "msn gta bf16": serving["msn_gta_bf16"][1]})
    paths["gta_train"], gta_step = timed("train", train_path_phase, gta_cfg, "GTA")
    paths["srt_train"], srt_step = timed("train", train_path_phase, srt_cfg, "SRT")
    paths["msn_so3_train"], msn_step = timed("train", train_path_phase, msn_cut, "msn_so3 (1 + 1 blocks)", MSN_BATCH,
                                             distinct=2)
    paths["clevr_so3_train"], so3_step = timed("train", train_path_phase, so3_cfg, "CLEVR-TR gta_so3", distinct=2)
    paths["msn_so3_bf16_train"], msn_bf16_step = timed("train", train_path_phase, msn_bf16, "msn_so3 bf16",
                                                       MSN_BATCH, distinct=2)
    paths["msn_srt_bf16_train"], msn_srt_step = timed("train", train_path_phase, msn_srt, "msn SRT bf16", MSN_BATCH,
                                                      distinct=2)
    paths["msn_gta_bf16_train"], msn_gta_step = timed("train", train_path_phase, msn_gta, "msn gta bf16", MSN_BATCH,
                                                      distinct=2)
    paths["clevr_t2_train"], t2_step = timed("train", train_path_phase, t2_cfg, "CLEVR-TR gta_t2", distinct=2)
    paths["msn_t2_bf16_train"], msn_t2_step = timed("train", train_path_phase, msn_t2, "msn gta_t2 bf16", MSN_BATCH,
                                                    distinct=2)
    for name, cfg in variants.items():
        paths[f"msn_{name}_bf16_serving"], paths[f"msn_{name}_bf16_train"], _ = timed(
            "msn variants", variant_phase, cfg, f"msn {name} bf16")
    other = {}
    for rel in OTHER_METHODS:
        cfg = synthetic(os.path.join(ROOT, "runs", *rel.split("/"), "config.yaml"))
        key = rel.split("/", 1)[0] + "_" + rel.rsplit("/", 1)[1]
        paths[f"{key}_serving"], paths[f"{key}_train"], other[rel] = timed("other methods", variant_phase, cfg, rel)
    # the new head widths' paths (SRT's decoder at dim_head 32 and 128, the
    # flagship at head width 32 and 128; fp32 and bf16), the embeddings and
    # the attention map no published config reaches
    options = {}
    for key, (cfg, label) in option_configs(gta_cfg, srt_cfg).items():
        paths[f"{key}_serving"], paths[f"{key}_train"], options[key] = timed("options", option_phase, cfg, label, key)
    card_vs_cpu = {label: timed("bf16 card vs cpu", bf16_card_vs_cpu_phase, cfg, label) for cfg, label in
                   ((msn_bf16, "msn_so3"), (msn_srt, "msn SRT"), (msn_t2, "msn gta_t2"))}
    bf16_layers = timed("bf16 layers", bf16_layer_phase, msn_bf16, msn_srt, load_dit_config(DIT_GTA_CONFIG),
                        synthetic(MSN_SO3_EUCLID_CONFIG))
    t_dit = time.perf_counter()
    # the parallel phase's two ranks start (process, imports, first trainer
    # on the host) while the DiT phases run; they step in parallel_phase.
    # Started after the DiT-S/2 steps, they stepped later, beside the DiT
    # CLIs' steps, and the card ran out of memory.
    two_ranks = start_parallel()
    dit_cfgs = {"dit_gta": load_dit_config(DIT_GTA_CONFIG), "dit_base": load_dit_config(DIT_BASE_CONFIG)}
    assert all(c.training.mixed_prec and c.training.batch_size == DIT_BATCH for c in dit_cfgs.values())
    dit_kernels = {key: timed("dit kernels", dit_kernel_phase, cfg, key, device) for key, cfg in dit_cfgs.items()}
    dit_steps, dit_vs_cpu = {}, {}
    for key, cfg in dit_cfgs.items():
        launches, dit_steps[key] = timed("dit paths", dit_path_phase, cfg, key)
        for path, counts in launches.items():
            paths[f"{key}_{path}"] = counts
        dit_vs_cpu[key] = timed("dit card vs cpu", dit_card_vs_cpu_phase, cfg, key)
    # DiT-XL/2's width (16 heads of 72: the instances of 96, padded), depth 4
    dit_xl_steps, dit_xl_grads = {}, {}
    for key, cfg in dit_cfgs.items():
        key, cfg = f"{key}_xl", dit_xl(cfg)
        dit_kernels[key] = timed("dit-xl kernels", dit_kernel_phase, cfg, key, device, prefix="dit_xl_")
        launches, dit_xl_steps[key] = timed("dit-xl paths", dit_xl_path_phase, cfg, key)
        for path, counts in launches.items():
            paths[f"{key}_{path}"] = counts
        dit_xl_grads[key] = timed("dit-xl card vs cpu", dit_card_vs_cpu_grads_phase, cfg, key)
    # the DiT CLIs and the parallel phase's two ranks (subprocesses) side by
    # side, the gradient checks in this process meanwhile; its unused pages
    # go back to the card before and after them (msn_so3's two TP ranks,
    # ~20 GB each, overlap dit_gta's resumed CLI)
    def grads_meanwhile():
        out = [timed("grads", grads_phase, c, label) for c, label in
               ((gta_cfg, "GTA"), (srt_cfg, "SRT"), (msn_cut, "msn_so3 (1 + 1 blocks)"))]
        torch.cuda.empty_cache()
        print(f"this process after the gradient checks: {memory_line()}", flush=True)
        return out

    torch.cuda.empty_cache()
    print(f"this process before the DiT CLIs and the parallel phase: {memory_line()}", flush=True)
    (_, _, parallel), (gta_grad, srt_grad, msn_grad) = timed(
        "dit cli + parallel", side_by_side, lambda: dit_cli_phase(DIT_GTA_CONFIG, "dit_gta"),
        lambda: dit_cli_phase(DIT_BASE_CONFIG, "dit_base", steps=1, resume=False, evaluate=False, sample_steps=2),
        lambda: parallel_phase(paths, two_ranks), meanwhile=grads_meanwhile)
    print(f"DiT phases: {time.perf_counter() - t_dit:.1f} s", flush=True)
    timed("cli", cli_phase)
    ref_ckpt = timed("ref_ckpt", ref_ckpt_phase, paths)
    runtime = timed("runtime", runtime_phase, gta_cfg, paths)
    disk = timed("disk", disk_phase, gta_cfg, msn_gta, srt_cfg, paths)
    device_data = timed("device data", device_data_phase, gta_cfg, paths, dit_cfgs["dit_gta"], smi)

    def by_path(kernel):
        return {path: counts[kernel] for path, counts in paths.items()}

    kernels = [
        kernel_entry("gta_fused_fwd", "gta_tpu/ops/gta_fused.py:209", by_path("gta_fused_fwd"),
                     "decoder_eval_b32", {**shapes, **train_fwd, **msn_shapes, **msn_train_fwd},
                     max(branch_fwd, gta_edge_fwd, msn_edge_fwd)),
        kernel_entry("gta_fused_bwd", "gta_tpu/ops/gta_fused.py:235", by_path("gta_fused_bwd"),
                     "decoder_train_b32", {**train_bwd, **msn_train_bwd}, max(branch_bwd, gta_edge_bwd, msn_edge_bwd)),
        kernel_entry("flash_core_fwd", "gta_tpu/ops/flash_core.py:73", by_path("flash_core_fwd"),
                     "decoder_eval_b32", {**flash_fwd, **flash96_fwd}, edge_fwd),
        kernel_entry("flash_core_bwd", "gta_tpu/ops/flash_core.py:86", by_path("flash_core_bwd"),
                     "decoder_train_b32", {**flash_bwd, **flash96_bwd}, edge_bwd),
        kernel_entry("gta_fused_fwd_bf16", "gta_tpu/ops/gta_fused.py:209", by_path("gta_fused_fwd_bf16"),
                     "msn_decoder_eval_b64", {**gta_bf16_fwd, **clevr_bf16_fwd, **dit_kernels["dit_gta"][0],
                                              **dit_kernels["dit_gta_xl"][0]}, 0.0, source="gta_fused_fwd"),
        kernel_entry("gta_fused_bwd_bf16", "gta_tpu/ops/gta_fused.py:235", by_path("gta_fused_bwd_bf16"),
                     "msn_decoder_train_b64", {**gta_bf16_bwd, **clevr_bf16_bwd, **dit_kernels["dit_gta"][1],
                                               **dit_kernels["dit_gta_xl"][1]}, 0.0, source="gta_fused_bwd"),
        kernel_entry("flash_core_fwd_bf16", "gta_tpu/ops/flash_core.py:73", by_path("flash_core_fwd_bf16"),
                     "msn_decoder_eval_b64", {**flash_bf16_fwd, **flash96_bf16_fwd, **dit_kernels["dit_base"][0],
                                              **dit_kernels["dit_base_xl"][0]}, 0.0, source="flash_core_fwd"),
        kernel_entry("flash_core_bwd_bf16", "gta_tpu/ops/flash_core.py:86", by_path("flash_core_bwd_bf16"),
                     "msn_decoder_train_b64", {**flash_bf16_bwd, **flash96_bf16_bwd, **dit_kernels["dit_base"][1],
                                               **dit_kernels["dit_base_xl"][1]}, 0.0, source="flash_core_bwd"),
    ]
    # the instances at head widths 32 and 128 (width_phase): the fp32 ones'
    # main shape CLEVR-TR's decoder train shape, the bf16 ones' DiT-XL/2's
    for C in NEW_WIDTHS:
        for kernel, replaces in (("gta_fused", "gta_tpu/ops/gta_fused.py:"),
                                 ("flash_core", "gta_tpu/ops/flash_core.py:")):
            for bf16 in (False, True):
                fwd, bwd = widths[instance_name(f"{kernel}_fwd", bf16, C)]
                main = f"c{C}_dit_xl_train_b{DIT_BATCH}" if bf16 else f"c{C}_decoder_train_b{EVAL_BATCH}"
                for part, numbers, line in (("fwd", fwd, {"gta_fused": 209, "flash_core": 73}),
                                            ("bwd", bwd, {"gta_fused": 235, "flash_core": 86})):
                    name = instance_name(f"{kernel}_{part}", bf16, C)
                    kernels.append(kernel_entry(name, f"{replaces}{line[kernel]}", by_path(name), main, numbers, 0.0,
                                                source=f"{kernel}_{part}", widths=(C,)))
    for label, step, batch, grad in (("GTA", gta_step, EVAL_BATCH, gta_grad), ("SRT", srt_step, EVAL_BATCH, srt_grad),
                                     ("msn_so3 (1 + 1 blocks)", msn_step, MSN_BATCH, msn_grad)):
        print(f"{label} train step B={batch}: {json.dumps(step)}; B=2 grads against fp64: the whole gradient's "
              f"excess through the kernels {grad[0]:.3e}, trans_coeff error over its terms {grad[1]:.3e}, "
              f"attention calls' cotangents {grad[2]:.3e}", flush=True)
    print(f"CLEVR-TR gta_so3 train step B={EVAL_BATCH}: {json.dumps(so3_step)}", flush=True)
    print(f"CLEVR-TR gta_t2 train step B={EVAL_BATCH}: {json.dumps(t2_step)}", flush=True)
    print(f"other attention methods (cold eval_step and train_step): {json.dumps(other)}", flush=True)
    print(f"msn gta bf16 train step B={MSN_BATCH}: {json.dumps(msn_gta_step)}", flush=True)
    print(f"evaluation per full-scale view: {json.dumps(eval_metrics)}", flush=True)
    print(f"disk: {json.dumps(disk)}", flush=True)
    print(f"runtime: {json.dumps(runtime)}", flush=True)
    print(f"device data: {json.dumps(device_data)}", flush=True)
    print(f"reference checkpoints: {json.dumps(ref_ckpt)}", flush=True)
    print(f"parallel (gloo ranks on the card; {smi}): {json.dumps(parallel)}", flush=True)
    for label, step in (("msn_so3 bf16", msn_bf16_step), ("msn SRT bf16", msn_srt_step),
                        ("msn gta_t2 bf16", msn_t2_step)):
        card_err, emu_err, gap, own = card_vs_cpu[label.split(" bf16")[0]]
        print(f"{label} train step B={MSN_BATCH}: {json.dumps(step)}; B=2 pixels from the CPU's fp32: card "
              f"{card_err:.3e}, emulated TPU rounding {emu_err:.3e}; card vs CPU bf16 {gap:.3e} (CPU bf16 vs "
              f"fp32 {own:.3e})", flush=True)
    for key, step in dit_steps.items():
        card_err, emu_err, gap, own = dit_vs_cpu[key]
        print(f"{key} bf16 train step B={DIT_BATCH}: {json.dumps(step)}; B=2 outputs from the CPU's fp32: card "
              f"{card_err:.3e}, emulated TPU rounding {emu_err:.3e}; card vs CPU bf16 {gap:.3e} (CPU bf16 vs fp32 "
              f"{own:.3e})", flush=True)
    print(f"head widths: padding copies {json.dumps(padding)}; SRT / GTA at head widths {NEW_WIDTHS}, planar, "
          f"camera_planar, return_last_attmap (B={OPTION_BATCH}, cold eval_step and train_step): "
          f"{json.dumps(options)}", flush=True)
    for key, step in dit_xl_steps.items():
        card_err, emu_err, loss_gap, emu_loss_gap = dit_xl_grads[key]
        print(f"{key} (DiT-XL/2's width, depth {DIT_XL['depth']}) bf16: {json.dumps(step)}; B=2 gradient (depth 1) "
              f"from the CPU's fp32: card {card_err:.3e}, emulated TPU rounding {emu_err:.3e}; loss card "
              f"{loss_gap:.3e}, emulation {emu_loss_gap:.3e}", flush=True)
    print(f"bf16 layers, card vs CPU (unequal share, largest ulp; {smi}): "
          f"{json.dumps({k: [float(f'{v:.3e}') for v in x] for k, x in bf16_layers.items()})}", flush=True)
    while _WARM_CLI_WORKERS:  # none is left unless a phase ran fewer chains than were warmed
        stop_cli_worker(_WARM_CLI_WORKERS.pop())
    print(f"phase seconds (all): {json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()})}", flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
