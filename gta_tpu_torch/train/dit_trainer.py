"""Training runtime for the DiT family (the diffusion analogue of
train/trainer.py).

Port of gta_tpu/train/dit_trainer.py: `DiTTrainer` owns the DiT on an
explicit device (CUDA unless the caller asks for the CPU), its schedule
tables, AdamW (or Adam) under warmup and exponential decay, and one
generator on the device from which every training draw comes (timesteps,
noise, the label dropout mask; step s on rank r draws from it seeded
`parallel.dist.step_seed(seed, s, r)`). `train_step` runs q_sample ->
model -> hybrid loss -> backward through the attention kernels -> the
gradients averaged over ranks under data parallel -> the optimizer step;
`evaluate` draws per batch from a seeded generator, label dropout on, as
the JAX trainer's `_eval_step_impl` does, and stays per rank as JAX's
does; `sample` runs CFG + DDIM and clips to [-1, 1].

`training.grad_accum` has no effect on the DiT, as in the JAX package:
gta_tpu/train/dit_trainer.py never reads it and train_dit.py has no
--accum, so every step takes its whole batch at once.

Precision, as the NVS Trainer: `training.mixed_prec` makes the model
compute in bf16 (parameters, AdamW state, the loss and the diffusion
arithmetic stay fp32); TF32 is off for matmuls and convolutions, and bf16
matmuls reduce in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import yaml

from gta_tpu_torch.config import TrainConfig, _parse_attn, _parse_training
from gta_tpu_torch.models.dit import DiTConfig, build_dit
from gta_tpu_torch.parallel import dist as pdist
from gta_tpu_torch.train import diffusion
from gta_tpu_torch.train.schedule import warmup_exp_decay
from gta_tpu_torch.train.trainer import resolve_device


@dataclasses.dataclass(frozen=True)
class DiTDataConfig:
    dataset: str = "images_synthetic"  # 'images_synthetic' | 'imagenet'
    path: str = ""
    num_images: int = 50000


@dataclasses.dataclass(frozen=True)
class DiTRunConfig:
    model: DiTConfig = DiTConfig()
    data: DiTDataConfig = DiTDataConfig()
    training: TrainConfig = TrainConfig()
    seed: int = 0


def dit_config_from_dict(raw: dict) -> DiTRunConfig:
    """A run config from the reference-style YAML dict (model.args.dit_kwargs,
    data, training), with gta_tpu/train/dit_trainer.py's defaults."""
    m = raw.get("model", {})
    kw = (m.get("args", {}) or {}).get("dit_kwargs", {}) or {}
    model = DiTConfig(
        input_size=int(kw.get("input_size", 32)),
        patch_size=int(kw.get("patch_size", 2)),
        in_channels=int(kw.get("in_channels", 3)),
        hidden_size=int(kw.get("hidden_size", 384)),
        depth=int(kw.get("depth", 12)),
        heads=int(kw.get("heads", 6)),
        mlp_ratio=float(kw.get("mlp_ratio", 4.0)),
        num_classes=int(kw.get("num_classes", 1000)),
        class_dropout=float(kw.get("class_dropout", 0.1)),
        learn_sigma=bool(kw.get("learn_sigma", True)),
        attn=_parse_attn(kw.get("attn_args", {}) or {}),
        timesteps=int(kw.get("timesteps", 1000)),
        vb_weight=float(kw.get("vb_weight", 1.0)),
    )
    d = raw.get("data", {}) or {}
    data = DiTDataConfig(
        dataset=d.get("dataset", "images_synthetic"),
        path=d.get("path") or "",
        num_images=int(d.get("num_images", 50000)),
    )
    return DiTRunConfig(model=model, data=data, training=_parse_training(raw.get("training", {}) or {}),
                        seed=int(raw.get("seed", 0)))


def load_dit_config(path: str) -> DiTRunConfig:
    with open(path) as f:
        return dit_config_from_dict(yaml.safe_load(f))


class DiTTrainer:
    """Owns the DiT, its schedule tables, optimizer and LR schedule, and the
    train, evaluation and sampling entry points. `seed` (default cfg.seed)
    draws the initial weights (rank 0's, broadcast, under data parallel)
    and seeds the training draws (`pdist.step_seed`)."""

    def __init__(self, cfg: DiTRunConfig, device: Optional[str] = None, seed: Optional[int] = None):
        t = cfg.training
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.cfg = cfg
        self.dtype = torch.bfloat16 if t.mixed_prec else torch.float32
        self.seed = cfg.seed if seed is None else seed
        mcfg = cfg.model
        self.model = build_dit(mcfg, self.dtype, torch.Generator().manual_seed(self.seed)).to(self.device)
        pdist.broadcast_module(self.model)
        self.sch = diffusion.make_schedule(mcfg.timesteps, mcfg.beta_start, mcfg.beta_end).to(self.device)
        self.generator = torch.Generator(device=self.device)
        # optax adam / adamw (b1 0.9, b2 0.999, eps 1e-8); adamw decays every parameter
        if t.noadamW:
            self.optimizer = torch.optim.Adam(self.model.parameters(), lr=t.lr)
        else:
            self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=t.lr, weight_decay=t.weight_decay)
        self.schedule = warmup_exp_decay(t.lr, t.lr_warmup, t.decay_it, t.decay_rate)
        # stepped after each optimizer step: the first step under warmup has lr 0
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, lambda it: self.schedule(it) / t.lr)
        self.step = 0

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "seed": self.seed,
            "step": self.step,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.seed = int(state["seed"])
        self.step = int(state["step"])

    # ------------------------------------------------------------------
    def _tensors(self, batch: Dict[str, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        images = torch.as_tensor(np.asarray(batch["image"]), dtype=torch.float32).to(self.device)
        labels = torch.as_tensor(np.asarray(batch["label"]), dtype=torch.long).to(self.device)
        return images, labels

    def draws(self, images: torch.Tensor, generator: torch.Generator):
        """(t, noise, drop) for a batch: timesteps uniform in [0, T), unit
        normal noise of the images' shape, and the label dropout mask
        (class_dropout per item), from `generator`."""
        B = images.shape[0]
        t = torch.randint(0, self.sch.timesteps, (B,), generator=generator, device=self.device)
        noise = torch.randn(images.shape, generator=generator, device=self.device)
        drop = torch.rand((B,), generator=generator, device=self.device) < self.cfg.model.class_dropout
        return t, noise, drop

    def loss(self, images, labels, t, noise, drop) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The hybrid loss of a batch at given draws (`draws`)."""
        mcfg = self.cfg.model

        def model_fn(x_t, tt):
            return self.model(x_t, tt, labels, drop)

        return diffusion.training_loss(self.sch, model_fn, images, t, noise, mcfg.learn_sigma, mcfg.vb_weight)

    def loss_and_grads(self, batch: Dict[str, np.ndarray]):
        """(loss, metrics, grads) of this rank's batch at this step's draws
        (the generator seeded `pdist.step_seed(seed, step)`), the gradients
        left in each parameter's `.grad` (zeros where none reaches the
        loss)."""
        images, labels = self._tensors(batch)
        self.generator.manual_seed(pdist.step_seed(self.seed, self.step))
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(images, labels, *self.draws(images, self.generator))
        loss.backward()
        grads = []
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One optimizer step on a collated batch ({'image': [B, H, W, C],
        'label': [B]}; this rank's shard under data parallel). Returns loss,
        mse, vb (learn_sigma), grad_norm (the global L2 norm of the
        gradients, averaged over ranks, before the update; these stay on
        the device, averaged over ranks too) and lr (the rate this step
        used)."""
        _, metrics, grads = self.loss_and_grads(batch)
        keys = sorted(metrics)
        metrics = dict(zip(keys, pdist.average_(grads, [metrics[k] for k in keys])))
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        lr = self.scheduler.get_last_lr()[0]
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {**metrics, "lr": lr, "grad_norm": grad_norm}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, batches: Iterable[Dict[str, np.ndarray]], seed: int = 0) -> Dict[str, float]:
        """Mean loss metrics over batches; batch i draws from a generator
        seeded seed * 100003 + i (the JAX trainer's per-batch key), label
        dropout on."""
        acc: Dict[str, list] = {}
        for i, batch in enumerate(batches):
            images, labels = self._tensors(batch)
            gen = torch.Generator(device=self.device).manual_seed(seed * 100003 + i)
            _, metrics = self.loss(images, labels, *self.draws(images, gen))
            for k, v in metrics.items():
                acc.setdefault(k, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in acc.items()}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample(self, labels, seed: int = 0, steps: int = 50, guidance: float = 4.0) -> np.ndarray:
        """Class-conditional DDIM samples [N, H, W, C] in [-1, 1] under
        classifier-free guidance, drawn from a generator seeded `seed`."""
        mcfg = self.cfg.model
        labels = torch.as_tensor(np.asarray(labels), dtype=torch.long).to(self.device)
        shape = (labels.shape[0], mcfg.input_size, mcfg.input_size, mcfg.in_channels)
        fn = diffusion.cfg_model_fn(lambda x, t, y: self.model(x, t, y), labels, mcfg.null_label, guidance)
        randn = diffusion.generator_randn(torch.Generator(device=self.device).manual_seed(seed))
        out = diffusion.ddim_sample(self.sch, fn, shape, randn, steps=steps, learn_sigma=mcfg.learn_sigma)
        return out.clamp(-1.0, 1.0).cpu().numpy()
