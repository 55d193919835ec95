"""Runtime for the port (reference trainer.py analogue).

`Trainer` owns the model on an explicit device, its optimizer, LR schedule
and dropout generator, and runs the train step (`train_step`: fp32 pixel
MSE -> backward through the attention kernels -> AdamW) and evaluation and
rendering (`eval_step`, `evaluate`, `render_image`, `render_rays`,
`visualize`, always with dropout off).

Gradient accumulation (`training.grad_accum`, gta_tpu/train/trainer.py:
131-166): the batch is split into `grad_accum` equal microbatches by
stride (row i to microbatch i mod accum), each microbatch's mean loss is
backpropagated on its own, and the summed gradients are divided by accum;
peak activation memory follows the microbatch. Data parallel
(parallel/dist.py): each rank steps on its shard of the global batch, and
`train_step` averages the gradients, the loss and the MSE over ranks in
one all_reduce after the last microbatch, so its metrics are global means.

Precision policy, from `training.mixed_prec` (the JAX trainer's
`self.dtype`, gta_tpu/train/trainer.py:56): the model computes in bf16 when
it is set and in fp32 otherwise (`Trainer.dtype`, models/layers.py).
Parameters and the AdamW state are fp32 either way, and so are the pixels
and the loss. TF32 is switched off for both matmuls and cuDNN convolutions,
and bf16 matmuls reduce in fp32; the attention kernels (fused GTA and
flash_core, one attention core) compute as 3xTF32 on the tensor cores in
fp32 (three TF32 products per fp32 product) and take bf16 operands with
fp32 accumulation in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from gta_tpu_torch.config import Config
from gta_tpu_torch.geometry.coords import make_2dcoord
from gta_tpu_torch.geometry.rays import camera_rays_from_extrinsic
from gta_tpu_torch.models.context import SceneBatch
from gta_tpu_torch.models.layers import init_weights, set_dropout_generator
from gta_tpu_torch.models.srt import build_model
from gta_tpu_torch.parallel import dist as pdist
from gta_tpu_torch.train.schedule import warmup_exp_decay
from gta_tpu_torch.utils.metrics import mse2psnr
from gta_tpu_torch.utils.visualize import draw_visualization_grid


def resolve_device(device: Optional[str]) -> torch.device:
    """`device`, or CUDA when none is given. Never falls back to the CPU on
    its own: without CUDA the caller must ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def split_microbatches(batch: SceneBatch, accum: int) -> List[SceneBatch]:
    """`batch` split into `accum` equal microbatches by stride: row i goes
    to microbatch i mod accum, every field alike (JAX's
    reshape((b // accum, accum) + ...).swapaxes(0, 1)); views of `batch`."""
    b = batch.target_pixels.shape[0]
    if b % accum:
        raise ValueError(f"batch size {b} not divisible by grad_accum={accum}")
    if accum == 1:
        return [batch]
    return [
        SceneBatch(**{f.name: None if (x := getattr(batch, f.name)) is None else x[i::accum]
                      for f in dataclasses.fields(batch)})
        for i in range(accum)
    ]


class Trainer:
    """Owns the model, its optimizer and schedule, and the train, evaluation
    and rendering entry points. `seed` (default cfg.seed) draws the initial
    weights (rank 0's, broadcast, under data parallel) and seeds the
    dropout masks: step s on rank r draws them from a generator seeded
    `pdist.step_seed(seed, s, r)`. `dtype` is the compute dtype: bf16 when
    `training.mixed_prec` is set, else fp32."""

    def __init__(self, cfg: Config, device: Optional[str] = None, seed: Optional[int] = None):
        t = cfg.training
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.cfg = cfg
        self.dtype = torch.bfloat16 if t.mixed_prec else torch.float32
        self.seed = cfg.seed if seed is None else seed
        self.model = build_model(cfg.model, dtype=self.dtype)
        init_weights(self.model, torch.Generator().manual_seed(self.seed))
        self.model.to(self.device).eval()
        pdist.broadcast_module(self.model)
        self.dropout_generator = torch.Generator(device=self.device)
        set_dropout_generator(self.model, self.dropout_generator)
        # optax adam / adamw (b1 0.9, b2 0.999, eps 1e-8); adamw decays every
        # parameter, LayerNorms and biases included, as optax does
        if t.noadamW:
            self.optimizer = torch.optim.Adam(self.model.parameters(), lr=t.lr)
        else:
            self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=t.lr, weight_decay=t.weight_decay)
        self.schedule = warmup_exp_decay(t.lr, t.lr_warmup, t.decay_it, t.decay_rate)
        # stepped after each optimizer step: step k uses schedule(k), so the
        # first step under warmup has lr 0 (optax reads the count before
        # incrementing it)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda it: self.schedule(it) / t.lr
        )
        self.step = 0

    def param_counts(self) -> Dict[str, int]:
        def count(module):
            return sum(p.numel() for p in module.parameters())

        return {
            "encoder": count(self.model.encoder),
            "decoder": count(self.model.decoder),
            "total": count(self.model),
        }

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
    def _loss_fn(self, batch: SceneBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(batch-mean loss, per-item MSE): fp32 MSE over every target view
        and point of an item, then the mean over the batch
        (reference trainer.py:119-121)."""
        pred, _ = self.model(batch)
        target = batch.target_pixels.reshape(batch.target_pixels.shape[0], -1, 3)
        mse = torch.mean((pred.float() - target) ** 2, dim=(1, 2))
        return torch.mean(mse), mse

    def loss_and_grads(self, batch: SceneBatch):
        """(loss, per-item MSE, grads): the loss of `batch` in training mode
        and its gradient for every parameter (zeros where a parameter does
        not reach the loss), left in each parameter's `.grad`. Under
        training.grad_accum the batch goes through the model in strided
        microbatches (`split_microbatches`): the loss is the mean of theirs, the
        gradient the sum of theirs over accum, and the per-item MSE comes
        in microbatch order (JAX's mses.reshape(-1)). This rank's batch
        alone: `train_step` averages over ranks."""
        batch = batch.to(self.device)  # once: the microbatches are views of it
        micro = split_microbatches(batch, self.cfg.training.grad_accum)
        self.dropout_generator.manual_seed(pdist.step_seed(self.seed, self.step))
        self.model.train()
        try:
            self.optimizer.zero_grad(set_to_none=True)
            losses, mses = [], []
            for mb in micro:
                loss, mse = self._loss_fn(mb)
                loss.backward()  # sums into .grad
                losses.append(loss.detach())
                mses.append(mse.detach())
        finally:
            self.model.eval()
        grads = []
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif len(micro) > 1:
                p.grad /= len(micro)
            grads.append(p.grad)
        return torch.mean(torch.stack(losses)), torch.cat(mses), grads

    def train_step(self, batch: SceneBatch, stop: bool = False) -> Dict[str, Any]:
        """One optimizer step on `batch` (this rank's shard of the global
        batch). Returns loss, mse (batch mean), lr (the rate this step
        used), grad_norm (global L2 norm of the averaged gradients before
        the update) and stop; loss, mse and grad_norm stay on the device.
        `stop` is this rank's stop request: in a process group it rides in
        the gradient all_reduce and comes back as a 0-dim bool tensor that
        is true on every rank where any rank asked (no extra sync); without
        one it comes back as given."""
        loss, mse, grads = self.loss_and_grads(batch)
        mse = torch.mean(mse)
        if pdist.initialized():
            flag = torch.full((), float(stop), device=self.device)  # a fill, not a copy that waits on the stream
            loss, mse, flag = pdist.average_(grads, [loss, mse, flag])
            stop = flag > 0
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        lr = self.scheduler.get_last_lr()[0]
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"loss": loss, "mse": mse, "lr": lr, "grad_norm": grad_norm, "stop": stop}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, batch: SceneBatch) -> Dict[str, torch.Tensor]:
        """Per-item MSE and PSNR over all target views and points."""
        batch = batch.to(self.device)
        pred, _ = self.model(batch)
        target = batch.target_pixels.reshape(batch.target_pixels.shape[0], -1, 3)
        mse = torch.mean((pred.float() - target) ** 2, dim=(1, 2))
        return {"mse": mse, "psnr": mse2psnr(mse)}

    def evaluate(self, batches: Iterable[SceneBatch]) -> Dict[str, float]:
        """Mean of eval_step metrics over an iterable of batches; prints the
        number of unique scenes seen. Under data parallel each rank
        evaluates its shard, the per-rank means are averaged over ranks in
        sorted key order and the scene ids gathered
        (gta_tpu/train/trainer.py:205-258)."""
        acc: Dict[str, list] = {}
        sceneids = []
        for batch in batches:
            if batch.sceneid is not None:
                sceneids.append(batch.sceneid.reshape(-1).cpu().numpy())
            for k, v in self.eval_step(batch).items():
                acc.setdefault(k, []).append(v.cpu().numpy())
        if sceneids:
            ids = pdist.gather_ids(np.concatenate(sceneids))
            print(f"Evaluated {len(np.unique(ids))} unique scenes.")
        local = {k: float(np.mean(np.concatenate(v))) for k, v in acc.items()}
        return pdist.mean_over_ranks(local, self.device)

    # ------------------------------------------------------------------
    def _to(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def render_image(
        self,
        batch: SceneBatch,
        height: int,
        width: int,
        target_transform: Optional[np.ndarray] = None,
        chunk: int = 4096,
        rays: Optional[np.ndarray] = None,
        cam: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Full-frame render: encode once, decode rays in fixed-size chunks
        (reference trainer.py:137-181). Returns [B, height, width, 3].

        target_transform: [B, 4, 4] relative camera of the novel view
        (canonical->view map); defaults to the canonical (identity) frame.
        Transform-mode models (batch.target_transforms present) receive the
        canonical view-0 ray grid plus the transform; `rays`/`cam` supply
        that grid explicitly when the inputs are downsampled (full-scale
        eval). Non-transform models receive the novel view's own ray grid in
        the canonical frame, built from the transform (camera at
        inv(ext)[:3, 3]), in flat [B, chunk, 3] sub-batches.
        """
        transform_mode = batch.target_transforms is not None
        batch = batch.to(self.device)
        z, enc_ctx = self.model.encode(batch)
        B = batch.input_images.shape[0]
        coord = np.broadcast_to(make_2dcoord(height, width).reshape(1, -1, 2), (B, height * width, 2))
        if target_transform is None:
            target_transform = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4))
        if rays is not None:
            rays = np.asarray(rays).reshape(B, -1, 3)
            cam = np.asarray(cam).reshape(B, -1, 3)
            if cam.shape[1] == 1:
                cam = np.broadcast_to(cam, (B, height * width, 3))
        elif not transform_mode:
            # geometry enters through the rays: the novel view's ray grid in
            # the canonical frame, from its extrinsic
            ext = np.asarray(target_transform)
            cam_pos = np.linalg.inv(ext)[:, :3, 3]  # camera origin in canonical coords
            rays = np.stack(
                [camera_rays_from_extrinsic(ext[b], cam_pos[b], width, height) for b in range(B)]
            ).reshape(B, -1, 3)
            cam = np.broadcast_to(cam_pos[:, None], (B, height * width, 3))
        else:
            rays = batch.input_rays[:, 0].reshape(B, -1, 3).cpu().numpy()
            cam = np.broadcast_to(
                batch.input_camera_pos[:, 0].cpu().numpy()[:, None], (B, height * width, 3)
            )
            if rays.shape[1] != height * width:
                raise ValueError(
                    f"render_image at {height}x{width} but the canonical input grid has "
                    f"{rays.shape[1]} rays (input downsampling?) — pass the full-scale "
                    "item's target_rays/cam explicitly"
                )

        n = height * width
        n_pad = ((n + chunk - 1) // chunk) * chunk
        pad = n_pad - n

        def pad_to(x):
            return np.concatenate([x, np.repeat(x[:, -1:], pad, 1)], 1) if pad else x

        coord, rays, cam = pad_to(coord), pad_to(rays), pad_to(cam)
        out = np.zeros((B, n_pad, 3), np.float32)
        tt = self._to(target_transform)[:, None] if transform_mode else None

        def view_axis(x):
            """A view axis for transform-mode batches; non-transform batches
            are flat [B, P, ...]."""
            return self._to(x[:, None] if transform_mode else x)

        for i in range(0, n_pad, chunk):
            sub = SceneBatch(
                input_images=batch.input_images,
                input_camera_pos=batch.input_camera_pos,
                input_rays=batch.input_rays,
                target_pixels=torch.zeros((B, 1, chunk, 3), device=self.device),
                target_camera_pos=view_axis(cam[:, i : i + chunk]),
                target_rays=view_axis(rays[:, i : i + chunk]),
                input_transforms=batch.input_transforms,
                target_transforms=tt,
                input_coord=batch.input_coord,
                target_coord=(
                    view_axis(coord[:, i : i + chunk]) if batch.target_coord is not None else None
                ),
            )
            pixels, _ = self.model.decode(z, sub, enc_ctx)
            out[:, i : i + chunk] = pixels.cpu().numpy()
        return out[:, :n].reshape(B, height, width, 3)

    @torch.no_grad()
    def render_rays(
        self, batch: SceneBatch, rays: np.ndarray, camera_pos: np.ndarray, chunk: int = 4096
    ) -> np.ndarray:
        """Decode arbitrary canonical-frame rays [B, P, 3] against the
        batch's input views — the non-transform eval path (reference
        evaluate.py:122-131). Returns [B, P, 3]."""
        batch = batch.to(self.device)
        z, enc_ctx = self.model.encode(batch)
        B, n = rays.shape[:2]
        n_pad = ((n + chunk - 1) // chunk) * chunk
        pad = n_pad - n

        def pad_to(x):
            return np.concatenate([x, np.repeat(x[:, -1:], pad, 1)], 1) if pad else x

        rays, cam = pad_to(np.asarray(rays)), pad_to(np.asarray(camera_pos))
        out = np.zeros((B, n_pad, 3), np.float32)
        for i in range(0, n_pad, chunk):
            sub = SceneBatch(
                input_images=batch.input_images,
                input_camera_pos=batch.input_camera_pos,
                input_rays=batch.input_rays,
                target_pixels=torch.zeros((B, chunk, 3), device=self.device),
                target_camera_pos=self._to(cam[:, i : i + chunk]),
                target_rays=self._to(rays[:, i : i + chunk]),
                input_transforms=batch.input_transforms,
                input_coord=batch.input_coord,
            )
            pixels, _ = self.model.decode(z, sub, enc_ctx)
            out[:, i : i + chunk] = pixels.cpu().numpy()
        return out[:, :n]

    def visualize(self, batch: SceneBatch, out_path: str, num_angles: int = 6) -> None:
        """Render `num_angles` novel views rotated about the world z-axis into
        an image grid at <out_path>.png (reference trainer.py:184-295).
        Rotation is conjugated into the canonical frame:
        T_rel = E_canon R_z(theta) E_canon^-1 (R_z alone without one)."""
        B, N, H, W = batch.input_rays.shape[:4]
        columns = [(f"input {i + 1}", batch.input_images[:, i].cpu().numpy()) for i in range(N)]
        canon = batch.transform.cpu().numpy() if batch.transform is not None else None
        for i in range(num_angles):
            angle = i * (2 * np.pi / num_angles)
            Rz = np.asarray(
                [
                    [np.cos(angle), -np.sin(angle), 0, 0],
                    [np.sin(angle), np.cos(angle), 0, 0],
                    [0, 0, 1, 0],
                    [0, 0, 0, 1],
                ],
                dtype=np.float32,
            )
            if canon is not None:
                rel = np.einsum("bij,jk,bkl->bil", canon, Rz, np.linalg.inv(canon))
            else:
                rel = np.broadcast_to(Rz, (B, 4, 4))
            img = self.render_image(batch, H, W, target_transform=rel.astype(np.float32))
            columns.append((f"render {(i * 360) // num_angles}°", img))
        draw_visualization_grid(columns, out_path)
