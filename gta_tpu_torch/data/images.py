"""Class-conditional image datasets for the DiT family.

Port of gta_tpu/data/images.py. The family's target dataset is ImageNet;
without it, training runs on a procedural dataset with the same pipeline
(label-conditional [-1, 1] NHWC images): oriented stripes whose
orientation and frequency are functions of the class, with a per-sample
phase, colour and noise, drawn by the same numpy RandomState code as the
JAX package's, so the items are byte-equal to its items.
`DeviceSyntheticImages` makes the same distribution on the device, batch
by batch (train_dit --device-data), its draws from data/device_synth.py's
counter-based hash.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from gta_tpu_torch.data.device_synth import draw_bits, scene_keys, stream_key, to_uniform, uniform


class SyntheticImages:
    """Map-style procedural dataset: items {'image': [H, W, 3] in [-1, 1]
    fp32, 'label': int32}."""

    def __init__(self, size: int = 32, num_classes: int = 10, mode: str = "train", num_images: int = 50000,
                 seed: int = 0):
        self.size = size
        self.num_classes = num_classes
        self.num_images = num_images
        base = {"train": 0, "val": 1 << 24, "test": 1 << 25}[mode]
        self.seed_base = seed * (1 << 26) + base

    def __len__(self):
        return self.num_images

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.RandomState(self.seed_base + idx)
        k = int(rng.randint(self.num_classes))
        s = self.size
        yy, xx = np.meshgrid(np.linspace(0, 1, s, dtype=np.float32), np.linspace(0, 1, s, dtype=np.float32),
                             indexing="ij")
        # class-determined orientation and frequency; sample-determined phase
        angle = np.pi * k / self.num_classes
        freq = 2.0 + 2.0 * (k % 5)
        phase = rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * freq * (np.cos(angle) * xx + np.sin(angle) * yy) + phase)
        color = rng.uniform(0.3, 1.0, size=(3,)).astype(np.float32)
        img = wave[..., None] * color[None, None]
        img += rng.normal(scale=0.05, size=img.shape)
        return {"image": np.clip(img, -1.0, 1.0).astype(np.float32), "label": np.int32(k)}


class DeviceSyntheticImages:
    """SyntheticImages' distribution made on `device` (CUDA unless the
    caller asks for the CPU): batches {'image': [B, S, S, 3] fp32 in
    [-1, 1], 'label': [B] int32} of tensors on the device, with no host
    work and no copy. An image depends only on (seed, mode, image id):
    its class, phase, colour and noise are hashes of those (the class
    and every other integer the same bits on the CPU and the card)."""

    def __init__(self, size: int = 32, num_classes: int = 10, mode: str = "train", num_images: int = 50000,
                 seed: int = 0, device: Optional[str] = None):
        from gta_tpu_torch.train.trainer import resolve_device

        self.size = size
        self.num_classes = num_classes
        self.num_images = num_images
        self.device = resolve_device(device)
        self.id_base = {"train": 0, "val": 1 << 24, "test": 1 << 25}[mode]
        self.key = stream_key(seed, self.id_base + 23)
        grid = np.linspace(0, 1, size, dtype=np.float32)
        yy, xx = np.meshgrid(grid, grid, indexing="ij")
        self.xx, self.yy = (torch.from_numpy(a).to(self.device) for a in (xx, yy))

    def ids(self, step: int, batch_size: int, shard_index: int = 0, shard_count: int = 1) -> torch.Tensor:
        """The image ids of batch `step` of this shard (val / test cycle a
        fixed range above their base)."""
        start = (step * shard_count + shard_index) * batch_size
        if self.id_base:
            start %= 1 << 20
        return torch.arange(start, start + batch_size, dtype=torch.int64, device=self.device) + self.id_base

    def batch(self, step: int, batch_size: int, shard_index: int = 0, shard_count: int = 1) -> Dict[str, torch.Tensor]:
        return self.images(self.ids(step, batch_size, shard_index, shard_count))

    def val_batches(self, num_scenes: int, batch_size: int) -> List[Dict[str, torch.Tensor]]:
        return [self.batch(i, batch_size) for i in range(max(1, num_scenes // batch_size))]

    def images(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, s = ids.shape[0], self.size
        keys = scene_keys(self.key, ids)
        k = (draw_bits(keys, 0, 1)[:, 0] * self.num_classes) >> 32  # [B] in [0, num_classes)
        kf = k.to(torch.float32)
        angle = (math.pi * kf / self.num_classes)[:, None, None]
        freq = (2.0 + 2.0 * (k % 5).to(torch.float32))[:, None, None]
        phase = uniform(keys, 1, 1, 0.0, 2 * math.pi)[:, :, None]
        wave = torch.sin(2 * math.pi * freq * (torch.cos(angle) * self.xx + torch.sin(angle) * self.yy) + phase)
        color = uniform(keys, 2, 3, 0.3, 1.0)
        img = wave[..., None] * color[:, None, None]
        # unit normal noise by Box-Muller from two streams of uniforms
        u1 = 1.0 - to_uniform(draw_bits(keys, 3, s * s * 3))  # (0, 1]
        u2 = to_uniform(draw_bits(keys, 4, s * s * 3))
        noise = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2 * math.pi * u2)
        img = img + 0.05 * noise.view(B, s, s, 3)
        return {"image": torch.clamp(img, -1.0, 1.0).to(torch.float32), "label": k.to(torch.int32)}


def collate_images(items) -> dict:
    return {
        "image": np.stack([it["image"] for it in items]),
        "label": np.stack([it["label"] for it in items]),
    }


class ImageNetTFDS:
    """ImageNet through tensorflow_datasets, as the JAX package reads it:
    not ported. Neither machine has tensorflow_datasets or a prepared
    ImageNet directory (ROADMAP queue 1 item 8)."""

    def __init__(self, size: int, mode: str, data_dir: str, shuffle: int = 10000):
        raise NotImplementedError(
            "ImageNet (tensorflow_datasets imagenet2012) is not ported: it waits on a prepared ImageNet "
            "directory (ROADMAP queue 1 item 8); without a datapath the DiT trains on SyntheticImages"
        )
