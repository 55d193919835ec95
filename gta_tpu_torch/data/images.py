"""Class-conditional image datasets for the DiT family.

Port of gta_tpu/data/images.py. The family's target dataset is ImageNet;
without it, training runs on a procedural dataset with the same pipeline
(label-conditional [-1, 1] NHWC images): oriented stripes whose
orientation and frequency are functions of the class, with a per-sample
phase, colour and noise, drawn by the same numpy RandomState code as the
JAX package's, so the items are byte-equal to its items.
"""

from __future__ import annotations

import numpy as np


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
