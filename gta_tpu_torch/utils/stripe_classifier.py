"""Training-free spectral classifier for the procedural DiT dataset.

The port's own copy of gta_tpu/utils/stripe_classifier.py. The procedural
class-conditional images (data/images.py) are oriented sinusoid stripes
whose orientation and frequency are functions of the class id
(angle = pi*k/K, freq = 2 + 2*(k % 5)); phase, colour and noise are
per-sample nuisances. The dominant FFT peak of the channel-mean image
identifies the class, which gives the family a sample metric
(class-conditional sample accuracy, scripts/eval_dit_samples.py) with no
learned judge.
"""

from __future__ import annotations

import numpy as np


def class_templates(num_classes: int = 10) -> np.ndarray:
    """Per-class (row, col) frequency of the stripe peak, in cycles per
    image: freq * (sin(a), cos(a)) (data/images.py draws on an [0, 1]
    meshgrid with indexing="ij", so yy varies along rows). [K, 2]."""
    out = []
    for k in range(num_classes):
        a = np.pi * k / num_classes
        f = 2.0 + 2.0 * (k % 5)
        out.append((f * np.sin(a), f * np.cos(a)))
    return np.asarray(out)


def dominant_peak(img: np.ndarray) -> np.ndarray:
    """The dominant non-DC FFT peak of a [H, W, 3] (or [H, W]) image as
    (row_freq, col_freq) in cycles per image, with row_freq >= 0 (a stripe's
    orientation is defined up to point symmetry)."""
    g = img.mean(-1) if img.ndim == 3 else img
    F = np.fft.fft2(g)
    F[0, 0] = 0.0
    H, W = g.shape
    idx = np.unravel_index(np.argmax(np.abs(F)), F.shape)
    fy = idx[0] if idx[0] <= H // 2 else idx[0] - H
    fx = idx[1] if idx[1] <= W // 2 else idx[1] - W
    if fy < 0 or (fy == 0 and fx < 0):
        fy, fx = -fy, -fx
    return np.asarray([float(fy), float(fx)])


def classify(images: np.ndarray, num_classes: int = 10) -> np.ndarray:
    """[B, H, W, 3] images (any affine range) -> int32 class predictions."""
    t = class_templates(num_classes)
    preds = np.empty(len(images), np.int32)
    for i, img in enumerate(np.asarray(images)):
        p = dominant_peak(img)
        preds[i] = int(np.argmin(((t - p[None]) ** 2).sum(-1)))
    return preds


def accuracy(images: np.ndarray, labels: np.ndarray, num_classes: int = 10):
    """(overall accuracy, per-class accuracy [K], NaN for absent classes)
    of the classifier on labelled images."""
    preds = classify(images, num_classes)
    labels = np.asarray(labels)
    acc = float((preds == labels).mean())
    per = np.asarray([float((preds[labels == k] == k).mean()) if (labels == k).any() else np.nan
                      for k in range(num_classes)])
    return acc, per
