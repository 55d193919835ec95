"""Batch and attention-context containers.

`SceneBatch` is the canonical batch layout the data pipeline produces
(NHWC images). `AttnContext` carries per-batch geometry through the model:
the precomputed GeomReps tables.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gta_tpu_torch.ops.reps import GeomReps


@dataclasses.dataclass
class SceneBatch:
    """One training/eval batch. B batch, N input views, Nt target views,
    P target points per view, H/W input resolution, T' patch tokens/view."""

    input_images: torch.Tensor  # [B, N, H, W, 3]
    input_camera_pos: torch.Tensor  # [B, N, 3]
    input_rays: torch.Tensor  # [B, N, H, W, 3]
    target_pixels: torch.Tensor  # [B, Nt, P, 3]
    target_camera_pos: torch.Tensor  # [B, Nt, P, 3]
    target_rays: torch.Tensor  # [B, Nt, P, 3]
    input_transforms: Optional[torch.Tensor] = None  # [B, N, 4, 4]
    target_transforms: Optional[torch.Tensor] = None  # [B, Nt, 4, 4]
    input_coord: Optional[torch.Tensor] = None  # [B, N, T', 2]
    target_coord: Optional[torch.Tensor] = None  # [B, Nt, P, 2]
    transform: Optional[torch.Tensor] = None  # [B, 4, 4] canonical extrinsic
    sceneid: Optional[torch.Tensor] = None  # [B]
    # pre-downsample extras (reference clevr_tr.py:261,329), emitted on
    # request (return_org_rays / return_org_images); no model reads them yet
    input_org_rays: Optional[torch.Tensor] = None  # [B, N, H0, W0, 3]
    org_input_images: Optional[torch.Tensor] = None  # [B, N, H0, W0, 3]

    def to(self, device) -> "SceneBatch":
        """A copy with every tensor field moved to `device`."""
        return SceneBatch(
            **{
                f.name: (None if (x := getattr(self, f.name)) is None else x.to(device))
                for f in dataclasses.fields(self)
            }
        )


@dataclasses.dataclass
class AttnContext:
    """Geometry context threaded through attention layers."""

    geom: GeomReps = dataclasses.field(default_factory=GeomReps)
