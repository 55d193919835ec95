"""Batch and attention-context containers.

`SceneBatch` is the canonical batch layout the data pipeline produces
(NHWC images). `AttnContext` carries per-batch geometry through the model:
the precomputed GeomReps tables and each method's side tables
(gta_tpu/models/context.py:51-66).
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
    """Geometry context threaded through attention layers: the group-rep
    tables, and the method-specific extras (reference encoder.py:122-181,
    layers.py:348-385, decoder.py:355-371)."""

    geom: GeomReps = dataclasses.field(default_factory=GeomReps)
    # camera transforms (ape, mln, repast, ftl)
    input_transforms: Optional[torch.Tensor] = None  # [B, N, 4, 4]
    target_transforms: Optional[torch.Tensor] = None  # [B, Nt, 4, 4]
    # 2D coordinate embeddings (ape, mln)
    input_coord_emb: Optional[torch.Tensor] = None  # [B, N, T', E]
    target_coord_emb: Optional[torch.Tensor] = None  # [B, Nt, P, E]
    # patch / pixel coords (frustum_posemb)
    input_coord: Optional[torch.Tensor] = None  # [B, N, T', 2]
    target_coord: Optional[torch.Tensor] = None  # [B, Nt, P, 2]
    # GBT Plücker-distance bias, late-fusion ray embedding, input rays
    plucker_dist: Optional[torch.Tensor] = None  # [B, Tq, Tk]
    gbt_ray_emb: Optional[torch.Tensor] = None  # [B, T, E]
    gbt_ray_input: Optional[torch.Tensor] = None  # [B, Tk, 6]
    # RePAST per-view ray embeddings
    key_ray_emb: Optional[torch.Tensor] = None  # [B, Nk, Lk, E]
    query_ray_emb: Optional[torch.Tensor] = None  # [B, Tq, Nk, E]
