"""Shared target-pixel sampling arithmetic for the data pipelines."""

from __future__ import annotations


def points_per_view(num_points: int, n_target: int) -> int:
    """Target rays sampled per target view.

    Every pipeline samples a fixed per-view count. At production sizes the
    count is rounded to the nearest multiple of 8 (2560 over 3 views:
    853 -> 856, < 0.4% off the reference's budget); small (test-fixture)
    sizes keep the exact floor. This rounding is part of the data
    semantics: both packages must draw the same rays.
    """
    base = num_points // n_target
    if base < 64 or base % 8 == 0:
        return base
    return max(8, int(round(base / 8)) * 8)
