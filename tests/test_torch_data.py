"""Parity of the port's data pipeline (gta_tpu_torch/data) with the JAX
package's numpy path: the same seed gives byte-equal arrays."""

import dataclasses
import os

import numpy as np
import pytest

from gta_tpu.config import DataConfig as JDataConfig
from gta_tpu.data.sampling import points_per_view as j_points_per_view
from gta_tpu.data.synthetic import SyntheticScenes as JSyntheticScenes, collate as j_collate
from gta_tpu_torch.config import DataConfig
from gta_tpu_torch.data.clevrtr import CLEVRTR
from gta_tpu_torch.data.registry import get_dataset
from gta_tpu_torch.data.sampling import points_per_view
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate

SMALL = dict(dataset="synthetic", height=32, width=48, downsample=1, num_points=48,
             num_input_views=2, num_target_views=3, downsample_input_coord=2)


def _pair(mode="val", full_scale=False, seed=0, **over):
    kw = {**SMALL, **over}
    return (
        SyntheticScenes(DataConfig(**kw), mode, full_scale=full_scale, seed=seed, use_native=False),
        JSyntheticScenes(JDataConfig(**kw), mode, full_scale=full_scale, seed=seed, use_native=False),
    )


def _assert_items_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_points_per_view():
    for n in (16, 48, 200, 2048, 2560, 4096):
        for nt in (1, 2, 3, 5):
            assert points_per_view(n, nt) == j_points_per_view(n, nt)
    assert points_per_view(2560, 3) == 856


@pytest.mark.parametrize("mode,full_scale,seed,over", [
    ("train", False, 0, {}),
    ("val", False, 3, {}),
    ("test", True, 0, {}),
    ("test", True, 1, dict(return_transform=False)),
    ("train", False, 0, dict(return_transform=False, overlap=True)),
])
def test_synthetic_items_byte_equal(mode, full_scale, seed, over):
    ours, theirs = _pair(mode, full_scale, seed, **over)
    assert (ours.h, ours.w, ours.target_h, ours.target_w) == (
        theirs.h, theirs.w, theirs.target_h, theirs.target_w)
    for idx in (0, 5):
        _assert_items_equal(ours[idx], theirs[idx])


def test_collate_matches():
    ours, theirs = _pair()
    got = collate([ours[0], ours[1]])
    want = j_collate([theirs[0], theirs[1]])
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        g = getattr(got, f.name, None)
        if w is None:
            assert g is None, f.name
        else:
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), f.name


def test_registry(tmp_path):
    ds = get_dataset("val", DataConfig(**SMALL), full_scale=True, max_len=3)
    assert isinstance(ds, SyntheticScenes) and len(ds) == 3
    assert (ds.target_h, ds.target_w) == (32, 48)
    (tmp_path / "train" / "metadata").mkdir(parents=True)
    for s in range(10):
        (tmp_path / "train" / "metadata" / f"{s}.json").write_text("{}")
    ds = get_dataset("val", DataConfig(**{**SMALL, "dataset": "clevrtr", "path": str(tmp_path)}))
    assert isinstance(ds, CLEVRTR) and [os.path.basename(p) for p in ds.metadata_paths] == ["9.json"]
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("val", DataConfig(**{**SMALL, "dataset": "imagenet"}))
