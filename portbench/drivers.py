"""The two entries a traffic file can drive, each against the program's
`Trainer` (`gta_tpu_torch.train.trainer`): `train_step` in a closed loop
over a pool of batches, and `render_image` in a closed loop of one client.

A driver builds the program's trainer from the config file's run config,
loads the benchmark's weights into it, makes its traffic on the device
from the seed, warms every shape the window uses, and then measures,
traces and checks. `readings()` returns what the program produced for the
comparison with the reference (portbench/check.py); `close()` frees the
program's state before the reference runs.
"""

from __future__ import annotations

import gc
import random
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import scenes
from portbench.weights import make_weights

POOL_SALT, SERVE_SALT = 2, 3
BATCH_FIELDS = ("input_images", "input_camera_pos", "input_rays", "target_pixels", "target_camera_pos",
                "target_rays", "input_transforms", "target_transforms", "input_coord", "target_coord")


def scene_batch(fields: dict):
    from gta_tpu_torch.models.context import SceneBatch

    return SceneBatch(**{k: fields.get(k) for k in BATCH_FIELDS})


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """Set-up shared by both entries: the program's trainer with the
    benchmark's weights."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from gta_tpu_torch.config import config_from_dict
        from gta_tpu_torch.train.trainer import Trainer

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.phases = {"imported": time.time()}  # when each part of set-up ended (run.py prints them)
        self.trainer = Trainer(config_from_dict(config["run_config"]), device=device, seed=seed)
        self.phases["trainer"] = time.time()
        self.weights = make_weights(config, seed, self.device)
        params = dict(self.trainer.model.named_parameters())
        if set(params) != set(self.weights):
            raise RuntimeError(f"the program's parameters differ from the reference's: "
                               f"{sorted(set(params) ^ set(self.weights))[:8]}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(self.weights[name])

    def close(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class TrainDriver(Driver):
    """`Trainer.train_step` on batches of `batch_size` cycled from a pool of
    `pool` batches; the first `setup_steps` (three) go through the same
    call in set-up, and the comparison follows them."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        B, n = traffic["batch_size"], traffic["pool"]
        made = scenes.make_scenes(config["sizes"], B * n, seed, POOL_SALT, self.device)
        made.pop("novel")
        self.pool_fields = [scenes.rows(made, slice(i * B, (i + 1) * B)) for i in range(n)]
        self.pool = [scene_batch(f) for f in self.pool_fields]
        sync(self.device)
        self.phases["weights_and_pool"] = time.time()
        self.losses = []
        self.grad_norms: Dict[str, float] = {}
        self.change_norms: Dict[str, float] = {}
        model = self.trainer.model
        names = [name for name, _ in model.named_parameters()]
        for i in range(traffic["setup_steps"]):
            out = self.trainer.train_step(self.pool[i % n])
            self.losses.append(out["loss"].detach().clone())
            if i == 0:
                state = self.trainer.optimizer.state
                self.grad_norms = _norms({name: state.get(p, {}).get("exp_avg", torch.zeros_like(p)) / 0.1
                                          for name, p in zip(names, model.parameters())})
        self.change_norms = _norms({name: p.detach() - self.weights[name] for name, p in model.named_parameters()})
        self.losses = [float(x) for x in self.losses]
        self.done = traffic["setup_steps"]
        sync(self.device)
        self.phases["setup_steps"] = time.time()

    def step(self, i: int) -> None:
        self.last = self.trainer.train_step(self.pool[(self.done + i) % len(self.pool)])

    def window(self, seconds: float) -> dict:
        """Steps until `seconds` have passed, dispatched ahead, the device
        synchronised at both ends."""
        sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.step(n)
            n += 1
        sync(self.device)
        took = time.perf_counter() - t0
        self.done += n
        finite = bool(torch.isfinite(self.last["loss"]))
        return {"attempted": n, "failed": 0 if finite else n, "window_s": took,
                "metrics": {"train_samples_per_s": n * self.traffic["batch_size"] / took}}

    def trace_step(self, i: int) -> None:
        self.step(0)
        self.done += 1

    def readings(self) -> dict:
        return {"losses": self.losses, "grad_norms": self.grad_norms, "change_norms": self.change_norms,
                "batches": self.pool_fields[:self.traffic["setup_steps"]]}


class RenderDriver(Driver):
    """`Trainer.render_image` of one full-frame novel view for each of
    `scenes_per_call` scenes a call, one client in a closed loop, over
    `pool` scenes made in set-up (calls cycle through them); each call is
    timed from issue to pixels in host memory. A sample of `sample_calls`
    calls (drawn from the seed) keeps its frames for the comparison."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        if not config["sizes"]["data"]["return_transform"]:
            raise NotImplementedError("render traffic drives configs whose novel views come as transforms")
        d = config["sizes"]["data"]
        self.h, self.w = d["height"], d["width"]
        S = traffic["scenes_per_call"]
        made = scenes.make_scenes(config["sizes"], traffic["pool"], seed, SERVE_SALT, self.device)
        self.calls = []
        for c in range(traffic["pool"] // S):
            f = scenes.rows(made, slice(c * S, (c + 1) * S))
            novel = f["novel"]
            inputs = {k: f[k] for k in ("input_images", "input_camera_pos", "input_rays", "input_transforms",
                                        "input_coord")}
            batch = scene_batch(dict(inputs, target_pixels=torch.zeros(S, 1, 1, 3, device=self.device),
                                     target_camera_pos=torch.zeros(S, 1, 1, 3, device=self.device),
                                     target_rays=torch.zeros(S, 1, 1, 3, device=self.device),
                                     target_transforms=novel[:, None],
                                     target_coord=torch.zeros(S, 1, 1, 2, device=self.device)))
            host = {"novel": novel.cpu().numpy(), "rays": f["input_rays"][:, 0].reshape(S, -1, 3).cpu().numpy(),
                    "cam": f["input_camera_pos"][:, :1].cpu().numpy()}
            self.calls.append((batch, host, inputs, novel))
        self.rng = random.Random(seed)
        self.kept: List[tuple] = []
        self.done = 0
        sync(self.device)
        self.phases["weights_and_pool"] = time.time()
        for i in range(traffic["warmup_calls"]):
            self.call(i)
        sync(self.device)
        self.phases["warmup_calls"] = time.time()

    def call(self, i: int) -> np.ndarray:
        batch, host, _, _ = self.calls[i % len(self.calls)]
        return self.trainer.render_image(batch, self.h, self.w, target_transform=host["novel"],
                                         chunk=self.traffic["chunk"], rays=host["rays"], cam=host["cam"])

    def _keep(self, index: int, frames: np.ndarray) -> None:
        """Reservoir sample of the calls' frames, drawn from the seed."""
        k = self.traffic["sample_calls"]
        if len(self.kept) < k:
            self.kept.append((index, frames))
        else:
            j = self.rng.randrange(self.done + 1)
            if j < k:
                self.kept[j] = (index, frames)

    def window(self, seconds: float) -> dict:
        sync(self.device)
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            c0 = time.perf_counter()
            frames = self.call(self.done)
            lat.append(time.perf_counter() - c0)
            self._keep(self.done % len(self.calls), frames)
            self.done += 1
        took = time.perf_counter() - t0
        n = len(lat)
        p95 = statistics.quantiles(lat, n=20)[18] if n >= 2 else lat[0]
        return {"attempted": n, "failed": 0, "window_s": took, "latencies_s": lat,
                "metrics": {"serve_frames_per_s": n * self.traffic["scenes_per_call"] / took,
                            "serve_p95_ms": 1e3 * p95}}

    def trace_step(self, i: int) -> None:
        frames = self.call(self.done)
        self._keep(self.done % len(self.calls), frames)
        self.done += 1

    def readings(self) -> dict:
        return {"frames": [(frames, self.calls[index][2], self.calls[index][3]) for index, frames in self.kept],
                "height": self.h, "width": self.w}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's L2 norm, in fp64, on the host."""
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].double()) for n in names]).cpu().tolist()
    return dict(zip(names, vals))


DRIVERS = {"train_step": TrainDriver, "render_image": RenderDriver}


def driver(config: dict, traffic: dict, seed: int, device: str) -> Driver:
    entry = traffic["entry"]
    if entry not in DRIVERS:
        raise ValueError(f"unknown traffic entry {entry!r} (one of {sorted(DRIVERS)})")
    return DRIVERS[entry](config, traffic, seed, device)
