"""The traced window and what the per-layer readers take from it.

A traced run makes three passes of the same number of steady steps (or
calls), each after a synchronise and up to one:

1. without the profiler: its length is the time `mfu` divides by, so
   that the profiler's own host work is not charged to the model;
2. under `torch.profiler` with CUDA activity alone: each device kernel's
   name and interval, the window of the idle share and of `busy_s`;
3. under `torch.profiler` with CPU and CUDA activity: each host op's
   interval, read only by `breakdown` to name the idle gaps (its gaps are
   those of this pass, which the profiler's host work lengthens).

A `Window` carries those with the cell's description; each reader in
portbench/metrics takes one and returns a number or None.

Busy time is the union of the kernels' intervals (kernels that overlap
count once), so the idle share is 1 - busy / window. `breakdown` lists the
kernels that took the most device time (pass 2) and the longest idle gaps
of pass 3, each named by the innermost host op that spans its middle.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

from portbench.kinds import ATTENTION, kind

Interval = Tuple[str, float, float]  # (name, start us, end us)


@dataclasses.dataclass
class Window:
    """A traced window of `steps` units of the cell's traffic (training
    steps or render calls)."""

    cell: dict  # the workload's entry in BENCHMARK.json
    config: dict  # its config file
    traffic: dict  # its traffic file
    steps: int
    window_s: float  # pass 2, under the profiler's CUDA activity
    kernels: List[Interval]  # pass 2
    host: List[Interval]  # pass 3, with its own kernels in `host_kernels`
    peak_bytes: Optional[int] = None
    flops_per_step: Optional[float] = None
    timed_s: Optional[float] = None  # pass 1, unprofiled
    host_kernels: List[Interval] = dataclasses.field(default_factory=list)


def timed(step: Callable[[int], None], steps: int, sync: Callable[[], None]) -> float:
    """Seconds of `steps` calls of step(i), synchronised at both ends."""
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        step(i)
    sync()
    return time.perf_counter() - t0


def profile_window(step: Callable[[int], None], steps: int, sync: Callable[[], None], host: bool) -> tuple:
    """(window seconds, kernels, host ops) of `steps` calls of step(i)
    under the profiler: CUDA activity, and CPU activity too where `host`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    wanted = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    activities = [a for a in wanted if a in supported_activities()]
    if not activities:  # a build without CUDA, profiled for device activity alone
        return timed(step, steps, sync), [], []
    sync()
    with profile(activities=activities) as prof:
        window_s = timed(step, steps, sync)
    kernels, ops = [], []
    for ev in prof.events():
        iv = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(iv)
        else:
            ops.append(iv)
    return window_s, kernels, ops


def trace_passes(step: Callable[[int], None], steps: int, sync: Callable[[], None]) -> dict:
    """The three passes' readings, as `Window`'s fields."""
    timed_s = timed(step, steps, sync)
    window_s, kernels, _ = profile_window(step, steps, sync, host=False)
    _, host_kernels, host = profile_window(step, steps, sync, host=True)
    return {"timed_s": timed_s, "window_s": window_s, "kernels": kernels, "host": host,
            "host_kernels": host_kernels}


def union_s(kernels: List[Interval]) -> float:
    """Seconds covered by at least one interval."""
    total, end = 0.0, None
    for _, s, e in sorted(kernels, key=lambda iv: iv[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def gaps(kernels: List[Interval]) -> List[Tuple[float, float]]:
    """The idle intervals (start, end) between kernels, in us."""
    out, end = [], None
    for _, s, e in sorted(kernels, key=lambda iv: iv[1]):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def seconds_by(kernels: List[Interval], key: Callable[[str], str]) -> dict:
    out = defaultdict(float)
    for name, s, e in kernels:
        out[key(name)] += (e - s) * 1e-6
    return dict(out)


def idle_share(w: Window) -> Optional[float]:
    """1 - busy / window, in %."""
    if not w.kernels or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - union_s(w.kernels) / w.window_s)


def attention_seconds(w: Window) -> float:
    """Device seconds of this repo's attention kernels (forward, backward,
    row transforms, centres)."""
    return sum(s for k, s in seconds_by(w.kernels, kind).items() if k in ATTENTION)


def breakdown(w: Window, top: int = 10) -> dict:
    """{"device_ops": [[name, seconds]], "idle_gaps": [[host op, seconds]]}."""
    ops = sorted(seconds_by(w.kernels, lambda n: n).items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(w.host_kernels), key=lambda g: g[0] - g[1])[:top]
    idle = []
    for s, e in longest:
        mid = (s + e) / 2
        spans = [(he - hs, name) for name, hs, he in w.host if hs <= mid <= he]
        idle.append([min(spans)[1] if spans else "(no host op)", (e - s) * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


def roofline(w: Window) -> Optional[float]:
    """The least time the traced steps' attention calls need (portbench/cost,
    at the config's precision) over the device time of the attention
    kernels, in %; None where the trace holds none."""
    from portbench.cost import attention_calls, bound_s
    from portbench.reference import model_spec

    took = attention_seconds(w)
    if took <= 0:
        return None
    calls = attention_calls(w.config["sizes"], model_spec(w.config)["encoder_attn"], w.traffic)
    return 100.0 * bound_s(calls, w.config["precision"]) * w.steps / took


def mfu(w: Window) -> Optional[float]:
    """Model FLOPs of the traced steps over their unprofiled time (pass 1)
    at the chip's peak for the config's precision, in %."""
    from portbench.cost import PEAK_FLOPS

    if not w.flops_per_step or not w.timed_s:
        return None
    return 100.0 * w.flops_per_step * w.steps / (w.timed_s * PEAK_FLOPS[w.config["precision"]])
