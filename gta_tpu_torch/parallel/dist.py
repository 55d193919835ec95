"""Data parallel over torch.distributed (the data axis of the JAX package's
parallel/mesh.py, as the reference trains under torchrun).

One process per card. `init_from_env` joins the process group that
torchrun's environment describes (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT): NCCL on CUDA, each rank on `cuda:LOCAL_RANK`,
gloo on the CPU. Without that environment there is no group, and every
helper here is the single process's identity (rank 0 of 1, no
communication). Where CUDA is asked for and NCCL is missing it raises:
a group never drops to gloo or to the CPU.

Each rank holds the same parameters (the same seed, then rank 0's
broadcast) and trains on its own shard of every global batch. The
trainers average the gradients over ranks once per optimizer step, after
the last microbatch, as one flat buffer (`average_`): over equal
shards that average is the global batch's mean gradient, as JAX's jit over
the global batch computes it. No `DistributedDataParallel`: some
parameters never reach the loss, and accumulation needs no `no_sync`.

Random draws (dropout masks; the DiT's timesteps, noise and label
dropout) differ between ranks: the draws of optimizer step `s` on rank `r`
come from a generator seeded `step_seed(seed, s, r)`, a SeedSequence hash
of the three, so they depend on neither the world size nor what a
checkpoint carried, and a resumed run draws what an unbroken one would.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)  # a collective that waits longer raises


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def init_from_env(device: Optional[str] = None) -> Optional[str]:
    """Join torchrun's process group when its environment is set, and
    return this rank's device: `cuda:LOCAL_RANK` unless `device` asks for
    the CPU (then gloo). Without WORLD_SIZE in the environment (a plain
    run) it returns `device` as it is and starts no group."""
    if "WORLD_SIZE" not in os.environ or initialized():
        return device
    cpu = device is not None and torch.device(device).type == "cpu"
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to run the process group on gloo"
            )
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: data parallel on CUDA needs it (no fallback to gloo)")
        backend = "nccl"
        device = f"cuda:{local_rank}"
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend,
        init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=TIMEOUT,
    )
    return device


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()


def describe() -> str:
    """One line naming the process group: backend, world size, this rank."""
    return f"Data parallel: backend {dist.get_backend()}, world size {world()}, rank {rank()}"


def step_seed(seed: int, step: int, rank_: Optional[int] = None) -> int:
    """The seed of rank `rank_`'s (default: this rank's) draws at optimizer
    step `step`: a 64-bit SeedSequence hash of (seed, rank, step)."""
    r = rank() if rank_ is None else rank_
    lo, hi = np.random.SeedSequence([seed, r, step]).generate_state(2, np.uint32)
    return int(lo) | (int(hi) << 32)


def all_reduce_mean_(flat: torch.Tensor) -> torch.Tensor:
    """Average `flat` over ranks in place (a sum, then / world: gloo has no
    AVG); every rank gets the same bits."""
    if initialized():
        dist.all_reduce(flat)
        flat /= world()
    return flat


def average_(grads: List[torch.Tensor], scalars: List[torch.Tensor]) -> List[torch.Tensor]:
    """Average every gradient in place, and each scalar, over ranks in one
    all_reduce of a flat fp32 buffer; returns the averaged scalars (0-dim,
    on the device). A flag carried as a scalar (0 or 1) comes back above 0
    on every rank where any rank raised it: the max of the flags. Without
    a process group it returns `scalars` as they are."""
    if not initialized():
        return scalars
    buf = torch.cat([g.reshape(-1) for g in grads] + [s.reshape(1).float() for s in scalars])
    all_reduce_mean_(buf)
    n = 0
    for g in grads:
        g.copy_(buf[n : n + g.numel()].view_as(g))
        n += g.numel()
    return list(buf[n:].unbind())


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def mean_over_ranks(local: Dict[str, float], device) -> Dict[str, float]:
    """Per-rank means averaged over ranks, keys reduced in sorted order
    (JAX's process_allgather of sorted keys; the reference's AVG
    all_reduce, common.py:80-102). Exact where every rank saw as many
    items, as the loader's even shards make it."""
    if not initialized():
        return dict(local)
    keys = sorted(local)
    vals = torch.tensor([local[k] for k in keys], dtype=torch.float64, device=device)
    all_reduce_mean_(vals)
    return {k: float(v) for k, v in zip(keys, vals.tolist())}


def gather_ids(ids: np.ndarray) -> np.ndarray:
    """Every rank's ids, concatenated in rank order."""
    if not initialized():
        return ids
    out = [None] * world()
    dist.all_gather_object(out, ids)
    return np.concatenate(out)
