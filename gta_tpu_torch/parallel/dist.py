"""The process mesh over torch.distributed: data, seq and model ranks
(the JAX package's parallel/mesh.py), as the reference trains under
torchrun.

One process per rank. `init_from_env` joins the process group that
torchrun's environment describes (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT): NCCL on CUDA unless the caller names gloo, each
rank on `cuda:LOCAL_RANK` (modulo the cards there are, so two gloo ranks
may share one card: NCCL refuses that), gloo on the CPU. Without that
environment there is no group, and every helper here is the single
process's identity (rank 0 of 1, no communication). Where CUDA is asked for
and NCCL is missing it raises: a group never drops to gloo or to the CPU
on its own.

`init_mesh(n_model, n_seq)` lays the world out as a (data, seq, model)
grid with model innermost, as `make_mesh` orders devices: rank = (d S + s)
N + m, builds one group per row of each axis and returns the `Mesh`, which
the caller hands to the trainer; `world_mesh()` is the whole world as the
data axis. The ranks of one data rank (its S x N seq and model ranks) read
the same batch; each data rank reads its own shard of every global batch
(the loader's shards and the device generator's follow `mesh.data`). The
model ranks hold blocks of heads (parallel/tp.py), the seq ranks blocks of
input views (parallel/ring.py).
The trainers average the gradients over the data axis once per optimizer
step, after the last microbatch, as one flat buffer (`average_`): over
equal shards that average is the global batch's mean gradient, as JAX's jit
over the global batch computes it. No `DistributedDataParallel`: some
parameters never reach the loss, and accumulation needs no `no_sync`.

Random draws (dropout masks; the DiT's timesteps, noise and label
dropout) differ between data ranks: the draws of optimizer step `s` on
data rank `r` come from a generator seeded `step_seed(seed, s, r)`, a
SeedSequence hash of the three, so they depend on neither the world size
nor what a checkpoint carried, and a resumed run draws what an unbroken
one would. The seq and model ranks of one data rank draw the same.

Under gloo, a CUDA tensor is sent and received (`ring_exchange`) through
pinned host buffers: gloo's send and recv take CPU tensors only. Its
all_reduce and broadcast take CUDA tensors as they are.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)  # a collective that waits longer raises
BACKENDS = ("nccl", "gloo")


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


def init_from_env(device: Optional[str] = None, backend: Optional[str] = None) -> Optional[str]:
    """Join torchrun's process group when its environment is set, and
    return this rank's device: `cuda:LOCAL_RANK` (modulo the visible cards)
    unless `device` asks for the CPU. `backend` defaults to NCCL on CUDA and
    gloo on the CPU; gloo may be named on CUDA (two ranks on one card),
    NCCL never on the CPU. Without WORLD_SIZE in the environment (a plain
    run) it returns `device` as it is and starts no group."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if "WORLD_SIZE" not in os.environ or initialized():
        return device
    cpu = device is not None and torch.device(device).type == "cpu"
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if cpu:
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA only: --dist-backend gloo with --device cpu")
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to run the process group on gloo"
            )
        backend = backend or "nccl"
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: a group on CUDA needs it unless gloo is named")
        device = f"cuda:{local_rank % torch.cuda.device_count()}"
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


def backend() -> Optional[str]:
    return dist.get_backend() if initialized() else None


def describe() -> str:
    """One line naming the process group: backend, world size, this rank."""
    return f"Data parallel: backend {backend()}, world size {world()}, rank {rank()}"


# ---------------------------------------------------------------------------
# The (data, seq, model) mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its size, this rank's
    index along it, the global ranks of its row (in axis order) and the
    row's process group (None where the size is 1, or the row is the whole
    world: the default group)."""

    size: int = 1
    index: int = 0
    ranks: Tuple[int, ...] = (0,)
    group: Optional[object] = None

    def next_rank(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    def prev_rank(self) -> int:
        return self.ranks[(self.index - 1) % self.size]


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: Axis
    seq: Axis
    model: Axis

    def describe(self) -> str:
        return (f"Mesh: data {self.data.size} x seq {self.seq.size} x model {self.model.size} (rank {rank()}: "
                f"data {self.data.index}, seq {self.seq.index}, model {self.model.index})")


def init_mesh(n_model: int = 1, n_seq: int = 1) -> Mesh:
    """Lay the world out as (data, seq, model) with model innermost, rank
    = (d S + s) N + m, and build every row's group (every rank builds every
    group, in one order). Collective: every rank calls it."""
    W, r = world(), rank()
    N, S = n_model, n_seq
    if W % (N * S):
        raise ValueError(f"world size {W} is not data x seq x model: --n-seq {S} x --n-model {N} does not divide it")
    D = W // (N * S)
    d, s, m = r // (S * N), (r // N) % S, r % N

    def rank_of(d_, s_, m_):
        return (d_ * S + s_) * N + m_

    def axis(size, index, rows, mine):
        """Build the group of every row (rows: lists of global ranks);
        this rank's row is rows[mine]."""
        group = None
        for i, row in enumerate(rows):
            g = dist.new_group(list(row)) if 1 < size < W else None
            if i == mine:
                group = g
        return Axis(size, index, tuple(rows[mine]), group)

    data = axis(D, d, [[rank_of(i, s_, m_) for i in range(D)] for s_ in range(S) for m_ in range(N)], s * N + m)
    seq = axis(S, s, [[rank_of(d_, i, m_) for i in range(S)] for d_ in range(D) for m_ in range(N)], d * N + m)
    model = axis(N, m, [[rank_of(d_, s_, i) for i in range(N)] for d_ in range(D) for s_ in range(S)], d * S + s)
    return Mesh(data, seq, model)


def world_axis() -> Axis:
    """The whole world as one axis (the default group)."""
    W = world()
    return Axis(W, rank(), tuple(range(W)))


def world_mesh() -> Mesh:
    """The whole world as the data axis: data parallel alone."""
    return Mesh(world_axis(), Axis(), Axis())


def step_seed(seed: int, step: int, rank_: Optional[int] = None) -> int:
    """The seed of data rank `rank_`'s (default: this rank's) draws at
    optimizer step `step`: a 64-bit SeedSequence hash of (seed, rank, step)."""
    r = rank() if rank_ is None else rank_
    lo, hi = np.random.SeedSequence([seed, r, step]).generate_state(2, np.uint32)
    return int(lo) | (int(hi) << 32)


def all_reduce_(flat: torch.Tensor, axis: Axis, mean: bool = False) -> torch.Tensor:
    """Sum (or average: a sum, then / size; gloo has no AVG) `flat` over
    `axis` in place; every rank of the row gets the same bits."""
    if initialized() and axis.size > 1:
        dist.all_reduce(flat, group=axis.group)
        if mean:
            flat /= axis.size
    return flat


def reduce_tensors_(tensors: Sequence[torch.Tensor], axis: Axis, mean: bool = False) -> None:
    """all_reduce_ of every tensor in `tensors`, as one flat fp32 buffer."""
    if not tensors or not initialized() or axis.size == 1:
        return
    buf = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_(buf, axis, mean)
    n = 0
    for t in tensors:
        t.copy_(buf[n : n + t.numel()].view_as(t))
        n += t.numel()


def average_(grads: List[torch.Tensor], scalars: List[torch.Tensor], axis: Optional[Axis] = None) -> List[torch.Tensor]:
    """Average every gradient in place, and each scalar, over `axis` (the
    data axis; default the whole world) in one all_reduce of a flat fp32
    buffer; returns the averaged scalars (0-dim, on the device). A flag
    carried as a scalar (0 or 1) comes back above 0 on every rank where any
    rank of the axis raised it: the max of the flags. Without a process
    group it returns `scalars` as they are."""
    if not initialized():
        return scalars
    buf = torch.cat([g.reshape(-1) for g in grads] + [s.reshape(1).float() for s in scalars])
    all_reduce_(buf, axis or world_axis(), mean=True)
    n = 0
    for g in grads:
        g.copy_(buf[n : n + g.numel()].view_as(g))
        n += g.numel()
    return list(buf[n:].unbind())


def broadcast_(t: torch.Tensor, src: int, axis: Axis) -> torch.Tensor:
    """Global rank `src`'s `t` on every rank of `axis`'s row, in place."""
    if initialized() and axis.size > 1:
        dist.broadcast(t, src, group=axis.group)
    return t


def all_gather(t: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every rank of `axis`'s row's `t` (one shape), in axis order."""
    if not initialized() or axis.size == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(out, t.contiguous(), group=axis.group)
    return out


class _GatherBlocks(torch.autograd.Function):
    """Every rank's block concatenated along `dim`; backward: this rank's
    block of the gradient."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return torch.cat(all_gather(t, axis), dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, ctx.dim)[ctx.axis.index], None, None


class _OwnBlock(torch.autograd.Function):
    """This rank's block along `dim`; backward: every rank's block of the
    gradient concatenated."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return t.chunk(axis.size, dim)[axis.index].clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g, ctx.axis), ctx.dim), None, None


def gather_blocks(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The whole tensor from each rank of `axis` holding block `axis.index`
    of it along `dim` (collective), for a consumer that runs whole and alike
    on every rank of the axis: each rank then holds the whole gradient,
    and the backward keeps this rank's block of it (no sum)."""
    return t if axis.size == 1 else _GatherBlocks.apply(t, axis, dim)


def own_block(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Block `axis.index` of `axis.size` of the whole tensor `t` (the same
    on every rank) along `dim`, for a consumer that runs on this rank's
    block alone: the backward gathers every rank's block of the gradient
    (collective), so `t`'s producer gets the whole gradient."""
    return t if axis.size == 1 else _OwnBlock.apply(t, axis, dim)


def ring_exchange(send: torch.Tensor, axis: Axis) -> Callable[[], torch.Tensor]:
    """Send `send` to the next rank of `axis`'s row and receive the
    previous rank's tensor of the same shape; returns a function that waits
    for both and returns the received tensor. The transfer overlaps with
    whatever runs before that call. Under gloo a CUDA tensor goes through
    pinned host buffers."""
    staged = send.is_cuda and backend() == "gloo"
    if staged:
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        host.copy_(send)
        out, recv = send, torch.empty_like(host, pin_memory=True)
        send = host
    else:
        recv = torch.empty_like(send)
    send = send.contiguous()
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, axis.next_rank(), axis.group),
                                   dist.P2POp(dist.irecv, recv, axis.prev_rank(), axis.group)])

    def wait() -> torch.Tensor:
        for req in reqs:
            req.wait()
        return recv.to(out.device, non_blocking=True) if staged else recv

    return wait


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def mean_over_ranks(local: Dict[str, float], device, axis: Optional[Axis] = None) -> Dict[str, float]:
    """Per-rank means averaged over `axis` (the data axis; default the
    whole world), keys reduced in sorted order (JAX's process_allgather of
    sorted keys; the reference's AVG all_reduce, common.py:80-102). Exact
    where every data rank saw as many items, as the loader's even shards
    make it; the seq and model ranks of a data rank hold its means
    already."""
    if not initialized():
        return dict(local)
    keys = sorted(local)
    vals = torch.tensor([local[k] for k in keys], dtype=torch.float64, device=device)
    all_reduce_(vals, axis or world_axis(), mean=True)
    return {k: float(v) for k, v in zip(keys, vals.tolist())}


def gather_ids(ids: np.ndarray, axis: Optional[Axis] = None) -> np.ndarray:
    """Every rank's ids along `axis` (the data axis; default the whole
    world), concatenated in its order."""
    if not initialized():
        return ids
    out = [None] * world()
    dist.all_gather_object(out, ids)
    return np.concatenate([out[r] for r in (axis or world_axis()).ranks])
