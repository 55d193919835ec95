"""ZeRO-1: the optimizer's moments sharded over the data axis (the JAX
package's parallel/zero.py).

JAX constrains each moment leaf to a data-axis sharding of one of its
axes (`_zero_spec`, zero.py:35) and lets XLA partition the update. Here the
unit is the parameter: each parameter belongs to one data rank (largest
first, to the rank that holds the fewest elements so far), which keeps its
AdamW moments and steps it with torch's own optimizer; then every owner
broadcasts its updated parameters over the data axis, one flat buffer per
owner. The gradients are whole on every rank before the step (the
trainer's all_reduce), so each parameter takes the update the unsharded
AdamW makes on the same gradient, bit for bit: the same optimizer class,
on the same device, with the same hyperparameters. Under tensor parallel
the parameters are the model rank's blocks of the layers the model axis
splits and the whole parameters of those it leaves whole (parallel/tp.py:
the same shapes on every model rank, so each data row partitions them
alike), and their moments shard over its data axis. The trainer's LambdaLR schedule steps the local optimizer
(`local`), whose learning rate is every rank's.

`full_state_dict` gathers the moments into the state_dict of one AdamW over
every parameter, in the model's parameter order (what a one-process run
saves), and `load_full_state_dict` keeps this rank's part of one: a
checkpoint is whole whatever the layout that wrote or reads it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from gta_tpu_torch.parallel import dist as pdist

MOMENTS = ("exp_avg", "exp_avg_sq")


def partition(sizes: List[int], n: int) -> List[int]:
    """The owner (0..n-1) of each of `sizes`' tensors: largest first, each
    to the owner with the fewest elements so far (the lowest on a tie)."""
    owner, load = [0] * len(sizes), [0] * n
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        o = min(range(n), key=lambda r: (load[r], r))
        owner[i] = o
        load[o] += sizes[i]
    return owner


class ZeroOptimizer:
    """`make_optimizer(params)` (torch AdamW or Adam) over this data rank's
    share of `params`; `step` updates them and broadcasts every owner's."""

    def __init__(self, params: List[torch.nn.Parameter], make_optimizer: Callable[[List], torch.optim.Optimizer],
                 axis: pdist.Axis):
        self.params = list(params)
        self.axis = axis
        self.owner = partition([p.numel() for p in self.params], axis.size)
        self.mine = [i for i, o in enumerate(self.owner) if o == axis.index]
        self.local = make_optimizer([self.params[i] for i in self.mine])

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Every parameter's gradient to None (the trainer's only use)."""
        for p in self.params:
            p.grad = None

    def _owned_by(self, o: int) -> List[int]:
        return [i for i, w in enumerate(self.owner) if w == o]

    def _broadcast(self, o: int, tensors: List[torch.Tensor]) -> None:
        """Owner `o`'s `tensors` (same shapes on every rank) on every rank
        of the data axis, as one flat buffer."""
        if not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        pdist.broadcast_(flat, self.axis.ranks[o], self.axis)
        n = 0
        for t in tensors:
            t.data.copy_(flat[n : n + t.numel()].view_as(t))
            n += t.numel()

    @torch.no_grad()
    def step(self) -> None:
        self.local.step()
        for o in range(self.axis.size):
            self._broadcast(o, [self.params[i] for i in self._owned_by(o)])

    def full_state_dict(self) -> Dict[str, Any]:
        """The state_dict of one optimizer over every parameter (collective
        over the data axis; every rank gets it)."""
        local = self.local.state_dict()
        group = dict(local["param_groups"][0], params=list(range(len(self.params))))
        if not local["state"]:  # before the first step
            return {"state": {}, "param_groups": [group]}
        state: Dict[int, Dict[str, torch.Tensor]] = {}
        step = next(iter(local["state"].values()))["step"]
        for o in range(self.axis.size):
            ids = self._owned_by(o)
            if o == self.axis.index:
                moments = [local["state"][j][m] for j in range(len(ids)) for m in MOMENTS]
            else:
                moments = [torch.empty_like(self.params[i], memory_format=torch.contiguous_format)
                           for i in ids for _ in MOMENTS]
            moments = [t.clone() for t in moments]
            self._broadcast(o, moments)
            for j, i in enumerate(ids):
                state[i] = {"step": step.clone(), **{m: moments[2 * j + k] for k, m in enumerate(MOMENTS)}}
        return {"state": dict(sorted(state.items())), "param_groups": [group]}

    def load_full_state_dict(self, full: Dict[str, Any]) -> None:
        """Keep this rank's part of the state_dict of one optimizer over
        every parameter."""
        group = dict(full["param_groups"][0], params=list(range(len(self.mine))))
        state = {j: dict(full["state"][i]) for j, i in enumerate(self.mine) if i in full["state"]}
        self.local.load_state_dict({"state": state, "param_groups": [group]})
