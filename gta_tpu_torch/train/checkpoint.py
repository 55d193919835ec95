"""Checkpoints with the reference's {rolling, backup, best} triple.

Layout under <out_dir>/ckpts/:
  latest/   rolling checkpoint (reference model.pt, train.py:307-308)
  step_N/   iteration-stamped backups (model_<it>.pt, train.py:312-313)
  best/     best-validation-metric model (model_best.pt, train.py:338)

Each holds `state.pt`, the Trainer's state (model, optimizer, schedule,
seed, step) as one torch file, and `scalars.json` (epoch_it / it / t /
loss_val_best / run_id, reference train.py:301-305). A save writes a
temporary file and renames it, so a checkpoint is whole or absent. Only a
save creates directories: restoring and `exists` leave the disk as it is.

In a process group (parallel/dist.py) every rank calls `save`, which
gathers the whole state (`Trainer.state_dict`: the model ranks' blocks and
the data ranks' AdamW moments under tensor parallel and ZeRO-1, so a
checkpoint is what one process saves, whatever the layout); only rank 0
writes (gta_tpu/train/checkpoint.py:38 writes scalars on process 0 only),
and every rank waits at a barrier until the files are whole, so no rank
restores a save still being written. Every rank restores the same files
and keeps its part of them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from gta_tpu_torch.parallel import dist as pdist


class Checkpointer:
    def __init__(self, out_dir: str):
        self.root = os.path.abspath(os.path.join(out_dir, "ckpts"))

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def save(self, name: str, trainer, scalars: Optional[Dict[str, Any]] = None) -> None:
        """Write checkpoint `name` (rank 0; every rank gathers the state
        with it and waits for the files)."""
        state = trainer.state_dict()
        if pdist.is_main():
            path = self._path(name)
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, "state.pt.tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(path, "state.pt"))
            if scalars is not None:
                with open(os.path.join(path, "scalars.json"), "w") as f:
                    json.dump(scalars, f)
        pdist.barrier()

    def restore(self, name: str, trainer) -> Dict[str, Any]:
        """Load checkpoint `name` into `trainer`; returns its scalars."""
        path = self._path(name)
        trainer.load_state_dict(torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True))
        sp = os.path.join(path, "scalars.json")
        if not os.path.exists(sp):
            return {}
        with open(sp) as f:
            return json.load(f)

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self._path(name), "state.pt"))

    def try_restore_latest(self, trainer, max_it: Optional[int] = None) -> Tuple[bool, Dict[str, Any]]:
        """Auto-resume: prefer the final backup, else the rolling checkpoint
        (reference train.py:221-235). Returns (restored, scalars)."""
        if max_it is not None and self.exists(f"step_{max_it}"):
            return True, self.restore(f"step_{max_it}", trainer)
        if self.exists("latest"):
            return True, self.restore("latest", trainer)
        return False, {}
