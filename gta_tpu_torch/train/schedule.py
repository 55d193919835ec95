"""LR schedule: linear warmup then exponential decay.

lr(it) = peak * it/peak_it                            (it < peak_it)
       = peak * decay_rate^((it-peak_it)/decay_it)    otherwise
(reference train.py:22-35; decay_rate 0.16). The step `it` is the count of
optimizer steps taken before the one the rate is for, so the first step
under warmup has lr 0, as optax reads its schedule.
"""

from __future__ import annotations


def warmup_exp_decay(peak_lr: float, peak_it: int, decay_it: int, decay_rate: float = 0.16):
    def schedule(it: int) -> float:
        if it < peak_it:
            return peak_lr * it / max(peak_it, 1)
        return peak_lr * decay_rate ** ((it - peak_it) / decay_it)

    return schedule
