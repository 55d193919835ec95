"""The model's FLOPs (the plain reference's count, portbench/cost) of the
traced steps over their unprofiled time at the chip's peak, in %."""

from portbench.trace import mfu


def read(w):
    return mfu(w)
