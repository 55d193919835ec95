"""The device's idle share of the traced window: 1 - (union of kernel
intervals) / window, in %."""

from portbench.trace import idle_share


def read(w):
    return idle_share(w)
