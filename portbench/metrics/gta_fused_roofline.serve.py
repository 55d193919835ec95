"""The fused GTA kernels' share of their roofline over a render call's
attention forwards, in % (portbench/trace.roofline)."""

from portbench.trace import roofline


def read(w):
    return roofline(w)
