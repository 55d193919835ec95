"""The fused GTA kernels' share of their roofline over a training step's
forward and backward attention calls, in % (portbench/trace.roofline)."""

from portbench.trace import roofline


def read(w):
    return roofline(w)
