"""Device ms per training step of kernels that are not this repo's
attention, a GEMM, a convolution or a copy (portbench/kinds: "other")."""

from portbench.kinds import kind
from portbench.trace import seconds_by


def read(w):
    if not w.kernels:
        return None
    return 1e3 * seconds_by(w.kernels, kind).get("other", 0.0) / w.steps
