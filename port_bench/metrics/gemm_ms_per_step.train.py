"""Device milliseconds a training step in the dense products: the
kernels whose names are cuBLAS's or CUTLASS's matrix products (the
aggregators' projections, the head, the pooling MLP's outer hop and
the backward's products of ``ops/pool.py``'s Function), over the traced
span's steps."""

import re

GEMM = re.compile(r"gemm|xmma|cutlass|cublas|splitKreduce", re.IGNORECASE)


def read(view):
    if not view.units:
        return None
    return sum(o.dur for o in view.matching(GEMM)) / 1e3 / view.units
