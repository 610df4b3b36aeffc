"""K1's share of its roofline in the whole-graph sweep: the least time
of a launch (its distinct gathered rows, ids and [B, F] f32 output at
the memory rate) over its mean device time. K1 is the port's fused
gather-mean of the innermost hop (``ops/gather.py``,
``gather_mean.cu``, ``gather_mean_kernel<T, VEC, false>``)."""

import re

from port_bench import counts

KERNEL = re.compile(r"gather_mean_kernel<[^<>]*false>")


def read(view):
    f = view.info["cfg"]["feature_dim"]
    return view.roofline_share(
        view.matching(KERNEL), [],
        lambda idx: counts.least_seconds(counts.gather_mean_bytes(idx, f)))
