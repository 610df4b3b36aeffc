"""K6's share of its roofline in training: the least time of a launch
(``counts.least_seconds`` of its distinct gathered rows, weights, ids,
output and residual at the memory rate, and 2 * rows * F * H at the
TF32 rate) over its mean device time, the small kernel that splits w
for it counted in. K6 is the port's fused gather -> MLP -> mean pool
writing the backward's residual (``ops/pool.py``,
``gather_mlp_pool.cu``, ``want_x`` 1)."""

import re

from port_bench import counts

KERNEL = re.compile(r"gather_mlp_pool_kernel<[^<>]*true>")
SPLIT = re.compile(r"split_w_kernel")


def read(view):
    cfg = view.info["cfg"]
    f, h = cfg["feature_dim"], cfg["pool_hidden"]
    return view.roofline_share(
        view.matching(KERNEL), view.matching(SPLIT),
        lambda idx: counts.least_seconds(
            counts.gather_pool_bytes(idx, f, h, residual=True),
            counts.gather_pool_flops(idx, f, h)))
