"""K5's share of its roofline in serving: the least time of a launch
(its distinct gathered rows, weights, ids and output at the memory
rate, and 2 * rows * F * H at the TF32 rate) over its mean device time,
the small kernel that splits w for it counted in. K5 is the port's
fused gather -> MLP -> mean pool (``ops/pool.py``,
``gather_mlp_pool.cu``, ``want_x`` 0)."""

import re

from port_bench import counts

KERNEL = re.compile(r"gather_mlp_pool_kernel<[^<>]*false>")
SPLIT = re.compile(r"split_w_kernel")


def read(view):
    cfg = view.info["cfg"]
    f, h = cfg["feature_dim"], cfg["pool_hidden"]
    return view.roofline_share(
        view.matching(KERNEL), view.matching(SPLIT),
        lambda idx: counts.least_seconds(
            counts.gather_pool_bytes(idx, f, h, residual=False),
            counts.gather_pool_flops(idx, f, h)))
