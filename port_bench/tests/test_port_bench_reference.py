"""The yardstick itself: the reference's mean-concat and meanpool
aggregators, and their gradients, against the numbers the reference TF1
code produced (``tests/fixtures/reference_traced.npz``, cases
``agg_mean_concat`` and ``agg_meanpool``: relu, concat, the loss 0.5 *
sum(out^2)). Read only; neither JAX nor the port is involved."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import spec
from port_bench.reference import sage

FIXTURE = spec.ROOT / "tests" / "fixtures" / "reference_traced.npz"
NAMES = {"neigh_weights": "neigh_w", "self_weights": "self_w",
         "mlp0_weights": "mlp.0.w", "mlp0_bias": "mlp.0.b"}


@pytest.mark.parametrize("case,aggregator", [("agg_mean_concat", "mean"),
                                             ("agg_meanpool", "meanpool")])
def test_aggregator_matches_the_tf1_trace(case, aggregator):
    fix = np.load(FIXTURE)

    def get(name):
        return torch.from_numpy(fix[f"{case}/{name}"].astype(np.float64))

    params = {f"aggs.0.{ours}": get(f"var_{tf}").requires_grad_(True)
              for tf, ours in NAMES.items() if f"{case}/var_{tf}" in fix}
    self_rows = get("self_vecs").requires_grad_(True)
    neigh = get("neigh_vecs").requires_grad_(True)
    cfg = {"aggregator": aggregator}
    out = sage._aggregate(cfg, params, 0, self_rows, neigh, last=False)
    (0.5 * (out * out).sum()).backward()
    close = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), fix[f"{case}/out"],
                               **close)
    np.testing.assert_allclose(self_rows.grad.numpy(),
                               fix[f"{case}/grad_self"], **close)
    np.testing.assert_allclose(neigh.grad.numpy(), fix[f"{case}/grad_neigh"],
                               **close)
    for tf, ours in NAMES.items():
        if f"{case}/grad_{tf}" in fix:
            np.testing.assert_allclose(params[f"aggs.0.{ours}"].grad.numpy(),
                                       fix[f"{case}/grad_{tf}"], **close)
