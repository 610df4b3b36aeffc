"""The unsupervised sharded stack at one rank (a one-rank gloo group in
this process) against the port's single-device functions, bit for bit:
the sharded runner (with and without weight decay) and the
data-parallel runner against ``make_unsupervised_chunk_runner`` under
first_k, the sharded eval, eval sweep and embed sweep against
``make_unsup_eval_step``, ``make_unsup_eval_sweep`` and
``embed_all_nodes`` under shared_perm with the same sampler seed. At
one rank the exchange is a plain take, every sum reduces one rank, and
the negatives' draw [steps, 1, n_neg] is the single-device [steps,
n_neg] one.

With an identity table the sharded runner agrees to float rounding
only (the hops' gradients add in another order,
``tests/test_torch_sharded_grid.py``): rtol 1e-5 / atol 1e-7.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graphsage_tpu_torch.models import supervised as ts
from graphsage_tpu_torch.models import unsupervised as tu
from graphsage_tpu_torch.nn.negative import (
    negatives_from_uniforms,
    unigram_cdf,
)
from graphsage_tpu_torch.parallel import dp as tdp
from graphsage_tpu_torch.parallel import graph_sharded as tgs
from graphsage_tpu_torch.train import unsupervised as tun
from tests.test_torch_sharded_grid import one_rank  # noqa: F401
from tests.test_torch_unsup_sharded import (
    B,
    CAP_FACTOR,
    LR,
    N_NEG,
    configs,
    pair_stream,
    toy,  # noqa: F401  (the module fixture)
    val_inputs,
)

N_STEPS = 4


def shared_perm(tcfg):
    return dataclasses.replace(tcfg, sage=dataclasses.replace(
        tcfg.sage, sampler_mode="shared_perm"))


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("runner,identity_dim,weight_decay", [
    ("sharded", 0, 0.0), ("sharded", 0, 0.01), ("sharded", 4, 0.01),
    ("dp", 0, 0.01)])
def test_one_rank_runner_equals_the_single_device_runner(
        toy, one_rank, runner, identity_dim, weight_decay):  # noqa: F811
    g, feats, adj, _, deg = toy
    _, tcfg = configs(g.num_nodes, identity_dim, weight_decay)
    pairs = t(pair_stream(g, deg, N_STEPS, n_dummy=5))
    u = np.random.default_rng(4).random((N_STEPS, 1, N_NEG),
                                        dtype=np.float32)
    cdf = torch.from_numpy(unigram_cdf(deg))
    negs = negatives_from_uniforms(cdf, t(u))
    out = []
    for which in ("single", runner):
        params = tu.init_unsupervised_params(
            torch.Generator().manual_seed(0), tcfg)
        optimizer = ts.make_optimizer(LR)
        opt_state = optimizer.init(params)
        if which == "single":
            run = tdp.make_unsupervised_chunk_runner(tcfg, optimizer, B)
            step_negs = negs[:, 0]      # [steps, n_neg], the same draw
        elif which == "sharded":
            run = tgs.make_sharded_unsupervised_chunk_runner(
                tcfg, optimizer, one_rank, B, capacity_factor=CAP_FACTOR)
            step_negs = negs
        else:
            run = tdp.make_dp_unsupervised_chunk_runner(tcfg, optimizer,
                                                        one_rank, B)
            step_negs = negs[:, 0]
        shadow, values = torch.tensor(-1.0), []
        for step in range(N_STEPS):
            res = run(params, opt_state, shadow, torch.Generator(),
                      t(feats), t(adj), pairs, step_negs, step, 1)
            params, opt_state, shadow = res[0], res[1], res[2]
            values.append((float(res[3]), float(res[4]), float(shadow)))
            if which == "sharded":
                assert int(res[5]) == 0
        out.append((values, {k: v.detach().clone()
                             for k, v in params.items()}))
    (single, p1), (sharded, p2) = out
    if identity_dim == 0:
        assert sharded == single
        for k, v in p1.items():
            assert torch.equal(v, p2[k]), k
    else:
        np.testing.assert_allclose(sharded, single, rtol=1e-6)
        for k, v in p1.items():
            np.testing.assert_allclose(p2[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_one_rank_evaluations_equal_the_single_device_ones(
        toy, one_rank):  # noqa: F811
    """The eval of one batch, the eval sweep over every val pair and the
    embed sweep over every node, under shared_perm: the single-device
    values and rows, bit for bit."""
    g, feats, _, full_adj, deg = toy
    _, tcfg = configs(g.num_nodes, weight_decay=0.01)
    tcfg = shared_perm(tcfg)
    params = tu.init_unsupervised_params(torch.Generator().manual_seed(3),
                                         tcfg)
    batch, pairs_all, val_negs = val_inputs(toy)
    negs = t(val_negs[:1])
    f, a = t(feats), t(full_adj)

    def gen():
        return torch.Generator().manual_seed(5)

    want = tun.make_unsup_eval_step(tcfg)(
        params, f, a, *(t(x) for x in batch), negs[0], gen())
    got = tgs.make_sharded_unsupervised_eval(tcfg, one_rank)(
        params, f, a, *(t(x) for x in batch), negs, gen())
    assert [float(x) for x in got[:2]] == [float(x) for x in want]
    assert int(got[2]) == 0

    want = tun.make_unsup_eval_sweep(tcfg, B)(params, f, a, t(pairs_all),
                                              negs[0], gen())
    got = tgs.make_sharded_unsup_eval_sweep(tcfg, one_rank, B)(
        params, f, a, t(pairs_all), negs, gen())
    assert [float(x) for x in got[:2]] == [float(x) for x in want]
    assert int(got[2]) == 0

    want = tun.embed_all_nodes(tcfg, B, params, f, a, seed=5)
    got, dropped = tun.sharded_embed_all_nodes(tcfg, one_rank, B, params, f,
                                               a, 5, CAP_FACTOR)
    np.testing.assert_array_equal(got, want)
    assert int(dropped) == 0
