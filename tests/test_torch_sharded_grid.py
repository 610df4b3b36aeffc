"""The port's sharded stack at four ranks and at one, against the JAX
package: ``exchange_gather`` at D = 4 in both layouts, and the composed
2 x 2 data x graph grid's chunk runner (one group of four gloo processes,
joined within 120 s); and, in this process over a one-rank gloo group,
the sharded runner and sweep at D = 1 against the port's single-device
ones, bit for bit.

Tolerances as in ``test_torch_sharded.py``: rows and dropped counts
equal; the runner's last loss rtol 1e-5, params rtol 2e-4 / atol 1e-6
where Adam resolves the gradient, ids and dropped counts equal,
replicated params bit-equal across ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from graphsage_tpu.models import supervised as js
from graphsage_tpu.parallel import graph_sharded as jgs
from graphsage_tpu_torch.models import supervised as ts
from graphsage_tpu_torch.parallel import dp as tdp
from graphsage_tpu_torch.parallel import graph_sharded as tgs
from graphsage_tpu_torch.parallel.distributed import make_grid
from graphsage_tpu_torch.train import supervised as tsup
from tests._torch_common import run_rank_checks
from tests.test_torch_sharded import (
    B,
    CAP_FACTOR,
    LR,
    assert_params_close,
    configs,
    exchange_inputs,
    ids_stream,
    jax_exchanges,
    mesh_of,
    np_params,
    root_second_moment,
    toy,  # noqa: F401  (the module fixture)
    train_job,
)

D4_CASES = [("strided", True, False, 5), ("strided", False, False, 23),
            ("block", False, False, 5), ("block", True, True, 23)]
N_STEPS = 3


def jax_composed(toy, ids_perm):
    """JAX's chunk runner over a (2, 2) ("data", "graph") mesh."""
    g, feats, adj, labels_table = toy
    jcfg, _ = configs(g.num_nodes)
    params = js.init_supervised_params(jax.random.key(0), jcfg)
    init = np_params(params)
    optimizer = js.make_optimizer(LR)
    opt = optimizer.init(params)
    run = jgs.make_sharded_supervised_chunk_runner(
        jcfg, optimizer, mesh_of(4, ("data", "graph")), B,
        capacity_factor=CAP_FACTOR, params_like=params, opt_state_like=opt,
        data_axis="data")
    p, o, loss, _, last_ids, dropped = run(
        params, opt, jax.random.key(7),
        jnp.asarray(jgs.shard_rows(feats, 2)[0]),
        jnp.asarray(jgs.shard_rows(adj, 2)[0]), jnp.asarray(ids_perm),
        jnp.asarray(labels_table), 0, N_STEPS)
    return init, (np_params(p), float(loss), np.asarray(last_ids),
                  int(dropped), root_second_moment(o, 2, g.num_nodes + 1))


@pytest.fixture(scope="module")
def group4(toy, tmp_path_factory):  # noqa: F811
    table, _, _ = exchange_inputs()
    idx = np.random.default_rng(4).integers(0, 37, (4, 19)).astype(np.int32)
    idx[:, :7] = 5      # one owner's bucket overflows capacity 5
    jobs, ref = {}, {}
    exchanged = jax_exchanges(table, idx, 4, D4_CASES)
    for case in D4_CASES:
        layout, split, remote, cap = case
        jobs[case] = dict(kind="exchange", grid=(4, 1), table=table, idx=idx,
                          capacity=cap, split_local=split,
                          remote_only=remote, layout=layout)
        ref[case] = exchanged[case]
    ids_perm = ids_stream(toy[0], N_STEPS, 6)
    init, ref["grid"] = jax_composed(toy, ids_perm)
    job = train_job(toy, "mean_split", N_STEPS, ids_perm, init)
    jobs["grid"] = dict(job, grid=(2, 2))
    return ref, run_rank_checks(jobs, 4, tmp_path_factory.mktemp("grid"))


@pytest.mark.parametrize("case", D4_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_exchange_gather_at_four_ranks_matches_jax(group4, case):
    ref, ranks = group4
    rows, dropped = ref[case]
    for r in range(4):
        np.testing.assert_array_equal(ranks[r][case]["rows"], rows[r])
        assert ranks[r][case]["dropped"] == dropped[r]


def test_composed_grid_runner_matches_jax(group4):
    ref, ranks = group4
    jparams, jloss, jids, jdropped, root_nu = ref["grid"]
    outs = [ranks[r]["grid"] for r in range(4)]
    np.testing.assert_allclose(outs[0]["chunks"][-1]["loss"], jloss,
                               rtol=1e-5)
    # data-major: rank d * 2 + g holds rows (d * 2 + g) * B/4 of the batch
    np.testing.assert_array_equal(
        np.concatenate([o["chunks"][-1]["ids"] for o in outs]), jids)
    assert outs[0]["chunks"][-1]["dropped"] == jdropped == 0
    assert_params_close(outs[0]["params"], jparams, root_nu, N_STEPS)
    for o in outs[1:]:
        for k, v in outs[0]["params"].items():
            np.testing.assert_array_equal(o["params"][k], v)


@pytest.fixture()
def one_rank(tmp_path):
    """A one-rank gloo group in this process, for the length of a test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_grid(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("identity_dim", [0, 4])
def test_one_shard_runner_equals_the_single_device_runner(
        toy, one_rank, identity_dim):  # noqa: F811
    """At D = 1 the exchange is a plain take and the sums reduce one rank:
    the sharded runner's losses and params equal the single-device
    runner's bit for bit. With an identity table they agree to float
    rounding: its gradient adds the hops' contributions in another order
    (the sharded path gathers the frontiers' rows before the inner hop's,
    the single-device path after)."""
    g, feats, adj, labels_table = toy
    _, tcfg = configs(g.num_nodes, identity_dim=identity_dim)
    ids_perm = torch.from_numpy(ids_stream(g, N_STEPS, 5))
    out = []
    for sharded in (False, True):
        params = ts.init_supervised_params(torch.Generator().manual_seed(0),
                                           tcfg)
        optimizer = ts.make_optimizer(LR)
        opt_state = optimizer.init(params)
        if sharded:
            run = tgs.make_sharded_supervised_chunk_runner(
                tcfg, optimizer, one_rank, B, capacity_factor=CAP_FACTOR)
        else:
            run = tdp.make_supervised_chunk_runner(tcfg, optimizer, B)
        losses = []
        for step in range(N_STEPS):
            res = run(params, opt_state, torch.Generator(), torch.from_numpy(
                feats), torch.from_numpy(adj), ids_perm,
                torch.from_numpy(labels_table), step, 1)
            losses.append(float(res[2]))
        out.append((losses, {k: v.detach().clone() for k, v in
                             params.items()}))
    if identity_dim == 0:
        assert out[0][0] == out[1][0]
        for k, v in out[0][1].items():
            assert torch.equal(v, out[1][1][k]), k
    else:
        np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
        for k, v in out[0][1].items():
            np.testing.assert_allclose(out[1][1][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_one_shard_sweep_equals_the_single_device_sweep(
        toy, one_rank):  # noqa: F811
    """The sharded eval sweep at D = 1, shared_perm sampling from the same
    seed: the single-device sweep's losses and predictions, bit for
    bit."""
    import dataclasses

    g, feats, adj, labels_table = toy
    _, tcfg = configs(g.num_nodes)
    tcfg = dataclasses.replace(tcfg, sage=dataclasses.replace(
        tcfg.sage, sampler_mode="shared_perm"))
    params = ts.init_supervised_params(torch.Generator().manual_seed(2), tcfg)
    ids_all = torch.from_numpy(np.arange(3 * B, dtype=np.int32) + 3)
    table = torch.from_numpy(labels_table)
    f, a = torch.from_numpy(feats), torch.from_numpy(adj)
    losses1, preds1 = tsup.make_eval_sweep(tcfg, B, g.num_nodes)(
        params, f, a, ids_all, table, torch.Generator().manual_seed(5))
    losses2, preds2, dropped = tgs.make_sharded_supervised_eval_sweep(
        tcfg, one_rank, B, capacity_factor=CAP_FACTOR)(
            params, f, a, ids_all, table, torch.Generator().manual_seed(5))
    assert torch.equal(losses1, losses2)
    assert torch.equal(preds1, preds2)
    assert int(dropped) == 0

