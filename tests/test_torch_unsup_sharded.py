"""The port's unsupervised sharded stack against the JAX package's
``parallel/graph_sharded.py`` and ``parallel/dp.py`` under ``shard_map``
on the conftest's virtual CPU devices: at two ranks (``--graph_shards
2``, with and without an identity table, and ``--data_shards 2``) and
on the 2 x 2 data x graph grid (four ranks).

One group of two gloo processes and one of four
(``parallel/launch.py::check_rank``, each joined within 120 s) run
every port job once per module; each test reads its part. Inputs come
from seeded NumPy, the weights cross through the bridge, sampling is
first_k and dropout 0, so nothing random is drawn. Each rank's
negatives are handed to JAX by patching ``sample_negatives``: it
returns the row of its ``cdf`` argument (the negatives, passed in
where the CDF goes) that the rank's composed index picks, found with
``jax.lax.axis_index``. The patch cannot see the step inside JAX's
``fori_loop``, so JAX's runners take one step per call, each with its
step's negatives, and every step is compared. No negative is a pair's
target: a positive tied with a negative may round either way in the
two packages' products.

Tolerances (``tests/test_torch_sharded.py``'s): every step's loss rtol
1e-5, its MRR and EMA 1e-6 (the ranks are exact; only the division
rounds), params rtol 2e-4 / atol 1e-6 where Adam resolves the gradient
(``assert_params_close``), the replicated params bit-equal across the
ranks, nothing dropped; the eval, the eval sweep and the embed sweep
rtol 1e-5 (the split mean sums in another order); the 2 x 2 eval sweep
within 1e-6 of the 1 x 2 one (the same rows, ranks and negatives, its
sums reduced in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu.models import unsupervised as ju
from graphsage_tpu.nn import negative as jneg
from graphsage_tpu.parallel import dp as jdp
from graphsage_tpu.parallel import graph_sharded as jgs
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.synthetic import make_synthetic_graph
from graphsage_tpu_torch.models import graphsage as tg
from graphsage_tpu_torch.models import unsupervised as tu
from graphsage_tpu_torch.nn.negative import unigram_cdf
from tests._torch_common import run_rank_checks
from tests.test_torch_sharded import (
    assert_params_close,
    mesh_of,
    np_params,
    root_second_moment,
)

B, N_NEG, LR, CAP_FACTOR = 16, 4, 0.01, 4.0
N_STEPS = 3
# name: (identity_dim, runner, grid = (graph_shards, data_shards))
TRAIN_CASES = {
    "d2": (0, "sharded", (2, 1)),
    "d2_identity": (4, "sharded", (2, 1)),
    "dp": (0, "dp", (1, 2)),
    "grid": (0, "sharded", (2, 2)),
}


def configs(num_nodes, identity_dim=0, weight_decay=0.01):
    kw = dict(feature_dim=8, aggregator="mean", concat=True,
              identity_dim=identity_dim, num_nodes=num_nodes,
              sampler_mode="first_k", fused_gather=True,
              shard_layout="strided")
    layers = ((4, 8), (3, 8))
    jcfg = ju.UnsupervisedConfig(sage=jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(*li) for li in layers), **kw),
        neg_sample_size=N_NEG, weight_decay=weight_decay)
    tcfg = tu.UnsupervisedConfig(sage=tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(*li) for li in layers), **kw),
        weight_decay=weight_decay)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def toy():
    """(graph, padded features, train adjacency, full adjacency, train
    degrees)."""
    g = make_synthetic_graph(num_nodes=120, num_classes=4, feat_dim=8,
                             seed=7)
    train_adj, deg, full_adj = build_both_adjs(g, 8, seed=1)
    return g, g.padded_features(), train_adj, full_adj, deg


def pair_stream(g, deg, n_steps, n_dummy, seed=3):
    """n_steps batches of B train edges, the last ``n_dummy`` the dummy
    pair: with n_dummy > B/2 the second rank's slice of the last batch
    is all padding at two ranks."""
    rng = np.random.default_rng(seed)
    edges = g.edges[(deg[g.edges[:, 0]] > 0) & (deg[g.edges[:, 1]] > 0)]
    pairs = np.full((n_steps * B, 2), g.num_nodes, dtype=np.int32)
    k = n_steps * B - n_dummy
    pairs[:k] = edges[rng.permutation(len(edges))[:k]]
    return pairs


def negatives(deg, targets, shape, seed):
    """Negative ids of ``shape`` from the unigram CDF of the nodes that
    are no pair's target."""
    neg_deg = deg.copy()
    neg_deg[targets[targets < len(deg)]] = 0
    cdf = unigram_cdf(neg_deg)
    u = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return np.clip(np.searchsorted(cdf, u), 0, len(cdf) - 1).astype(np.int32)


def rank_row(data_axis):
    """The patched ``sample_negatives``: the row of the negatives that
    the rank's composed index (data-major) picks."""
    def pick(rng, cdf, n):
        me = jax.lax.axis_index("graph")
        if data_axis:
            me = jax.lax.axis_index(data_axis) * jax.lax.axis_size(
                "graph") + me
        return cdf[me]
    return pick


def jax_train(toy, name, pairs, negs, mp):
    """JAX's runner one step per call: (init params, every step's (loss,
    mrr, ema), final params canonical, sqrt of Adam's nu, dropped)."""
    g, feats, adj, _, _ = toy
    id_dim, runner, (Dg, Dd) = TRAIN_CASES[name]
    jcfg, _ = configs(g.num_nodes, id_dim)
    params = ju.init_unsupervised_params(jax.random.key(0), jcfg)
    init = np_params(params)
    optimizer = js.make_optimizer(LR)
    shadow = jnp.asarray(-1.0)
    steps, dropped = [], 0
    if runner == "dp":
        mp.setattr(jneg, "sample_negatives", lambda rng, cdf, n: cdf)
        run = jdp.make_dp_unsupervised_chunk_runner(
            jcfg, optimizer, mesh_of(Dd, ("data",)), B)
        opt = optimizer.init(params)
        for i in range(N_STEPS):
            params, opt, shadow, loss, mrr = run(
                params, opt, shadow, jax.random.key(7), jnp.asarray(feats),
                jnp.asarray(adj), jnp.asarray(pairs), jnp.asarray(negs[i]),
                i, 1)
            steps.append((float(loss), float(mrr), float(shadow)))
        return (init, steps, np_params(params),
                root_second_moment(opt, 1, g.num_nodes + 1), 0)
    mp.setattr(jneg, "sample_negatives",
               rank_row("data" if Dd > 1 else None))
    psh = dict(params)
    if id_dim:
        psh["embeds"] = jnp.asarray(
            jgs.shard_rows(np.asarray(params["embeds"]), Dg)[0])
    opt = optimizer.init(psh)
    mesh = mesh_of(Dg * Dd, ("data", "graph")) if Dd > 1 else mesh_of(Dg)
    run = jgs.make_sharded_unsupervised_chunk_runner(
        jcfg, optimizer, mesh, B, capacity_factor=CAP_FACTOR,
        params_like=psh, opt_state_like=opt,
        data_axis="data" if Dd > 1 else None)
    f = jnp.asarray(jgs.shard_rows(feats, Dg)[0])
    a = jnp.asarray(jgs.shard_rows(adj, Dg)[0])
    for i in range(N_STEPS):
        psh, opt, shadow, loss, mrr, d = run(
            psh, opt, shadow, jax.random.key(7), f, a, jnp.asarray(pairs),
            jnp.asarray(negs[i]), i, 1)
        steps.append((float(loss), float(mrr), float(shadow)))
        dropped += int(d)
    p = jgs.embeds_to_canonical(psh, Dg, "strided")
    if id_dim:
        p = dict(p, embeds=np.asarray(p["embeds"])[:g.num_nodes + 1])
    return (init, steps, np_params(p),
            root_second_moment(opt, Dg, g.num_nodes + 1), dropped)


def jax_evals(toy, params, data_axis, batch, val_negs, pairs_all, mp):
    """JAX's sharded eval (1-D), eval sweep and embed sweep over a
    ``(2,)`` graph mesh or a ``(2, 2)`` data x graph mesh, each graph
    rank's negatives its row of ``val_negs``."""
    g, feats, _, adj, _ = toy
    jcfg, _ = configs(g.num_nodes)
    mp.setattr(jneg, "sample_negatives", lambda rng, cdf, n: cdf[
        jax.lax.axis_index("graph")])
    mesh = mesh_of(4, ("data", "graph")) if data_axis else mesh_of(2)
    f = jnp.asarray(jgs.shard_rows(feats, 2)[0])
    a = jnp.asarray(jgs.shard_rows(adj, 2)[0])
    out = {}
    if not data_axis:
        loss, mrr, d = jgs.make_sharded_unsupervised_eval(
            jcfg, mesh, capacity_factor=CAP_FACTOR)(
                params, f, a, *(jnp.asarray(x) for x in batch),
                jnp.asarray(val_negs), jax.random.key(1))
        out["eval"] = (float(loss), float(mrr), int(d))
    loss, mrr, d = jgs.make_sharded_unsup_eval_sweep(
        jcfg, mesh, B, capacity_factor=CAP_FACTOR, data_axis=data_axis)(
            params, f, a, jnp.asarray(pairs_all), jnp.asarray(val_negs),
            jax.random.key(1))
    out["sweep"] = (float(loss), float(mrr), int(d))
    n_b = -(-g.num_nodes // B)
    ids = np.full(n_b * B, g.num_nodes, np.int32)
    ids[:g.num_nodes] = np.arange(g.num_nodes)
    rows, d = jgs.make_sharded_embed_sweep(
        jcfg, mesh, B, capacity_factor=CAP_FACTOR, data_axis=data_axis)(
            params, f, a, jnp.asarray(ids), jax.random.key(1))
    total = 4 if data_axis else 2
    out["embed"] = jgs.reassemble_sharded_rows(
        np.asarray(rows), total, n_b)[:g.num_nodes]
    out["embed_dropped"] = int(d)
    return out


def val_inputs(toy):
    """A val batch (b1, b2, mask) of 13 real pairs, the val pairs padded
    to whole batches, and one set of negatives per graph rank."""
    g, _, _, _, deg = toy
    val = g.edges[g.train_removed].astype(np.int32)
    n_b = -(-len(val) // B)
    pairs_all = np.full((n_b * B, 2), g.num_nodes, np.int32)
    pairs_all[:len(val)] = val
    b1 = np.full(B, g.num_nodes, np.int32)
    b2 = np.full(B, g.num_nodes, np.int32)
    b1[:13], b2[:13] = val[:13, 0], val[:13, 1]
    mask = (b1 != g.num_nodes).astype(np.float32)
    val_negs = negatives(deg, val[:, 1], (2, N_NEG), seed=5)
    return (b1, b2, mask), pairs_all, val_negs


@pytest.fixture(scope="module")
def groups(toy, tmp_path_factory):
    """Every job's JAX reference and the port's per-rank outputs of the
    two-rank and the four-rank group."""
    g, feats, adj, full_adj, deg = toy
    pairs = pair_stream(g, deg, N_STEPS, n_dummy=10)
    jobs = {2: {}, 4: {}}
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (id_dim, runner, grid) in TRAIN_CASES.items():
            total = grid[0] * grid[1]
            shape = ((N_STEPS, N_NEG) if runner == "dp"
                     else (N_STEPS, total, N_NEG))
            negs = negatives(deg, pairs[:, 1], shape, seed=11)
            init, steps, final, root_nu, dropped = jax_train(
                toy, name, pairs, negs, mp)
            _, tcfg = configs(g.num_nodes, id_dim)
            jobs[total][name] = dict(
                kind="unsup_train", grid=grid, runner=runner,
                unsup_config=tcfg, params=init, features=feats, adj=adj,
                pairs_perm=pairs, neg_ids=negs, batch_size=B, lr=LR,
                capacity_factor=CAP_FACTOR,
                chunks=[(i, 1) for i in range(N_STEPS)])
            ref[name] = (steps, final, root_nu, dropped)

        # the evaluations: params with an untrained identity-free model
        jcfg, tcfg = configs(g.num_nodes)
        params = ju.init_unsupervised_params(jax.random.key(3), jcfg)
        batch, pairs_all, val_negs = val_inputs(toy)
        for total, data_axis in ((2, None), (4, "data")):
            ref[f"eval{total}"] = jax_evals(toy, params, data_axis, batch,
                                            val_negs, pairs_all, mp)
            jobs[total][f"eval{total}"] = dict(
                kind="unsup_eval", grid=(2, total // 2), unsup_config=tcfg,
                params=np_params(params), features=feats, adj=full_adj,
                val_negs=val_negs, pairs=pairs_all, embed=True,
                batch_size=B, capacity_factor=CAP_FACTOR, seed=1,
                **({"batch": batch} if total == 2 else {}))

        # _global_masked_mrr: rank 1's slice all padding
        rr = np.random.default_rng(2).uniform(0.1, 1.0, (2, 8)).astype(
            np.float32)
        mask = np.ones((2, 8), np.float32)
        mask[0, 5:] = 0.0
        mask[1] = 0.0
        jobs[2]["mrr"] = dict(kind="masked_mrr", grid=(2, 1), rr=rr,
                              mask=mask)
        per_rank = (rr * mask).sum(1) / np.maximum(mask.sum(1), 1.0)
        f = shard_map(
            lambda m, k: jgs._global_masked_mrr(m[0], k, "graph").reshape(
                1),
            mesh=mesh_of(2), in_specs=(P("graph"), P("graph")),
            out_specs=P("graph"), check_vma=False)
        ref["mrr"] = (np.asarray(f(jnp.asarray(per_rank),
                                   jnp.asarray(mask.reshape(-1)))),
                      float(per_rank.mean()))

    ranks = {total: run_rank_checks(jobs[total], total,
                                    tmp_path_factory.mktemp(f"unsup{total}"))
             for total in (2, 4)}
    return ref, ranks


def test_global_masked_mrr_matches_jax(groups):
    """A rank whose slice is all padding does not pull the MRR down: the
    sums are reduced, not the ranks' means (whose plain mean is half)."""
    ref, ranks = groups
    jvals, pmean = ref["mrr"]
    for r in range(2):
        np.testing.assert_allclose(ranks[2][r]["mrr"], jvals[r], rtol=1e-6)
    assert abs(ranks[2][0]["mrr"] - 2 * pmean) < 1e-6


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_chunk_runner_matches_jax(groups, name):
    ref, ranks = groups
    steps, jparams, root_nu, jdropped = ref[name]
    graph_shards, data_shards = TRAIN_CASES[name][2]
    outs = [o[name] for o in ranks[graph_shards * data_shards]]
    for i, (loss, mrr, ema) in enumerate(steps):
        chunk = outs[0]["chunks"][i]
        np.testing.assert_allclose(chunk["loss"], loss, rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(chunk["mrr"], mrr, rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(chunk["ema"], ema, rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {i}")
        for o in outs[1:]:   # every rank reads the world's values
            assert all(o["chunks"][i][k] == chunk[k]
                       for k in ("loss", "mrr", "ema", "dropped"))
    assert jdropped == 0
    assert all(c["dropped"] == 0 for o in outs for c in o["chunks"])
    ours = outs[0]["params"]
    assert ours.keys() == jparams.keys()
    assert_params_close(ours, jparams, root_nu, N_STEPS)
    for k in ours:
        for o in outs[1:]:   # replicated on every rank, bit for bit
            np.testing.assert_array_equal(o["params"][k], ours[k])


@pytest.mark.parametrize("total", [2, 4])
def test_evaluations_match_jax(groups, total):
    """The eval of one batch (two ranks), the eval sweep and the embed
    sweep (reassembled over the total shard count) against JAX's."""
    ref, ranks = groups
    want = ref[f"eval{total}"]
    for r in range(total):
        out = ranks[total][r][f"eval{total}"]
        for key in ("eval", "sweep") if total == 2 else ("sweep",):
            np.testing.assert_allclose(out[key][:2], want[key][:2],
                                       rtol=1e-5, err_msg=key)
            assert out[key][2] == want[key][2] == 0
        np.testing.assert_allclose(out["embed"], want["embed"], rtol=1e-5,
                                   atol=1e-6)
        assert out["embed_dropped"] == want["embed_dropped"] == 0
        assert 0.0 < out["sweep"][1] <= 1.0


def test_grid_eval_sweep_equals_the_one_by_two_sweep(groups):
    """The sweep splits graph-major and each graph rank keeps its
    negatives: the 2 x 2 grid's loss and MRR are the 1 x 2 grid's."""
    _, ranks = groups
    one_by_two = ranks[2][0]["eval2"]["sweep"]
    for r in range(4):
        np.testing.assert_allclose(ranks[4][r]["eval4"]["sweep"][:2],
                                   one_by_two[:2], rtol=1e-6)
