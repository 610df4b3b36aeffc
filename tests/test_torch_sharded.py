"""The port's graph-sharded stack at two ranks against the JAX package's
``parallel/graph_sharded.py`` and ``parallel/dp.py`` on two of the
conftest's virtual CPU devices.

One group of two gloo processes (``parallel/launch.py::check_rank``,
joined within 120 s) runs every port job once per module; each test
reads its part. Inputs come from seeded NumPy and the weights cross
through the bridge. Under ``first_k`` sampling and dropout 0 nothing
random is drawn, so the two packages see the same samples.

Tolerances (the JAX suite's own, ``tests/test_graph_sharded.py``):
exchanged rows and dropped counts equal; the identity table's gradient
through the exchange 1e-6; embeddings rtol 1e-5 (the split mean sums in
another order); the chunk runners' last loss rtol 1e-5, their params
rtol 2e-4 and atol 1e-6, last ids and dropped counts equal, and the
replicated params bit-equal across the ranks; the sweep rtol 1e-5.
Dropout at D = 2 draws other masks than JAX's (and than one device's),
so it is held to properties: the split mean equals the same mean built
by hand from each share's Philox mask (rtol 1e-6), the masks keep
1 - p of the elements (within 4 sigma) at 1 / (1 - p), the local and
remote shares' masks and the ranks' masks differ, and the runner's
losses are finite and near one device's at the same dropout (15%), its
replicated params bit-equal across the ranks.
Params are held so where Adam resolves the gradient: an element whose
root second moment stays below 1e3 eps (a gradient of ~1e-7, where the
step g / (|g| + eps) turns last-bit differences into a share of the
learning rate) is held to 1e-3 of the learning rate per step instead
(an untouched one, such as an identity row outside the batches, has no
second moment and no step); such elements must stay under 2% of the
params.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu.parallel import dp as jdp
from graphsage_tpu.parallel import graph_sharded as jgs
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.synthetic import make_synthetic_graph
from graphsage_tpu_torch.models import graphsage as tg
from graphsage_tpu_torch.models import supervised as ts
from graphsage_tpu_torch.parallel import graph_sharded as tgs
from tests._torch_common import run_rank_checks

D = 2
B = 16
LR = 0.01
CAP_FACTOR = 4.0
# (layout, split_local, remote_only, capacity): both layouts, split on
# and off, remote_only, exact (23) and overflowing (5) capacities
EXCHANGE_CASES = [
    ("strided", True, False, 23), ("strided", False, False, 5),
    ("strided", True, True, 5), ("block", True, False, 5),
    ("block", False, False, 23), ("block", True, True, 23),
]
TRAIN_CASES = {
    # name: (aggregator, fused_gather, identity_dim, runner, grid)
    "mean_split": ("mean", True, 0, "sharded", (D, 1)),
    "maxpool": ("maxpool", False, 0, "sharded", (D, 1)),
    "identity": ("mean", True, 4, "sharded", (D, 1)),
    "dp": ("mean", True, 0, "dp", (1, D)),
}


def mesh_of(n, axes=("graph",)):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(
        (n,) if len(axes) == 1 else (2, n // 2)), axes)


def configs(num_nodes, aggregator="mean", fused=True, identity_dim=0,
            layout="strided", weight_decay=0.01):
    kw = dict(feature_dim=8, aggregator=aggregator, concat=True,
              identity_dim=identity_dim, num_nodes=num_nodes,
              sampler_mode="first_k", fused_gather=fused,
              shard_layout=layout)
    sup = dict(num_classes=4, weight_decay=weight_decay)
    layers = ((4, 8), (3, 8))
    jcfg = js.SupervisedConfig(sage=jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(s, d) for s, d in layers), **kw), **sup)
    tcfg = ts.SupervisedConfig(sage=tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(s, d) for s, d in layers), **kw), **sup)
    return jcfg, tcfg


def np_params(jax_params) -> dict:
    from graphsage_tpu_torch.params import params_from_jax

    return {k: v.numpy() for k, v in
            params_from_jax(jax.device_get(jax_params)).items()}


def root_second_moment(jax_opt_state, n_shards, n_rows) -> dict:
    """sqrt of Adam's bias-corrected second moment per param element (the
    identity table's in canonical order)."""
    from graphsage_tpu_torch.params import opt_state_from_jax

    st = opt_state_from_jax(jax.device_get(jax_opt_state))
    nu = {k: v.numpy() for k, v in st["nu"].items()}
    if "embeds" in nu:
        nu["embeds"] = tgs.embeds_to_canonical(
            {"embeds": nu["embeds"]}, n_shards, "strided")["embeds"][:n_rows]
    return {k: np.sqrt(v / (1 - 0.999 ** st["count"])) for k, v in nu.items()}


def assert_params_close(ours, theirs, root_nu, n_steps, lr=LR):
    """rtol 2e-4 / atol 1e-6 where sqrt(nu) >= 1e3 eps; elsewhere within
    1e-3 of lr per step (module docstring)."""
    loose = total = 0
    for k in ours:
        resolved = root_nu[k] >= 1e3 * 1e-8
        loose += int((~resolved & (root_nu[k] > 0)).sum())
        total += resolved.size
        np.testing.assert_allclose(ours[k][resolved], theirs[k][resolved],
                                   rtol=2e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(ours[k][~resolved], theirs[k][~resolved],
                                   rtol=0, atol=1e-3 * lr * n_steps,
                                   err_msg=k)
    assert loose < 0.02 * total


@pytest.fixture(scope="module")
def toy():
    g = make_synthetic_graph(num_nodes=120, num_classes=4, feat_dim=8,
                             seed=7)
    train_adj, _, _ = build_both_adjs(g, 8, seed=1)
    labels_table = np.zeros((g.num_nodes + 1, 4), np.float32)
    labels_table[:g.num_nodes] = g.labels
    return g, g.padded_features(), train_adj, labels_table


def exchange_inputs():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((37, 5)).astype(np.float32)
    idx = rng.integers(0, 37, (D, 23)).astype(np.int32)
    idx[:, :6] = 2          # one owner's bucket overflows capacity 5
    weights = rng.standard_normal((D, 23, 5)).astype(np.float32)
    return table, idx, weights


def jax_exchanges(table, idx, n, cases):
    """{case: (rows [n, m, F], dropped [n])} of JAX's exchange under
    shard_map over ``n`` devices, every case in one compiled function."""
    tables = [jnp.asarray(jgs.shard_rows(table, n, layout)[0])
              for layout in ("strided", "block")]

    def body(strided, block, i):
        out = []
        for layout, split, remote, cap in cases:
            rows, dropped = jgs.exchange_gather(
                strided if layout == "strided" else block, i, "graph", cap,
                return_dropped=True, split_local=split, layout=layout,
                remote_only=remote)
            out += [rows, dropped.reshape(1)]
        return tuple(out)

    f = shard_map(body, mesh=mesh_of(n), in_specs=(P("graph"),) * 3,
                  out_specs=(P("graph"),) * (2 * len(cases)),
                  check_vma=False)
    out = f(*tables, jnp.asarray(idx.reshape(-1)))
    return {case: (np.asarray(out[2 * k]).reshape(n, idx.shape[1], -1),
                   np.asarray(out[2 * k + 1]))
            for k, case in enumerate(cases)}


def jax_exchange_grads(table, idx, weights, n, capacity):
    """{layout: d sum(rows * weights) / d table} in the device layout,
    both layouts in one compiled gradient."""
    w = jnp.asarray(weights.reshape(-1, weights.shape[-1]))
    i = jnp.asarray(idx.reshape(-1))

    def loss(tables):
        total = 0.0
        for layout, t in zip(("strided", "block"), tables):
            f = shard_map(
                functools.partial(jgs.exchange_gather, axis_name="graph",
                                  capacity=capacity, layout=layout),
                mesh=mesh_of(n), in_specs=(P("graph"), P("graph")),
                out_specs=P("graph"), check_vma=False)
            total = total + jnp.sum(f(t, i) * w)
        return total

    tables = tuple(jnp.asarray(jgs.shard_rows(table, n, layout)[0])
                   for layout in ("strided", "block"))
    grads = jax.jit(jax.grad(loss))(tables)
    return {"strided": np.asarray(grads[0]), "block": np.asarray(grads[1])}


def ids_stream(g, n_steps, n_dummy):
    """n_steps batches of B train ids, the last ``n_dummy`` entries the
    dummy id (a padded tail batch)."""
    ids = np.arange(n_steps * B, dtype=np.int32) % g.num_nodes
    ids[len(ids) - n_dummy:] = g.num_nodes
    return ids


def jax_train(toy, name, n_steps, ids_perm):
    g, feats, adj, labels_table = toy
    agg, fused, id_dim, runner, grid = TRAIN_CASES[name]
    jcfg, _ = configs(g.num_nodes, agg, fused, id_dim)
    params = js.init_supervised_params(jax.random.key(0), jcfg)
    init = np_params(params)     # the runners donate their params
    optimizer = js.make_optimizer(LR)
    if runner == "dp":
        run = jdp.make_dp_supervised_chunk_runner(
            jcfg, optimizer, mesh_of(grid[1], ("data",)), B)
        p, o, loss, logits, last_ids = run(
            params, optimizer.init(params), jax.random.key(7),
            jnp.asarray(feats), jnp.asarray(adj), jnp.asarray(ids_perm),
            jnp.asarray(labels_table), 0, n_steps)
        return (init, p, float(loss), np.asarray(last_ids), 0,
                root_second_moment(o, 1, g.num_nodes + 1))
    Dg, Dd = grid
    psh = dict(params)
    if id_dim:
        psh["embeds"] = jnp.asarray(
            jgs.shard_rows(np.asarray(params["embeds"]), Dg)[0])
    opt = optimizer.init(psh)
    mesh = mesh_of(Dg * Dd, ("data", "graph")) if Dd > 1 else mesh_of(Dg)
    run = jgs.make_sharded_supervised_chunk_runner(
        jcfg, optimizer, mesh, B, capacity_factor=CAP_FACTOR,
        params_like=psh, opt_state_like=opt,
        data_axis="data" if Dd > 1 else None)
    p, o, loss, _, last_ids, dropped = run(
        psh, opt, jax.random.key(7),
        jnp.asarray(jgs.shard_rows(feats, Dg)[0]),
        jnp.asarray(jgs.shard_rows(adj, Dg)[0]), jnp.asarray(ids_perm),
        jnp.asarray(labels_table), 0, n_steps)
    p = jgs.embeds_to_canonical(p, Dg, "strided")
    if id_dim:
        p = dict(p, embeds=np.asarray(p["embeds"])[:g.num_nodes + 1])
    return (init, p, float(loss), np.asarray(last_ids), int(dropped),
            root_second_moment(o, Dg, g.num_nodes + 1))


def train_job(toy, name, n_steps, ids_perm, jax_params):
    g, feats, adj, labels_table = toy
    agg, fused, id_dim, runner, grid = TRAIN_CASES[name]
    _, tcfg = configs(g.num_nodes, agg, fused, id_dim)
    return dict(kind="train", grid=grid, runner=runner, sup_config=tcfg,
                params=jax_params, features=feats, adj=adj,
                ids_perm=ids_perm, labels_table=labels_table,
                batch_size=B, lr=LR, capacity_factor=CAP_FACTOR,
                chunks=[(0, n_steps)])


N_STEPS = 3
DROP = 0.25     # its keep scale 4/3 is no other rate's 1/p or 1/(1-p)^2


def dropout_config(g):
    """The "identity" case (mean, fused, identity_dim 4) at dropout
    ``DROP``: the inner hop's split mean, the identity columns' and the
    plain dropouts all draw."""
    _, tcfg = configs(g.num_nodes, identity_dim=4)
    return dataclasses.replace(tcfg, sage=dataclasses.replace(
        tcfg.sage, dropout=DROP))


@pytest.fixture(scope="module")
def group(toy, tmp_path_factory):
    """Every job's JAX reference and the port's per-rank outputs."""
    g, feats, adj, labels_table = toy
    table, idx, weights = exchange_inputs()
    jobs, ref = {}, {}
    exchanged = jax_exchanges(table, idx, D, EXCHANGE_CASES)
    for case in EXCHANGE_CASES:
        layout, split, remote, cap = case
        key = f"x_{layout}_{split}_{remote}_{cap}"
        jobs[key] = dict(kind="exchange", grid=(D, 1), table=table, idx=idx,
                         capacity=cap, split_local=split,
                         remote_only=remote, layout=layout)
        ref[key] = exchanged[case]
    grads = jax_exchange_grads(table, idx, weights, D, 5)
    for layout in ("strided", "block"):
        key = f"grad_{layout}"
        jobs[key] = dict(kind="exchange", grid=(D, 1), table=table, idx=idx,
                         capacity=5, split_local=True, remote_only=False,
                         layout=layout, weights=weights)
        ref[key] = grads[layout]

    # sharded_sage_embed: fused split mean with an identity table
    jcfg, tcfg = configs(g.num_nodes, identity_dim=4)
    params = js.init_supervised_params(jax.random.key(0), jcfg)
    ids = np.arange(B, dtype=np.int32) * 7 % g.num_nodes
    jobs["embed"] = dict(kind="embed", grid=(D, 1), sup_config=tcfg,
                         params=np_params(params), features=feats, adj=adj,
                         ids=ids, capacity_factor=CAP_FACTOR)
    psh = dict(params, embeds=jnp.asarray(
        jgs.shard_rows(np.asarray(params["embeds"]), D)[0]))
    embed = shard_map(
        lambda p, f, a, i: jgs.sharded_sage_embed(
            p, f, a, i, jax.random.key(0), jcfg.sage, "graph", CAP_FACTOR),
        mesh=mesh_of(D),
        in_specs=(jgs._embeds_spec_tree(psh, "graph"), P("graph"),
                  P("graph"), P("graph")),
        out_specs=P("graph"), check_vma=False)
    ref["embed"] = np.asarray(embed(
        psh, jnp.asarray(jgs.shard_rows(feats, D)[0]),
        jnp.asarray(jgs.shard_rows(adj, D)[0]), jnp.asarray(ids)))

    # the inner hop's split mean at dropout DROP, both layouts
    split_idx = np.random.default_rng(5).integers(
        0, 37, (D, 40 * 4)).astype(np.int32)
    for layout in ("strided", "block"):
        jobs[f"split_{layout}"] = dict(
            kind="split_mean", grid=(D, 1), table=table, idx=split_idx,
            S0=4, rate=DROP, seed=11, step=3, layout=layout)

    ids_perm = ids_stream(g, N_STEPS, 5)
    for name in TRAIN_CASES:
        init, p, loss, last_ids, dropped, root_nu = jax_train(
            toy, name, N_STEPS, ids_perm)
        jobs[name] = train_job(toy, name, N_STEPS, ids_perm, init)
        ref[name] = (np_params(p), loss, last_ids, dropped, root_nu)
        if name == "identity":   # the same run at dropout DROP
            jobs["dropout"] = dict(
                jobs[name], sup_config=dropout_config(g), drop_seed=9,
                chunks=[(i, 1) for i in range(N_STEPS)])
            ref["dropout"] = init

    # the sharded eval sweep over 37 nodes (3 batches, the last padded)
    jcfg, tcfg = configs(g.num_nodes)
    params = js.init_supervised_params(jax.random.key(1), jcfg)
    nodes = np.arange(5, 42)
    jobs["sweep"] = dict(kind="sweep", grid=(D, 1), sup_config=tcfg,
                         params=np_params(params), features=feats, adj=adj,
                         nodes=nodes, labels=g.labels, batch_size=B,
                         capacity_factor=CAP_FACTOR)
    n_b = -(-len(nodes) // B)
    ids_all = np.full(n_b * B, g.num_nodes, np.int32)
    ids_all[:len(nodes)] = nodes
    sweep = jgs.make_sharded_supervised_eval_sweep(
        jcfg, mesh_of(D), B, capacity_factor=CAP_FACTOR)
    losses, preds, dropped = sweep(
        params, jnp.asarray(jgs.shard_rows(feats, D)[0]),
        jnp.asarray(jgs.shard_rows(adj, D)[0]), jnp.asarray(ids_all),
        jnp.asarray(labels_table), jax.random.key(1))
    ref["sweep"] = (np.asarray(losses), jgs.reassemble_sharded_rows(
        preds, D, n_b)[:len(nodes)], int(dropped))

    ranks = run_rank_checks(jobs, D, tmp_path_factory.mktemp("sharded"))
    return ref, ranks


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((37, 3)).astype(np.float32)
    for n in (1, 2, 3, 8):
        for layout in ("strided", "block"):
            ours, ss = tgs.shard_rows(table, n, layout)
            theirs, jss = jgs.shard_rows(table, n, layout)
            np.testing.assert_array_equal(ours, np.asarray(theirs))
            assert ss == jss
            assert np.array_equal(tgs.shard_rows(torch.from_numpy(table), n,
                                                 layout)[0].numpy(), ours)
            for i in range(n):
                np.testing.assert_array_equal(
                    tgs.local_shard(table, n, i, layout),
                    ours[i * ss:(i + 1) * ss])
            rows = np.arange(n * ss)
            np.testing.assert_array_equal(
                tgs.device_rows_to_node_ids(rows, n, ss, layout),
                np.asarray(jgs.device_rows_to_node_ids(rows, n, ss, layout)))
            tree = {"embeds": ours, "head.w": table}
            canon = tgs.embeds_to_canonical(tree, n, layout)
            jcanon = jgs.embeds_to_canonical({"embeds": jnp.asarray(ours)},
                                             n, layout)
            np.testing.assert_array_equal(canon["embeds"],
                                          np.asarray(jcanon["embeds"]))
            np.testing.assert_array_equal(canon["embeds"][:37], table)
            assert canon["head.w"] is table
            back = tgs.embeds_to_device_layout(canon, n, layout)
            np.testing.assert_array_equal(back["embeds"], ours)


def test_canonical_round_trip_of_optimizer_state():
    rng = np.random.default_rng(1)
    mu = rng.standard_normal((12, 2)).astype(np.float32)
    dev, _ = tgs.shard_rows(mu, 4)
    state = {"count": 3, "mu": {"embeds": dev, "head.w": mu},
             "nu": {"embeds": dev}}
    canon = tgs.embeds_to_canonical(state, 4, "strided")
    assert canon["count"] == 3
    np.testing.assert_array_equal(canon["mu"]["embeds"], mu)
    np.testing.assert_array_equal(canon["nu"]["embeds"], mu)
    assert canon["mu"]["head.w"] is mu


@pytest.mark.parametrize("layout", ["strided", "block"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_suggest_capacity_factor_matches_jax(toy, n, layout):
    _, _, adj, _ = toy
    assert tgs.suggest_capacity_factor(adj, n, layout=layout) == \
        jgs.suggest_capacity_factor(adj, n, layout=layout)
    for m in (100, 4096, 4097, 50_000):
        assert tgs._capacity(m, n, 1.7) == jgs._capacity(m, n, 1.7)


@pytest.mark.parametrize("case", EXCHANGE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_exchange_gather_matches_jax(group, case):
    ref, ranks = group
    layout, split, remote, cap = case
    key = f"x_{layout}_{split}_{remote}_{cap}"
    rows, dropped = ref[key]
    for r in range(D):
        np.testing.assert_array_equal(ranks[r][key]["rows"], rows[r])
        assert ranks[r][key]["dropped"] == dropped[r]
    if cap == 5 and not split:
        assert dropped.sum() > 0     # the case does overflow


@pytest.mark.parametrize("layout", ["strided", "block"])
def test_identity_gradient_through_the_exchange(group, layout):
    ref, ranks = group
    key = f"grad_{layout}"
    ours = np.concatenate([ranks[r][key]["grad"] for r in range(D)])
    np.testing.assert_allclose(ours, ref[key], rtol=1e-6, atol=1e-6)
    assert np.abs(ours).max() > 0


def test_sharded_embed_overlap_is_blocking_bitwise_and_matches_jax(group):
    ref, ranks = group
    for r in range(D):
        out = ranks[r]["embed"]
        np.testing.assert_array_equal(out["overlap"], out["blocking"])
        assert out["overlap_dropped"] == out["blocking_dropped"] == 0
    ours = np.concatenate([ranks[r]["embed"]["overlap"] for r in range(D)])
    np.testing.assert_allclose(ours, ref["embed"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_chunk_runner_matches_jax(group, name):
    ref, ranks = group
    jparams, jloss, jids, jdropped, root_nu = ref[name]
    outs = [ranks[r][name] for r in range(D)]
    chunk = outs[0]["chunks"][-1]
    np.testing.assert_allclose(chunk["loss"], jloss, rtol=1e-5)
    np.testing.assert_array_equal(
        np.concatenate([o["chunks"][-1]["ids"] for o in outs]), jids)
    assert chunk["dropped"] == jdropped == 0
    ours = outs[0]["params"]
    assert ours.keys() == jparams.keys()
    assert_params_close(ours, jparams, root_nu, N_STEPS)
    for k in ours:
        for o in outs[1:]:   # replicated on every rank, bit for bit
            np.testing.assert_array_equal(o["params"][k], ours[k])
    assert all(o["chunks"][-1]["loss"] == chunk["loss"] for o in outs)


def test_sharded_eval_sweep_matches_jax(group):
    ref, ranks = group
    losses, preds, dropped = ref["sweep"]
    for r in range(D):
        out = ranks[r]["sweep"]
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["preds"], preds, rtol=1e-5,
                                   atol=1e-7)
        assert out["dropped"] == dropped == 0


@pytest.mark.parametrize("layout", ["strided", "block"])
def test_split_mean_dropout_masks_each_share_by_its_own_stream(group,
                                                               layout):
    _, ranks = group
    n_sigma = 4.0
    masks = []
    for r in range(D):
        out = ranks[r][f"split_{layout}"]
        np.testing.assert_allclose(out["mean"], out["by_hand"], rtol=1e-6,
                                   atol=1e-7)
        assert out["dropped"] == 0
        assert 0 < out["is_local"].mean() < 1     # both shares served
        local, remote = out["local_mask"], out["remote_mask"]
        n = local.size
        for m in (local, remote):
            kept = m[m != 0]
            np.testing.assert_allclose(kept, 1 / (1 - DROP), rtol=1e-6)
            assert abs(kept.size / n - (1 - DROP)) < n_sigma * np.sqrt(
                DROP * (1 - DROP) / n)
        # independent streams disagree on 2p(1-p) of the elements
        expect = 2 * DROP * (1 - DROP)
        assert abs(((local != 0) != (remote != 0)).mean() - expect) < (
            n_sigma * np.sqrt(expect * (1 - expect) / n))
        masks.append(local != 0)
    # each rank folds its own seed
    assert abs((masks[0] != masks[1]).mean() - expect) < n_sigma * np.sqrt(
        expect * (1 - expect) / masks[0].size)


def test_graph_sharded_training_with_dropout(group, toy):
    """Three steps at D = 2 and dropout DROP, with an identity table,
    against the single-device runner from the same weights at the same
    dropout (its own masks): each step's loss finite and within 15%, the
    params trained and bit-equal across the ranks, nothing dropped. The
    bound is a sanity check: other mask draws alone move these 16-node
    losses by 2.6-4.7%, dropout itself by ~9%; the masks' scale and
    streams are held exactly by the split-mean test above."""
    from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner

    ref, ranks = group
    g, feats, adj, labels_table = toy
    outs = [ranks[r]["dropout"] for r in range(D)]
    losses = [c["loss"] for c in outs[0]["chunks"]]
    assert np.all(np.isfinite(losses))
    assert all(c["dropped"] == 0 for o in outs for c in o["chunks"])
    for k, v in outs[0]["params"].items():
        for o in outs[1:]:
            np.testing.assert_array_equal(o["params"][k], v, err_msg=k)
        assert not np.array_equal(v, ref["dropout"][k]), k
    assert [c["loss"] for c in outs[1]["chunks"]] == losses

    config = dropout_config(g)
    params = {k: torch.from_numpy(np.array(v)) for k, v in
              ref["dropout"].items()}
    optimizer = ts.make_optimizer(LR)
    opt_state = optimizer.init(params)
    run = make_supervised_chunk_runner(config, optimizer, B)
    ids_perm = torch.from_numpy(ids_stream(g, N_STEPS, 5))
    one = []
    for i in range(N_STEPS):
        res = run(params, opt_state, torch.Generator().manual_seed(1),
                  torch.from_numpy(feats), torch.from_numpy(adj), ids_perm,
                  torch.from_numpy(labels_table), i, 1, drop_seed=9)
        one.append(float(res[2]))
    np.testing.assert_allclose(losses, one, rtol=0.15)
    # the masks drew: the same run at dropout 0 ends at another loss
    assert losses[-1] != ranks[0]["identity"]["chunks"][-1]["loss"]
