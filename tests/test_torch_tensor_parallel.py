"""The port's feature-dim tensor parallelism (``--n_model_shards``,
``parallel/tensor.py``) against the JAX package's GSPMD runs on the
conftest's virtual CPU devices: ``make_mesh``, ``sage_param_shardings(
tp=True)``, ``place_*`` and ``make_supervised_chunk_runner(mesh=...)``,
with JAX's fused gather off as its trainer sets it under tensor
parallelism.

Two groups of gloo processes (``parallel/launch.py::check_rank``,
joined within 120 s) run every port job once per module: two ranks
(1 x 2, data x model) and four (2 x 2). Inputs come from seeded NumPy
and the weights cross through the bridge, cut to each rank's shard by
``params.py::params_to_model_shard``. Under ``first_k`` sampling and
dropout 0 nothing random is drawn, so the packages see the same samples.
JAX splits no dimension unevenly, so its cases take F = 8 and an
identity table of 8; the port's own uneven splits (F = 10: 8 + 2
columns; identity 6: 4 + 2, identity 4: 4 + 0) are held to the port's
one-device runner, at dropout 0.5 with the default sampler: under one
data slice a model group draws as one device does.

Tolerances (``tests/test_torch_sharded.py``'s): the runner takes one
step, then two; each chunk's loss rtol 1e-5, the params after the first
step rtol 2e-4 / atol 1e-6 where Adam resolves the gradient, sqrt(v) at
least 1e3 eps (``assert_first_step_close``), the last ids equal, the
replicated params bit-equal across
every rank and each shard bit-equal across the data slices; the eval
batch and the sweep rtol 1e-5. Later steps' params are not held element
by element: the partial products add in another order than one
device's product, and an element whose gradient is near Adam's eps
steps by a share of lr that last-bit differences set (a pooling MLP's
or an LSTM kernel's few such elements move by ~1e-3 relative in three
steps); the later losses are held instead. The
K2 and identity-column masks on a block equal the whole rows' masks at
its columns bit for bit; the means rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu.parallel import dp as jdp
from graphsage_tpu.parallel.mesh import make_mesh
from graphsage_tpu.train import supervised as jtrain
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.synthetic import make_synthetic_graph
from graphsage_tpu_torch.models import graphsage as tg
from graphsage_tpu_torch.models import supervised as ts
from graphsage_tpu_torch.ops import philox
from graphsage_tpu_torch.ops.gather import fused_gather_mean
from graphsage_tpu_torch.params import (
    params_from_model_shards,
    params_to_model_shard,
)
from graphsage_tpu_torch.parallel import tensor as tt
from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner
from graphsage_tpu_torch.train.supervised import labels_table_of
from tests._torch_common import port_params, run_rank_checks
from tests.test_torch_sharded import np_params, root_second_moment

B = 16
LR = 0.01
N_STEPS = 3
N = 120
CHUNKS = [(0, 1), (1, N_STEPS - 1)]   # one step, then the rest
# name: (aggregator, identity_dim, the port's route flags, grid)
JAX_CASES = {
    "mean_identity": ("mean", 8, dict(fused_gather=True), (1, 1, 2)),
    "gcn_dedup": ("gcn", 0, dict(fused_gather=True, dedup_gather=True),
                  (1, 1, 2)),
    "meanpool": ("meanpool", 0, dict(fused_gather=True), (1, 1, 2)),
    "maxpool_rows": ("maxpool", 0, dict(rows_gather=True), (1, 1, 2)),
    "seq_rows": ("seq", 0, dict(rows_gather=True), (1, 1, 2)),
    "mean_identity_2x2": ("mean", 8, dict(fused_gather=True), (1, 2, 2)),
    "maxpool_rows_2x2": ("maxpool", 0, dict(rows_gather=True), (1, 2, 2)),
}
# held to the port's one-device runner: (aggregator, feature_dim,
# identity_dim, route flags, dropout)
ONE_DEVICE_CASES = {
    "mean_uneven_dropout": ("mean", 10, 6, dict(fused_gather=True), 0.5),
    "maxpool_empty_block_dropout": ("maxpool", 10, 4,
                                    dict(rows_gather=True), 0.5),
    "seq_empty_block": ("seq", 10, 4, dict(rows_gather=True), 0.0),
}


def layers(aggregator):
    mult = 1 if aggregator != "gcn" else 2
    return tuple((s, mult * 8) for s in (4, 3))


def configs(aggregator, identity_dim, flags, feature_dim=8, dropout=0.0,
            sampler="first_k"):
    kw = dict(feature_dim=feature_dim, aggregator=aggregator,
              concat=aggregator != "gcn", identity_dim=identity_dim,
              num_nodes=N, sampler_mode=sampler, dropout=dropout)
    sup = dict(num_classes=4, weight_decay=0.01)
    lay = layers(aggregator)
    jcfg = js.SupervisedConfig(sage=jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(s, d) for s, d in lay), fused_gather=False,
        **kw), **sup)
    tcfg = ts.SupervisedConfig(sage=tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(s, d) for s, d in lay), **kw, **flags),
        **sup)
    return jcfg, tcfg


def toy_data(feat_dim):
    g = make_synthetic_graph(num_nodes=N, num_classes=4, feat_dim=feat_dim,
                             seed=7)
    adj, _, full_adj = build_both_adjs(g, 8, seed=1)
    return g, g.padded_features(), adj, full_adj, labels_table_of(g.labels,
                                                                   N)


def ids_stream(n_dummy=5):
    ids = np.arange(N_STEPS * B, dtype=np.int32) * 7 % N
    ids[len(ids) - n_dummy:] = N
    return ids


def tp_mesh(grid):
    _, D, M = grid
    return make_mesh(n_data=D, n_model=M, devices=jax.devices()[:D * M])


def jax_tp_train(data, name):
    """JAX's trainer under --n_model_shards: (initial params, params,
    last loss, last ids, sqrt of Adam's nu)."""
    g, feats, adj, _, labels_table = data
    agg, id_dim, flags, grid = JAX_CASES[name]
    jcfg, _ = configs(agg, id_dim, flags)
    params = js.init_supervised_params(jax.random.key(0), jcfg)
    init = np_params(params)
    optimizer = js.make_optimizer(LR)
    mesh = tp_mesh(grid)
    params, opt_state = jdp.place_train_state(
        params, optimizer,
        jdp.sage_param_shardings(params, mesh, jcfg.sage, tp=True))
    features, train_adj = jdp.place_graph_arrays(
        jnp.asarray(feats), jnp.asarray(adj), mesh, tp=True)
    run = jax.jit(jdp.make_supervised_chunk_runner(jcfg, optimizer, B,
                                                   mesh=mesh))
    stream, table = jnp.asarray(ids_stream()), jnp.asarray(labels_table)
    p, o, loss1, _, _ = run(params, opt_state, jax.random.key(7), features,
                            train_adj, stream, table, 0, 1)
    first = (np_params(p), root_second_moment(o, 1, N + 1))
    _, _, loss, _, last_ids = run(p, o, jax.random.key(7), features,
                                  train_adj, stream, table, 1, N_STEPS - 1)
    return init, first, [float(loss1), float(loss)], np.asarray(last_ids)


def train_job(data, tcfg, params, grid, **extra):
    _, feats, adj, _, labels_table = data
    return dict(kind="tp_train", grid=grid, sup_config=tcfg, params=params,
                features=feats, adj=adj, ids_perm=ids_stream(),
                labels_table=labels_table, batch_size=B, lr=LR,
                chunks=CHUNKS, first=True, **extra)


def one_device_train(data, tcfg, params, seed, drop_seed):
    """The port's single-device runner over the same chunks: ((params,
    sqrt of Adam's nu) after the first step, the chunks' losses)."""
    _, feats, adj, _, labels_table = data
    params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    optimizer = ts.make_optimizer(LR)
    opt_state = optimizer.init(params)
    run = make_supervised_chunk_runner(tcfg, optimizer, B)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for start, n in CHUNKS:
        out = run(params, opt_state, gen, torch.from_numpy(feats),
                  torch.from_numpy(adj), torch.from_numpy(ids_stream()),
                  torch.from_numpy(labels_table), start, n,
                  drop_seed=drop_seed)
        losses.append(float(out[2]))
        if start == 0:
            st = optimizer.state_dict(opt_state, params)
            first = ({k: v.detach().numpy().copy()
                      for k, v in params.items()},
                     {k: np.sqrt(v.numpy() / (1 - 0.999))
                      for k, v in st["nu"].items()})
    return first, losses


@pytest.fixture(scope="module")
def data8():
    return toy_data(8)


@pytest.fixture(scope="module")
def data10():
    return toy_data(10)


@pytest.fixture(scope="module")
def group(data8, data10, tmp_path_factory):
    """Every job's reference and the port's per-rank outputs, of both
    rank groups: {2: (refs, ranks), 4: (refs, ranks)}."""
    g, feats, adj, full_adj, labels_table = data8
    jobs = {2: {}, 4: {}}
    refs = {}
    for name, (agg, id_dim, flags, grid) in JAX_CASES.items():
        init, first, losses, last_ids = jax_tp_train(data8, name)
        _, tcfg = configs(agg, id_dim, flags)
        jobs[grid[1] * grid[2]][name] = train_job(data8, tcfg, init, grid)
        refs[name] = (first, losses, last_ids)

    for name, (agg, F, id_dim, flags, rate) in ONE_DEVICE_CASES.items():
        _, tcfg = configs(agg, id_dim, flags, feature_dim=F, dropout=rate,
                          sampler="shared_perm")
        init = {k: v.numpy() for k, v in ts.init_supervised_params(
            torch.Generator().manual_seed(0), tcfg).items()}
        jobs[2][name] = train_job(data10, tcfg, init, (1, 1, 2), seed=3,
                                  drop_seed=11)
        refs[name] = one_device_train(data10, tcfg, init, 3, 11)

    # the eval of one batch and the sweep, against JAX's GSPMD sweep
    jcfg, tcfg = configs("mean", 8, dict(fused_gather=True))
    params = js.init_supervised_params(jax.random.key(1), jcfg)
    nodes = np.arange(5, 42)
    vb_ids = np.arange(B, dtype=np.int32) * 5 % N
    vb = (vb_ids, labels_table[vb_ids], np.ones(B, np.float32))
    vb[2][-3:] = 0
    jobs[2]["eval"] = dict(kind="tp_eval", grid=(1, 1, 2), sup_config=tcfg,
                           params=np_params(params), features=feats,
                           adj=full_adj, batch_size=B, nodes=nodes,
                           labels=g.labels, batch=vb)
    mesh = tp_mesh((1, 1, 2))
    placed, _ = jdp.place_train_state(
        params, js.make_optimizer(LR),
        jdp.sage_param_shardings(params, mesh, jcfg.sage, tp=True))
    features, full = jdp.place_graph_arrays(jnp.asarray(feats),
                                            jnp.asarray(full_adj), mesh,
                                            tp=True)
    n_b = -(-len(nodes) // B)
    ids_all = np.full(n_b * B, N, np.int32)
    ids_all[:len(nodes)] = nodes
    losses, preds = jtrain.make_eval_sweep(jcfg, B, N)(
        placed, features, full, jnp.asarray(ids_all),
        jnp.asarray(labels_table), jax.random.key(1))
    eval_loss, eval_preds = jtrain.make_eval_step(jcfg)(
        placed, features, full, *(jnp.asarray(x) for x in vb),
        jax.random.key(1))
    refs["eval"] = ((float(eval_loss), np.asarray(eval_preds)),
                    (float(np.mean(np.asarray(losses))),
                     np.asarray(preds)[:len(nodes)]))

    # reduce_from_model against torch.distributed.nn's all_reduce
    rng = np.random.default_rng(4)
    _, tcfg = configs("mean", 6, {}, feature_dim=10)
    jobs[2]["reduce"] = dict(
        kind="tp_reduce", grid=(1, 1, 2), sup_config=tcfg,
        x=rng.standard_normal((5, 16)).astype(np.float32),
        w=rng.standard_normal((16, 3)).astype(np.float32),
        weights=rng.standard_normal((5, 3)).astype(np.float32))
    refs["reduce"] = jobs[2]["reduce"]

    out = {}
    for n in (2, 4):
        out[n] = run_rank_checks(jobs[n], n,
                                 tmp_path_factory.mktemp(f"tp{n}"))
    return refs, out


def ranks_of(group, name):
    refs, out = group
    for n in (2, 4):
        if name in out[n][0]:
            return refs[name], [o[name] for o in out[n]]
    raise KeyError(name)


def assert_first_step_close(ours, theirs, root_nu, lr=LR):
    """The params after one step: rtol 2e-4 / atol 1e-6 where sqrt(v) >=
    1e3 eps. Below that the first step, lr * g / (|g| + eps), moves by
    up to lr * dg / eps for a gradient rounded dg apart, and the partial
    products' other summation order rounds a gradient of ~1e-8 by
    ~1e-10: such elements are held within 5% of lr (the worst seen is
    1.3%, in a pooling MLP's first layer). The LSTM's kernel at this
    width has many such gradients (42% of the seq model's params), so
    the held elements need only be the majority."""
    loose = total = 0
    for k in ours:
        resolved = root_nu[k] >= 1e3 * 1e-8
        loose += int((~resolved & (root_nu[k] > 0)).sum())
        total += resolved.size
        np.testing.assert_allclose(ours[k][resolved], theirs[k][resolved],
                                   rtol=2e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(ours[k][~resolved], theirs[k][~resolved],
                                   rtol=0, atol=0.05 * lr, err_msg=k)
    assert loose < 0.5 * total


def assert_replicas(outs, tcfg, grid):
    """Every rank's whole params equal; a replicated param bit-equal on
    every rank; a shard bit-equal across the data slices."""
    _, D, M = grid
    split = tt.split_params(tcfg.sage)
    for o in outs[1:]:
        for k, v in outs[0]["params"].items():
            np.testing.assert_array_equal(o["params"][k], v, err_msg=k)
    for r, o in enumerate(outs):
        d, m = divmod(r, M)
        for k, v in o["local"].items():
            twin = outs[m] if k in split else outs[0]
            np.testing.assert_array_equal(v, twin["local"][k], err_msg=k)


# ------------------------------------------------------- no rank group

@pytest.mark.parametrize("width,n,want", [
    (602, 2, [(0, 304), (304, 602)]),
    (602, 4, [(0, 152), (152, 304), (304, 456), (456, 602)]),
    (10, 2, [(0, 8), (8, 10)]),
    (4, 2, [(0, 4), (4, 4)]),
    (0, 3, [(0, 0)] * 3),
])
def test_column_blocks(width, n, want):
    assert tt.column_blocks(width, n) == want


def test_column_blocks_lie_on_philox_groups():
    for width in range(0, 70):
        for n in range(1, 6):
            blocks = tt.column_blocks(width, n)
            assert blocks[0][0] == 0 and blocks[-1][1] == width
            assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
            # an empty block past the last column may start off a group
            assert all(lo <= hi and (lo % 4 == 0 or lo == width)
                       for lo, hi in blocks)
            groups = [-(-(hi - lo) // 4) for lo, hi in blocks]
            assert max(groups) - min(groups) <= 1
            assert groups == sorted(groups, reverse=True)


@pytest.mark.parametrize("F,n", [(13, 2), (602, 2), (602, 4), (10, 3)])
def test_k2_plain_on_a_block_is_the_whole_mask_at_its_columns(F, n):
    """K2's plain version and ``philox_dropout`` on a column block draw
    the whole rows' mask at the block's columns, bit for bit (the last
    block of F = 13 at n = 2 is 5 columns wide, of F = 10 at n = 3 two:
    widths that are 1 and 2 mod 4)."""
    rng = np.random.default_rng(F)
    table = torch.from_numpy(rng.standard_normal((37, F)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 37, (9, 5)).astype(np.int32))
    seed, offset = 2**40 + 17, (3, tg.KERNEL_DROP_TAG)
    whole_mask = philox.dropout_keep_mask(45, F, 0.5, seed, *offset)
    whole_mean = fused_gather_mean(table, idx, 0.5, seed, offset)
    whole_drop = philox.philox_dropout(table, 0.5, seed, 3, 0x1D)
    for lo, hi in tt.column_blocks(F, n):
        block = table[:, lo:hi].contiguous()
        mask = philox.dropout_keep_mask(45, hi - lo, 0.5, seed, *offset,
                                        col_base=lo, row_width=F)
        assert torch.equal(mask, whole_mask[:, lo:hi])
        mean = fused_gather_mean(block, idx, 0.5, seed, offset, col_base=lo,
                                 row_width=F)
        np.testing.assert_allclose(mean.numpy(), whole_mean[:, lo:hi].numpy(),
                                   rtol=1e-6, atol=1e-7)
        assert torch.equal(
            philox.philox_dropout(block, 0.5, seed, 3, 0x1D, lo, F),
            whole_drop[:, lo:hi])
    with pytest.raises(ValueError, match="4-column"):
        philox.dropout_bits(2, 3, 1, 0, 0, col_base=2, row_width=8)


@pytest.mark.parametrize("agg", ["mean", "gcn", "maxpool", "meanpool",
                                 "twomaxpool", "seq"])
@pytest.mark.parametrize("identity_dim", [0, 6])
def test_bridge_round_trip(agg, identity_dim):
    """The whole params cut into M = 3 shards and put back together are
    the whole params; each shard holds the matching rows."""
    _, tcfg = configs(agg, identity_dim, {}, feature_dim=10)
    whole = ts.init_supervised_params(torch.Generator().manual_seed(2), tcfg)
    shards = [params_to_model_shard(whole, tcfg.sage, 3, m) for m in range(3)]
    back = params_from_model_shards(shards, tcfg.sage)
    assert back.keys() == whole.keys()
    for k in whole:
        assert torch.equal(back[k], whole[k]), k
    split = tt.split_params(tcfg.sage)
    for k in whole:
        if k not in split:
            assert all(s[k] is whole[k] for s in shards)
    rows = torch.from_numpy(tt.input_rows(tcfg.sage, 3, 1))
    key = "aggs.0.w" if agg == "gcn" else "aggs.0.self_w"
    assert torch.equal(shards[1][key], whole[key][rows])
    numpy_shard = params_to_model_shard(
        {k: v.numpy() for k, v in whole.items()}, tcfg.sage, 3, 1)
    for k, v in numpy_shard.items():
        np.testing.assert_array_equal(v, shards[1][k].numpy())


def test_bridge_from_jax_gspmd_placed_params():
    """JAX's params placed by ``sage_param_shardings(tp=True)`` cross the
    bridge as their logical arrays, and each rank's shard is the rows
    (and identity columns) ``input_rows`` names; the shards put back
    together are JAX's params."""
    jcfg, tcfg = configs("mean", 8, {})
    params = js.init_supervised_params(jax.random.key(3), jcfg)
    placed, _ = jdp.place_train_state(
        params, js.make_optimizer(LR),
        jdp.sage_param_shardings(params, tp_mesh((1, 1, 2)), jcfg.sage,
                                 tp=True))
    assert len(placed["aggs"][0]["self_w"].sharding.device_set) == 2
    whole = port_params(params)
    shards = [port_params(placed, (tcfg.sage, 2, m)) for m in range(2)]
    for m, shard in enumerate(shards):
        rows = torch.from_numpy(tt.input_rows(tcfg.sage, 2, m))
        assert torch.equal(shard["aggs.0.neigh_w"],
                           whole["aggs.0.neigh_w"][rows])
        lo, hi = tt.column_blocks(8, 2)[m]
        assert torch.equal(shard["embeds"], whole["embeds"][:, lo:hi])
        assert torch.equal(shard["aggs.1.self_w"], whole["aggs.1.self_w"])
    back = params_from_model_shards(shards, tcfg.sage)
    for k, v in whole.items():
        assert torch.equal(back[k], v), k


def test_split_by_role_not_by_shape():
    """twomaxpool at F = 512: the MLP's second layer [512, 256] has
    ``input_dim`` rows, which JAX's shape rule would split
    (``graphsage_tpu/parallel/dp.py:324-326``), but it contracts the
    first layer's output: the port keeps it whole."""
    _, tcfg = configs("twomaxpool", 0, {}, feature_dim=512)
    whole = ts.init_supervised_params(torch.Generator().manual_seed(0), tcfg)
    assert whole["aggs.0.mlp.1.w"].shape == (512, 256)
    assert set(tt.split_params(tcfg.sage)) == {"aggs.0.mlp.0.w",
                                               "aggs.0.self_w"}
    _, seq = configs("seq", 4, {})
    assert tt.split_params(seq.sage) == {
        "aggs.0.self_w": (0, "rows"), "aggs.0.lstm.kernel": (0, "lstm"),
        "embeds": (1, "cols")}


def test_tp_seed_folds_the_data_index_only():
    from graphsage_tpu_torch.parallel.distributed import fold_seed

    grid = type("G", (), {"data_size": 1, "data_rank": 0})
    assert tt.tp_seed(5, grid) == 5
    grid.data_size, grid.data_rank = 2, 1
    assert tt.tp_seed(5, grid) == fold_seed(5, 1)


# ------------------------------------------------------- the rank groups

@pytest.mark.parametrize("name", list(JAX_CASES))
def test_tp_runner_matches_jax_gspmd(group, name):
    ((jparams, root_nu), jlosses, jids), outs = ranks_of(group, name)
    agg, id_dim, flags, grid = JAX_CASES[name]
    _, tcfg = configs(agg, id_dim, flags)
    _, D, M = grid
    losses = [c["loss"] for c in outs[0]["chunks"]]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert all([c["loss"] for c in o["chunks"]] == losses for o in outs)
    ids = np.concatenate([outs[d * M]["chunks"][-1]["ids"]
                          for d in range(D)])
    np.testing.assert_array_equal(ids, jids)
    ours = outs[0]["first"]["params"]
    assert ours.keys() == jparams.keys()
    assert_first_step_close(ours, jparams, root_nu)
    assert_replicas(outs, tcfg, grid)
    for k, (dim, _) in tt.split_params(tcfg.sage).items():
        assert outs[0]["local"][k].shape[dim] < jparams[k].shape[dim]


@pytest.mark.parametrize("name", list(ONE_DEVICE_CASES))
def test_tp_runner_matches_one_device(group, name):
    """Uneven blocks (and an empty one), at dropout 0.5 with the
    default sampler: one model group of two draws as one device."""
    ((params, root_nu), losses), outs = ranks_of(group, name)
    agg, F, id_dim, flags, rate = ONE_DEVICE_CASES[name]
    _, tcfg = configs(agg, id_dim, flags, feature_dim=F, dropout=rate,
                      sampler="shared_perm")
    np.testing.assert_allclose([c["loss"] for c in outs[0]["chunks"]],
                               losses, rtol=1e-5)
    assert_first_step_close(outs[0]["first"]["params"], params, root_nu)
    assert_replicas(outs, tcfg, (1, 1, 2))


def test_tp_checkpoint_state_is_whole(group):
    """The gathered Adam moments have the whole shapes and the count of
    the steps, as one device keeps them."""
    _, outs = ranks_of(group, "mean_identity")
    out = outs[0]
    assert out["count"] == N_STEPS
    for tree in ("mu", "nu"):
        assert {k: v.shape for k, v in out[tree].items()} == {
            k: v.shape for k, v in out["params"].items()}
    assert out["params"]["embeds"].shape == (N + 1, 8)
    assert out["local"]["embeds"].shape == (N + 1, 4)


def test_tp_eval_and_sweep_match_jax(group):
    ((jloss, jpreds), (jsweep_loss, jsweep_preds)), outs = ranks_of(
        group, "eval")
    for o in outs:
        loss, preds = o["eval"]
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(preds, jpreds, rtol=1e-5, atol=1e-7)
        sweep_loss, sweep_preds = o["sweep"]
        np.testing.assert_allclose(sweep_loss, jsweep_loss, rtol=1e-5)
        np.testing.assert_allclose(sweep_preds, jsweep_preds, rtol=1e-5,
                                   atol=1e-7)


def test_reduce_from_model_forward_and_backward(group):
    """The sum over the model group forward; backward, each shard's
    gradient is the whole gradient's rows. ``torch.distributed.nn``'s
    all_reduce would give M = 2 times that."""
    job, outs = ranks_of(group, "reduce")
    sage = job["sup_config"].sage
    x, w, weights = job["x"], job["w"], job["weights"]
    whole_grad = x.T @ weights
    for m, o in enumerate(outs):
        rows = tt.input_rows(sage, 2, m)
        for name in ("ours", "dist_nn"):
            np.testing.assert_allclose(o[name]["y"], x @ w, rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(o["ours"]["grad"], whole_grad[rows],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["dist_nn"]["grad"],
                                   2 * whole_grad[rows], rtol=1e-5,
                                   atol=1e-6)


def test_the_model_group_sees_one_batch_split(group):
    """At 2 x 2 the two ranks of a data slice take the same rows, and
    the two slices the two halves of each batch."""
    _, outs = ranks_of(group, "mean_identity_2x2")
    ids = [o["chunks"][-1]["ids"] for o in outs]
    np.testing.assert_array_equal(ids[0], ids[1])
    np.testing.assert_array_equal(ids[2], ids[3])
    assert len(ids[0]) == B // 2
    assert not np.array_equal(ids[0], ids[2])


def test_dataclass_grid_defaults_keep_the_sharded_layout():
    from graphsage_tpu_torch.parallel.distributed import Grid

    grid = Grid(graph_size=2, data_size=2, graph_rank=1, data_rank=1,
                graph_group=None, data_group=None)
    assert (grid.model_size, grid.model_rank, grid.total, grid.me) == (
        1, 0, 4, 3)
    assert not grid.is_chief
    assert dataclasses.replace(grid, graph_rank=0, data_rank=0).is_chief
    assert not dataclasses.replace(grid, graph_rank=0, data_rank=0,
                                   model_rank=1).is_chief
