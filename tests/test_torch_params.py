"""The weight bridge (graphsage_tpu_torch/params.py) and the port's torch
checkpoints."""

import jax
import numpy as np
import pytest
import torch

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu_torch.params import params_from_jax, params_to_jax
from graphsage_tpu_torch.train import checkpoint


def _jax_params(aggregator, identity_dim):
    mult = 2 if aggregator == "gcn" else 1
    sage = jg.SAGEConfig(
        layers=(jg.LayerInfo(4, 8 * mult), jg.LayerInfo(3, 8 * mult),
                jg.LayerInfo(2, 8 * mult)),
        feature_dim=6, aggregator=aggregator,
        concat=aggregator != "gcn", identity_dim=identity_dim, num_nodes=30)
    return jax.device_get(js.init_supervised_params(
        jax.random.key(0), js.SupervisedConfig(sage=sage, num_classes=5)))


@pytest.mark.parametrize("aggregator,identity_dim", [
    ("mean", 0), ("mean", 4), ("gcn", 4), ("meanpool", 0), ("maxpool", 4),
    ("twomaxpool", 0), ("seq", 0),
])
def test_bridge_round_trips_every_leaf(aggregator, identity_dim):
    tree = _jax_params(aggregator, identity_dim)
    flat = params_from_jax(tree)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(leaves)
    assert "head.w" in flat and "aggs.2.b" not in flat
    assert ("embeds" in flat) == (identity_dim > 0)
    back = params_to_jax(flat)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for path, leaf in leaves:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert flat[key].dtype == torch.float32
        np.testing.assert_array_equal(flat[key].numpy(), leaf)
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              leaves):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trips_exactly(tmp_path):
    params = params_from_jax(_jax_params("mean", 4))
    root = str(tmp_path / "ck")
    assert checkpoint.restore(root) is None
    checkpoint.save(root, params, 7)
    checkpoint.save(root, {k: v + 1 for k, v in params.items()}, 3)
    assert checkpoint.latest_step(root) == 7
    restored, step = checkpoint.restore(root)
    assert step == 7 and restored.keys() == params.keys()
    for k, v in params.items():
        assert torch.equal(restored[k], v)
    assert not [f for f in (tmp_path / "ck").iterdir()
                if f.suffix == ".tmp"]


def test_pool_checkpoint_round_trips_mlp_and_moments(tmp_path):
    """The pooling MLP's keys (aggs.{i}.mlp.{j}.{w,b}) and their Adam
    moments survive a checkpoint exactly, and go back to the JAX pytree
    as the list of Dense layers."""
    tree = _jax_params("twomaxpool", 0)
    params = params_from_jax(tree)
    assert {"aggs.0.mlp.0.w", "aggs.0.mlp.1.b", "aggs.2.mlp.1.w"} <= \
        params.keys()
    assert len(params_to_jax(params)["aggs"][1]["mlp"]) == 2
    moments = {k: v * 0.5 for k, v in params.items()}
    opt_state = {"count": 4, "mu": moments, "nu": {
        k: v * v for k, v in moments.items()}}
    checkpoint.save(str(tmp_path), params, 4, opt_state)
    saved, saved_opt, step = checkpoint.restore_train_state(str(tmp_path))
    assert step == 4 and saved_opt["count"] == 4
    for k, v in params.items():
        assert torch.equal(saved[k], v)
        assert torch.equal(saved_opt["mu"][k], opt_state["mu"][k])
        assert torch.equal(saved_opt["nu"][k], opt_state["nu"][k])
