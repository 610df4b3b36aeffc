"""The port's masked losses, accuracy and MLP baseline (``nn/metrics.py``)
against the JAX package's ``nn/metrics.py``, on the same inputs and the
same MLP weights (the bridge), at 1e-6; gradients at atol 1e-6, rtol
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.nn import metrics as jm
from graphsage_tpu_torch.nn import metrics as tm
from graphsage_tpu_torch.params import params_from_jax
from tests._torch_common import t

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    preds = rng.standard_normal((9, 5)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 9)]
    multi = (rng.random((9, 5)) > 0.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 0, 1], dtype=np.float32)
    return preds, labels, multi, mask


@pytest.mark.parametrize("name,which", [
    ("masked_softmax_cross_entropy", "labels"),
    ("masked_logit_cross_entropy", "multi"),
    ("masked_l2", "multi"),
    ("masked_accuracy", "labels"),
])
def test_masked_metrics_match_jax(inputs, name, which):
    preds, labels, multi, mask = inputs
    y = labels if which == "labels" else multi
    for m in (mask, np.zeros_like(mask), np.ones_like(mask)):
        want = float(getattr(jm, name)(jnp.asarray(preds), jnp.asarray(y),
                                       jnp.asarray(m)))
        got = float(getattr(tm, name)(t(preds), t(y), t(m)))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("categorical,weight_decay", [(True, 0.0),
                                                      (True, 0.01),
                                                      (False, 0.01)])
def test_mlp_loss_and_gradients_match_jax(inputs, categorical, weight_decay):
    preds, labels, _, mask = inputs
    x = preds
    jparams = jm.init_mlp_params(jax.random.key(2), (5, 7, 5))
    params = {k: params_from_jax(v) for k, v in
              jax.device_get(jparams).items()}
    for layer in params.values():
        for p in layer.values():
            p.requires_grad_(True)
    (jloss, jout), jgrads = jax.value_and_grad(jm.mlp_loss, has_aux=True)(
        jparams, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask),
        weight_decay=weight_decay, categorical=categorical)
    loss, out = tm.mlp_loss(params, t(x), t(labels), t(mask),
                            weight_decay=weight_decay,
                            categorical=categorical)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for layer in ("l1", "l2"):
        for k in ("w", "b"):
            np.testing.assert_allclose(
                params[layer][k].grad.numpy(),
                np.asarray(jgrads[layer][k]), atol=1e-6, rtol=1e-5,
                err_msg=f"{layer}.{k}")


def test_mlp_init_shapes_and_dropout():
    params = tm.init_mlp_params(torch.Generator().manual_seed(0), (4, 6, 3))
    assert params["l1"]["w"].shape == (4, 6)
    assert params["l2"]["b"].shape == (3,)
    assert (params["l1"]["b"] == 0).all()
    x = torch.ones(5, 4)
    det = tm.mlp_forward(params, x, dropout_rate=0.5)
    torch.testing.assert_close(det, tm.mlp_forward(params, x))
    dropped = tm.mlp_forward(params, x, dropout_rate=0.5,
                             generator=torch.Generator().manual_seed(1),
                             deterministic=False)
    assert dropped.shape == (5, 3) and not torch.equal(dropped, det)
