"""The port's NumPy F1 against the JAX package's scikit-learn F1."""

import numpy as np
import pytest

from graphsage_tpu.train.metrics import calc_f1 as sk_calc_f1
from graphsage_tpu_torch.train.metrics import calc_f1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,C", [(200, 5), (37, 2), (64, 12)])
def test_softmax_f1_matches_sklearn(seed, n, C):
    rng = np.random.default_rng(seed)
    labels = np.eye(C)[rng.integers(0, C, n)]
    # skew the predictions so some classes are never predicted
    preds = rng.random((n, C)) * np.linspace(1.0, 0.2, C)
    np.testing.assert_allclose(calc_f1(labels, preds, False),
                               sk_calc_f1(labels, preds, False), atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,C", [(200, 6), (15, 9)])
def test_sigmoid_f1_matches_sklearn(seed, n, C):
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, C)) < 0.3).astype(np.float32)
    labels[:, 0] = 0.0                 # a class with no positives ...
    preds = rng.random((n, C)).astype(np.float32)
    preds[:, 0] = 0.0                  # ... and none predicted: F1 0
    np.testing.assert_allclose(calc_f1(labels, preds, True),
                               sk_calc_f1(labels, preds, True), atol=1e-12)


def test_all_empty_multilabel_scores_zero():
    z = np.zeros((4, 3))
    assert calc_f1(z, z, True) == (0.0, 0.0)
    assert sk_calc_f1(z, z, True) == (0.0, 0.0)
