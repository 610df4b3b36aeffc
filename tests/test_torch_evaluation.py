"""The port's evaluation (``evaluation.py``), with no scikit-learn in it,
against scikit-learn and the JAX package's ``evaluation.py``.

- With shuffling off, the port's SGD logistic regression is
  scikit-learn's ``SGDClassifier(loss="log_loss", shuffle=False)`` (its
  defaults, and with a fixed epoch count): coefficients and intercepts
  within 1e-6 of their largest magnitude, and the same epoch counts, on
  multiclass, two-class and multilabel data. Each problem is first
  checked to be one where scikit-learn's own fit moves by less than 1e-4
  of its norm when X moves by 1e-13: SGD's first epochs, at eta ~
  1/(alpha t0) = 10, can grow last-bit differences ~3x an epoch (a
  two-class fit of 40 epochs moves by 0.04), and then no two
  implementations agree whose arithmetic differs in a bit.
- With shuffling (one permutation per epoch shared by every class,
  where scikit-learn draws one per class), test and train micro-F1
  within 0.02 of the JAX package's, each the mean over seeds 1-4 (one
  seed's shuffle moves a multilabel F1 by up to 0.013), the dummy
  baseline's equal, on ``tests/test_evaluation.py``'s problems and a
  10-class mixture. The JAX package's multilabel fit runs in this
  process (``MultiOutputClassifier``'s ``n_jobs`` set to None), so that
  its ``seed`` reaches every column's shuffle.
- The ``feat`` baseline's scaling within 1e-6 of ``StandardScaler``;
  ``label_tsvs``, the ``val-test.npy`` branch and the ``eval``
  subcommand against the JAX package's ``evaluate_embeddings``, F1s as
  above.
"""

import warnings

import numpy as np
import pytest
import sklearn.multioutput
from sklearn.linear_model import SGDClassifier
from sklearn.multioutput import MultiOutputClassifier
from sklearn.preprocessing import StandardScaler

from graphsage_tpu import evaluation as jev
from graphsage_tpu.data.synthetic import make_synthetic_graph, write_dataset
from graphsage_tpu_torch import cli
from graphsage_tpu_torch import evaluation as tev

SEEDS = (1, 2, 3, 4)
F1_KEYS = ("test_f1", "train_f1", "test_f1_pos", "train_f1_pos")


@pytest.fixture()
def jax_in_process(monkeypatch):
    """The JAX package's MultiOutputClassifier without worker processes,
    whose global NumPy generators its ``seed`` does not reach."""
    init = sklearn.multioutput.MultiOutputClassifier.__init__

    def in_process(self, estimator, *, n_jobs=None):
        init(self, estimator, n_jobs=None)

    monkeypatch.setattr(sklearn.multioutput.MultiOutputClassifier,
                        "__init__", in_process)


def _mean_over_seeds(fn):
    """{key: mean over SEEDS} of ``fn(seed)``'s result dict."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs = [fn(seed) for seed in SEEDS]
    return {k: float(np.mean([r[k] for r in runs])) for k in runs[0]}


def _close(ours, theirs):
    assert set(theirs) <= set(ours)
    for k in F1_KEYS:
        if k in theirs:
            assert abs(ours[k] - theirs[k]) <= 0.02, k
    for k in ("dummy_f1", "dummy_f1_pos"):
        if k in theirs:
            assert ours[k] == pytest.approx(theirs[k], abs=1e-12), k


def _problem(kind):
    """(X, y) of tests/test_evaluation.py's kind, or a two-class one."""
    if kind == "multiclass":
        rng = np.random.default_rng(0)
        y = rng.integers(0, 3, 200)
        return np.eye(3, 8)[y] * 4 + rng.normal(0, 0.5, (200, 8)), y
    if kind == "multilabel":
        rng = np.random.default_rng(1)
        y = (rng.random((200, 4)) > 0.5).astype(np.int32)
        return y + rng.normal(0, 0.3, (200, 4)), y
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 300) * 5 + 2          # labels 2 and 7
    return (y[:, None] > 2) * np.ones(6) + rng.normal(0, 1.5, (300, 6)), y


def _sklearn_fit(X, y, **kw):
    """(coef [C, d], intercept [C], epochs)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if y.ndim == 2:
            est = MultiOutputClassifier(SGDClassifier(
                loss="log_loss", shuffle=False, **kw)).fit(X, y)
            return (np.vstack([e.coef_ for e in est.estimators_]),
                    np.concatenate([e.intercept_ for e in est.estimators_]),
                    [e.n_iter_ for e in est.estimators_])
        est = SGDClassifier(loss="log_loss", shuffle=False, **kw).fit(X, y)
        return est.coef_, est.intercept_, est.n_iter_


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("kind", ["multiclass", "two_class", "multilabel"])
@pytest.mark.parametrize("max_iter", [None, 100])
def test_unshuffled_fit_equals_sklearn(kind, max_iter):
    X, y = _problem(kind)
    kw = {} if max_iter is None else {"max_iter": max_iter, "tol": None}
    coef, intercept, epochs = _sklearn_fit(X, y, **kw)
    assert _rel(_sklearn_fit(X * (1 + 1e-13), y, **kw)[0], coef) < 1e-4
    ours = tev.LogisticSGD(max_iter, shuffle=False).fit(X, y)
    assert _rel(ours.coef_.numpy(), coef) < 1e-6
    assert _rel(ours.intercept_.numpy(), intercept) < 1e-6
    if y.ndim == 2:
        assert list(ours.n_iter_) == list(epochs)
    else:
        assert ours.n_iter_.max() == epochs
    np.testing.assert_array_equal(ours.predict(X),
                                  _predict(coef, intercept, y, X))


def _predict(coef, intercept, y, X):
    """scikit-learn's decision rule on given coefficients."""
    scores = X @ coef.T + intercept
    if y.ndim == 2:
        return (scores > 0).astype(y.dtype)
    classes = np.unique(y)
    if len(classes) == 2:
        return classes[(scores[:, 0] > 0).astype(int)]
    return classes[np.argmax(scores, axis=1)]


def _mixture():
    rng = np.random.default_rng(2)
    centers = rng.normal(0, 1, (10, 16))
    ytr, yte = rng.integers(0, 10, 600), rng.integers(0, 10, 300)
    return (centers[ytr] + rng.normal(0, 0.7, (600, 16)), ytr,
            centers[yte] + rng.normal(0, 0.7, (300, 16)), yte)


def _evaluation_problem(kind):
    """tests/test_evaluation.py's train/test splits."""
    if kind == "mixture":
        return _mixture()
    rng = np.random.default_rng(0 if kind == "single" else 1)
    if kind == "single":
        centers = np.eye(3, 8, dtype=np.float32) * 4
        ytr, yte = rng.integers(0, 3, 200), rng.integers(0, 3, 100)
        return (centers[ytr] + rng.normal(0, 0.5, (200, 8)), ytr,
                centers[yte] + rng.normal(0, 0.5, (100, 8)), yte)
    ytr = (rng.random((200, 4)) > 0.5).astype(np.int32)
    yte = (rng.random((100, 4)) > 0.5).astype(np.int32)
    return (ytr + rng.normal(0, 0.3, (200, 4)), ytr,
            yte + rng.normal(0, 0.3, (100, 4)), yte)


@pytest.mark.parametrize("kind", ["single", "multilabel", "mixture"])
def test_shuffled_f1_within_002_of_jax(jax_in_process, kind):
    xtr, ytr, xte, yte = _evaluation_problem(kind)
    theirs = _mean_over_seeds(
        lambda s: jev.run_regression(xtr, ytr, xte, yte, seed=s))
    ours = _mean_over_seeds(
        lambda s: tev.run_regression(xtr, ytr, xte, yte, seed=s,
                                     device="cpu"))
    _close(ours, theirs)
    assert ours["test_f1"] > 0.9


def test_fixed_epochs_run_without_a_stop():
    xtr, ytr, _, _ = _mixture()
    fit = tev.LogisticSGD(3, seed=5).fit(xtr, ytr)
    assert list(fit.n_iter_) == [3] * 10


def test_single_class_column_raises():
    with pytest.raises(ValueError, match="greater than one"):
        tev.LogisticSGD(2).fit(np.zeros((4, 2)), np.array([[1, 0]] * 4))


def test_standard_scale_matches_sklearn():
    rng = np.random.default_rng(4)
    feats = rng.normal(3, 2, (50, 6)).astype(np.float32)
    feats[:, 2] = 7.0                       # a constant column
    train = np.arange(0, 50, 2)
    ours = tev.standard_scale(feats, train)
    theirs = StandardScaler().fit(feats[train]).transform(feats)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    g = make_synthetic_graph(num_nodes=600, num_classes=3, feat_dim=8,
                             seed=2)
    prefix = str(tmp_path_factory.mktemp("ds") / "synth")
    write_dataset(g, prefix)
    return g, prefix


def _both(prefix, embed_dir, **kw):
    """(ours, theirs): evaluate_embeddings' results, means over SEEDS."""
    theirs = _mean_over_seeds(lambda s: jev.evaluate_embeddings(
        prefix, embed_dir, "test", seed=s, **kw))
    ours = _mean_over_seeds(lambda s: tev.evaluate_embeddings(
        prefix, embed_dir, "test", seed=s, device="cpu", **kw))
    return ours, theirs


def test_feat_baseline_and_label_tsvs_match_jax(dataset, tmp_path):
    g, prefix = dataset
    ours, theirs = _both(prefix, "feat")
    _close(ours, theirs)
    classes = np.argmax(g.labels, axis=1)
    tsvs = []
    for c in range(3):   # class 2 loses a third of its nodes
        ids = np.flatnonzero(classes == c)
        if c == 2:
            ids = ids[::3]
        path = tmp_path / f"class_{c}.tsv"
        path.write_text("\n".join(["id\tmeta"] + [f"{g.node_ids[i]}\tx"
                                                  for i in ids]))
        tsvs.append(str(path))
    assert tev.read_label_tsvs(tsvs) == jev.read_label_tsvs(tsvs)
    ours, theirs = _both(prefix, "feat", label_tsvs=tsvs)
    _close(ours, theirs)


def test_val_test_branch_takes_eval_rows_from_the_retrain(dataset,
                                                          tmp_path):
    """val.npy's eval rows are noise and val-test.npy's carry the labels:
    only the branch that reads val-test.npy for them scores well."""
    g, prefix = dataset
    rng = np.random.default_rng(3)
    good = g.labels + rng.normal(0, 0.2, g.labels.shape)
    noise = rng.normal(0, 1, g.labels.shape)
    is_eval = g.is_val | g.is_test
    first = np.where(is_eval[:, None], noise, good)
    order = rng.permutation(g.num_nodes)     # rows in another order
    ids = "\n".join(str(g.node_ids[i]) for i in order)
    np.save(tmp_path / "val.npy", first[order])
    (tmp_path / "val.txt").write_text(ids)
    np.save(tmp_path / "val-test.npy", good[order])
    (tmp_path / "val-test.txt").write_text(ids)
    ours, theirs = _both(prefix, str(tmp_path))
    _close(ours, theirs)
    assert ours["test_f1"] > 0.9


def test_eval_cli(dataset, capsys):
    _, prefix = dataset
    assert cli.main(["eval", prefix, "feat", "test", "--seed", "3",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "test F1 (micro):" in out and "fit time:" in out
    assert cli.main(["eval", prefix, "feat", "val", "--sgd_max_iter", "2",
                     "--device", "cpu"]) == 0
    assert "val F1 (micro):" in capsys.readouterr().out
