"""Downstream evaluation: logistic regression over saved embeddings.

The reference's eval scripts: an SGD logistic classifier fitted on the
train nodes' embeddings, micro-F1 on the val or test nodes, beside a
raw-feature baseline (``feat``) and a most-frequent-class baseline.
Multilabel datasets fit one binary classifier per label column, single
label ones one-vs-rest (one binary classifier for two classes). This is
how unsupervised runs (GraphSAGE and node2vec) are scored.

The classifier is scikit-learn's ``SGDClassifier(loss="log_loss")``
with its defaults, written in torch (the port imports no scikit-learn):
L2 penalty alpha 1e-4 applied by scaling the weights, an intercept, the
"optimal" rate eta = 1 / (alpha (t0 + t)) with Bottou's t0, one update
per sample in float64, and a stop once the epoch's mean objective has
not improved by ``tol`` 1e-3 for 5 epochs (at most 1000 epochs; with
``sgd_max_iter`` that many, with no stop). Every binary problem steps
on the same sample at once, as rows of one [C, d] weight matrix, and a
problem that has stopped keeps the weights it stopped with (its row
steps on, unread). A step is five operations: the scores, the loss
gradient (two), the weight and the intercept updates, plus the weights'
norms where the stop reads the objective. On the card the scores' op
copies the intercepts first, so a step is six kernels (seven with the
norms): the loop is bound by kernel launches, and the CPU fits faster
(``--device cpu``). The epoch's objective is summed at its end from the
stored scores. Without shuffling the fit equals scikit-learn's; with
it, every problem shares one permutation per epoch from
``default_rng(seed)`` where scikit-learn draws its own per problem, so
the fits differ as two shuffles do.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from graphsage_tpu_torch.device import resolve_device

ALPHA = 1e-4
TOL = 1e-3
MAX_ITER = 1000
N_ITER_NO_CHANGE = 5
WSCALE_MIN = 1e-9     # below it the weight scale is folded into the rows


def fit_sgd_logistic(X: torch.Tensor, Y: torch.Tensor,
                     max_iter: int = MAX_ITER, tol: float | None = TOL,
                     shuffle: bool = True, seed: int = 0,
                     alpha: float = ALPHA):
    """Binary logistic SGD for every column of ``Y``.

    ``X`` [n, d] and ``Y`` [n, C] in {0, 1}, float64 on one device.
    Returns (coef [C, d], intercept [C], epochs run [C] on the host).
    """
    n, d = X.shape
    C = Y.shape[1]
    dev = X.device
    W = torch.zeros(C, d, dtype=torch.float64, device=dev)
    b = torch.zeros(C, dtype=torch.float64, device=dev)
    coef = torch.zeros_like(W)
    intercept = torch.zeros_like(b)
    wscale = 1.0
    # the rate's t0: eta at the first sample is typw / max(1, -grad)
    typw = math.sqrt(1.0 / math.sqrt(alpha))
    grad0 = 1.0 / (1.0 + math.exp(typw)) - 1.0   # at y = 1, p = -typw
    optimal_init = 1.0 / (typw / max(1.0, grad0) * alpha)
    t = 1
    best = np.full(C, np.inf)
    no_improvement = np.zeros(C, dtype=np.int64)
    epochs = np.full(C, max_iter, dtype=np.int64)
    running = np.ones(C, dtype=bool)
    rng = np.random.default_rng(seed)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    scores = torch.empty(n, C, dtype=torch.float64, device=dev)
    dloss = torch.empty(C, dtype=torch.float64, device=dev)
    # ||w||^2 after each sample's step (the objective's L2 term), kept
    # only where the tolerance stop reads the objective
    norms = torch.empty_like(scores) if tol is not None else None
    scales = np.empty(n)
    sq_before = torch.zeros(C, dtype=torch.float64, device=dev)

    def freeze(cs):
        coef[cs] = W[cs] * wscale
        intercept[cs] = b[cs]

    for epoch in range(max_iter):
        order = rng.permutation(n) if shuffle else np.arange(n)
        for k, i in enumerate(order):
            x = X[i]
            # the score; a problem that has stopped steps on, unread
            p = torch.addmv(b, W, x, alpha=wscale, out=scores[k])
            eta = 1.0 / (alpha * (optimal_init + t - 1))
            torch.sigmoid(p, out=dloss).sub_(Y[i])
            wscale *= max(0.0, 1.0 - eta * alpha)
            if wscale < WSCALE_MIN:
                W *= wscale
                wscale = 1.0
            W.addr_(dloss, x, alpha=-eta / wscale)
            b.add_(dloss, alpha=-eta)
            if norms is not None:
                torch.linalg.vector_norm(W, dim=1, out=norms[k])
                scales[k] = wscale
            t += 1
        if not (torch.isfinite(b).all() and torch.isfinite(W).all()):
            raise ValueError(
                f"floating-point under-/overflow at epoch {epoch + 1}: "
                "scale the inputs")
        if tol is None:
            continue
        # the epoch's objective: each sample's loss log(1 + e^p) - y p
        # plus the L2 term of the weights it was scored with
        y = Y[torch.from_numpy(order).to(dev)]
        sq = norms.square() * torch.from_numpy(scales * scales).to(
            norms)[:, None]
        objective = ((torch.logaddexp(scores, zero) - y * scores).sum(0)
                     + 0.5 * alpha * (sq_before + sq[:-1].sum(0)))
        sq_before = sq[-1]
        mean_objective = objective.cpu().numpy() / n
        stop = []
        for c in np.flatnonzero(running):
            if mean_objective[c] > best[c] - tol:
                no_improvement[c] += 1
            else:
                no_improvement[c] = 0
            best[c] = min(best[c], mean_objective[c])
            if no_improvement[c] >= N_ITER_NO_CHANGE:
                stop.append(c)
                epochs[c] = epoch + 1
        if stop:
            freeze(torch.as_tensor(stop, device=dev))
            running[stop] = False
        if not running.any():
            break
    if running.any():
        freeze(torch.as_tensor(np.flatnonzero(running), device=dev))
    return coef, intercept, epochs


class LogisticSGD:
    """``SGDClassifier(loss="log_loss")`` for one label vector (one
    binary classifier, or one-vs-rest over three classes or more) or a
    multilabel matrix (one binary classifier per column, as
    ``MultiOutputClassifier``)."""

    def __init__(self, max_iter: int | None = None, shuffle: bool = True,
                 seed: int = 0, device="cpu"):
        self.max_iter = MAX_ITER if max_iter is None else max_iter
        self.tol = TOL if max_iter is None else None
        self.shuffle = shuffle
        self.seed = seed
        self.device = torch.device(device)

    def fit(self, X, y) -> "LogisticSGD":
        y = np.asarray(y)
        self.multilabel = y.ndim == 2
        columns = y.T if self.multilabel else y[None]
        self.classes_ = [np.unique(col) for col in columns]
        for cl in self.classes_:
            if len(cl) < 2:
                raise ValueError("The number of classes has to be greater "
                                 f"than one; got {len(cl)} class")
        if self.multilabel or len(self.classes_[0]) == 2:
            targets = np.stack([col == cl[1] for col, cl
                                in zip(columns, self.classes_)], axis=1)
        else:
            targets = y[:, None] == self.classes_[0][None, :]
        self.coef_, self.intercept_, self.n_iter_ = fit_sgd_logistic(
            self._tensor(X), self._tensor(targets.astype(np.float64)),
            self.max_iter, self.tol, self.shuffle, self.seed)
        return self

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device)

    def predict(self, X) -> np.ndarray:
        scores = (self._tensor(X) @ self.coef_.T
                  + self.intercept_).cpu().numpy()
        if self.multilabel:
            return np.stack([cl[(s > 0).astype(np.int64)] for s, cl
                             in zip(scores.T, self.classes_)], axis=1)
        classes = self.classes_[0]
        if len(classes) == 2:
            return classes[(scores[:, 0] > 0).astype(np.int64)]
        return classes[np.argmax(scores, axis=1)]


def prior_predict(train_labels, n: int) -> np.ndarray:
    """``DummyClassifier``'s "prior" strategy: the most frequent train
    label (the smallest of a tie), per column for multilabel, for ``n``
    rows."""
    y = np.asarray(train_labels)
    columns = y.T if y.ndim == 2 else y[None]
    modes = []
    for col in columns:
        values, counts = np.unique(col, return_counts=True)
        modes.append(values[np.argmax(counts)])
    out = np.tile(np.asarray(modes)[None, :], (n, 1))
    return out if y.ndim == 2 else out[:, 0]


def micro_f1_pos(y_true, y_pred) -> float:
    """Micro-F1 of the positive cells of multilabel matrices (0 when no
    cell is positive in either)."""
    t = np.asarray(y_true) > 0
    p = np.asarray(y_pred) > 0
    tp = float((t & p).sum())
    denom = 2 * tp + float((~t & p).sum()) + float((t & ~p).sum())
    return 2 * tp / denom if denom > 0 else 0.0


def run_regression(train_embeds, train_labels, test_embeds, test_labels,
                   seed: int = 1, sgd_max_iter: int | None = None,
                   device="cuda") -> dict:
    """-> {"test_f1", "train_f1", "dummy_f1"} (+ "*_f1_pos" multilabel),
    "fit_seconds", the classifier's fit on ``device`` (``cuda`` unless
    the caller asks for ``cpu``), and "fit_updates", its per-sample
    steps (train rows x the most epochs any problem ran).

    ``*_f1`` is micro-F1 over all labels: accuracy for single-label
    data, and for multilabel data the share of cells right (the
    reference's per-column prints pooled). ``*_f1_pos`` is micro-F1 of
    the positive cells, the paper's PPI metric, where an all-negative
    predictor scores 0. ``sgd_max_iter`` fixes the SGD epochs (no
    tolerance stop)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    log = LogisticSGD(sgd_max_iter, seed=seed, device=device).fit(
        train_embeds, train_labels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_seconds = time.perf_counter() - t0
    test_pred = log.predict(test_embeds)
    train_pred = log.predict(train_embeds)
    dummy_pred = prior_predict(train_labels, len(test_embeds))

    def f1(y_true, y_pred):
        return float(np.mean(np.asarray(y_true).ravel()
                             == np.asarray(y_pred).ravel()))

    out = {
        "test_f1": f1(test_labels, test_pred),
        "train_f1": f1(train_labels, train_pred),
        "dummy_f1": f1(test_labels, dummy_pred),
    }
    if log.multilabel:
        out["test_f1_pos"] = micro_f1_pos(test_labels, test_pred)
        out["train_f1_pos"] = micro_f1_pos(train_labels, train_pred)
        out["dummy_f1_pos"] = micro_f1_pos(test_labels, dummy_pred)
    out["fit_seconds"] = fit_seconds
    out["fit_updates"] = len(train_embeds) * int(log.n_iter_.max())
    return out


def standard_scale(feats: np.ndarray, train_idx) -> np.ndarray:
    """``StandardScaler`` fitted on the ``train_idx`` rows: float64 mean
    and population std, near-constant columns left unscaled."""
    rows = np.asarray(feats, dtype=np.float64)[train_idx]
    mean = rows.mean(axis=0)
    var = rows.var(axis=0)
    n = rows.shape[0]
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.where(constant, 1.0, np.sqrt(var))
    return ((np.asarray(feats, dtype=np.float64) - mean)
            / scale).astype(feats.dtype)


def load_embeddings(embed_dir: str, mod: str = ""):
    """(embeds [K, d], id -> row) from val<mod>.npy / val<mod>.txt."""
    embeds = np.load(os.path.join(embed_dir, f"val{mod}.npy"))
    with open(os.path.join(embed_dir, f"val{mod}.txt")) as fp:
        id_map = {line.strip(): i for i, line in enumerate(fp)}
    return embeds, id_map


def read_label_tsvs(paths):
    """Class map from per-class TSV files: class i is the index of the
    file, the node id its first column, the header line skipped (the
    reference's citation eval)."""
    class_map = {}
    for i, path in enumerate(paths):
        with open(path) as fp:
            fp.readline()
            for line in fp:
                parts = line.split()
                if parts:
                    class_map[parts[0]] = i
    return class_map


def evaluate_embeddings(prefix: str, embed_dir: str, setting: str = "test",
                        seed: int = 1, label_tsvs=None,
                        sgd_max_iter: int | None = None,
                        device="cuda") -> dict:
    """Load the dataset and the embeddings, split, regress, print.

    ``embed_dir`` "feat" scores the raw features, standardized on the
    train rows. When ``val-test.npy`` is there (node2vec's retrain), the
    train rows come from ``val.npy`` and the eval rows from it."""
    from graphsage_tpu_torch.data.io import load_data

    if setting not in ("val", "test"):
        raise ValueError(f"setting must be val or test, got {setting!r}")
    graph = load_data(prefix, normalize=False)
    is_eval = graph.is_val if setting == "val" else graph.is_test
    train_idx = np.flatnonzero(graph.is_train)
    eval_idx = np.flatnonzero(is_eval)

    if label_tsvs:
        # nodes in no TSV leave both splits
        cm = read_label_tsvs(label_tsvs)
        labeled = np.asarray([str(nid) in cm for nid in graph.node_ids],
                             dtype=bool)
        train_idx = train_idx[labeled[train_idx]]
        eval_idx = eval_idx[labeled[eval_idx]]
        y = np.asarray([cm.get(str(nid), -1) for nid in graph.node_ids],
                       dtype=np.int64)
    elif isinstance(next(iter(graph.class_map.values())),
                    (list, np.ndarray)):
        y = graph.labels.astype(np.int32)
    else:
        y = np.argmax(graph.labels, axis=1)

    if embed_dir == "feat":
        feats = standard_scale(graph.features, train_idx)
        train_embeds, eval_embeds = feats[train_idx], feats[eval_idx]
    else:
        embeds, id_map = load_embeddings(embed_dir)
        train_embeds = embeds[[id_map[str(graph.node_ids[i])]
                               for i in train_idx]]
        if os.path.exists(os.path.join(embed_dir, "val-test.npy")):
            embeds, id_map = load_embeddings(embed_dir, mod="-test")
        eval_embeds = embeds[[id_map[str(graph.node_ids[i])]
                              for i in eval_idx]]

    result = run_regression(train_embeds, y[train_idx], eval_embeds,
                            y[eval_idx], seed=seed,
                            sgd_max_iter=sgd_max_iter, device=device)
    print(f"{setting} F1 (micro): {result['test_f1']:.5f}")
    print(f"train F1 (micro): {result['train_f1']:.5f}")
    print(f"dummy baseline F1 (micro): {result['dummy_f1']:.5f}")
    if "test_f1_pos" in result:
        print(f"{setting} multilabel micro-F1 (positives): "
              f"{result['test_f1_pos']:.5f} "
              f"(dummy {result['dummy_f1_pos']:.5f})")
    print(f"fit time: {result['fit_seconds']:.3f} s on {device}, "
          f"{result['fit_updates']} sample updates")
    return result
