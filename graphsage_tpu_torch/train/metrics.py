"""Micro and macro F1 in NumPy, with the reference's thresholding.

Softmax takes the argmax as the single label; sigmoid (multilabel)
rounds at 0.5. Scores follow scikit-learn's ``f1_score`` with
``zero_division=0``: a class with no true and no predicted positives
scores 0. Macro averages over the labels present in either argument
(multiclass) or over every column (multilabel).
"""

from __future__ import annotations

import numpy as np


def _f1(tp, fp, fn):
    denom = 2 * tp + fp + fn
    return np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)


def calc_f1(y_true: np.ndarray, y_pred: np.ndarray, sigmoid: bool):
    """(micro_f1, macro_f1) of [n, C] label and prediction matrices."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if sigmoid:
        t = y_true > 0.5
        p = y_pred > 0.5
    else:
        true_cls = np.argmax(y_true, axis=1)
        pred_cls = np.argmax(y_pred, axis=1)
        labels = np.union1d(true_cls, pred_cls)
        t = true_cls[:, None] == labels[None, :]
        p = pred_cls[:, None] == labels[None, :]
    tp = (t & p).sum(axis=0).astype(np.float64)
    fp = (~t & p).sum(axis=0).astype(np.float64)
    fn = (t & ~p).sum(axis=0).astype(np.float64)
    micro = float(_f1(tp.sum(), fp.sum(), fn.sum()))
    macro = float(_f1(tp, fp, fn).mean()) if tp.size else 0.0
    return micro, macro
