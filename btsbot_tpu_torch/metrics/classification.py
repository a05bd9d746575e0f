"""Alert-level classification metrics, vectorized numpy.

A numpy-only copy of btsbot_tpu.metrics.classification, which the port cannot
import (the JAX package's ``__init__`` loads flax).

Replaces the reference's sklearn/list-comprehension metric code
(reference val.py:185-221) with O(N log N) vectorized
equivalents; cross-checked against sklearn in tests.
"""

from __future__ import annotations

import numpy as np


def roc_curve(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) matching sklearn.metrics.roc_curve on
    deduplicated thresholds (descending)."""
    labels = np.asarray(labels).astype(bool).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    labels = labels[order]

    # indices where the score changes (threshold boundaries)
    distinct = np.where(np.diff(scores))[0]
    idx = np.r_[distinct, labels.size - 1]

    tps = np.cumsum(labels)[idx]
    fps = (idx + 1) - tps
    p = labels.sum()
    n = labels.size - p
    tpr = tps / max(p, 1)
    fpr = fps / max(n, 1)
    return (np.r_[0.0, fpr], np.r_[0.0, tpr],
            np.r_[scores[0] + 1.0, scores[idx]])


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    # np.trapz was renamed trapezoid in numpy 2.0; support both so an
    # unpinned install on numpy 1.x doesn't AttributeError
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(tpr, fpr))


def confusion_counts(labels: np.ndarray, preds: np.ndarray):
    """(TP, FP, TN, FN) from binary int arrays (val.py:188-196)."""
    labels = np.asarray(labels).astype(int).ravel()
    preds = np.asarray(preds).astype(int).ravel()
    tp = int(np.sum((labels == 1) & (preds == 1)))
    fp = int(np.sum((labels == 0) & (preds == 1)))
    tn = int(np.sum((labels == 0) & (preds == 0)))
    fn = int(np.sum((labels == 1) & (preds == 0)))
    return tp, fp, tn, fn


def alert_metrics(labels: np.ndarray, raw_preds: np.ndarray,
                  threshold: float = 0.5) -> dict:
    """The reference's alert-level summary block (val.py:185-221):
    ROC-AUC, per-class accuracies, balanced accuracy, precision/recall.
    Degenerate classes yield the reference's -999.0 sentinels."""
    preds = np.rint(np.asarray(raw_preds)).astype(int) \
        if threshold == 0.5 else (np.asarray(raw_preds) > threshold).astype(int)
    tp, fp, tn, fn = confusion_counts(labels, preds)

    bts_acc = tp / max(1, tp + fn)
    notbts_acc = tn / max(1, tn + fp)
    bal_acc = (bts_acc + notbts_acc) / 2

    if tp > 0 and tn > 0:
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)
    else:
        precision = -999.0
        recall = -999.0

    return {
        "roc_auc": roc_auc(labels, raw_preds),
        "bts_acc": bts_acc,
        "notbts_acc": notbts_acc,
        "bal_acc": bal_acc,
        "alert_precision": precision,
        "alert_recall": recall,
        "accuracy": float(np.mean(preds == np.asarray(labels).astype(int))),
        "confusion": {"TP": tp, "FP": fp, "TN": tn, "FN": fn},
    }

