"""Score calibration: temperature scaling + expected calibration error.

A copy of ``btsbot_tpu/metrics/calibration.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package.

The reference ships raw sigmoid scores into a fixed policy threshold
(score > 0.85 at magpsf < 19, val.py:410-418) with no calibration step.
Deep classifiers are typically overconfident (Guo et al. 2017,
arXiv:1706.04599); a miscalibrated scorer silently shifts the operating
point of every downstream policy.  This module adds the standard post-hoc
fix — a single temperature fitted on validation data — plus the ECE
diagnostic, so a deployed model's 0.85 threshold means what it says.

Pure numpy on host (N ≲ 1e6 validation scores; no device round trips).
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-7


def scores_to_logits(scores: np.ndarray) -> np.ndarray:
    """Invert the sigmoid (scores clipped away from {0,1} for stability)."""
    s = np.clip(np.asarray(scores, np.float64), _EPS, 1.0 - _EPS)
    return np.log(s) - np.log1p(-s)


def nll(logits: np.ndarray, labels: np.ndarray,
        temperature: float = 1.0) -> float:
    """Mean binary NLL of sigmoid(logits / T) against labels."""
    z = np.asarray(logits, np.float64) / float(temperature)
    y = np.asarray(labels, np.float64)
    # stable: log(1+e^z) = max(z,0) + log1p(e^-|z|)
    softplus = np.maximum(z, 0.0) + np.log1p(np.exp(-np.abs(z)))
    return float(np.mean(softplus - y * z))


def fit_temperature(logits: np.ndarray, labels: np.ndarray,
                    bounds: tuple[float, float] = (0.05, 20.0),
                    iters: int = 60) -> float:
    """Fit the NLL-optimal temperature by golden-section search.

    The binary NLL is convex in 1/T (it is a one-parameter logistic
    regression with fixed direction), so a bracketed golden-section on
    log T converges globally; 60 iterations give ~1e-9 relative width.
    """
    lo, hi = (np.log(b) for b in bounds)
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - phi * (b - a)
    d = a + phi * (b - a)
    fc = nll(logits, labels, np.exp(c))
    fd = nll(logits, labels, np.exp(d))
    for _ in range(iters):
        if fc <= fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = nll(logits, labels, np.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = nll(logits, labels, np.exp(d))
    return float(np.exp((a + b) / 2.0))


def calibrate_scores(scores: np.ndarray, temperature: float) -> np.ndarray:
    """Apply a fitted temperature to raw sigmoid scores."""
    z = scores_to_logits(scores) / float(temperature)
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


def expected_calibration_error(scores: np.ndarray, labels: np.ndarray,
                               n_bins: int = 15) -> float:
    """Standard equal-width ECE: sum_b (n_b/N)·|acc_b − conf_b|."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels, np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(s, edges[1:-1]), 0, n_bins - 1)
    ece = 0.0
    for b in range(n_bins):
        m = idx == b
        if not m.any():
            continue
        ece += m.mean() * abs(y[m].mean() - s[m].mean())
    return float(ece)


def calibration_report(scores: np.ndarray, labels: np.ndarray,
                       n_bins: int = 15) -> dict:
    """Fit T on (scores, labels) and report before/after NLL + ECE.

    Use validation-split scores; apply the returned temperature to test /
    production scores via :func:`calibrate_scores`.
    """
    logits = scores_to_logits(scores)
    t = fit_temperature(logits, labels)
    calibrated = calibrate_scores(scores, t)
    return {
        "temperature": round(t, 4),
        "nll_before": round(nll(logits, labels, 1.0), 6),
        "nll_after": round(nll(logits, labels, t), 6),
        "ece_before": round(expected_calibration_error(scores, labels,
                                                       n_bins), 6),
        "ece_after": round(expected_calibration_error(calibrated, labels,
                                                      n_bins), 6),
    }
