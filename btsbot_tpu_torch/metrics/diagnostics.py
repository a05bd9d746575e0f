"""Diagnostic evaluation summary (port of btsbot_tpu.metrics.diagnostics,
without its figure).

Alert-level metrics and the follow-up policy replay (metrics.classification,
metrics.policy), with the summary keys of the reference's
``val.diagnostic_fig`` (reference val.py:678-682), on candidates held as a
dict of numpy columns.  The 12-panel figure needs matplotlib, which the
port does not use: ``make_figure=True`` raises.
"""

from __future__ import annotations

import numpy as np

from .classification import alert_metrics
from .policy import policy_performance, replay_policies


def diagnostic_summary(
    cand,
    raw_preds: np.ndarray,
    labels: np.ndarray,
    junk_ids=(),
    save_times: dict | None = None,
    trigger_times: dict | None = None,
    make_figure: bool = False,
) -> dict:
    """cand: columns objectId / jd / magpsf (and peakmag if available)
    aligned with raw_preds / labels."""
    if make_figure:
        raise NotImplementedError(
            "the diagnostic figure is not ported (ROADMAP Queue A item 11: "
            "the framework-neutral surface); pass make_figure=False")
    raw_preds = np.asarray(raw_preds).reshape(-1)
    labels = np.asarray(labels).astype(int).reshape(-1)
    summary = alert_metrics(labels, raw_preds)
    replay = replay_policies(
        object_ids=np.asarray(cand["objectId"]),
        jd=np.asarray(cand["jd"]),
        magpsf=np.asarray(cand["magpsf"]),
        raw_preds=raw_preds,
        labels=labels,
        peakmag=np.asarray(cand["peakmag"]) if "peakmag" in cand else None,
        junk_ids=junk_ids,
    )
    summary["policy_performance"] = policy_performance(
        replay, save_times=save_times, trigger_times=trigger_times)
    return summary
