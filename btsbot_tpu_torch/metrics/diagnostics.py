"""Diagnostic evaluation summary and the 12-panel figure (port of
btsbot_tpu.metrics.diagnostics).

Alert-level metrics and the follow-up policy replay (metrics.classification,
metrics.policy), with the summary keys of the reference's
``val.diagnostic_fig`` (reference val.py:678-682), on candidates held as a
dict of numpy columns.  ``make_figure=True`` also draws the reference's
12-panel PDF: accuracy / loss curves, ROC, score vs magnitude, confusion
matrix, classification types by magnitude, and each of the first three
policies' binned purity / completeness and save latency.  The figure needs
matplotlib, imported only when one is drawn; ``require_matplotlib`` lets a
caller fail before it trains rather than after.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from .classification import alert_metrics, confusion_counts, roc_curve
from .policy import policy_performance, replay_policies

MAG_BINS = np.arange(15, 21.5, 0.5)  # reference val.py:198


def require_matplotlib() -> None:
    """Raise ImportError unless matplotlib can be imported."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError(
            "the diagnostic figure needs matplotlib, which is not installed; "
            "pass --no-figure (make_figure=False) to train or validate without it")


def close_figure(summary: dict) -> None:
    """Drop a drawn figure from ``summary`` and free it (it was saved)."""
    fig = summary.pop("fig", None)
    if fig is not None:
        import matplotlib.pyplot as plt
        plt.close(fig)


def _col(cand, name: str) -> np.ndarray:
    return np.asarray(cand[name])


def diagnostic_summary(
    cand,
    raw_preds: np.ndarray,
    labels: np.ndarray,
    run_data: dict | None = None,
    junk_ids=(),
    save_times: dict | None = None,
    trigger_times: dict | None = None,
    make_figure: bool = False,
    fig_path: str | None = None,
) -> dict:
    """cand: columns objectId / jd / magpsf (and peakmag if available)
    aligned with raw_preds / labels.  With ``make_figure`` the summary's
    ``"fig"`` is the matplotlib figure, saved to ``fig_path`` when given;
    ``run_data`` gives its title and curves (``run_name``, ``loss``,
    ``accuracy``, ``val_loss``, ``val_accuracy``)."""
    if make_figure:
        require_matplotlib()
    raw_preds = np.asarray(raw_preds).reshape(-1)
    labels = np.asarray(labels).astype(int).reshape(-1)
    preds = np.rint(raw_preds).astype(int)

    summary = alert_metrics(labels, raw_preds)
    replay = replay_policies(
        object_ids=_col(cand, "objectId"),
        jd=_col(cand, "jd"),
        magpsf=_col(cand, "magpsf"),
        raw_preds=raw_preds,
        labels=labels,
        peakmag=_col(cand, "peakmag") if "peakmag" in cand else None,
        junk_ids=junk_ids,
    )
    summary["policy_performance"] = policy_performance(
        replay, save_times=save_times, trigger_times=trigger_times)

    if make_figure:
        summary["fig"] = _diagnostic_figure(cand, raw_preds, labels, preds, summary,
                                            run_data or {}, fig_path)
    return summary


def _diagnostic_figure(cand, raw_preds, labels, preds, summary, run_data, fig_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    fig, axes = plt.subplots(4, 3, figsize=(20, 22), dpi=120)
    fig.suptitle(run_data.get("run_name", ""), size=20)
    (ax_acc, ax_loss, ax_roc), (ax_hist2d, ax_cm, ax_types), pol_cp, pol_st = axes

    # accuracy / loss curves with class-accuracy reference lines
    ax_acc.plot(run_data.get("accuracy", []), label="Training")
    ax_acc.plot(run_data.get("val_accuracy", []), label="Validation")
    for val, lab in ((summary["bts_acc"], "BTS"),
                     (summary["notbts_acc"], "notBTS"),
                     (summary["bal_acc"], "Balanced")):
        ax_acc.axhline(val, linestyle="dashed", linewidth=1, label=lab)
    ax_acc.set_xlabel("Epoch")
    ax_acc.set_ylabel("Accuracy")
    ax_acc.legend()
    ax_acc.grid(True, linewidth=0.3)

    ax_loss.plot(run_data.get("loss", []), label="Training")
    ax_loss.plot(run_data.get("val_loss", []), label="Validation")
    ax_loss.set_xlabel("Epoch")
    ax_loss.set_ylabel("Loss")
    ax_loss.legend()
    ax_loss.grid(True, linewidth=0.3)

    # ROC
    fpr, tpr, _ = roc_curve(labels, raw_preds)
    ax_roc.plot([0, 1], [0, 1], "k--", lw=1)
    ax_roc.plot(fpr, tpr, label=f"ROC (area = {summary['roc_auc']:.5f})")
    ax_roc.set_xlabel("False Positive Rate")
    ax_roc.set_ylabel("True Positive Rate")
    ax_roc.legend(loc="lower right")
    ax_roc.grid(True, linewidth=0.3)

    # score vs magnitude 2D histogram
    mags = _col(cand, "magpsf")
    h = ax_hist2d.hist2d(mags, raw_preds, bins=28, range=[[16, 21], [0, 1]],
                         norm=LogNorm())
    plt.colorbar(h[3], ax=ax_hist2d, label="# of alerts")
    ax_hist2d.set_xlabel("PSF Magnitude")
    ax_hist2d.set_ylabel("Bright transient score")

    # confusion matrix
    tp, fp, tn, fn = confusion_counts(labels, preds)
    cm = np.array([[tn, fp], [fn, tp]], dtype=float)
    cm_norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    im = ax_cm.imshow(cm_norm, cmap="Blues", vmin=0, vmax=1)
    for i in range(2):
        for j in range(2):
            ax_cm.text(j, i, f"{cm_norm[i, j]:.3f}", ha="center", va="center")
    ax_cm.set_xticks([0, 1], ["notBTS", "BTS"])
    ax_cm.set_yticks([0, 1], ["notBTS", "BTS"])
    ax_cm.set_xlabel("Predicted")
    ax_cm.set_ylabel("True")
    plt.colorbar(im, ax=ax_cm)

    # classification-type stacked histogram vs magnitude
    masks = {
        "TP": (labels == 1) & (preds == 1),
        "FP": (labels == 0) & (preds == 1),
        "TN": (labels == 0) & (preds == 0),
        "FN": (labels == 1) & (preds == 0),
    }
    bottom = np.zeros(MAG_BINS.size - 1)
    for name, mask in masks.items():
        cnt, _ = np.histogram(mags[mask], bins=MAG_BINS)
        ax_types.bar(MAG_BINS[:-1], cnt, bottom=bottom, align="edge",
                     width=MAG_BINS[1] - MAG_BINS[0], label=name,
                     linewidth=0.1, edgecolor="k")
        bottom += cnt
    ax_types.axvspan(10, 18.5, color="gold", alpha=0.2, lw=0)
    ax_types.set_xlim([16, 21])
    ax_types.legend(ncol=2, frameon=False)
    ax_types.set_xlabel("PSF Magnitude")
    ax_types.set_ylabel("# of alerts")

    # per-policy purity / completeness and save-latency panels (first 3 policies)
    perf = summary["policy_performance"]
    for ax_cp, ax_st, name in zip(pol_cp, pol_st, list(perf)[:3]):
        p = perf[name]
        if p["policy_precision"] > -999:
            bins = np.asarray(p["peakmag_bins"])
            rec = np.asarray(p["binned_recall"], dtype=float)
            pre = np.asarray(p["binned_precision"], dtype=float)
            ax_cp.step(bins, 100 * np.r_[rec[:1], rec], label="Completeness")
            ax_cp.step(bins, 100 * np.r_[pre[:1], pre], label="Purity")
            ax_cp.axhline(100 * p["policy_precision"], linestyle="dashed", linewidth=1)
            ax_cp.axhline(100 * p["policy_recall"], linestyle="dashed", linewidth=1)
            ax_cp.set_title(f"{name} ({100 * p['policy_recall']:.0f}%,"
                            f"{100 * p['policy_precision']:.0f}%)")
        ax_cp.axvline(18.5, c="k", linewidth=1, linestyle="dashed", alpha=0.5)
        ax_cp.set_xlim([17.0, 18.5])
        ax_cp.set_ylim([0, 100.5])
        ax_cp.set_xlabel("Peak Magnitude")
        ax_cp.set_ylabel("% of objects")
        ax_cp.grid(True, linewidth=0.3)
        ax_cp.legend(frameon=False)

        if p["med_save_dt"] > -999:
            ax_st.axvline(p["med_save_dt"], c="k", linewidth=1.5,
                          label=f"med: {p['med_save_dt']:.2f} d")
        ax_st.axvline(0, linestyle="dashed", c="gray", linewidth=1)
        ax_st.set_xlim([-15, 15])
        ax_st.set_xlabel("Days after save by scanner")
        ax_st.set_ylabel("# of sources")
        ax_st.legend(frameon=False)

    if fig_path:
        os.makedirs(os.path.dirname(fig_path) or ".", exist_ok=True)
        fig.savefig(fig_path, bbox_inches="tight")
    return fig
