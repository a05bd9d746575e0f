"""Follow-up policy simulation, vectorized.

A numpy-only copy of btsbot_tpu.metrics.policy, which the port cannot
import (the JAX package's ``__init__`` loads flax).

Re-implements the reference's per-object chronological policy replay
(reference val.py:400-614) without the O(objects·alerts²)
pandas loops.  All four production policies are *monotone* in the alert
prefix (their trigger conditions are cumulative counts and running minima),
so the replay reduces to per-object cumulative sums / minima computed with
sorted segment operations — O(N log N) for the whole split.

Policies (val.py:400-418):

* ``bts_p1``  — ≥2 alerts with pred==1 (score>0.5) and magpsf<19;
* ``bts_p2``  — bts_p1, gated on running min(magpsf) ≤ 18.5;
* ``prod_p1`` — ≥1 alert with score>0.85 and magpsf<19 (the production
  trigger);
* ``prod_p2`` — prod_p1 gated on running min(magpsf) ≤ 18.5.

Object selection (val.py:431-452): first occurrence per objectId, not in the
RCFJunk list, ≥2 alerts in the split, and not "BTS-peak-thinned"
(label==1 with min magpsf > 18.5).

Save/trigger latency (val.py:560-593): for true positives with a recorded
human save/trigger time (≥ Jan 1 2021 JD, trigger < 1e10), Δt = first policy
trigger jd − human jd; medians reported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

JAN1_2021_JD = 2459215.5
BRIGHT_NARROW_BINS = np.arange(17.00, 18.50 + 0.25, 0.25)


def _policy_valid(scores, mags, kind: str):
    if kind.startswith("bts"):
        return (scores > 0.5) & (mags < 19)
    return (scores > 0.85) & (mags < 19)


def _policy_params(kind: str):
    min_count = 2 if kind.startswith("bts") else 1
    gated = kind.endswith("p2")
    return min_count, gated


@dataclasses.dataclass
class PolicyReplay:
    object_ids: np.ndarray        # (O,) selected objects
    labels: np.ndarray            # (O,) int
    peakmag: np.ndarray           # (O,) float ("peakmag" column, first value)
    remaining_alert_peakmag: np.ndarray  # (O,) min magpsf within split
    preds: dict                   # policy -> (O,) int final prediction
    trigger_jd: dict              # policy -> (O,) float (-1 if never)
    trigger_mag: dict             # policy -> (O,) float (-1 if never)


def replay_policies(
    object_ids: np.ndarray,
    jd: np.ndarray,
    magpsf: np.ndarray,
    raw_preds: np.ndarray,
    labels: np.ndarray,
    peakmag: np.ndarray | None = None,
    junk_ids=(),
    policies=("bts_p1", "bts_p2", "prod_p1", "prod_p2"),
) -> PolicyReplay:
    """Vectorized chronological replay over all objects at once."""
    object_ids = np.asarray(object_ids)
    jd = np.asarray(jd, dtype=np.float64)
    magpsf = np.asarray(magpsf, dtype=np.float64)
    raw_preds = np.asarray(raw_preds, dtype=np.float64)
    labels = np.asarray(labels).astype(int)
    if peakmag is None:
        peakmag = np.full_like(jd, np.nan)
    peakmag = np.asarray(peakmag, dtype=np.float64)

    # sort all alerts by (object, jd); objects keep first-occurrence order info
    uniq, inv = np.unique(object_ids, return_inverse=True)
    order = np.lexsort((jd, inv))
    g = inv[order]                      # group index per sorted alert
    jd_s, mag_s, score_s, lab_s, peak_s = (
        jd[order], magpsf[order], raw_preds[order], labels[order],
        peakmag[order])

    starts = np.r_[0, 1 + np.where(np.diff(g))[0]]     # segment starts
    counts = np.diff(np.r_[starts, g.size])

    # per-object scalars
    obj_label = lab_s[starts]
    obj_peakmag = peak_s[starts]
    # running & total min magpsf per object
    seg_min = np.minimum.reduceat(mag_s, starts)

    # object filter (val.py:434-446)
    junk = np.isin(uniq, np.asarray(list(junk_ids)))
    good_coverage = counts >= 2
    thinned = (obj_label == 1) & (seg_min > 18.5)
    keep = (~junk) & good_coverage & (~thinned)

    # cumulative-within-segment helpers (segments are contiguous after sort)
    pos_in_seg = np.arange(g.size) - np.repeat(starts, counts)

    def seg_cumsum(x):
        c = np.cumsum(x)
        base = np.where(starts == 0, 0.0, c[np.maximum(starts - 1, 0)])
        return c - np.repeat(base, counts)

    def seg_cummin(x):
        # prefix-doubling segmented running minimum, O(N log L)
        res = x.copy()
        shift = 1
        while shift < counts.max(initial=1):
            can = pos_in_seg >= shift
            res[can] = np.minimum(res[can], res[np.nonzero(can)[0] - shift])
            shift *= 2
        return res

    replay_preds: dict[str, np.ndarray] = {}
    trigger_jd: dict[str, np.ndarray] = {}
    trigger_mag: dict[str, np.ndarray] = {}

    run_min_mag = seg_cummin(mag_s)
    for name in policies:
        min_count, gated = _policy_params(name)
        valid = _policy_valid(score_s, mag_s, name).astype(np.float64)
        cum_valid = seg_cumsum(valid)
        fired = cum_valid >= min_count
        if gated:
            fired &= run_min_mag <= 18.5

        # final prediction: policy on the full prefix = last alert's state
        ends = starts + counts - 1
        replay_preds[name] = fired[ends].astype(int)

        # first firing alert per object (monotone ⇒ argmax of fired)
        first_idx = np.full(uniq.size, -1)
        any_fired = np.add.reduceat(fired.astype(int), starts) > 0
        # index of first True within each segment
        big = np.where(fired, np.arange(fired.size), np.iinfo(np.int64).max)
        first_global = np.minimum.reduceat(big, starts)
        first_idx = np.where(any_fired, first_global, -1)

        tj = np.full(uniq.size, -1.0)
        tm = np.full(uniq.size, -1.0)
        sel = first_idx >= 0
        tj[sel] = jd_s[first_idx[sel]]
        tm[sel] = mag_s[first_idx[sel]]
        trigger_jd[name] = tj
        trigger_mag[name] = tm

    return PolicyReplay(
        object_ids=uniq[keep],
        labels=obj_label[keep],
        peakmag=obj_peakmag[keep],
        remaining_alert_peakmag=seg_min[keep],
        preds={k: v[keep] for k, v in replay_preds.items()},
        trigger_jd={k: v[keep] for k, v in trigger_jd.items()},
        trigger_mag={k: v[keep] for k, v in trigger_mag.items()},
    )


def policy_performance(
    replay: PolicyReplay,
    save_times: dict | None = None,
    trigger_times: dict | None = None,
    bins: np.ndarray = BRIGHT_NARROW_BINS,
) -> dict:
    """Per-policy precision/recall, peak-mag-binned purity/completeness, and
    median save/trigger latency (val.py:502-614).  Degenerate cases produce
    the reference's -999.0 sentinels."""
    out: dict[str, dict] = {}
    labels = replay.labels
    for name, preds in replay.preds.items():
        tp_mask = (labels == 1) & (preds == 1)
        fp_mask = (labels == 0) & (preds == 1)
        tn_mask = (labels == 0) & (preds == 0)
        fn_mask = (labels == 1) & (preds == 0)
        tp, fp, tn, fn = (int(m.sum()) for m in
                          (tp_mask, fp_mask, tn_mask, fn_mask))

        mags = replay.remaining_alert_peakmag
        tp_b, _ = np.histogram(mags[tp_mask], bins=bins)
        fp_b, _ = np.histogram(mags[fp_mask], bins=bins)
        fn_b, _ = np.histogram(mags[fn_mask], bins=bins)

        if tp > 0 and tn > 0:
            precision = tp / (tp + fp)
            recall = tp / (tp + fn)
            with np.errstate(divide="ignore", invalid="ignore"):
                binned_precision = tp_b / (tp_b + fp_b)
                binned_recall = tp_b / (tp_b + fn_b)

            save_dt = []
            trig_dt = []
            tjd = replay.trigger_jd[name]
            for i in np.nonzero(tp_mask)[0]:
                oid = replay.object_ids[i]
                if save_times and oid in save_times:
                    st = save_times[oid]
                    if st >= JAN1_2021_JD and tjd[i] > 0:
                        save_dt.append(tjd[i] - st)
                if trigger_times and oid in trigger_times:
                    tt = trigger_times[oid]
                    if JAN1_2021_JD <= tt < 1e10 and tjd[i] > 0:
                        trig_dt.append(tjd[i] - tt)
            med_save_dt = float(np.median(save_dt)) if save_dt else -999.0
            med_trigger_dt = float(np.median(trig_dt)) if trig_dt else -999.0
            binned_precision = list(binned_precision)
            binned_recall = list(binned_recall)
        else:
            precision = recall = -999.0
            binned_precision = [-999.0]
            binned_recall = [-999.0]
            med_save_dt = med_trigger_dt = -999.0

        out[name] = {
            "policy_precision": precision,
            "policy_recall": recall,
            "binned_precision": binned_precision,
            "binned_recall": binned_recall,
            "peakmag_bins": list(bins),
            "med_save_dt": med_save_dt,
            "med_trigger_dt": med_trigger_dt,
        }
    return out
