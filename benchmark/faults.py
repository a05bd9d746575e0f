"""Faults planted under the timed path, to show that ``correct`` catches them.

Each fault is a context manager that patches the program while it is
active: the CPU tests (``test_bench_correct.py``) and ``readings.py
--fault`` on the card run a cell inside one.  Keyed by the traffic's
driver, then by the fault:

* ``state_unchanged``: the optimizer's update does nothing;
* ``half_batch``: half of each batch left out (the loss the mean over the
  rest; a scorer's second half given the first half's answers);
* ``answer_altered``: one answer changed where it is produced (one logit
  + 1).

A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(owner, attr: str, value):
    old = owner.__dict__[attr] if attr in owner.__dict__ else getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, old)


def _bump_first(logits: torch.Tensor) -> torch.Tensor:
    """The first row's logit + 1."""
    first = (torch.arange(logits.shape[0], device=logits.device) == 0)
    return logits + first.reshape((-1,) + (1,) * (logits.dim() - 1)).to(logits.dtype)


def _bump_first_score(scores: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(_bump_first(torch.logit(scores.float()))).to(scores.dtype)


def _half(x: torch.Tensor) -> torch.Tensor:
    """The last axis's second half replaced by its first."""
    h = x.shape[-1] // 2
    return torch.cat([x[..., :h], x[..., :x.shape[-1] - h]], dim=-1)


def _scorer(fn):
    from btsbot_tpu_torch.engine.serve import AlertScorer
    score = AlertScorer._score
    return patched(AlertScorer, "_score", lambda self, *a: fn(score(self, *a)))


def _train_half_batch():
    import btsbot_tpu_torch.engine.steps as steps
    bce = steps.weighted_bce_with_logits
    return patched(steps, "weighted_bce_with_logits",
                   lambda z, y, w: bce(z[:len(z) // 2], y[:len(y) // 2], w))


def _train_answer_altered():
    from btsbot_tpu_torch.models.convnext import MmConvNeXt
    forward = MmConvNeXt.forward
    return patched(MmConvNeXt, "forward",
                   lambda self, *a, **k: _bump_first(forward(self, *a, **k)))


FAULTS = {
    "archive": {"half_batch": lambda: _scorer(_half),
                "answer_altered": lambda: _scorer(_bump_first_score)},
    "train": {"state_unchanged": lambda: patched(torch.optim.AdamW, "step",
                                                 lambda self, closure=None: None),
              "half_batch": _train_half_batch,
              "answer_altered": _train_answer_altered},
}
