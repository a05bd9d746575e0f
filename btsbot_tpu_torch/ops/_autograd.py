"""Backward passes that recompute a kernel's plain PyTorch version.

The JAX kernels differentiate through a custom VJP that re-runs their
reference math (pallas_mlp.py:128-131, pallas_convnext.py:187-190); the
port's ``torch.autograd.Function``s do the same with this helper.
"""

from __future__ import annotations

import torch


def recompute_backward(reference, saved, needs_grad, grad_out):
    """Gradients of ``reference(*saved)`` against ``grad_out`` for the
    inputs flagged in ``needs_grad`` (None for the others)."""
    inputs = [t.detach().requires_grad_(bool(n)) for t, n in
              zip(saved, needs_grad)]
    with torch.enable_grad():
        out = reference(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad_out,
                                     allow_unused=True)) if wanted else iter(())
    return tuple(next(grads) if t.requires_grad else None for t in inputs)
