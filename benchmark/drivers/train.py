"""Training: ``run_training``'s loop over a host-resident set.

The survey team retrains the model: a seeded set of ``set_alerts``
L2-normalised alerts held on the host, ``positive_share`` of them positive
(the same count for every seed), ``pos_weight`` as ``run_training`` takes it
from the set.  Batches of the configuration's ``batch_size`` come from
``data.dataset.iterate_batches`` (shuffled by the seed plus the epoch,
``drop_last``) and ``engine.steps.to_device``, and go into
``make_train_step``'s step: ``run_training`` with ``device_data`` off, its
default, with the epoch's losses read once at each epoch's end and no other
synchronisation.  The configuration states float32 and the program sets no
precision flag of PyTorch's, whose default lets cuDNN take TF32 for the
convolutions (the stem, the downsamples, the depthwise backward); set-up
turns that off for the process, as a user who trains in float32 does
(matmuls already run in float32 by default).

Set-up builds the train state once, drives it through the first
``first_steps`` steps of the window's own feed (which also warms up every
shape), and hands the same state to the window.  Of those steps it keeps
the losses of the first three, each parameter's gradient as AdamW holds it
after the first (its first moment over 1 − β1), and each parameter's change
after the third.  After the window the plain reference takes the same three
steps from the same weights on the same rows, with the same augmentation and
dropout draws (the program's rule: a generator on the card reseeded from
(seed, step) each step, augmentation then the two dropout masks), and the
three are compared: the worst step's loss (``loss_gap``), the worst leaf's
first gradient (``grad_gap``) and the median leaf's change
(``change_gap_median``), each leaf's norm against the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..reference.mm_convnext import Reference, adamw_, augment, param_spec, trainable, \
    weighted_bce

COMPARED_STEPS = 3


def labels_for(n: int, share: float, seed: int) -> np.ndarray:
    """round(share·n) positives in a seeded order."""
    labels = np.zeros(n, np.float32)
    labels[:int(round(share * n))] = 1.0
    return labels[np.random.default_rng(seed).permutation(n)]


def step_seed(seed: int, step: int) -> int:
    """The program's generator seed of update ``step`` (engine/steps.py at
    commit c3d034a)."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def epoch_order(n: int, seed: int) -> np.ndarray:
    """The shuffled order of an epoch (data/dataset.py at commit c3d034a)."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    return order


def first_lr(model_cfg: dict) -> float:
    """The learning rate of epoch 0: linear warm-up from 1 % of the base."""
    lr = float(model_cfg["learning_rate"])
    return lr * 0.01 if int(model_cfg.get("warmup_epochs", 0)) > 0 else lr


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(got: dict, want: dict, leaves) -> dict:
    """|‖got‖ − ‖want‖| / max(‖want‖, the median leaf's ‖want‖) of each of
    ``leaves``; the number compared is the worst."""
    med = float(np.median([want[k] for k in leaves]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in leaves}


class Cell:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.cfg = ctx.cfg

    def _feed(self):
        from btsbot_tpu_torch.data.dataset import iterate_batches
        from btsbot_tpu_torch.engine.steps import to_device

        dev, bs = self.ctx.device, self.batch
        epoch = 0
        while True:
            losses = []
            for images, metadata, labels in iterate_batches(
                    self.dataset, bs, shuffle=True, drop_last=True, seed=self.ctx.seed + epoch):
                m = yield to_device(images, dev), to_device(metadata, dev), \
                    to_device(labels, dev)
                losses.append(m["loss"])
            float(torch.stack(losses).double().mean())  # the epoch's loss, as run_training
            epoch += 1

    def _step(self):
        """One step on the pending batch, then the feed's next batch, in
        ``run_training``'s order."""
        with torch.profiler.record_function("train.step"):
            m = self.step(self.state, *self.pending, self.pos_weight)
        with torch.profiler.record_function("train.feed"):
            self.pending = self.feed.send(m)
        return m

    def setup(self) -> None:
        from btsbot_tpu_torch.core.config import normalize_config
        from btsbot_tpu_torch.data.dataset import AlertDataset
        from btsbot_tpu_torch.engine.state import create_train_state
        from btsbot_tpu_torch.engine.steps import make_train_step
        from btsbot_tpu_torch.models.factory import build_model

        ctx, cfg, traffic = self.ctx, self.cfg, self.ctx.traffic
        torch.backends.cudnn.allow_tf32 = False  # float32, as the configuration states
        self.weights = harness.make_weights(cfg, ctx.seed, torch.float32, ctx.device)
        n = traffic["set_alerts"]
        self.images, self.meta = harness.make_pool(
            n, len(cfg["model"]["metadata_cols"]), ctx.seed + 1, ctx.device)
        self.labels = labels_for(n, traffic["positive_share"], ctx.seed + 2)
        self.dataset = AlertDataset(labels=self.labels, images=self.images, metadata=self.meta)
        config = normalize_config(cfg["model"])
        self.batch = int(config["batch_size"])
        model = build_model(config, dtype=torch.float32, device=ctx.device)
        model.load_state_dict(self.weights, strict=True)
        self.state = create_train_state(config, model, n // self.batch, seed=ctx.seed)
        self.step = make_train_step(config)
        self.pos_weight = float(self.dataset.pos_weight)
        self.feed = self._feed()
        self.pending = next(self.feed)
        self.losses, self.grads, self.changes = [], {}, {}
        named = dict(model.named_parameters())
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        for i in range(traffic["first_steps"]):
            m = self._step()
            if i < COMPARED_STEPS:
                self.losses.append(float(m["loss"]))
            if i == 0:
                opt_state = self.state.optimizer.state
                self.grads = norms({k: opt_state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                                    / (1 - beta1) for k, p in named.items()})
            if i == COMPARED_STEPS - 1:
                self.changes = norms({k: p.detach() - self.weights[k]
                                      for k, p in named.items()})
        harness.sync(ctx.device)

    def window(self, seconds: float, tw: harness.TraceWindow) -> dict:
        rows = harness.RowCounter(self.state.model, tw)
        steps = traced = 0
        tw.start()
        t0 = time.perf_counter()
        while True:
            self._step()
            steps += 1
            if tw.active:
                traced += 1
            if tw.due():
                tw.stop()
            if time.perf_counter() - t0 >= seconds:
                break
        harness.sync(self.ctx.device)
        elapsed = time.perf_counter() - t0
        rows.remove()
        return {"metrics": {"train_alerts_per_s": steps * self.batch / elapsed},
                "attempted": steps * self.batch, "failed": 0,
                "counters": {"steps_traced": traced, "alerts_traced": traced * self.batch,
                             "forward_rows": rows.rows}}

    def release(self) -> None:
        del self.state, self.step, self.feed, self.pending
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, tf32: bool = False) -> tuple[list, dict, dict]:
        """(losses, first gradients' norms, changes' norms) of the plain
        reference's first three steps."""
        cfg, dev, bs, seed = self.cfg, self.ctx.device, self.batch, self.ctx.seed
        m = cfg["model"]
        ref = Reference(cfg, tf32=tf32)
        spec = param_spec(cfg)
        names = trainable(spec)
        p = {k: v.float().clone() for k, v in self.weights.items()}
        m1 = {k: torch.zeros_like(p[k]) for k in names}
        m2 = {k: torch.zeros_like(p[k]) for k in names}
        pos_weight = float((self.labels == 0).sum() / max(1, (self.labels == 1).sum()))
        order = epoch_order(len(self.labels), seed)
        lr, betas = first_lr(m), (float(m["beta_1"]), float(m["beta_2"]))
        losses, grads = [], {}
        for t in range(COMPARED_STEPS):
            idx = order[t * bs:(t + 1) * bs]
            images = torch.from_numpy(self.images[idx]).to(dev)
            metadata = torch.from_numpy(self.meta[idx]).to(dev)
            labels = torch.from_numpy(self.labels[idx]).to(dev)
            g = torch.Generator(device=dev).manual_seed(step_seed(seed, t))
            flips = [torch.rand(bs, generator=g, device=dev) < 0.5 for _ in range(2)]
            rot = torch.randint(0, 4, (bs,), generator=g, device=dev)
            images = augment(images, flips[0], flips[1], rot)
            masks = [torch.empty((bs, width), device=dev).bernoulli_(1 - drop, generator=g)
                     for width, drop in ((m["meta_fc1_neurons"], m["meta_dropout"]),
                                         (m["comb_fc2_neurons"], m["comb_dropout"]))]
            leaves = {k: p[k].requires_grad_(True) for k in names}
            loss = weighted_bce(ref.logits(p, images, metadata, train=True, masks=masks),
                                labels, pos_weight)
            grad = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
            losses.append(float(loss.detach()))
            if t == 0:
                grads = norms(grad)
            with torch.no_grad():
                p.update({k: p[k].detach() for k in names})
                adamw_(p, grad, m1, m2, t + 1, lr, betas)
        changes = norms({k: p[k] - self.weights[k] for k in names})
        return losses, grads, changes

    def compare(self, got: tuple, want: tuple) -> list[harness.Check]:
        (l_got, g_got, c_got), (l_want, g_want, c_want) = got, want
        limits = self.cfg["limits"]["train"]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_got, l_want))
        grad = leaf_gaps(g_got, g_want, list(g_want))
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone under Adam: left out of the change
        med = float(np.median(list(g_want.values())))
        change = leaf_gaps(c_got, c_want, [k for k in c_want if g_want[k] >= 1e-3 * med])
        self.worst_leaves = {"grad_gap": max(grad, key=grad.get),
                             "change_gap": max(change, key=change.get),
                             "change_gap_worst": max(change.values())}
        # the median leaf's: a small leaf's change swings from seed to seed
        # (Adam normalises each element, so elements whose gradient is
        # near zero move by its rounding)
        return [harness.Check("loss_gap", loss_gap, limits["loss_gap"]),
                harness.Check("grad_gap", max(grad.values()), limits["grad_gap"]),
                harness.Check("change_gap_median", float(np.median(list(change.values()))),
                              limits["change_gap_median"])]

    def control(self) -> list[harness.Check]:
        """The reference with every product in TF32, in the program's place."""
        with harness.tf32_off():
            return self.compare(self.reference_steps(tf32=True), self.reference_steps())

    def checks(self) -> list[harness.Check]:
        with harness.tf32_off():
            want = self.reference_steps()
        return self.compare((self.losses, self.grads, self.changes), want)
