"""End-to-end training engine (port of btsbot_tpu.engine.train).

The JAX package's ``run_training`` with its semantics:

* pos-weighted BCE, pos_weight = num_notbts / num_bts;
* AdamW(lr, betas), the warmup → cosine LR constant within an epoch;
* flip / rot augmentation on the device per the config flags;
* early stopping: the best model is saved when 1.005·val_loss is below
  every earlier val loss, and a patience counter runs on the other epochs;
* the best model and the resume state written every epoch, then
  ``report.json``.

The run directory is ``{out_root}/{model_name}_{train_data_version}_N{N_max}_torch/{run_name}``
(the JAX package's layout with the suffix ``_torch`` for ``_tpu``), holding
``best_model.pth``, ``latest.pt`` and ``report.json`` (engine.checkpoint).
Training runs on the CUDA card unless ``device="cpu"`` is asked for; there
every ConvNeXt block of every training and evaluation forward is the block
kernel (an InceptionNeXt block's LN → MLP half ``fused_ln_mlp``).  Every
family trains here; a frozen_fusion run with
``image_model_dir`` (and no ``skip_load_state``) starts from the branch run
directories' ``best_model.pth`` files and updates only its combined head
(engine.state).  Not ported yet (ROADMAP): the mesh, the experiment logger, a
distillation teacher, a backbone checkpoint, embeddings and the diagnostic
figure.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..core.config import normalize_config
from ..core.device import resolve_device
from ..data.dataset import (
    AlertDataset,
    apply_val_cuts,
    epoch_order,
    iterate_batches,
    load_split,
)
from ..metrics.classification import alert_metrics
from ..metrics.diagnostics import diagnostic_summary
from ..metrics.report import make_report
from ..models.factory import build_model
from ..models.fusion import load_fusion_branches
from .checkpoint import (
    BEST_MODEL,
    LATEST,
    load_model_checkpoint,
    restore_train_state,
    save_model_state_dict,
    save_train_state,
)
from .eval import evaluate
from .schedule import lr_at_epoch
from .state import create_train_state
from .steps import (
    COMPUTE_DTYPES,
    make_device_train_step,
    make_train_step,
    put_dataset_on_device,
    to_device,
)


def _initial_weights(config, model, initial_state_dict, log) -> None:
    if initial_state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in initial_state_dict.items()})
    elif (config["model_name"] == "frozen_fusion" and config.get("image_model_dir")
          and not config.get("skip_load_state", False)):
        model.load_state_dict(load_fusion_branches(config, model.state_dict()),
                              strict=True)
        log("Loaded frozen-fusion branch weights from model dirs")
    elif config.get("backbone_checkpoint"):
        raise NotImplementedError(
            "backbone_checkpoint initialisation is not ported yet (ROADMAP "
            "Queue A item 8); pass initial_state_dict")
    elif config.get("pretrained"):
        log("pretrained=true but the port has no pretrained backbone source; "
            "starting from torch's default init")


def run_training(
    config,
    data_dir: str = "data",
    run_name: str = "run",
    out_root: str = "models",
    train_ds: AlertDataset | None = None,
    val_ds: AlertDataset | None = None,
    test_ds: AlertDataset | None = None,
    make_figure: bool = False,
    resume: bool = False,
    log: Callable[[str], None] = print,
    epoch_callback: Callable[[int, dict], None] | None = None,
    initial_state_dict: Mapping[str, Any] | None = None,
    device=None,
) -> dict[str, Any]:
    """Train, evaluate every epoch, early-stop, checkpoint and report.
    ``initial_state_dict``: reference-named starting weights (numpy arrays
    or tensors).  ``make_figure`` defaults to False here: the figure is not
    ported, and True raises.  Returns the JAX package's keys (model_dir, model, state,
    history, summaries) and ``best_val_scores``, the val predictions of the
    epoch whose weights are in ``best_model.pth``."""
    config = normalize_config(config)
    seed = int(config.get("random_seed", 0))
    dev = resolve_device(device)

    # /---------------- data ----------------/
    if train_ds is None:
        train_ds = load_split(config, "train", data_dir)
    if val_ds is None:
        val_ds = load_split(config, "val", data_dir)
    val_ds = apply_val_cuts(val_ds, config)
    if config.get("use_test_split", False) and test_ds is None:
        test_ds = load_split(config, "test", data_dir)

    batch_size = int(config["batch_size"])
    epochs = int(config["epochs"])
    patience = int(config["patience"])
    pos_weight = float(train_ds.pos_weight)
    steps_per_epoch = len(train_ds) // batch_size
    log(f"num_notbts: {train_ds.num_neg}  num_bts: {train_ds.num_pos}  "
        f"pos_weight: {pos_weight:.3f}")

    # /---------------- model / optimizer ----------------/
    # parameters and optimizer state stay float32; the forward computes in
    # the config's compute_dtype (engine.steps)
    model = build_model(config, dtype=torch.float32, device=dev, seed=seed)
    _initial_weights(config, model, initial_state_dict, log)
    state = create_train_state(config, model, steps_per_epoch, seed=seed)

    device_data = bool(config.get("device_data", False))
    if device_data:
        image_dtype = config.get("device_data_dtype")
        train_step = make_device_train_step(config, *put_dataset_on_device(
            train_ds, dev, COMPUTE_DTYPES[image_dtype] if image_dtype else None))
    else:
        train_step = make_train_step(config)

    run_model_name = (f"{config['model_name']}_{config['train_data_version']}"
                      f"_N{config.get('N_max', 100)}_torch")
    model_dir = os.path.join(out_root, run_model_name, run_name)
    os.makedirs(model_dir, exist_ok=True)

    # /---------------- history / resume ----------------/
    train_losses = np.zeros(epochs)
    train_accs = np.zeros(epochs)
    val_losses = np.full(epochs, np.inf)
    val_accs = np.zeros(epochs)
    start_epoch = 0
    epochs_since_improvement = 0
    best_raw_preds = None
    best_val_labels = None

    latest_path = os.path.join(model_dir, LATEST)
    best_path = os.path.join(model_dir, BEST_MODEL)
    if resume and os.path.isfile(latest_path):
        state, extra = restore_train_state(latest_path, state)
        start_epoch = int(extra["epoch"]) + 1
        epochs_since_improvement = int(extra["epochs_since_improvement"])
        for name, arr in (("train_losses", train_losses), ("train_accs", train_accs),
                          ("val_losses", val_losses), ("val_accs", val_accs)):
            prev = np.asarray(extra[name])
            arr[:prev.size] = prev[:arr.size]
        log(f"Resumed from {latest_path} at epoch {start_epoch}")

    # /---------------- epoch loop ----------------/
    final_epoch = max(start_epoch - 1, 0)
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        # loss / correct stay on the device until the end of the epoch
        losses = []
        corrects = []
        seen = 0
        if device_data:
            order = torch.from_numpy(epoch_order(len(train_ds), seed + epoch)).to(dev)
            for b in range(steps_per_epoch):
                m = train_step(state, order[b * batch_size:(b + 1) * batch_size],
                               pos_weight)
                losses.append(m["loss"])
                corrects.append(m["correct"])
                seen += batch_size
        else:
            for images, metadata, labels in iterate_batches(
                    train_ds, batch_size, shuffle=True, drop_last=True,
                    seed=seed + epoch):
                m = train_step(state, to_device(images, dev), to_device(metadata, dev),
                               to_device(labels, dev), pos_weight)
                losses.append(m["loss"])
                corrects.append(m["correct"])
                seen += len(labels)
        epoch_train_loss = (float(torch.stack(losses).double().mean())
                            if losses else float("nan"))
        epoch_train_acc = (int(torch.stack(corrects).sum()) if corrects else 0) / max(1, seen)
        train_losses[epoch] = epoch_train_loss
        train_accs[epoch] = epoch_train_acc

        val_loss, val_acc, val_raw_preds, val_labels = evaluate(
            model, config, val_ds, pos_weight, batch_size)
        val_losses[epoch] = val_loss
        val_accs[epoch] = val_acc
        final_epoch = epoch

        log(f"epoch {epoch + 1}/{epochs}  t={time.time() - t0:.1f}s  "
            f"train loss {epoch_train_loss:.5f} acc {epoch_train_acc:.5f}  "
            f"val loss {val_loss:.5f} acc {val_acc:.5f}")

        # early stopping with the reference's 0.5% improvement margin
        prev_best = float(np.min(val_losses[:epoch])) if epoch > 0 else np.inf
        improved = 1.005 * val_loss < prev_best
        if improved:
            save_model_state_dict(best_path, model)
            best_raw_preds = np.copy(val_raw_preds)
            best_val_labels = np.copy(val_labels)
            epochs_since_improvement = 0
            log(f"  val loss improved from {prev_best:.5f}; saved best model")
        else:
            epochs_since_improvement += 1
            log(f"  no improvement for {epochs_since_improvement} epoch(s)")

        # the resume state after the patience update, so a resume restores
        # this epoch's outcome
        save_train_state(latest_path, state, {
            "epoch": epoch,
            "epochs_since_improvement": epochs_since_improvement,
            "train_losses": train_losses[:epoch + 1],
            "train_accs": train_accs[:epoch + 1],
            "val_losses": val_losses[:epoch + 1],
            "val_accs": val_accs[:epoch + 1],
        })

        if not improved and epochs_since_improvement >= patience:
            log("  triggered early stopping")
            break

        if epoch_callback is not None:
            epoch_callback(epoch, {
                "epoch": epoch,
                "train_loss": epoch_train_loss,
                "train_accuracy": epoch_train_acc,
                "val_loss": val_loss,
                "val_accuracy": val_acc,
                "learning_rate": lr_at_epoch(
                    epoch, float(config["learning_rate"]), epochs,
                    int(config.get("warmup_epochs", 0))),
            })

    if best_raw_preds is None:  # no epoch improved (resume edge): use last
        if start_epoch >= epochs:
            # a resumed run that had finished every epoch: evaluate once
            _, _, val_raw_preds, val_labels = evaluate(
                model, config, val_ds, pos_weight, batch_size)
        best_raw_preds = val_raw_preds
        best_val_labels = val_labels

    # /---------------- final analysis ----------------/
    run_data = {
        "run_name": run_name,
        "train_loss": train_losses[:final_epoch + 1],
        "train_accuracy": train_accs[:final_epoch + 1],
        "val_loss": val_losses[:final_epoch + 1],
        "val_accuracy": val_accs[:final_epoch + 1],
    }

    summaries = {}
    analysis = [("val", val_ds, best_raw_preds, best_val_labels)]
    if test_ds is not None:
        # the test split is scored by the best model, as the reference does
        eval_model = model
        if os.path.isfile(best_path):
            eval_model = build_model(config, device=dev, seed=seed)
            eval_model.load_state_dict(load_model_checkpoint(config, model_dir))
        _, _, test_preds, test_labels = evaluate(
            eval_model, config, test_ds, pos_weight, batch_size)
        analysis.append(("test", test_ds, test_preds, test_labels))

    for split, ds, preds, labels in analysis:
        if ds.candidates is not None and "objectId" in ds.candidates:
            summary = diagnostic_summary(ds.candidates, preds, labels,
                                         make_figure=make_figure)
        else:
            summary = alert_metrics(labels, preds)
        summaries[split] = summary

    make_report(config, os.path.join(model_dir, "report.json"), run_data,
                summaries["val"])
    if config.get("generate_embeddings", False):
        log("generate_embeddings is not ported yet (ROADMAP Queue A item 11); "
            "skipping.")

    log(f"Best val loss: {np.min(val_losses[:final_epoch + 1]):.5f}  "
        f"best val acc: {np.max(val_accs[:final_epoch + 1]):.5f}")
    log(f"Model diagnostics at {model_dir}")

    return {
        "model_dir": model_dir,
        "model": model,
        "state": state,
        "history": run_data,
        "summaries": summaries,
        "best_val_scores": best_raw_preds,
    }
