"""Self-contained CVD (pathology) classification fine-tune tutorial (port of examples/train/classification.py).

ED and ES frames stacked as two channels into a ConvViT, smoothed cross-entropy, accuracy-based early
stopping. The loop that ``run_train`` automates is written out inline in torch: one train step (gradients,
the fused AdamW update, the update dropped on a non-finite loss), an evaluation each ``eval_interval``
epochs with patched forwards, early stopping, and ``best.safetensors``.

Run on processed ACDC data (as ``acdc_preprocess`` writes it); the default config is
``PACKAGED["classification/acdc"]``, changed by dotted overrides:
    python -m cinema_tpu_torch.examples.train.classification --data_dir path/to/acdc/processed \
        [--n_epochs 10] [--device cuda] [key=value ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import PACKAGED, Config, apply_overrides, from_dict
from cinema_tpu_torch.data import BatchLoader, EDESClassificationDataset, read_metadata, to_device
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.examples.common import compute_dtype
from cinema_tpu_torch.factory import init_weights, resolve_device
from cinema_tpu_torch.losses import classification_loss
from cinema_tpu_torch.models.layers import sampling_from
from cinema_tpu_torch.tasks.classification import classification_forward, get_classification_model
from cinema_tpu_torch.train.checkpoint import save_params_safetensors
from cinema_tpu_torch.train.fused_optim import FusedAdamW, FusedAdamWState
from cinema_tpu_torch.train.loop import split_by_class
from cinema_tpu_torch.train.optim import build_optimizer

CONFIG = "classification/acdc"


def get_datasets(config: Config):
    """Stratified split: 2 validation patients per class (pandas' ``groupby(class).sample(n=2,
    random_state=0)``)."""
    data_dir = Path(config.data.dir).expanduser()
    class_col = config.data.class_column
    classes = list(config.data[class_col])
    rows = [r for r in read_metadata(data_dir / "train_metadata.csv") if r[class_col] in classes]
    train_ids, val_ids = split_by_class([r[class_col] for r in rows], n_val_per_class=2, seed=0)
    train_tf, val_tf = get_segmentation_transforms(config)

    def make(ids, tf):
        return EDESClassificationDataset(data_dir / "train", [rows[i] for i in ids], class_col, classes, "sax", tf)

    return make(train_ids, train_tf), make(val_ids, val_tf)


def make_train_step(model: nn.Module, tx: FusedAdamW, opt_state: FusedAdamWState) -> Callable:
    """The training step ``step(batch, generator) -> metrics``: smoothed CE -> gradients -> AdamW update,
    dropped where the loss is not finite. Dropout and drop path draw from ``generator``."""
    params = list(model.parameters())

    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        with sampling_from(generator):
            loss, metrics = classification_loss(model({"sax": batch["sax_image"]}), batch["label"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        tx.step(grads, opt_state, torch.isfinite(loss.detach()))
        return {k: v.detach() for k, v in metrics.items()}

    return step


def run(config: Config, n_epochs: int, device: str = "cuda") -> None:
    device = resolve_device(device)
    train_ds, val_ds = get_datasets(config)
    batch_size = int(config.train.batch_size_per_device)
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True, drop_last=True, seed=0)
    val_loader = BatchLoader(val_ds, 1, shuffle=False, drop_last=False)
    steps_per_epoch = max(1, len(train_ds) // batch_size)

    model = init_weights(get_classification_model(config, dtype=compute_dtype(device), device=device), seed=0)
    tx = build_optimizer(
        dict(model.named_parameters()),
        lr=float(config.train.lr),
        min_lr=float(config.train.min_lr),
        warmup_steps=int(config.train.n_warmup_epochs) * steps_per_epoch,
        max_n_steps=n_epochs * steps_per_epoch,
        weight_decay=float(config.train.weight_decay),
        clip_grad=float(config.train.clip_grad),
    )
    opt_state = tx.init()
    train_step = make_train_step(model, tx, opt_state)
    # evaluation: a study deeper than the patch becomes overlapping patches whose softmax is averaged
    patch_size = {"sax": tuple(config.data.sax.patch_size)}

    out_dir = Path(config.logging.dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(0)
    best, patience_left = -np.inf, int(config.train.early_stopping.patience)
    for epoch in range(n_epochs):
        losses = []
        for batch in train_loader.epoch(epoch):
            metrics = train_step(to_device(batch, device), generator)
            losses.append(metrics["loss"].detach())
        print(f"epoch {epoch}: train loss {float(torch.stack(losses).float().mean()):.4f}")

        if (epoch + 1) % int(config.train.eval_interval) and epoch + 1 != n_epochs:
            continue
        model.eval()
        correct, total = 0, 0
        with torch.no_grad():
            for batch in val_loader.epoch(0):
                logits = classification_forward(model, {"sax": to_device(batch, device)["sax_image"]}, patch_size)
                correct += int(int(logits.argmax(dim=-1)[0]) == int(batch["label"][0]))
                total += 1
        acc = correct / max(total, 1)
        print(f"epoch {epoch}: val accuracy {acc:.4f}")
        if acc > best + float(config.train.early_stopping.min_delta):
            best, patience_left = acc, int(config.train.early_stopping.patience)
            save_params_safetensors(model, out_dir / "best.safetensors")
            print(f"  saved {out_dir / 'best.safetensors'}")
        else:
            patience_left -= 1
            if patience_left <= 0:
                print("early stop")
                break


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_dir", required=True, type=Path)
    parser.add_argument("--n_epochs", type=int, default=10)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides of the packaged config")
    args = parser.parse_args(argv)
    config = apply_overrides(from_dict(PACKAGED[CONFIG]), [f"data.dir={args.data_dir}", *args.overrides])
    run(config, args.n_epochs, device=args.device)


if __name__ == "__main__":
    main()
