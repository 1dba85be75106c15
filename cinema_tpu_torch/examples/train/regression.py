"""Self-contained ejection-fraction regression fine-tune tutorial (port of examples/train/regression.py).

ED and ES frames stacked as two channels into a ConvViT with a one-output head, MSE on z-normalised targets,
MAE-based early stopping. The loop that ``run_train`` automates is written out inline in torch: one train
step (gradients, the fused AdamW update, the update dropped on a non-finite loss), an evaluation each
``eval_interval`` epochs with patch-mean forwards, early stopping, and ``best.safetensors``.

Run on processed ACDC data (as ``acdc_preprocess`` writes it); the default config is
``PACKAGED["regression/acdc"]``, changed by dotted overrides:
    python -m cinema_tpu_torch.examples.train.regression --data_dir path/to/acdc/processed \
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
from cinema_tpu_torch.data import BatchLoader, EDESRegressionDataset, read_metadata, to_device
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.examples.common import compute_dtype
from cinema_tpu_torch.factory import init_weights, resolve_device
from cinema_tpu_torch.losses import regression_loss
from cinema_tpu_torch.models.layers import sampling_from
from cinema_tpu_torch.tasks.regression import get_regression_model, regression_forward
from cinema_tpu_torch.train.checkpoint import save_params_safetensors
from cinema_tpu_torch.train.fused_optim import FusedAdamW, FusedAdamWState
from cinema_tpu_torch.train.loop import pandas_sample
from cinema_tpu_torch.train.optim import build_optimizer

CONFIG = "regression/acdc"


def get_datasets(config: Config):
    """Random split: ``min(10, n // 3)`` validation patients (pandas' ``sample(n=..., random_state=0)``), each
    list in the table's order."""
    data_dir = Path(config.data.dir).expanduser()
    reg_col = config.data.regression_column
    rows = read_metadata(data_dir / "train_metadata.csv")
    val = set(pandas_sample(len(rows), min(10, len(rows) // 3), np.random.RandomState(0)))
    train_tf, val_tf = get_segmentation_transforms(config)

    def make(keep, tf):
        return EDESRegressionDataset(data_dir / "train", [r for i, r in enumerate(rows) if keep(i)], reg_col,
                                     float(config.data[reg_col]["mean"]), float(config.data[reg_col]["std"]), "sax", tf)

    return make(lambda i: i not in val, train_tf), make(lambda i: i in val, val_tf)


def make_train_step(model: nn.Module, tx: FusedAdamW, opt_state: FusedAdamWState) -> Callable:
    """The training step ``step(batch, generator) -> metrics``: MSE -> gradients -> AdamW update,
    dropped where the loss is not finite. Dropout and drop path draw from ``generator``."""
    params = list(model.parameters())

    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        with sampling_from(generator):
            loss, metrics = regression_loss(model({"sax": batch["sax_image"]})[:, 0], batch["label"])
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

    model = init_weights(get_regression_model(config, dtype=compute_dtype(device), device=device), seed=0)
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
    # evaluation: a study deeper than the patch becomes overlapping patches whose outputs are averaged
    patch_size = {"sax": tuple(config.data.sax.patch_size)}
    reg_col = config.data.regression_column
    reg_std = float(config.data[reg_col]["std"])

    out_dir = Path(config.logging.dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(0)
    best, patience_left = np.inf, int(config.train.early_stopping.patience)
    for epoch in range(n_epochs):
        losses = []
        for batch in train_loader.epoch(epoch):
            metrics = train_step(to_device(batch, device), generator)
            losses.append(metrics["loss"].detach())
        print(f"epoch {epoch}: train loss {float(torch.stack(losses).float().mean()):.4f}")

        if (epoch + 1) % int(config.train.eval_interval) and epoch + 1 != n_epochs:
            continue
        model.eval()
        errs = []
        with torch.no_grad():
            for batch in val_loader.epoch(0):
                preds = regression_forward(model, {"sax": to_device(batch, device)["sax_image"]}, patch_size)
                errs.append(abs(float(preds.float().reshape(-1)[0]) - float(batch["label"][0])))
        mae = float(np.mean(errs)) * reg_std  # denormalised MAE
        print(f"epoch {epoch}: val MAE {mae:.4f} ({reg_col} units)")
        if mae < best - float(config.train.early_stopping.min_delta):
            best, patience_left = mae, int(config.train.early_stopping.patience)
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
