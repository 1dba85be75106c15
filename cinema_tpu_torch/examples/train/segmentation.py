"""Self-contained SAX segmentation fine-tune tutorial (port of examples/train/segmentation.py).

The loop that ``run_train`` automates, written out inline in torch:

    datasets and loader -> one train step (gradients, the fused AdamW update with layer decay, the update
    dropped on a non-finite loss) -> Dice on the card and HD95 on the host each ``eval_interval`` epochs ->
    early stopping -> ``best.safetensors``.

``--mae_ckpt`` starts from pretrained MAE weights (safetensors, as published): the MAE -> ConvUNetR transfer
of ``convert.load_pretrain_weights`` (decoder and mask keys dropped, strict accounting).

Run on processed ACDC data (as ``acdc_preprocess`` writes it); the default config is
``PACKAGED["segmentation/acdc"]``, changed by dotted overrides:
    python -m cinema_tpu_torch.examples.train.segmentation --data_dir path/to/acdc/processed \
        [--n_epochs 10] [--mae_ckpt cinema.safetensors] [--device cuda] [key=value ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import PACKAGED, Config, apply_overrides, from_dict
from cinema_tpu_torch.convert import load_pretrain_weights, load_safetensors
from cinema_tpu_torch.data import BatchLoader, EDESSegmentationDataset, read_metadata, to_device
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.examples.common import compute_dtype
from cinema_tpu_torch.factory import get_segmentation_model, init_weights, resolve_device
from cinema_tpu_torch.inference import sliding_window_forward
from cinema_tpu_torch.losses import segmentation_loss
from cinema_tpu_torch.metrics import dice_score, hausdorff_distance_95, one_hot
from cinema_tpu_torch.models.layers import sampling_from
from cinema_tpu_torch.train.checkpoint import save_params_safetensors
from cinema_tpu_torch.train.fused_optim import FusedAdamW, FusedAdamWState
from cinema_tpu_torch.train.loop import split_by_class
from cinema_tpu_torch.train.optim import build_optimizer

CONFIG = "segmentation/acdc"


def get_datasets(config: Config):
    """Stratified split: 2 validation patients per pathology (pandas' ``groupby("pathology").sample(n=2,
    random_state=0)``)."""
    data_dir = Path(config.data.dir).expanduser()
    rows = read_metadata(data_dir / "train_metadata.csv")
    train_ids, val_ids = split_by_class([r["pathology"] for r in rows], n_val_per_class=2, seed=0)
    train_tf, val_tf = get_segmentation_transforms(config)

    def make(ids, tf):
        return EDESSegmentationDataset(data_dir / "train", [rows[i] for i in ids], "sax", tf)

    return make(train_ids, train_tf), make(val_ids, val_tf)


def make_train_step(model: nn.Module, tx: FusedAdamW, opt_state: FusedAdamWState) -> Callable:
    """The training step ``step(batch, generator) -> metrics``: loss -> gradients -> AdamW update, dropped
    where the loss is not finite (the reference skips such steps). Dropout and drop path draw from
    ``generator``."""
    params = list(model.parameters())

    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        with sampling_from(generator):
            logits = model({"sax": batch["sax_image"]})["sax"]
            loss, metrics = segmentation_loss(logits, batch["sax_label"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        tx.step(grads, opt_state, torch.isfinite(loss.detach()))
        return {k: v.detach() for k, v in metrics.items()}

    return step


@torch.no_grad()
def eval_step(model: nn.Module, image: torch.Tensor, label: torch.Tensor, patch_size, n_classes: int):
    """Sliding-window evaluation of one study: (per-class Dice (batch, n_classes), argmax labels). A study
    deeper than the patch is covered by overlapping patches in one forward."""
    model.eval()
    logits = sliding_window_forward(model, {"sax": image}, {"sax": patch_size}, "softmax")["sax"]
    pred = logits.argmax(dim=-1)
    return dice_score(one_hot(pred, n_classes), one_hot(label, n_classes)), pred


def run(config: Config, n_epochs: int, device: str = "cuda") -> None:
    device = resolve_device(device)
    train_ds, val_ds = get_datasets(config)
    batch_size = int(config.train.batch_size_per_device)
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True, drop_last=True, seed=0)
    val_loader = BatchLoader(val_ds, 1, shuffle=False, drop_last=False)
    steps_per_epoch = max(1, len(train_ds) // batch_size)

    model = init_weights(get_segmentation_model(config, dtype=compute_dtype(device), device=device), seed=0)
    if config.model.get("ckpt_path"):
        # MAE -> ConvUNetR transfer with the reference's key surgery
        state_dict = load_safetensors(Path(config.model.ckpt_path).expanduser())
        loaded = load_pretrain_weights(model, "sax", state_dict)
        print(f"loaded {len(loaded)} pretrained tensors")
    tx = build_optimizer(
        dict(model.named_parameters()),
        lr=float(config.train.lr),
        min_lr=float(config.train.min_lr),
        warmup_steps=int(config.train.n_warmup_epochs) * steps_per_epoch,
        max_n_steps=n_epochs * steps_per_epoch,
        weight_decay=float(config.train.weight_decay),
        clip_grad=float(config.train.clip_grad),
        layer_decay=float(config.train.layer_decay),
        n_blocks=model.enc_depth,
    )
    opt_state = tx.init()
    train_step = make_train_step(model, tx, opt_state)
    patch_size, n_classes = tuple(config.data.sax.patch_size), int(config.model.out_chans)
    spacing = tuple(config.data.sax.spacing)

    out_dir = Path(config.logging.dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(0)
    best, patience_left = -np.inf, int(config.train.early_stopping.patience)
    for epoch in range(n_epochs):
        losses = []
        for batch in train_loader.epoch(epoch):
            batch = to_device(batch, device)
            metrics = train_step({"sax_image": batch["sax_image"], "sax_label": batch["sax_label"].long()},
                                 generator)
            losses.append(metrics["loss"].detach())
        print(f"epoch {epoch}: train loss {float(torch.stack(losses).float().mean()):.4f}")

        if (epoch + 1) % int(config.train.eval_interval) and epoch + 1 != n_epochs:
            continue
        dices, hds = [], []
        for batch in val_loader.epoch(0):
            batch = to_device(batch, device)
            label = batch["sax_label"].long()
            d, pred = eval_step(model, batch["sax_image"], label, patch_size, n_classes)
            dices.append(np.nanmean(d.cpu().numpy()[:, 1:]))  # foreground classes
            hd = hausdorff_distance_95(  # on the host, as MONAI's
                one_hot(pred, n_classes).cpu().numpy(), one_hot(label, n_classes).cpu().numpy(), spacing=spacing
            )  # (batch, n_classes - 1): foreground classes only
            hds.append(np.nanmean(hd))
        mean_dice = float(np.mean(dices))
        print(f"epoch {epoch}: val mean foreground dice {mean_dice:.4f}, HD95 {np.nanmean(hds):.2f} mm")
        if mean_dice > best + float(config.train.early_stopping.min_delta):
            best, patience_left = mean_dice, int(config.train.early_stopping.patience)
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
    parser.add_argument("--mae_ckpt", type=Path, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides of the packaged config")
    args = parser.parse_args(argv)
    overrides = [f"data.dir={args.data_dir}", *args.overrides]
    if args.mae_ckpt:
        overrides.append(f"model.ckpt_path={args.mae_ckpt}")
    config = apply_overrides(from_dict(PACKAGED[CONFIG]), overrides)
    run(config, args.n_epochs, device=args.device)


if __name__ == "__main__":
    main()
