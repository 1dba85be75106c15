"""Self-contained MAE pretraining tutorial (port of examples/train/pretrain.py).

The loop that ``tasks.pretrain`` automates, written out inline in torch: the studies' manifest
(``scan_manifest``), the frame-seeking ``UKBCineDataset`` with the pretraining augmentation, one MAE train
step (masks drawn on the device, the masked-patch MSE, gradients, the fused AdamW update dropped on a
non-finite loss), and ``last.safetensors`` after every epoch.

Run on a folder of studies (``<pid>/<pid>_<view>.nii.gz`` or ``<pid>/<pid>_<view>_t.nii.gz`` 4-D cines, as
``ukb_dicom_preprocess`` writes them); the default config is ``PACKAGED["mae"]``, changed by dotted
overrides:
    python -m cinema_tpu_torch.examples.train.pretrain --data_dir path/to/processed \
        [--n_epochs 10] [--device cuda] [key=value ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from cinema_tpu_torch.config import PACKAGED, Config, apply_overrides, from_dict
from cinema_tpu_torch.data import BatchLoader, UKBCineDataset, to_device
from cinema_tpu_torch.data.transforms import get_pretrain_transforms
from cinema_tpu_torch.examples.common import compute_dtype
from cinema_tpu_torch.factory import get_mae_model, init_weights, resolve_device
from cinema_tpu_torch.ops.masking import PatchMask
from cinema_tpu_torch.tasks.pretrain import scan_manifest
from cinema_tpu_torch.train.checkpoint import save_params_safetensors
from cinema_tpu_torch.train.fused_optim import FusedAdamW, FusedAdamWState
from cinema_tpu_torch.train.optim import build_optimizer

CONFIG = "mae"


def make_train_step(model: nn.Module, tx: FusedAdamW, opt_state: FusedAdamWState, mask_ratio: float) -> Callable:
    """The MAE step ``step(batch, generator, mask_dict=None) -> metrics``: random masking (drawn from
    ``generator`` unless ``mask_dict`` is given), masked-patch MSE, gradients, AdamW update dropped where the
    loss is not finite."""
    params = list(model.parameters())

    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator,
             mask_dict: Optional[Dict[str, PatchMask]] = None) -> Dict[str, torch.Tensor]:
        model.train()
        loss, _preds, _masks, metrics = model(batch, mask_ratio, mask_dict, generator=generator)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        tx.step(grads, opt_state, torch.isfinite(loss.detach()))
        return {k: v.detach() for k, v in metrics.items()}

    return step


def run(config: Config, n_epochs: int, device: str = "cuda") -> None:
    device = resolve_device(device)
    views = list(config.model.views)
    data_dir = Path(config.data.dir).expanduser()
    pids = scan_manifest(data_dir, views)
    if not pids:
        raise ValueError(f"No studies with views {views} found under {data_dir}.")
    print(f"found {len(pids)} studies")

    dataset = UKBCineDataset(data_dir, pids, views=views, transform=get_pretrain_transforms(config), seed=0)
    batch_size = int(config.train.batch_size_per_device)
    loader = BatchLoader(dataset, batch_size, shuffle=True, drop_last=True, seed=0)
    steps_per_epoch = max(1, len(dataset) // batch_size)

    model = init_weights(get_mae_model(config, dtype=compute_dtype(device), device=device), seed=0)
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
    step = make_train_step(model, tx, opt_state, float(config.train.enc_mask_ratio))

    out_dir = Path(config.logging.dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(0)
    for epoch in range(n_epochs):
        losses = []
        for batch in loader.epoch(epoch):
            metrics = step(to_device(batch, device), generator)
            losses.append(metrics["loss"])
        print(f"epoch {epoch}: train loss {float(torch.stack(losses).float().mean()):.4f}")
        save_params_safetensors(model, out_dir / "last.safetensors")
    print(f"saved {out_dir / 'last.safetensors'}")


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
