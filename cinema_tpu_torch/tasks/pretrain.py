"""MAE pretraining entry point (port of cinema_tpu/tasks/pretrain.py; reference cinema/mae/pretrain.py).

One process drives one card: mask sampling, the masked forward, the
gradients and the fused AdamW update are one step function that reads
nothing back from the device; the loss is read once per epoch.

Usage:
    python -m cinema_tpu_torch.tasks.pretrain [--config mae.yaml] [--device cuda] [key=value ...]

Without ``--config`` the packaged CineMA-base configuration is used
(``cinema_tpu_torch.config.PACKAGED["mae"]``); ``data.dir=...`` names the
data. Per epoch the run directory receives a line in ``metrics.jsonl``, the
checkpoint ``ckpt_{epoch}.pt`` and the model as ``cinema.safetensors``;
``train.ckpt_path=...`` resumes from a checkpoint.

Data: ``data.dir`` holds one ``.npz`` per study with one array per view,
``sax`` as (x, y, z, t) and the ``lax_*`` views as (x, y, t). Each epoch
takes one seeded random frame of every study, min-max scales it to [0, 1]
and end-pads or crops it to the view's patch size. NIfTI input, the
manifest cache, worker processes and the augmentation transforms of the
JAX package are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np
import torch

from cinema_tpu_torch.config import PACKAGED, Config, apply_overrides, from_dict, load_config
from cinema_tpu_torch.factory import get_mae_model, init_weights, resolve_device
from cinema_tpu_torch.serve import scale_intensity
from cinema_tpu_torch.train.checkpoint import (
    CheckpointRetention,
    load_checkpoint,
    save_checkpoint,
    save_params_safetensors,
)
from cinema_tpu_torch.train.loop import MetricsLogger
from cinema_tpu_torch.train.optim import build_optimizer, get_n_accum_steps
from cinema_tpu_torch.train.state import TrainState, make_mae_train_step


def fit_to_size(x: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """End-pad with zeros or crop the leading axes of ``x`` to ``size``."""
    x = x[tuple(slice(0, s) for s in size)]
    return np.pad(x, [(0, s - n) for n, s in zip(x.shape, size)] + [(0, 0)] * (x.ndim - len(size)))


class NpzCineDataset:
    """One ``.npz`` per study under ``data_dir``; an item is one frame per view,
    {view: (*patch_size, 1) float32 in [0, 1]}."""

    def __init__(self, data_dir: Path, views: Sequence[str], sizes: Dict[str, Sequence[int]], seed: int = 0,
                 max_n_samples: int = -1) -> None:
        self.paths = sorted(Path(data_dir).glob("*.npz"))
        if max_n_samples > 0:
            self.paths = self.paths[:max_n_samples]
        if not self.paths:
            raise ValueError(f"No .npz studies found under {data_dir}.")
        self.views, self.sizes, self.seed = list(views), sizes, seed

    def __len__(self) -> int:
        return len(self.paths)

    def load(self, index: int, epoch: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, epoch, index])
        item = {}
        with np.load(self.paths[index]) as study:
            n_frames = study[self.views[0]].shape[-1]
            t = int(rng.integers(n_frames))  # the same frame for every view of the study
            for view in self.views:
                frame = scale_intensity(study[view][..., t])
                item[view] = fit_to_size(frame, self.sizes[view])[..., None]
        return item


class BatchLoader:
    """Seeded shuffled batches per epoch, incomplete last batch dropped; a
    background thread loads ``depth`` batches ahead of the training step."""

    def __init__(self, dataset: NpzCineDataset, batch_size: int, seed: int = 0, depth: int = 2) -> None:
        self.dataset, self.batch_size, self.seed, self.depth = dataset, batch_size, seed, depth

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.random.default_rng([self.seed, epoch]).permutation(len(self.dataset))
        for b in range(len(self)):
            items = [self.dataset.load(int(i), epoch) for i in order[b * self.batch_size : (b + 1) * self.batch_size]]
            yield {view: np.stack([item[view] for item in items]) for view in self.dataset.views}

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of one epoch."""
        out: queue.Queue = queue.Queue(maxsize=self.depth)

        def work() -> None:
            try:
                for batch in self._batches(epoch):
                    out.put(batch)
                out.put(None)
            except Exception as e:  # handed to the consumer, which raises it
                out.put(e)

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        while True:
            batch = out.get()
            if batch is None:
                break
            if isinstance(batch, Exception):
                raise batch
            yield batch
        thread.join()


def init_run_dir(config: Config, tags: List[str]) -> Path:
    """Create ``<logging.dir>/<timestamp>-<tags>/`` with the run record ``run.json`` (tags + config)."""
    base = Path(config.get("logging", {}).get("dir") or "runs")
    out_dir = base / "-".join([time.strftime("%Y%m%d-%H%M%S"), *tags[:3]])
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "run.json", "w") as f:
        json.dump({"tags": tags, "created": time.strftime("%Y-%m-%dT%H:%M:%S"), "config": config}, f, indent=2,
                  default=str)
    return out_dir


def run(config: Config, device: Union[str, torch.device] = "cuda") -> Path:
    """Pretrain CineMA as ``config`` says, on ``device``; returns the run directory."""
    device = resolve_device(device)
    views = list(config.model.views)
    if not config.data.get("dir"):
        raise ValueError("config.data.dir is not set: it names the directory of .npz studies.")
    n_accum = get_n_accum_steps(config.train.batch_size, config.train.batch_size_per_device, 1)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = init_weights(get_mae_model(config, dtype=dtype, device=device), seed=config.seed)

    dataset = NpzCineDataset(
        Path(config.data.dir).expanduser(), views, model.image_size_dict, seed=config.seed,
        max_n_samples=config.data.get("max_n_samples", -1),
    )
    loader = BatchLoader(dataset, config.train.batch_size_per_device, seed=config.seed)
    if len(loader) == 0:
        raise ValueError(f"{len(dataset)} studies do not fill one batch of {config.train.batch_size_per_device}.")
    steps_per_epoch = max(len(loader) // n_accum, 1)
    print(f"Found {len(dataset)} studies: {len(loader)} batches and {steps_per_epoch} updates per epoch.", flush=True)

    tx = build_optimizer(
        dict(model.named_parameters()),
        lr=config.train.lr,
        min_lr=config.train.min_lr,
        warmup_steps=config.train.n_warmup_epochs * steps_per_epoch,
        max_n_steps=config.train.n_epochs * steps_per_epoch,
        betas=tuple(config.train.betas),
        weight_decay=config.train.weight_decay,
        clip_grad=config.train.clip_grad,
        accum_steps=n_accum,
    )
    state = TrainState.create(model, tx)
    step_fn = make_mae_train_step(model, tx, config.train.enc_mask_ratio, seed=config.seed)

    tags = ["ukb_mae_pretrain"] + (["multi_view"] if len(views) > 1 else [])
    out_dir = init_run_dir(config, tags)
    metrics_logger = MetricsLogger(out_dir)
    retention = CheckpointRetention(config.train.max_n_ckpts, pin_every=100)

    start_epoch = 0
    if config.train.get("ckpt_path"):
        state = load_checkpoint(Path(config.train.ckpt_path), state)
        # state.step counts batches; checkpoints are written at epoch ends
        start_epoch = state.step // len(loader)
        print(f"Resumed from {config.train.ckpt_path} at epoch {start_epoch}.", flush=True)

    for epoch in range(start_epoch, config.train.n_epochs):
        t0 = time.perf_counter()
        losses, skipped = [], []
        for batch in loader.epoch(epoch):
            device_batch = {v: torch.from_numpy(x).to(device, non_blocking=True) for v, x in batch.items()}
            state, metrics = step_fn(state, device_batch)
            losses.append(metrics["loss"])
            skipped.append(metrics["skipped_nan"])
        # the epoch's one read from the device
        epoch_loss = float(torch.nanmean(torch.stack(losses)))
        n_skipped = int(torch.stack(skipped).sum())
        dt = time.perf_counter() - t0
        clips_per_sec = len(loader) * loader.batch_size / dt
        metrics_logger.log({
            "epoch": epoch, "loss": epoch_loss, "clips_per_sec_per_chip": clips_per_sec,
            "n_samples": state.n_samples, "skipped_nan": n_skipped,
        })
        print(f"epoch {epoch}: loss={epoch_loss:.4f} {clips_per_sec:.1f} clips/s", flush=True)
        path = save_checkpoint(out_dir, state, epoch)
        save_params_safetensors(state.params, out_dir / "cinema.safetensors")
        retention.add(path, epoch)
    return out_dir


def main(argv: Union[List[str], None] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=Path, help="YAML config (default: the packaged CineMA-base config)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides, e.g. data.dir=studies")
    args = parser.parse_args(argv)
    config = load_config(args.config) if args.config else from_dict(PACKAGED["mae"])
    run(apply_overrides(config, args.overrides), device=args.device)


if __name__ == "__main__":
    main()
