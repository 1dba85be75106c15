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

Data: what the UKB preprocessing writes (cinema_tpu/data/preprocess/ukb_dicom.py): ``data.dir``
holds one folder per study, ``<pid>/<pid>_<view>.nii.gz``, one 4-D cine per view of
``model.views`` (uint8, one gzip member per frame). :func:`scan_manifest` lists the studies that
hold every view and keeps the list in ``data.dir`` beside them; ``data.max_n_samples`` keeps its
first studies. An item is one random frame of each view (``UKBCineDataset``, frame seeks), zoomed,
min-max scaled and end-padded to the view's patch size (``get_pretrain_transforms``), as the JAX
package loads it; ``train.n_workers_per_device`` workers load the items, in processes where
``train.use_process_workers`` says so or, by default, on a host of more than four cores, and
``device_prefetch`` copies two batches ahead of the step.

Several cards: ``torchrun --nproc_per_node=N -m cinema_tpu_torch.tasks.pretrain mesh.multiprocess=true
[mesh.n_model=M] [mesh.fsdp=true] ...``: each process drives one card, each data rank loads its shard of
the studies (``shard_manifest``, seeded with ``config.seed``), the gradients are reduced over the ranks
(``cinema_tpu_torch.parallel``) and rank 0 writes the run folder.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import List, Union

import torch

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.data import BatchLoader, UKBCineDataset, device_prefetch, find_view_file
from cinema_tpu_torch.data.transforms import get_pretrain_transforms
from cinema_tpu_torch.factory import get_mae_model, init_weights, resolve_device
from cinema_tpu_torch.parallel import multihost
from cinema_tpu_torch.parallel.mesh import make_mesh, parallelize
from cinema_tpu_torch.tasks.cli import task_main
from cinema_tpu_torch.train.checkpoint import (
    CheckpointRetention,
    checkpoint_state,
    load_checkpoint,
    save_checkpoint,
    save_params_safetensors,
)
from cinema_tpu_torch.train.loop import MetricsLogger, init_run_dir, is_main_process
from cinema_tpu_torch.train.optim import build_optimizer, get_n_accum_steps
from cinema_tpu_torch.train.state import TrainState, make_mae_train_step


def scan_manifest(data_dir: Path, views: List[str], rescan: bool = False) -> List[str]:
    """The studies under ``data_dir`` that hold a 4-D NIfTI of every view, sorted, with the JAX package's
    cache (reference pretrain.py:49-85).

    The list is kept in ``data_dir/manifest_pids_{sorted views}.json`` as ``{"pids", "n_dir_entries"}``,
    the file the JAX package reads and writes. The cache is stale, and the folder scanned again, when its
    first study no longer resolves, when the number of subdirectories of ``data_dir`` changed, when it is
    the legacy list format or when it does not parse; ``rescan`` ignores it. A folder where the cache
    cannot be written is scanned all the same.
    """
    cache_path = data_dir / f"manifest_pids_{'_'.join(sorted(views))}.json"
    with os.scandir(data_dir) as it:  # the d_type of each entry: no stat() per study
        n_dir_entries = sum(1 for e in it if e.is_dir())
    if not rescan and cache_path.exists():
        try:
            with open(cache_path, encoding="utf-8") as f:
                cached = json.load(f)
        except (json.JSONDecodeError, OSError):
            cached = None
        pids = cached.get("pids") if isinstance(cached, dict) else None
        cached_entries = cached.get("n_dir_entries", -1) if isinstance(cached, dict) else -1
        if (pids and cached_entries == n_dir_entries
                and find_view_file(data_dir / pids[0], pids[0], views[0]) is not None):
            print(f"Loaded {len(pids)} studies from cache {cache_path}.", flush=True)
            return pids
        print(f"Manifest cache {cache_path} is stale, rescanning.", flush=True)

    pids = [d.name for d in sorted(data_dir.iterdir())
            if d.is_dir() and all(find_view_file(d, d.name, v) is not None for v in views)]
    if pids:
        try:
            with open(cache_path, "w", encoding="utf-8") as f:
                json.dump({"pids": pids, "n_dir_entries": n_dir_entries}, f)
        except OSError:
            print(f"Could not write manifest cache {cache_path}.", flush=True)
    return pids


def run(config: Config, device: Union[str, torch.device] = "cuda") -> Path:
    """Pretrain CineMA as ``config`` says, on ``device``; returns the run directory."""
    device = resolve_device(device)
    mesh_cfg = config.get("mesh") or {}
    multiprocess = bool(mesh_cfg.get("multiprocess", False))
    device = multihost.maybe_initialize_distributed(multiprocess, device)
    views = list(config.model.views)
    if not config.data.get("dir"):
        raise ValueError("config.data.dir is not set: it names the directory of the UKB studies.")
    data_dir = Path(config.data.dir).expanduser()
    pids = scan_manifest(data_dir, views, rescan=bool(config.data.get("rescan", False)))
    if config.data.get("max_n_samples", -1) > 0:
        pids = pids[: config.data.max_n_samples]
    if not pids:
        raise ValueError(f"No studies with views {views} found under {data_dir}.")
    mesh = parallel = None
    if multiprocess:
        mesh = make_mesh(n_model=int(mesh_cfg.get("n_model", 1)), device_type=device.type)
    n_accum = get_n_accum_steps(config.train.batch_size, config.train.batch_size_per_device,
                                1 if mesh is None else mesh.size(0))
    # this data rank's studies (DistributedSampler's order; the whole list in a single process)
    pids = multihost.shard_manifest(pids, *multihost.data_shard(mesh), shuffle_seed=config.seed)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = init_weights(get_mae_model(config, dtype=dtype, device=device), seed=config.seed)
    if mesh is not None:
        parallel = parallelize(model, mesh, fsdp=bool(mesh_cfg.get("fsdp", False)))
    main = is_main_process()

    dataset = UKBCineDataset(data_dir, pids, views=views, transform=get_pretrain_transforms(config),
                             seed=config.seed)
    # a frame seek and a scipy zoom per view hold the interpreter for most of an item: worker processes
    # scale with the cores where threads do not
    use_processes = config.train.get("use_process_workers")
    if use_processes is None:
        use_processes = (os.cpu_count() or 1) > 4
    loader = BatchLoader(dataset, config.train.batch_size_per_device, seed=config.seed, shuffle=True, drop_last=True,
                         n_workers=config.train.get("n_workers_per_device", 8), processes=bool(use_processes))
    if len(loader) == 0:
        raise ValueError(f"{len(dataset)} studies do not fill one batch of {config.train.batch_size_per_device}.")
    steps_per_epoch = max(len(loader) // n_accum, 1)
    if main:
        print(f"Found {len(dataset)} studies: {len(loader)} batches and {steps_per_epoch} updates per epoch.",
              flush=True)

    tx = build_optimizer(
        dict(model.named_parameters()) if parallel is None else dict(zip(parallel.names,
                                                                         parallel.optimizer_params(model))),
        lr=config.train.lr,
        min_lr=config.train.min_lr,
        warmup_steps=config.train.n_warmup_epochs * steps_per_epoch,
        max_n_steps=config.train.n_epochs * steps_per_epoch,
        betas=tuple(config.train.betas),
        weight_decay=config.train.weight_decay,
        clip_grad=config.train.clip_grad,
        accum_steps=n_accum,
        global_norm=None if parallel is None else parallel.global_norm,
    )
    state = TrainState.create(model, tx)
    step_fn = make_mae_train_step(model, tx, config.train.enc_mask_ratio, seed=config.seed, parallel=parallel)

    tags = ["ukb_mae_pretrain"] + (["multi_view"] if len(views) > 1 else [])
    out_dir = init_run_dir(config, tags)
    metrics_logger = MetricsLogger(out_dir, enabled=main)
    retention = CheckpointRetention(config.train.max_n_ckpts, pin_every=100)

    start_epoch = 0
    if config.train.get("ckpt_path"):
        state = load_checkpoint(Path(config.train.ckpt_path), state, parallel)
        # state.step counts batches; checkpoints are written at epoch ends
        start_epoch = state.step // len(loader)
        print(f"Resumed from {config.train.ckpt_path} at epoch {start_epoch}.", flush=True)

    with loader:
        for epoch in range(start_epoch, config.train.n_epochs):
            t0 = time.perf_counter()
            losses, skipped = [], []
            for device_batch in device_prefetch(loader.epoch(epoch), device, depth=2):
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
            payload = checkpoint_state(state, parallel)  # every rank gathers its parts
            path = save_checkpoint(out_dir, state, epoch, parallel, payload)
            if main:
                print(f"epoch {epoch}: loss={epoch_loss:.4f} {clips_per_sec:.1f} clips/s", flush=True)
                save_params_safetensors(payload["params"], out_dir / "cinema.safetensors")
                retention.add(path, epoch)
    return out_dir


def main(argv: Union[List[str], None] = None) -> None:
    task_main("mae", run, __doc__, argv)


if __name__ == "__main__":
    main()
