"""Generic fine-tune training loop (port of cinema_tpu/train/loop.py; reference cinema/train.py:171-351).

The host orchestration around one train step: data loading, evaluation
intervals, early stopping, checkpoint retention and the metrics log. One
process drives one card. With ``mesh.multiprocess`` (one process per card,
launched by torchrun) the run joins the process group and lays the model
out over a ('data', 'model') mesh (``cinema_tpu_torch.parallel``): each data
rank loads its shard of every epoch, the gradients are reduced over the
ranks, and rank 0 alone writes the run folder, whose name every rank shares.
The JAX package's ahead-of-time executable cache has no counterpart here.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config, from_dict, save_config
from cinema_tpu_torch.data import BatchLoader, device_prefetch
from cinema_tpu_torch.factory import init_weights, resolve_device
from cinema_tpu_torch.log import flatten_dict, get_run_tags
from cinema_tpu_torch.parallel import multihost
from cinema_tpu_torch.parallel.mesh import make_mesh, parallelize
from cinema_tpu_torch.train.checkpoint import (
    CheckpointRetention,
    checkpoint_state,
    load_checkpoint,
    save_checkpoint,
    save_params_safetensors,
)
from cinema_tpu_torch.train.optim import EarlyStopping, build_optimizer, get_n_accum_steps
from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step


def pick_n_data(n_devices: int, batch_size: int, batch_size_per_device: int, n_samples: int) -> int:
    """The widest data-parallel size that keeps the global batch divisible (cinema_tpu/train/loop.py:36-52):
    the largest n <= n_devices with ``batch_size % (batch_size_per_device * n) == 0`` and a local batch
    that the dataset can fill."""
    cap = min(n_devices, max(batch_size // batch_size_per_device, 1))
    cap = min(cap, max(n_samples // batch_size_per_device, 1))
    for n in range(cap, 0, -1):
        if batch_size % (batch_size_per_device * n) == 0:
            return n
    return 1


def is_main_process() -> bool:
    """Rank 0 of a distributed run, or a single-process run: the process that writes the run folder."""
    return multihost.process_index() == 0


class MetricsLogger:
    """Append-only JSONL metrics log; a logger that is not ``enabled`` (a rank other than 0) writes nothing."""

    def __init__(self, out_dir: Path, enabled: bool = True) -> None:
        self.path = Path(out_dir) / "metrics.jsonl"
        self.enabled = enabled
        if enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, metrics: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in metrics.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


def init_run_dir(config: Config, tags: Optional[List[str]] = None, out_dir: Optional[Path] = None) -> Path:
    """Create the run directory with its run record ``run.json`` (cinema_tpu/log.py:89-120): ``tags``
    (default :func:`get_run_tags`, ``[]`` where the config lacks one of its keys), ``created`` and the config
    flattened with ``_``. The directory defaults to ``<logging.dir or runs>/%Y%m%d_%H%M%S-<first three tags>``.
    In a distributed run the time stamp is rank 0's and rank 0 alone writes; every rank returns the path."""
    if tags is None:
        try:
            tags = get_run_tags(config)
        except (AttributeError, KeyError, TypeError):
            tags = []
    now = time.localtime(multihost.synced_time())
    if out_dir is None:
        base = Path(config.logging.dir) if config.get("logging") and config.logging.get("dir") else Path("runs")
        out_dir = base / "-".join([time.strftime("%Y%m%d_%H%M%S", now), *tags[:3]])
    out_dir = Path(out_dir)
    if is_main_process():
        out_dir.mkdir(parents=True, exist_ok=True)
        record = {"tags": tags, "created": time.strftime("%Y-%m-%dT%H:%M:%S", now),
                  "config": flatten_dict(config)}
        with open(out_dir / "run.json", "w") as f:
            json.dump(record, f, indent=2, default=str)
    return out_dir


def maybe_reduce_batch_size(config: Config, n: int) -> Config:
    """Halve the batch size until it fits the dataset (reference train.py:26-46)."""
    batch_size = config.train.batch_size
    if n >= batch_size:
        return config
    while n < batch_size:
        batch_size //= 2
    if batch_size == 0:
        raise ValueError(f"Dataset size is too small {n}.")
    print(f"Using batch size {batch_size} instead.", flush=True)
    config = from_dict(config)
    config.train.batch_size = batch_size
    config.train.batch_size_per_device = min(config.train.batch_size_per_device, batch_size)
    return config


def pandas_sample(n: int, size: int, rng: np.random.RandomState) -> List[int]:
    """The rows that pandas' ``sample`` takes of ``n`` rows, in the order it takes them: one
    ``choice`` without replacement from the frame's generator (pandas.core.sample.sample)."""
    return [int(i) for i in rng.choice(n, size=size, replace=False)]


def _grouped(groups: Sequence[Any]) -> List[List[int]]:
    """The indices of each group, in pandas' ``groupby`` order: groups by sorted key, rows in their order;
    a missing key (``None``) belongs to no group."""
    members: Dict[Any, List[int]] = {}
    for i, key in enumerate(groups):
        if key is not None:
            members.setdefault(key, []).append(i)
    return [members[key] for key in sorted(members)]


def groupby_sample(groups: Sequence[Any], n: int, seed: int = 0) -> List[int]:
    """The indices that pandas' ``groupby(groups).sample(n=n, random_state=seed)`` draws, in the order of its
    result: group by group in sorted key order, each group's in drawn order. A group smaller than ``n``, where
    pandas raises, is taken whole."""
    rng = np.random.RandomState(seed)
    return [members[i] for members in _grouped(groups)
            for i in pandas_sample(len(members), min(n, len(members)), rng)]


def split_by_class(labels: Sequence[Any], n_val_per_class: int = 2, seed: int = 0) -> Tuple[List[int], List[int]]:
    """Indices (train, val), each in the order of ``labels``: the studies that pandas'
    ``groupby(labels).sample(n=n_val_per_class, random_state=seed)`` draws go to validation
    (cinema_tpu/tasks/classification/acdc.py:30)."""
    val = set(groupby_sample(labels, n_val_per_class, seed))
    return [i for i in range(len(labels)) if i not in val], sorted(val)


def _sample_fraction(items: List[Any], frac: float, groups: Optional[Sequence[Any]]) -> List[Any]:
    """The items that pandas' ``sample(frac=frac, random_state=0)`` keeps, of each group apart (``groupby``)
    where ``groups`` are given, in pandas' order: ``round(frac * n)`` of a group of n."""
    rng = np.random.RandomState(0)
    keep: List[int] = []
    for members in _grouped(groups) if groups is not None else [list(range(len(items)))]:
        keep += [members[i] for i in pandas_sample(len(members), round(frac * len(members)), rng)]
    return [items[i] for i in keep]


def maybe_subset_dataset(
    config: Config,
    train: List[Any],
    val: List[Any],
    train_groups: Optional[Sequence[Any]] = None,
    val_groups: Optional[Sequence[Any]] = None,
) -> Tuple[List[Any], List[Any]]:
    """The ``data.max_n_samples`` cap and the ``data.proportion`` of the training list, the rows and the
    order that the JAX package's pandas calls give (cinema_tpu/train/loop.py:89-101; reference
    train.py:49-82).

    The cap keeps the fraction ``cap / len`` of each list: of every group (classification passes the
    class labels) or of the whole list. The proportion then keeps ``int(proportion * len)`` of the
    training list, drawn with ``config.seed``.
    """
    cap = config.data.get("max_n_samples", -1)
    if cap > 0:
        if train:
            train = _sample_fraction(train, min(cap / len(train), 1.0), train_groups)
        if val:
            val = _sample_fraction(val, min(cap / len(val), 1.0), val_groups)
    proportion = config.data.get("proportion", 1.0)
    if proportion < 1:
        keep = pandas_sample(len(train), int(proportion * len(train)), np.random.RandomState(config.seed))
        train = [train[i] for i in keep]
    return train, val


def run_train(
    config: Config,
    load_dataset: Callable[[Config], Tuple[Any, Any]],
    get_model_fn: Callable[..., nn.Module],
    loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
    eval_dataloader_fn: Callable[[nn.Module, BatchLoader, Config], Dict[str, float]],
    load_pretrained_fn: Optional[Callable[[nn.Module, Config], Optional[Dict[str, bool]]]] = None,
    out_dir: Optional[Path] = None,
    device: Union[str, torch.device] = "cuda",
) -> Path:
    """Fine-tune a model: train, evaluate, early-stop, save (reference run_train, train.py:171-351).

    Args:
        config: task config (reference YAML schema).
        load_dataset: config -> (train_dataset, val_dataset), each with ``__len__`` and
            ``load(index, epoch) -> dict of arrays``.
        get_model_fn: (config, dtype=..., device=...) -> model.
        loss_fn: (model, batch) -> (loss, metrics), run inside the train step.
        eval_dataloader_fn: (model, val_loader, config) -> metrics.
        load_pretrained_fn: (model, config) -> freeze mask (name -> loaded) or None; loads the
            weights in place; applied when ``config.model.ckpt_path`` is set.
        out_dir: run directory; defaults to ``config.logging.dir`` / timestamp.
        device: the card, unless the caller asks for the CPU (float32 there, bfloat16 on the card).

    With ``mesh.multiprocess``, ``mesh.n_model`` (tensor parallelism), ``mesh.fsdp`` and ``mesh.n_data``
    (default: ``pick_n_data`` of the processes) lay the run out over the processes (module docstring).

    Returns:
        the run directory, holding ``run.json``, ``config.yaml``, ``metrics.jsonl`` and for each saved epoch
        ``ckpt_{epoch}.pt``, its early-stopping sidecar ``ckpt_{epoch}.pt.meta.json`` and
        ``model_{epoch}.safetensors``. ``config.train.resume_path`` names a checkpoint to resume from.
    """
    device = resolve_device(device)
    mesh_cfg = config.get("mesh") or {}
    multiprocess = bool(mesh_cfg.get("multiprocess", False))
    device = multihost.maybe_initialize_distributed(multiprocess, device)
    train_dataset, val_dataset = load_dataset(config)
    for ds in (train_dataset, val_dataset):
        if hasattr(ds, "seed"):
            ds.seed = config.seed  # reproducible per-item choices
    config = maybe_reduce_batch_size(config, len(train_dataset))
    mesh = None
    if multiprocess:
        n_model = int(mesh_cfg.get("n_model", 1))
        n_data = mesh_cfg.get("n_data")
        if n_data is None:
            n_data = pick_n_data(multihost.process_count() // n_model, config.train.batch_size,
                                 config.train.batch_size_per_device, len(train_dataset))
        mesh = make_mesh(int(n_data), n_model, device.type)
    # the items load in ``train.n_workers`` threads: on the card's host they keep a ConvUNetR-base step fed,
    # where worker processes load no faster and take seconds to start (PERF.md, section 6); each data rank
    # loads its shard of the epoch's order
    n_workers = config.train.get("n_workers", 4)
    train_loader = BatchLoader(train_dataset, config.train.batch_size_per_device, seed=config.seed,
                               n_workers=n_workers, process_shard=multihost.data_shard(mesh))
    val_loader = BatchLoader(val_dataset, 1, shuffle=False, drop_last=False, n_workers=n_workers)
    n_accum_steps = get_n_accum_steps(config.train.batch_size, config.train.batch_size_per_device,
                                      1 if mesh is None else mesh.size(0))
    steps_per_epoch = max(len(train_loader) // n_accum_steps, 1)

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = init_weights(get_model_fn(config, dtype=dtype, device=device), seed=config.seed)
    freeze_mask = None
    pretrained = config.model.get("ckpt_path") is not None and load_pretrained_fn is not None
    if pretrained:
        loaded = load_pretrained_fn(model, config)
        if config.model.get("freeze_pretrained"):
            freeze_mask = loaded
    parallel = None
    if mesh is not None:
        parallel = parallelize(model, mesh, fsdp=bool(mesh_cfg.get("fsdp", False)))
    main = is_main_process()

    tx = build_optimizer(
        dict(model.named_parameters()) if parallel is None else dict(zip(parallel.names,
                                                                         parallel.optimizer_params(model))),
        lr=config.train.lr,
        min_lr=config.train.min_lr,
        warmup_steps=config.train.n_warmup_epochs * steps_per_epoch,
        max_n_steps=config.train.n_epochs * steps_per_epoch,
        betas=tuple(config.train.betas),
        weight_decay=config.train.weight_decay,
        clip_grad=config.train.clip_grad if config.train.clip_grad > 0 else None,
        layer_decay=config.train.get("layer_decay") if pretrained else None,
        n_blocks=getattr(model, "enc_depth", 0),
        freeze_mask=freeze_mask,
        accum_steps=n_accum_steps,
        global_norm=None if parallel is None else parallel.global_norm,
    )
    state = TrainState.create(model, tx)

    # resume: the whole train state, and early stopping's best metric and patience from
    # the checkpoint's sidecar, so the saved best stays monotone
    early_stop = EarlyStopping(
        min_delta=config.train.early_stopping.min_delta, patience=config.train.early_stopping.patience
    )
    start_epoch = 0
    resumed_meta = False
    if config.train.get("resume_path"):
        resume = Path(config.train.resume_path)
        if not resume.exists():
            raise FileNotFoundError(f"train.resume_path {resume} does not exist.")
        state = load_checkpoint(resume, state, parallel)
        # state.step counts micro-batches
        start_epoch = state.step // len(train_loader)
        meta_path = resume.parent / f"{resume.name}.meta.json"
        if meta_path.exists():
            early_stop.load_state_dict(json.loads(meta_path.read_text()))
            resumed_meta = True
        print(f"Resumed from {resume} at epoch {start_epoch}.", flush=True)

    step_fn = make_supervised_train_step(model, tx, loss_fn, seed=config.seed, parallel=parallel)
    out_dir = init_run_dir(config, out_dir=out_dir)
    if main:  # the config as the JAX package's run_train saves it, read by its load_run and cinema_eval
        save_config(config, out_dir / "config.yaml")
    metrics_logger = MetricsLogger(out_dir, enabled=main)
    retention = CheckpointRetention(config.train.max_n_ckpts)
    saved_any = False

    with train_loader, val_loader:
        for epoch in range(start_epoch, config.train.n_epochs):
            epoch_metrics: Dict[str, list] = {}
            for device_batch in device_prefetch(train_loader.epoch(epoch), device, depth=2):
                state, metrics = step_fn(state, device_batch)
                for k, v in metrics.items():
                    epoch_metrics.setdefault(k, []).append(v)
            # the epoch's one read from the device
            logged = {f"train_{k}": float(torch.stack(v).float().mean()) for k, v in epoch_metrics.items()}
            logged.update({"epoch": epoch, "n_samples": state.n_samples})
            metrics_logger.log(logged)

            if (epoch + 1) % config.train.eval_interval != 0:
                continue

            val_metrics = {f"val_{k}": v for k, v in eval_dataloader_fn(model, val_loader, config).items()}
            val_metrics["epoch"] = epoch
            metrics_logger.log(val_metrics)
            if main:
                print(f"epoch {epoch}: " + ", ".join(f"{k}={v:.4f}" for k, v in val_metrics.items()
                                                    if isinstance(v, float)), flush=True)

            early_metric = val_metrics[config.train.early_stopping.metric]
            if config.train.early_stopping.mode == "max":
                early_metric = -early_metric
            early_stop.update(early_metric)

            # the first evaluation of a fresh run always saves (the reference's epoch-0 save,
            # train.py:335-342): a metric that is NaN at every epoch never improves
            if early_stop.has_improved or not (saved_any or resumed_meta):
                saved_any = True
                payload = checkpoint_state(state, parallel)  # every rank gathers its parts
                path = save_checkpoint(out_dir, state, epoch, parallel, payload)
                if main:
                    (path.parent / f"{path.name}.meta.json").write_text(
                        json.dumps({**early_stop.state_dict(), "epoch": epoch})
                    )
                    save_params_safetensors(payload["params"], out_dir / f"model_{epoch}.safetensors")
                    retention.add(path, epoch)
                    print(f"Saved checkpoint of epoch {epoch} at {path}.", flush=True)
            if early_stop.should_stop:
                print("Met early stopping criteria, breaking.", flush=True)
                break
    return out_dir
