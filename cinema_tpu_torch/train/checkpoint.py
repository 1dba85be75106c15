"""Checkpoints and the safetensors export (port of cinema_tpu/train/checkpoint.py).

The whole train state (parameters, optimizer state, counters) goes into one
``torch.save`` file, which stands in for the JAX package's orbax directory.
A distributed run writes whole tensors in the same layout, so its checkpoint
loads in a single-process run and back.
The model alone is exported as safetensors under the reference checkpoint's
key names, loadable by the reference PyTorch stack, by the JAX package's
bridge and by this package.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import TYPE_CHECKING, List, Mapping, Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from cinema_tpu_torch.convert import save_safetensors
from cinema_tpu_torch.train.state import TrainState

if TYPE_CHECKING:
    from cinema_tpu_torch.parallel.mesh import Parallel


_SHARDED_MOMENTS = ("mu", "nu", "acc")  # the optimizer's per-parameter tensors


def checkpoint_state(state: TrainState, parallel: Optional["Parallel"] = None) -> dict:
    """What a checkpoint holds: counters, the model's ``state_dict`` and the optimizer's state. In a
    distributed run every rank takes part and gets whole tensors (tensor-parallel and FSDP shards
    gathered), the single-process layout."""
    opt_state = state.opt_state.state_dict()
    if parallel is None:
        params = state.params.state_dict()
    else:
        params = parallel.full_state_dict(state.params)
        for key in _SHARDED_MOMENTS:
            opt_state[key] = [parallel.full_tensor(name, t) for name, t in zip(parallel.names, opt_state[key])]
    return {"step": state.step, "n_samples": state.n_samples, "params": params, "opt_state": opt_state}


def save_checkpoint(ckpt_dir: Union[str, Path], state: TrainState, epoch: int,
                    parallel: Optional["Parallel"] = None, payload: Optional[dict] = None) -> Path:
    """Save a train state as ckpt_dir/ckpt_{epoch}.pt (``payload``: its :func:`checkpoint_state`, made
    here where not given). In a distributed run every rank gathers and rank 0 writes."""
    ckpt_dir = Path(ckpt_dir)
    path = (ckpt_dir / f"ckpt_{epoch}.pt").absolute()
    payload = checkpoint_state(state, parallel) if payload is None else payload
    if parallel is None or dist.get_rank() == 0:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        torch.save(payload, path)
    return path


def load_checkpoint(path: Union[str, Path], state: TrainState, parallel: Optional["Parallel"] = None) -> TrainState:
    """Restore a state saved by :func:`save_checkpoint` into ``state`` (in place, on its device); in a
    distributed run each rank reads the whole file and keeps its parts."""
    device = next(state.params.parameters()).device
    saved = torch.load(Path(path), map_location=device, weights_only=True)
    if parallel is None:
        state.params.load_state_dict(saved["params"], strict=True)
    else:
        parallel.load_full_state_dict(state.params, saved["params"])
        for key in _SHARDED_MOMENTS:
            saved["opt_state"][key] = [parallel.local_tensor(name, t)
                                       for name, t in zip(parallel.names, saved["opt_state"][key])]
    state.opt_state.load_state_dict(saved["opt_state"])
    state.step = int(saved["step"])
    state.n_samples = int(saved["n_samples"])
    return state


class CheckpointRetention:
    """Rolling retention with optional pinning (reference mae/pretrain.py:412-428
    keeps max_n_ckpts, pinning every ``pin_every``-th epoch)."""

    def __init__(self, max_n_ckpts: int, pin_every: int = 0) -> None:
        self.max_n_ckpts = max_n_ckpts
        self.pin_every = pin_every
        self.saved: List[Path] = []

    def add(self, path: Path, epoch: int) -> None:
        if self.pin_every and (epoch + 1) % self.pin_every == 0:
            return  # pinned, not subject to deletion
        self.saved.append(Path(path))
        if 0 < self.max_n_ckpts < len(self.saved):
            to_delete = self.saved.pop(0)
            if to_delete.is_dir():
                shutil.rmtree(to_delete, ignore_errors=True)
            elif to_delete.exists():
                to_delete.unlink()

    @property
    def last(self) -> Optional[Path]:
        return self.saved[-1] if self.saved else None


def save_params_safetensors(params: Union[nn.Module, Mapping[str, torch.Tensor]], path: Union[str, Path]) -> None:
    """Export a model (or its state_dict) as safetensors in the reference layout."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    save_safetensors(path, {k: v.detach().cpu().numpy() for k, v in state.items()})


def latest_checkpoint(ckpt_dir: Union[str, Path]) -> Optional[Path]:
    """The ckpt_{n}.pt of the highest epoch n, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    candidates = sorted(
        (p for p in ckpt_dir.glob("ckpt_*.pt") if p.stem.split("_")[-1].isdigit()),
        key=lambda p: int(p.stem.split("_")[-1]),
    )
    return candidates[-1] if candidates else None
