"""Multi-process runs (port of cinema_tpu/parallel/multihost.py).

One process drives one card, as ``torchrun --nproc_per_node=N`` starts them
(the reference's ``mp.spawn`` with NCCL DDP, cinema/device.py:23-48):

- :func:`maybe_initialize_distributed` joins the process group from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) where the config sets ``mesh.multiprocess``:
  NCCL on the card, gloo where the caller asks for the CPU;
- :func:`shard_manifest` gives each data-parallel rank its slice of the study
  list, seeded, wrap-padded and strided: ``DistributedSampler(shuffle=True)``;
- with one card per process, a process loads ``batch_size_per_device`` rows
  (the JAX package's ``local_data_shard_count`` is 1 here) and
  ``data.device_prefetch`` puts them on its own card: the JAX package's
  ``make_global_batch`` assembles one global array from the processes' rows,
  here each rank's step takes its own rows and the gradients are reduced.

Tensor-parallel peers (``mesh.n_model`` > 1) share a data coordinate and must
load the same rows, so the entry points shard the manifest and the loader by
the data coordinate of the mesh (:func:`data_shard`), not by the process rank.
(The JAX package shards by ``jax.process_index()``, which gives two processes
of one model row different rows: ROADMAP.md, known divergences.)

Runs without ``mesh.multiprocess`` join no group and pass through unchanged.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple, TypeVar, Union

import numpy as np
import torch
import torch.distributed as dist

from cinema_tpu_torch.log import get_logger
from cinema_tpu_torch.parallel.mesh import DATA_AXIS

logger = get_logger(__name__)

T = TypeVar("T")

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(multiprocess: bool = False,
                                 device: Union[str, torch.device] = "cuda") -> torch.device:
    """Join the process group of a multi-process run and return this process's device.

    A no-op that returns ``device`` unless ``multiprocess`` is set (the JAX package's gate on
    ``mesh.multiprocess``). Otherwise: on the card, ``cuda:LOCAL_RANK`` becomes the current
    device and the group is NCCL's; on the CPU it is gloo's. A group that exists already is
    kept (a second entry point in one process joins nothing).
    """
    device = torch.device(device)
    if not multiprocess:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"mesh.multiprocess is set but {missing} are not in the environment: "
                               "launch with torchrun, or set them.")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
        logger.info(f"distributed: rank {dist.get_rank()}/{dist.get_world_size()} ({dist.get_backend()}) "
                    f"on {device}")
    return device


def distributed() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def data_shard(mesh) -> Tuple[int, int]:
    """(data-parallel rank, data-parallel size): ``mesh``'s data coordinate and size (``mesh.make_mesh``),
    or (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(DATA_AXIS), mesh.size(0)


def shard_manifest(
    items: Sequence[T],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    shuffle_seed: Optional[int] = None,
) -> List[T]:
    """This rank's equal-length shard of a manifest: ``DistributedSampler``'s order (reference
    cinema/mae/pretrain.py:327-330) — an optional seeded shuffle of the whole list, wrap-padded to a
    multiple of the size, then ``[rank::size]``. Every rank gets ceil(n / size) items and together they
    cover the list. Rank and size default to the process group's, as the JAX package's do; a
    distributed entry point passes its :func:`data_shard`.
    """
    n = len(items)
    if n == 0:
        return []
    rank = (dist.get_rank() if distributed() else 0) if process_index is None else process_index
    world = (dist.get_world_size() if distributed() else 1) if process_count is None else process_count
    if world == 1:
        return list(items)
    order = np.arange(n)
    if shuffle_seed is not None:
        order = np.random.default_rng(shuffle_seed).permutation(n)
    per_rank = -(-n // world)
    padded = np.resize(order, per_rank * world)  # wrap-pad like DistributedSampler
    return [items[i] for i in padded[rank::world]]


def synced_time() -> int:
    """The time in seconds, process 0's in a process group (the run folder's time stamp, the same on
    every rank; port of cinema_tpu/log.py:69-86)."""
    t = int(time.time())
    if process_count() > 1:
        # a failed broadcast raises: a local time would split the run over several folders
        stamp = torch.tensor([t], dtype=torch.int64, device=_collective_device())
        dist.broadcast(stamp, src=0)
        t = int(stamp[0])
    return t


def _collective_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
