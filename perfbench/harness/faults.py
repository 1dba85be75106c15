"""Faults planted under the timed path, and the control, to show that the comparison catches them.

Train steps: ``state_unchanged`` (the step computes its loss but hands back the parameters, the
optimizer's state and the counters as they were) and ``half_batch`` (half of the batch left out, the
mean taken over the rest). Serving: ``altered_label`` (each study's first frame comes back with
every label moved to the next class, where the labels are produced). Data-parallel train steps,
besides the train steps' faults on every rank: ``replica_drift`` (rank 1 scales its largest leaf's
reduced gradient by 1 + 2^-8 before the update; every collective still runs, so the ranks' replicas
part without a hang). ``rank_raises`` and ``rank_loads_jax`` are no faults of the results: rank 1
raises before it joins the group, to show that a dead rank ends the run, or puts a module named
``jax`` into its ``sys.modules``, to show that a rank's guard against the JAX package ends it too.

``CONTROL`` is planted by the drivers themselves, after the window: the plain reference computed
with fp8 products (``reference.lowp.FP8``, the step below the configurations' bfloat16) takes the
program's place in the comparison (the calls it follows, or the labels of the sampled frames), so
that it is judged on the same sample and by the same ``correct`` as the program.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

TRAIN = ("state_unchanged", "half_batch")
SERVE = ("altered_label",)
DDP = ("replica_drift",)
# the faults that a cell of each kind of traffic can have
BY_KIND = {"train_pool": TRAIN, "train_ddp": TRAIN + DDP, "serve_cine": SERVE}
CONTROL = "fp8_control"
RANK_RAISES = "rank_raises"
RANK_LOADS_JAX = "rank_loads_jax"


def wrap_step(fault: str, step_fn: Callable, model: torch.nn.Module) -> Callable:
    if fault == "half_batch":
        def half(state, batch):
            rows = next(iter(batch.values())).shape[0]
            return step_fn(state, {k: v[: rows // 2] for k, v in batch.items()})
        return half
    if fault == "state_unchanged":
        def unchanged(state, batch):
            params = [p.detach().clone() for p in model.parameters()]
            opt = state.opt_state
            tensors = [opt.count, *opt.mu, *opt.nu, *opt.acc] + ([opt.mini_step] if opt.mini_step is not None else [])
            saved = [t.clone() for t in tensors]
            step, n_samples = state.step, state.n_samples
            state, metrics = step_fn(state, batch)
            with torch.no_grad():
                for p, old in zip(model.parameters(), params):
                    p.copy_(old)
                for t, old in zip(tensors, saved):
                    t.copy_(old)
            state.step, state.n_samples = step, n_samples
            return state, metrics
        return unchanged
    raise ValueError(f"Unknown train-step fault {fault!r}.")


def plant_ddp(fault: str, parallel, rank: int) -> None:
    """Plants a data-parallel fault in this rank's ``parallel.mesh.Parallel``."""
    if fault != "replica_drift":
        raise ValueError(f"Unknown data-parallel fault {fault!r}.")
    if rank != 1:
        return
    reduce = parallel.gradients

    def drifted(loss, model):
        grads = reduce(loss, model)
        largest = max(range(len(grads)), key=lambda j: grads[j].numel())
        grads[largest].mul_(1.0 + 2.0**-8)
        return grads

    parallel.gradients = drifted


def wrap_serve(fault: str, serve_fn: Callable, n_classes: int) -> Callable:
    if fault != "altered_label":
        raise ValueError(f"Unknown serving fault {fault!r}.")

    def altered(model, video):
        labels = serve_fn(model, video)
        labels[..., 0] = (labels[..., 0] + 1) % n_classes
        return labels.astype(np.uint8)
    return altered
