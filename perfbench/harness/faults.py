"""Faults planted under the timed path, and the control, to show that the comparison catches them.

Train steps: ``state_unchanged`` (the step computes its loss but hands back the parameters, the
optimizer's state and the counters as they were) and ``half_batch`` (half of the batch left out, the
mean taken over the rest). Serving: ``altered_label`` (each study's first frame comes back with
every label moved to the next class, where the labels are produced).

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
CONTROL = "fp8_control"


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


def wrap_serve(fault: str, serve_fn: Callable, n_classes: int) -> Callable:
    if fault != "altered_label":
        raise ValueError(f"Unknown serving fault {fault!r}.")

    def altered(model, video):
        labels = serve_fn(model, video)
        labels[..., 0] = (labels[..., 0] + 1) % n_classes
        return labels.astype(np.uint8)
    return altered
