"""Spans and counters of cinema_tpu_torch: the one place the package keeps either.

Spans name the phases of a served study and of a train step:

    with trace.span("serve.study", request=n):
        with trace.span("serve.preprocess"):
            ...

Tracing is off by default, and ``span`` then returns one shared object that does nothing: no
allocation, no torch call. Inside ``with trace.recording():`` (or after ``trace.enable(True)``) a
span enters ``torch.profiler.record_function`` with its request id, if it has one, as the record's
argument string. A running ``torch.profiler`` stamps the span on its own clock, in the timeline of
the device's kernels; without a profiler the record keeps nothing.
Tracing changes no result of the program.

Every span name is declared in ``SPANS`` (``PARENT`` gives each one's enclosing span), and every
counter name in ``COUNTERS``: an undeclared name raises, so that whatever filters or reads them
cannot fall out of step with the program.

Counters are always on: ``count`` adds to a dict of integers, with no device read. ``counter``
reads one, ``counters`` copies them all and ``reset`` sets some (or all) back to 0.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

from torch.profiler import record_function

SPANS = (
    "serve.study",  # segment_cine, one call; request: its ordinal, the count of serve.studies
    "serve.preprocess",  # numpy min-max scaling and padding of every frame
    "serve.upload",  # the padded frames to the model's device
    "serve.forward",  # video_forward: the chunks through the model
    "serve.readback",  # the labels to the host
    "serve.crop",  # the labels cropped to the study's shape, time last
    "step",  # one call of a train step; request: state.step
    "step.forward",  # the mask draw and the model's forward (MAE), or the loss function
    "step.backward",  # the gradients
    "step.update",  # the optimizer's step, through the restore of the model's buffers
)

PARENT = {
    "serve.study": None, "serve.preprocess": "serve.study", "serve.upload": "serve.study",
    "serve.forward": "serve.study", "serve.readback": "serve.study", "serve.crop": "serve.study",
    "step": None, "step.forward": "step", "step.backward": "step", "step.update": "step",
}

COUNTERS = (
    "serve.studies",  # calls of segment_cine
    "serve.frames",  # frames of the studies served
    "serve.frame_slots",  # frames the model ran: the ragged last chunk is filled with repeats
    "attention.packed.launches",  # forward launches of the packed attention kernel
    "attention.packed.bwd_launches",  # its backward launches
    "attention.packed.grad_copies",  # output gradients copied before its backward
    "attention.heads.launches",  # forward launches of the per-head attention kernel
    "attention.heads.bwd_launches",
    "attention.heads.grad_copies",
)

_DECLARED = frozenset(SPANS)
_on = False
_counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)


class _Off:
    """The span of tracing off: enters and leaves, and does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, request: Optional[int] = None):
    """A context manager over one phase ``name`` of ``SPANS``; ``request`` identifies a root's call."""
    if name not in _DECLARED:
        raise ValueError(f"{name!r} is not a declared span: trace.SPANS has {SPANS}.")
    if not _on:
        return _OFF
    return record_function(name, None if request is None else str(request))


def enable(on: bool) -> bool:
    """Switch tracing on or off; returns whether it was on."""
    global _on
    was, _on = _on, bool(on)
    return was


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Tracing on inside the block, and as it was after it."""
    was = enable(True)
    try:
        yield
    finally:
        enable(was)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of ``COUNTERS`` (KeyError for an undeclared name)."""
    _counts[name] += n


def counter(name: str) -> int:
    return _counts[name]


def counters() -> Dict[str, int]:
    return dict(_counts)


def reset(*names: str) -> None:
    """Set the counters ``names`` (all, without a name) back to 0."""
    for name in names or COUNTERS:
        if name not in _counts:
            raise KeyError(f"{name!r} is not a declared counter: trace.COUNTERS has {COUNTERS}.")
        _counts[name] = 0
