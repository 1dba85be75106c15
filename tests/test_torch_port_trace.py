"""cinema_tpu_torch.trace: the spans of a served study and of the two train steps under a CPU
``torch.profiler``, the counters of served frames and model slots, and the outputs, which tracing
must leave bit for bit as they are. Tiny models from the example checkpoints' configurations."""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cinema_tpu_torch import serve, trace
from cinema_tpu_torch.config import load_config
from cinema_tpu_torch.factory import get_convunetr_model, get_mae_model, init_weights
from cinema_tpu_torch.tasks.segmentation import segmentation_loss_fn
from cinema_tpu_torch.train.optim import build_optimizer
from cinema_tpu_torch.train.state import TrainState, make_mae_train_step, make_supervised_train_step

CKPTS = Path(__file__).parent / "fixtures" / "example_ckpts"
MAE_CONFIG = next(CKPTS.glob("mae-*")) / "mae.yaml"
SEG_CONFIG = next(CKPTS.glob("seg_sax-*")) / "seg_sax.yaml"
PATHS = ("serve", "mae", "supervised")
ROOTS = {"serve": "serve.study", "mae": "step", "supervised": "step"}


def _seg_model() -> torch.nn.Module:
    config = load_config(SEG_CONFIG)
    config.data.sax.patch_size = [32, 32, 4]
    return init_weights(get_convunetr_model(config, device="cpu"), seed=3)


def _study(t: int = 10) -> np.ndarray:
    return np.random.default_rng(t).random((28, 30, 3, t)).astype(np.float32) * 200


def _step(path: str):
    """(model, state, step_fn, batch) of a fresh train step, the same on every call."""
    rng = np.random.default_rng(5)
    if path == "mae":
        model = init_weights(get_mae_model(load_config(MAE_CONFIG), device="cpu"), seed=3)
        batch = {"sax": rng.random((2, 16, 16, 4, 1)), "lax_2c": rng.random((2, 32, 32, 1))}
        make = lambda tx: make_mae_train_step(model, tx, 0.75, seed=4)  # noqa: E731
    else:
        model = _seg_model()
        batch = {"sax_image": rng.random((2, 32, 32, 4, 1)), "sax_label": rng.integers(0, 4, (2, 32, 32, 4))}
        make = lambda tx: make_supervised_train_step(model, tx, segmentation_loss_fn, seed=4)  # noqa: E731
    batch = {k: torch.from_numpy(v.astype(np.float32 if v.dtype == np.float64 else np.int64)) for k, v in batch.items()}
    tx = build_optimizer(dict(model.named_parameters()), lr=1e-3, warmup_steps=0, max_n_steps=10)
    return model, TrainState.create(model, tx), make(tx), batch


def _run(path: str, calls: int = 1):
    """The path's outputs: labels of a study, or (losses, gradient norms, parameters) after ``calls``."""
    if path == "serve":
        return [serve.segment_cine(_serving_model(), _study()) for _ in range(calls)]
    model, state, step_fn, batch = _step(path)
    losses = []
    for _ in range(calls):
        state, metrics = step_fn(state, batch)
        losses.append((metrics["loss"], metrics["grad_norm"]))
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


@functools.cache
def _serving_model() -> torch.nn.Module:
    return _seg_model().eval()


def _profiled(path: str, calls: int = 1):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(path, calls)
    return prof.events()


def _enclosing_span(event):
    parent = event.cpu_parent
    while parent is not None and parent.name not in trace.SPANS:
        parent = parent.cpu_parent
    return None if parent is None else parent.name


@pytest.mark.parametrize("path", PATHS)
def test_tracing_off_records_no_program_span(path):
    assert not trace.enable(False)
    assert not {e.name for e in _profiled(path)} & set(trace.SPANS)


@pytest.mark.parametrize("path", PATHS)
def test_tracing_on_records_every_span_with_its_parent_and_the_root_its_request(path, monkeypatch):
    entered = []

    def recorded(name, args=None):
        entered.append((name, args))
        return torch.profiler.record_function(name, args)

    monkeypatch.setattr(trace, "record_function", recorded)
    studies = trace.counter("serve.studies")
    with trace.recording():
        events = [e for e in _profiled(path, calls=2) if e.name in trace.SPANS]
    assert not trace.enable(False)
    want = {name for name in trace.SPANS if name.startswith(ROOTS[path])
            or trace.PARENT[name] == ROOTS[path]}
    assert {e.name for e in events} == want
    assert sorted(e.name for e in events) == sorted(name for name, _ in entered)
    for e in events:
        assert _enclosing_span(e) == trace.PARENT[e.name], e.name
    roots = [args for name, args in entered if name == ROOTS[path]]
    assert roots == ([str(studies + 1), str(studies + 2)] if path == "serve" else ["0", "1"])
    assert all(args is None for name, args in entered if name != ROOTS[path])


def test_undeclared_names_raise_and_tracing_off_hands_out_one_shared_object():
    with pytest.raises(ValueError):
        trace.span("serve.postprocess")
    with trace.recording(), pytest.raises(ValueError):
        trace.span("step.optimizer")
    with pytest.raises(KeyError):
        trace.count("serve.chunks")
    with pytest.raises(KeyError):
        trace.reset("serve.chunks")
    assert trace.span("step") is trace.span("serve.study", request=3)
    with trace.span("step.update") as inner:
        assert inner is trace.span("step")


@pytest.mark.parametrize("t,slots", [(50, 56), (5, 8), (16, 16)])
def test_a_study_counts_its_frames_and_the_model_s_slots(t, slots):
    before = trace.counters()
    labels = serve.segment_cine(_serving_model(), _study(t))
    after = trace.counters()
    assert labels.shape == (28, 30, 3, t)
    assert (after["serve.studies"] - before["serve.studies"], after["serve.frames"] - before["serve.frames"],
            after["serve.frame_slots"] - before["serve.frame_slots"]) == (1, t, slots)


@pytest.mark.parametrize("path", PATHS)
def test_outputs_are_bitwise_equal_with_tracing_on_and_off(path):
    off = _run(path, calls=2)
    with trace.recording():
        on = _run(path, calls=2)
    if path == "serve":
        assert all(np.array_equal(a, b) for a, b in zip(off, on))
        return
    (off_losses, off_params), (on_losses, on_params) = off, on
    assert all(torch.equal(a, b) for pair_off, pair_on in zip(off_losses, on_losses) for a, b in zip(pair_off, pair_on))
    assert off_params.keys() == on_params.keys()
    assert all(torch.equal(off_params[k], on_params[k]) for k in off_params)


@pytest.mark.parametrize("path", PATHS)
def test_a_recorded_span_encloses_on_the_profiler_s_clock_the_ops_it_ran(path):
    with trace.recording():
        events = _profiled(path)
    spans = {e.name: e for e in events if e.name in trace.SPANS}
    inside = {name: 0 for name in spans}
    for e in events:
        if e.name in trace.SPANS:
            continue
        owner = _enclosing_span(e)
        if owner is not None:
            s = spans[owner]
            assert s.time_range.start <= e.time_range.start <= e.time_range.end <= s.time_range.end, (owner, e.name)
            inside[owner] += 1
    work = ("serve.upload", "serve.forward") if path == "serve" else ("step.forward", "step.backward", "step.update")
    assert all(inside[name] > 0 for name in work), inside


def test_the_counters_read_copy_and_reset():
    trace.count("attention.heads.grad_copies", 3)
    copied = trace.counters()
    assert copied["attention.heads.grad_copies"] == trace.counter("attention.heads.grad_copies") >= 3
    copied["attention.heads.grad_copies"] = -1
    trace.reset("attention.heads.grad_copies")
    assert trace.counter("attention.heads.grad_copies") == 0
    assert set(trace.counters()) == set(trace.COUNTERS) and set(trace.PARENT) == set(trace.SPANS)
