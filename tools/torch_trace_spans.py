"""The program's spans on the card: what a gap pass with tracing on reads, and what tracing costs it.

    python3 tools/torch_trace_spans.py [--cells CELL ...] [--seeds N ...] [--pairs 2] [--out PATH]

For each benchmark cell (``perfbench/workloads/<cell>.json``) and seed, the cell's program is built as
its driver builds it (weights and inputs from the seed; ConvUNetR-base in bf16 and the mix's studies,
or ``perfbench.drivers.train_pool.build_program`` and the pool on the card) and warmed up. Then come
gap passes, each as the benchmark's (``perfbench.harness.trace.profile_span`` with host operations:
the mix's longest study, or one micro-batch), with program tracing off and on in turns (off, on, on,
off for each of ``--pairs``). Every pass prints one JSON line: its wall per unit (8-frame chunk or
micro-batch), the device's busy time and the idle gaps, each named by the innermost host operation or
program span running at its midpoint. The program spans' copies on the device's timeline are kept
out of the busy time. A pass with tracing on adds:

- ``program_spans``: each span's name, host start and end (microseconds on the profiler's clock) and
  enclosing span;
- ``prep_ms``: the summed durations of ``serve.preprocess`` and ``serve.upload`` per chunk;
- ``optimizer_ms``: per micro-batch, the union of the device operations inside the device-timeline
  copy of ``step.update``; ``optimizer_ms_by_launch`` is the union of those launched, by the
  profiler's correlation ids, from a host operation inside ``step.update``;
- ``gaps_by_span``: the idle gaps summed by the innermost program span running at each midpoint, over
  all of the pass's spans (the benchmark's rule looks back over the last 4000 host operations only).

A last line, ``span_cost``, gives the microseconds of one span's enter and exit: tracing off, tracing
on without a profiler and tracing on under the gap pass's profiler.

Needs a CUDA device. Writes every line to ``--out`` too.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cinema_tpu_torch import trace  # noqa: E402
from perfbench.harness import registry, weights  # noqa: E402
from perfbench.harness import traffic as traffic_gen  # noqa: E402
from perfbench.harness.trace import SPAN, Span, merged, union_us  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA


def gap_pass(fn) -> Tuple[Span, list, object]:
    """``profile_span(fn, host_ops=True)`` of the benchmark, with the program spans' device-timeline
    copies kept apart: (span, those copies, the profiler)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU]) as prof:
        with record_function(SPAN):
            t0 = time.perf_counter()
            units = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.events()
    device, notes, host = [], [], []
    for e in events:
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == CUDA:
            if e.name != SPAN:
                (notes if e.name in trace.SPANS else device).append(rng)
        else:
            host.append(rng)
    return Span(device=device, host=host, wall_s=wall, units=units), notes, prof


def enclosing_span(event):
    parent = event.cpu_parent
    while parent is not None and parent.name not in trace.SPANS:
        parent = parent.cpu_parent
    return None if parent is None else parent.name


def launched_inside(prof, name: str) -> List[Tuple[float, float]]:
    """(start, end) in microseconds of the device operations launched from a host operation that started
    inside the span ``name``: a device operation's linked correlation id is the id of the innermost
    host operation (no linked id of its own) that launched it."""
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() != CUDA]
    windows = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in host if e.name() == name]
    ids = {e.correlation_id() for e in host
           if e.linked_correlation_id() == 0 and any(a <= e.start_ns() <= b for a, b in windows)}
    return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3) for e in events
            if e.device_type() == CUDA and e.name() != SPAN and e.name() not in trace.SPANS
            and e.linked_correlation_id() in ids]


def gaps_by_span(span: Span, spans: list) -> Dict[str, float]:
    """Seconds of the idle gaps between the pass's device operations, by the innermost (latest-started)
    program span running at each gap's midpoint."""
    bounds = next((a, b) for n, a, b in span.host if n == SPAN)
    busy = [(bounds[0], bounds[0])] + merged((a, b) for _, a, b in span.device) + [(bounds[1], bounds[1])]
    out: Dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        running = [(a, n) for n, a, b, _ in spans if a <= mid <= b]
        name = max(running)[1] if running else "outside every program span"
        out[name] = out.get(name, 0.0) + (start - end) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def readings(span: Span, notes: list, prof, kind: str) -> Dict:
    spans = [(e.name, float(e.time_range.start), float(e.time_range.end), enclosing_span(e))
             for e in prof.events() if e.device_type != CUDA and e.name in trace.SPANS]
    out = {"program_spans": spans, "device_copies": sorted({n for n, _, _ in notes}),
           "gaps_by_span": gaps_by_span(span, spans)}
    if kind == "serve_cine":
        prep = sum(b - a for n, a, b, _ in spans if n in ("serve.preprocess", "serve.upload"))
        out["prep_ms"] = prep / 1e3 / span.units
        out["by_span_ms"] = {n: sum(b - a for m, a, b, _ in spans if m == n) / 1e3 / span.units
                             for n in trace.SPANS if n.startswith("serve.")}
    else:
        windows = [(a, b) for n, a, b in notes if n == "step.update"]
        inside = [(max(a, lo), min(b, hi)) for _, a, b in span.device for lo, hi in windows if a < hi and b > lo]
        out["optimizer_ms"] = union_us(inside) / 1e3 / span.units if windows else None
        try:
            out["optimizer_ms_by_launch"] = union_us(launched_inside(prof, "step.update")) / 1e3 / span.units
        except AttributeError as e:  # a torch whose profiler events keep no correlation ids
            out["optimizer_ms_by_launch"] = f"not read: {e}"
        out["by_span_ms"] = {n: sum(b - a for m, a, b, _ in spans if m == n) / 1e3 / span.units
                             for n in trace.SPANS if n.startswith("step")}
    return out


def serve_program(cfg: dict, traffic: dict, seed: int, device: torch.device):
    from cinema_tpu_torch.config import from_dict
    from cinema_tpu_torch.factory import get_convunetr_model
    from cinema_tpu_torch.serve import CHUNK, segment_cine

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = get_convunetr_model(from_dict(cfg), dtype=dtype, device=device)
    model.load_state_dict(weights.make_weights(weights.on_meta("segmentation", cfg), seed, device), strict=True)
    model.eval()
    studies = traffic_gen.cine_studies(traffic, seed)
    segment_cine(model, studies[0])
    longest = studies[max(range(len(studies)), key=lambda i: studies[i].shape[-1])]

    def one() -> int:
        segment_cine(model, longest)
        return math.ceil(longest.shape[-1] / CHUNK)

    return one


def train_program(w: dict, cfg: dict, seed: int, device: torch.device):
    from perfbench.drivers.train_pool import build_program
    from perfbench.reference import train as ref_train

    pool = traffic_gen.image_pool(w["traffic"], cfg, seed, device)
    settings = ref_train.optimizer_settings(cfg, w["step"], len(pool), int(w["traffic"]["batch"]))
    _, step_fn, state = build_program(w["step"], cfg, settings, seed, device)
    calls = 0

    def one() -> int:
        nonlocal state, calls
        state, _ = step_fn(state, pool[calls % len(pool)])
        calls += 1
        return 1

    for _ in range(int(settings["accum"]) + 1):  # every kernel built, one update applied
        one()
    return one


def span_cost(n: int = 20000) -> Dict[str, float]:
    """Microseconds per enter and exit of one span, each way of running it."""
    from torch.profiler import ProfilerActivity, profile

    def per_span() -> float:
        t0 = time.perf_counter()
        for i in range(n):
            with trace.span("step", request=i):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    out = {"off_us": per_span()}
    with trace.recording():
        out["on_us"] = per_span()
        with profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU]):
            out["on_profiled_us"] = per_span()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", nargs="+", default=["seg-serve-cine", "mae-pretrain-b16", "seg-finetune-b4"])
    parser.add_argument("--seeds", nargs="+", type=int, default=[2147483711, 3000000019, 4100000023])
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--out", type=Path, default=Path("build/trace_spans.jsonl"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trace_spans needs a CUDA device.", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a", encoding="utf-8") as out:
        for cell in args.cells:
            w = registry.workload(cell)
            cfg = registry.config(w["config"])
            for seed in args.seeds:
                if w["kind"] == "serve_cine":
                    one = serve_program(cfg, w["traffic"], seed, device)
                else:
                    one = train_program(w, cfg, seed, device)
                for i, on in enumerate([False, True, True, False] * args.pairs):
                    with trace.recording() if on else contextlib.nullcontext():
                        span, notes, prof = gap_pass(one)
                    line = {"cell": cell, "seed": seed, "pass": i, "tracing": on, "units": span.units,
                            "wall_ms_per_unit": span.wall_s * 1e3 / span.units,
                            "busy_ms_per_unit": span.busy_s() * 1e3 / span.units,
                            "idle_gaps": span.idle_gaps(), "device": torch.cuda.get_device_name(device)}
                    if on:
                        line.update(readings(span, notes, prof, w["kind"]))
                    elif any(e.name in trace.SPANS for e in prof.events()):
                        raise RuntimeError("A pass with tracing off recorded a program span.")
                    print(json.dumps(line), flush=True)
                    out.write(json.dumps(line) + "\n")
                del one
                gc.collect()
                torch.cuda.empty_cache()
        line = {"span_cost": span_cost(), "device": torch.cuda.get_device_name(device)}
        print(json.dumps(line), flush=True)
        out.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
