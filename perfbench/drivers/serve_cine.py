"""Traffic kind ``serve_cine``: one client segments cines with the program's ``serve.segment_cine``,
one study after another (closed loop).

Set-up builds the model as ``serve.main`` does on the card (ConvUNetR in bfloat16, eval mode) with
the benchmark's weights, makes the mix's studies in host memory and serves one study to warm the
one input shape (chunks of 8 frames at the padded size). The window then serves the studies in the
seed's order, cycling, until ``--seconds`` have passed and the study in flight is done; the frames
of all studies served, each at its own ``t``, over the window's seconds make the rate. After the
window the program is freed and the plain reference computes, in float32, the logits of a sample of
the frames served: the first long study served and others drawn from the seed. Under the control
(``faults.CONTROL``) the labels judged at those frames are the argmax of the reference with fp8
products instead of the served ones.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from perfbench.harness import checks, faults, trace, weights, yardstick
from perfbench.harness import traffic as traffic_gen
from perfbench.reference import models as ref
from perfbench.reference.lowp import FP8, Exact
from perfbench.reference.serve import frame_logits


def reference_model(cfg: dict, seed: int, device: torch.device, lowp) -> ref.ConvUNetR:
    with torch.device(device):
        model = ref.ConvUNetR(cfg)
    model = model.to(device)
    model.load_state_dict(weights.make_weights(weights.on_meta("segmentation", cfg), seed, device), strict=True)
    ref.set_lowp(model, lowp)
    return model.eval()


def run(cell) -> dict:
    from cinema_tpu_torch.config import from_dict
    from cinema_tpu_torch.factory import get_convunetr_model
    from cinema_tpu_torch.serve import CHUNK, segment_cine

    w, cfg, device, seed = cell.workload, cell.config, cell.device, cell.seed
    traffic, correct = w["traffic"], w["correct"]
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = get_convunetr_model(from_dict(cfg), dtype=dtype, device=device)
    model.load_state_dict(weights.make_weights(weights.on_meta("segmentation", cfg), seed, device), strict=True)
    model.eval()
    serve = segment_cine
    n_classes = cfg["model"]["out_chans"]
    if cell.fault in faults.SERVE:
        serve = faults.wrap_serve(cell.fault, segment_cine, n_classes)
    studies = traffic_gen.cine_studies(traffic, seed)
    serve(model, studies[0])

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    cell.mark_setup_done()
    served = {}
    frames = n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        k = n % len(studies)
        labels = serve(model, studies[k])
        served.setdefault(k, labels)
        frames += studies[k].shape[-1]
        n += 1
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    span = gaps = None
    if cell.trace:
        longest = max(range(len(studies)), key=lambda i: studies[i].shape[-1])

        def traced() -> int:
            serve(model, studies[longest])
            return math.ceil(studies[longest].shape[-1] / CHUNK)

        span = trace.profile_span(traced)
        gaps = trace.profile_span(traced, host_ops=True)

    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    size = tuple(cfg["data"]["sax"]["patch_size"])
    flop_per_frame = yardstick.model_flop(cfg, "segmentation", 1, train=False)
    calls = yardstick.attention_calls(cfg, "segmentation", CHUNK, train=False)
    rng = np.random.default_rng([int(seed) % (2**63), 3])
    done = sorted(served)
    long_t = max(studies[k].shape[-1] for k in done)
    first_long = next(k for k in done if studies[k].shape[-1] == long_t)
    others = [k for k in done if k != first_long]
    sample = [first_long] + list(rng.choice(others, size=min(len(others), int(correct["n_studies"]) - 1),
                                            replace=False))
    reference = reference_model(cfg, seed, device, Exact())
    control = reference_model(cfg, seed, device, FP8()) if cell.fault == faults.CONTROL else None
    block = int(correct["ref_block"])
    label_gaps = []
    for k in sample:
        video, t = studies[k], studies[k].shape[-1]
        picked = rng.choice(t - 1, size=min(t - 1, int(correct["n_frames"]) - 1), replace=False)
        frames_checked = sorted({0, t - 1, *picked.tolist()})
        logits = frame_logits(reference, video, frames_checked, size, device, block)
        if control is None:
            labels = torch.from_numpy(np.ascontiguousarray(np.moveaxis(served[k][..., frames_checked], -1, 0)))
        else:
            labels = frame_logits(control, video, frames_checked, size, device, block).argmax(-1)
        label_gaps.append(checks.label_gap(logits, labels.to(device)))
    return {
        "units": frames, "window_s": window_s, "attempted": n, "failed": 0,
        "memory_peak_bytes": peak, "flop_per_unit": flop_per_frame, "span": span, "gaps": gaps, "span_attention_calls": calls,
        "numbers": {"label_gap": max(label_gaps)},
    }
