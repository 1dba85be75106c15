"""Traffic kind ``train_pool``: a train step of the program over a pool of batches resident on the card.

Set-up builds the step as the program's entry point builds it (``make_mae_train_step`` as
``tasks.pretrain.run`` does, or ``make_supervised_train_step`` with the segmentation loss as
``train.loop.run_train`` does; ``build_optimizer`` with accumulation to the configured batch, the
schedule of a run whose epoch is the pool), loads the benchmark's weights, and drives the step
through its first calls (``follow`` of the workload's ``correct`` section) on distinct batches of
the pool; those calls warm every shape up. The window then cycles the pool through the same step
object, closed loop, for ``--seconds``; all the micro-batches it issued and all its time, to the
synchronise after the last, make the rate. After the window the program is freed and the plain
reference follows the same first calls from the same weights, batches and seeds. Under the control
(``faults.CONTROL``) the reference with fp8 products follows them too and is judged in the
program's place.
"""

from __future__ import annotations

import gc
import time
import torch

from perfbench.harness import checks, faults, trace, weights, yardstick
from perfbench.harness import traffic as traffic_gen
from perfbench.reference import train as ref_train
from perfbench.reference.lowp import FP8, Exact

# micro-batches in the profiled span of a ``--trace 1`` run
SPAN_CALLS = 3


def build_program(step: str, cfg: dict, settings: dict, seed: int, device: torch.device):
    """(model, step_fn, state) of the program, with the benchmark's weights."""
    from cinema_tpu_torch.config import from_dict
    from cinema_tpu_torch.factory import get_convunetr_model, get_mae_model
    from cinema_tpu_torch.train.optim import build_optimizer, get_n_accum_steps
    from cinema_tpu_torch.train.state import TrainState, make_mae_train_step, make_supervised_train_step

    config = from_dict(cfg)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if step == "mae":
        model = get_mae_model(config, dtype=dtype, device=device)
    else:
        model = get_convunetr_model(config, dtype=dtype, device=device)
    model.load_state_dict(weights.make_weights(weights.on_meta(step, cfg), seed, device), strict=True)
    t = config.train
    k = get_n_accum_steps(t.batch_size, t.batch_size_per_device, 1)
    if k != settings["accum"]:
        raise ValueError(f"The program accumulates {k} micro-batches, the reference {settings['accum']}.")
    tx = build_optimizer(
        dict(model.named_parameters()), lr=t.lr, min_lr=t.min_lr, warmup_steps=settings["warmup"],
        max_n_steps=settings["max_steps"], betas=tuple(t.betas), weight_decay=t.weight_decay,
        clip_grad=t.clip_grad, layer_decay=settings["layer_decay"], n_blocks=settings["n_blocks"], accum_steps=k,
    )
    state = TrainState.create(model, tx)
    if step == "mae":
        step_fn = make_mae_train_step(model, tx, t.enc_mask_ratio, seed=seed)
    else:
        from cinema_tpu_torch.tasks.segmentation import segmentation_loss_fn

        step_fn = make_supervised_train_step(model, tx, segmentation_loss_fn, seed=seed)
    return model, step_fn, state


def run(cell) -> dict:
    w, cfg, device, seed = cell.workload, cell.config, cell.device, cell.seed
    step, traffic, correct = w["step"], w["traffic"], w["correct"]
    n_follow = int(correct["follow"])
    pool = traffic_gen.image_pool(traffic, cfg, seed, device)
    if n_follow > len(pool):
        raise ValueError("The calls the reference follows need distinct batches of the pool.")
    batch = int(traffic["batch"])
    settings = ref_train.optimizer_settings(cfg, step, len(pool), batch)
    model, step_fn, state = build_program(step, cfg, settings, seed, device)
    if cell.fault in faults.TRAIN:
        step_fn = faults.wrap_step(cell.fault, step_fn, model)
    names = [n for n, _ in model.named_parameters()]

    # the first calls, which the reference follows; they build and warm every kernel of the step
    prog = {"loss": []}
    for i in range(n_follow):
        state, metrics = step_fn(state, pool[i])
        prog["loss"].append(metrics["loss"])
        if i == 0:
            prog["grad"] = {n: float(a.norm()) * settings["accum"] for n, a in zip(names, state.opt_state.acc)}
    prog["loss"] = [float(x) for x in prog["loss"]]
    start = weights.make_weights(weights.on_meta(step, cfg), seed, device)
    # kept in host memory through the window, so that they add nothing to its peak
    with torch.no_grad():
        prog["change_t"] = {n: (p.detach() - start[n]).cpu() for n, p in model.named_parameters()}
        prog["acc_t"] = {n: (a * settings["accum"]).cpu() for n, a in zip(names, state.opt_state.acc)}
    del start

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    cell.mark_setup_done()
    skipped = []
    i = n_follow
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        state, metrics = step_fn(state, pool[i % len(pool)])
        skipped.append(metrics.get("skipped_nan", torch.zeros((), device=device)))
        i += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    n_calls = i - n_follow
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    n_failed = int(torch.stack(skipped).sum()) if skipped else 0

    span = gaps = None
    if cell.trace:
        def steps(n: int) -> int:
            nonlocal state, i
            for _ in range(n):
                state, _ = step_fn(state, pool[i % len(pool)])
                i += 1
            return n

        span = trace.profile_span(lambda: steps(SPAN_CALLS))
        gaps = trace.profile_span(lambda: steps(1), host_ops=True)

    del model, step_fn, state, metrics, skipped
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    flop = yardstick.model_flop(cfg, step, batch, train=True)
    calls = yardstick.attention_calls(cfg, step, batch, train=True)
    start = weights.make_weights(weights.on_meta(step, cfg), seed, device)
    block = int(correct["ref_block"])
    reference = ref_train.follow(step, cfg, start, pool[:n_follow], seed, settings, Exact(), block)
    if cell.fault == faults.CONTROL:
        prog = ref_train.follow(step, cfg, start, pool[:n_follow], seed, settings, FP8(), block)
    for key in ("change_t", "acc_t"):
        prog[key] = {n: t.to(device) for n, t in prog[key].items()}
    return {
        "units": n_calls * batch, "window_s": window_s, "attempted": n_calls,
        "failed": n_failed, "memory_peak_bytes": peak, "flop_per_unit": flop / batch, "span": span, "gaps": gaps,
        "span_attention_calls": calls, "numbers": checks.training_numbers(prog, reference),
        "worst": checks.worst_leaves(prog, reference),
    }
