"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Drives the port's two paths (``cinema_tpu_torch``), serving and MAE
pretraining, at full width and holds every hand-written kernel of those
paths against its plain PyTorch version on the card:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles every kernel under ``cinema_tpu_torch/csrc`` with nvcc
   (one process per source, all at once);
3. kernels: the attention forward and backward kernels against their plain
   versions at the serving and training shapes and at ragged and
   cross-attention shapes, with each one's time, the plain version's, one
   PyTorch library call's (a yardstick only) and the card's lower bound;
4. serving: ConvUNetR-base from the packaged ACDC config with seeded random
   weights serves a 50-frame 192x192x16 SAX cine in chunks of 8 and one
   192x192x24 study by sliding window, in bf16; the launch counts of the
   serving run are checked, and one chunk's f32 logits through the kernel
   are held against the plain attention path;
5. training: CineMA-base from the packaged MAE config with seeded random
   weights, bf16, four views, batch 16, on seeded synthetic studies:
   ``tasks.pretrain.run`` takes one epoch and writes its checkpoint and
   ``cinema.safetensors``, which are reloaded; then one warm-up and six
   timed steps of ``make_mae_train_step`` with the launch counts, losses and
   counters checked, a NaN batch that must leave the state bit-identical,
   and one f32 step at batch 2 whose loss and gradients through the kernels
   are held against the plain attention path.

Any failed check exits non-zero. The last two lines of stdout are the
kernels JSON line and ``{"ok": true, "device": {...}}``.

Usage:
    python3 chip_smoke.py [--out report.json] [--profile]

``--profile`` adds a torch.profiler pass over one serving chunk and one
training step and prints the device time by kernel.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# kernel vs plain version, largest abs error on the output:
# - f32: both sum in f32, in another order; exp2 against exp (a few ulp)
# - bf16: both round the output to bf16 once, and the kernel also rounds the
#   probabilities to bf16 before P.V. One bf16 ulp of x is at most x * 2^-7,
#   so the bound is two ulps of the largest output, 2^-6 * max|plain|. With
#   randn inputs at T=2305 the scores are ~N(0, 1) and each output averages
#   ~850 keys (|out| ~ 0.03, max < 0.5), so the bound is a few 1e-3 there.
ATOL_F32 = 1e-4
BF16_REL = 2.0**-6
# q is also scaled by this at the serving shape: scores ~N(0, 16) put most of
# a row's weight on a few keys, so outputs are O(1) and a skipped key tile or
# a softmax scale a few percent off moves them by far more than the bound
SHARP_Q = 4.0
# the row log-sum-exp (log2 domain, |values| up to a few tens with sharp
# scores) against torch.logsumexp: f32 on both sides, bf16 inputs are exact
# in f32, so only the summation order and exp2/log2 against exp/log differ
LSE_ATOL = 1e-3
# f32 ConvUNetR-base logits, kernel attention against the plain attention:
# per-call differences of ~1e-6 carried through 12 blocks and the decoder
LOGITS_ATOL = 1e-3
# one f32 CineMA-base step at batch 2, kernels against the plain attention
# (torch autograd through it): the loss is a mean of O(1) squares, compared
# relatively; each parameter's gradient is compared to the largest gradient
# entry of that parameter, the per-call differences of ~1e-6 being carried
# through 20 blocks forward and back
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(batch: int, n_q: int, n_k: int, embed: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time on an H100 for packed attention: 4*B*Tq*Tk*E flop (q.k^T and
    P.v) against q, k, v read once and the output written once."""
    flop_s = 4 * batch * n_q * n_k * embed / PEAK_FLOPS[dtype]
    byte_s = (2 * batch * n_q * embed + 2 * batch * n_k * embed) * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s >= byte_s else "bytes")


def _attention_inputs(batch, n_q, n_k, embed, dtype, gen, q_scale):
    q = (torch.randn(batch, n_q, embed, device="cuda", generator=gen) * q_scale).to(dtype)
    kv = torch.randn(batch, n_k, 2 * embed, device="cuda", generator=gen).to(dtype)
    # k, v: column slices of the fused kv projection, as the model passes them
    return q, kv[..., :embed], kv[..., embed:]


def check_attention(batch, n_q, n_k, embed, n_heads, dtype, gen, timed, q_scale=1.0):
    """Forward kernel against its plain version: the output and the saved row log-sum-exp."""
    from cinema_tpu_torch.ops import flash_attention as fa

    q, k, v = _attention_inputs(batch, n_q, n_k, embed, dtype, gen, q_scale)
    out = fa.flash_attention_packed(q, k, v, n_heads)
    out_lse, lse = fa.flash_attention_packed_forward(q, k, v, n_heads, save_lse=True)
    torch.cuda.synchronize()
    want = fa.flash_attention_packed_plain(q, k, v, n_heads)
    check(out.dtype == dtype and out.shape == q.shape, f"kernel output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "kernel output is not finite")
    check(torch.equal(out, out_lse), "the forward output changes when the log-sum-exp is saved")
    err = (out.float() - want.float()).abs().max().item()
    want_max = want.float().abs().max().item()
    tol = ATOL_F32 if dtype == torch.float32 else BF16_REL * want_max
    lse_err = (lse - fa.flash_attention_packed_lse_plain(q, k, n_heads)).abs().max().item()
    row = {"shape": [batch, n_q, n_k, embed, n_heads], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale,
           "max_abs_err": err, "tol": tol, "max_abs_plain": want_max, "lse_err": lse_err, "lse_tol": LSE_ATOL}
    if timed:
        d = embed // n_heads
        qh, kh, vh = (x.unflatten(-1, (n_heads, d)).transpose(1, 2) for x in (q, k, v))
        row["ms"] = median_ms(lambda: fa.flash_attention_packed(q, k, v, n_heads))
        row["plain_ms"] = median_ms(lambda: fa.flash_attention_packed_plain(q, k, v, n_heads), reps=5)
        row["library_ms"] = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
        row["bound_ms"], row["bound_by"] = attention_bound_ms(batch, n_q, n_k, embed, dtype)
    print("attention", json.dumps(row), flush=True)
    check(err <= tol, f"kernel disagrees with the plain version at {row}")
    check(lse_err <= LSE_ATOL, f"saved log-sum-exp disagrees with the plain one at {row}")
    return row


def attention_bwd_bound_ms(batch: int, n_q: int, n_k: int, embed: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time on an H100 for the packed attention backward: five products,
    10*B*Tq*Tk*E flop, against q, k, v, o, g read once and dq, dk, dv written once."""
    flop_s = 10 * batch * n_q * n_k * embed / PEAK_FLOPS[dtype]
    byte_s = (4 * batch * n_q * embed + 4 * batch * n_k * embed) * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s >= byte_s else "bytes")


def check_attention_bwd(batch, n_q, n_k, embed, n_heads, dtype, gen, timed, q_scale=1.0):
    """Backward kernel against flash_attention_packed_bwd_plain on the same q, k, v, out, g."""
    from cinema_tpu_torch.ops import flash_attention as fa

    q, k, v = _attention_inputs(batch, n_q, n_k, embed, dtype, gen, q_scale)
    g = torch.randn(batch, n_q, embed, device="cuda", generator=gen).to(dtype)
    out, lse = fa.flash_attention_packed_forward(q, k, v, n_heads, save_lse=True)
    got = fa.flash_attention_packed_backward(q, k, v, out, lse, g, n_heads)
    torch.cuda.synchronize()
    want = fa.flash_attention_packed_bwd_plain(q, k, v, out, g, n_heads)
    row = {"shape": [batch, n_q, n_k, embed, n_heads], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale}
    worst = 0.0
    for name, x, w, ref in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        check(x.dtype == dtype and x.shape == ref.shape, f"{name} is {x.dtype} {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name} is not finite at {row}")
        w_max = w.float().abs().max().item()
        err = (x.float() - w.float()).abs().max().item()
        # f32: relative to the largest gradient once that exceeds 1. bf16: as the forward, with the f32
        # tolerance as a floor: with one key P = 1 and dS = P * (dP - delta) = 0 exactly, so dq and dk
        # are zero and what both sides hold is the f32 rounding of dP - delta (~1e-6)
        tol = ATOL_F32 * max(1.0, w_max) if dtype == torch.float32 else max(BF16_REL * w_max, ATOL_F32)
        row[name] = {"max_abs_err": err, "tol": tol, "max_abs_plain": w_max}
        worst = max(worst, err)
    row["max_abs_err"] = worst
    again = fa.flash_attention_packed_backward(q, k, v, out, lse, g, n_heads)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"the backward changes from run to run at {row}")
    if timed:
        d = embed // n_heads
        row["ms"] = median_ms(lambda: fa.flash_attention_packed_backward(q, k, v, out, lse, g, n_heads))
        row["plain_ms"] = median_ms(lambda: fa.flash_attention_packed_bwd_plain(q, k, v, out, g, n_heads), reps=5)
        # the library's backward alone: autograd.grad on a saved graph of one SDPA call
        qh, kh, vh = (x.unflatten(-1, (n_heads, d)).transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        gh = g.unflatten(-1, (n_heads, d)).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        row["library_ms"] = median_ms(lambda: torch.autograd.grad(sdpa, (qh, kh, vh), gh, retain_graph=True))
        row["bound_ms"], row["bound_by"] = attention_bwd_bound_ms(batch, n_q, n_k, embed, dtype)
    print("attention_bwd", json.dumps(row), flush=True)
    for name in ("dq", "dk", "dv"):
        check(row[name]["max_abs_err"] <= row[name]["tol"], f"backward kernel's {name} disagrees with the plain "
                                                           f"version at {row}")
    return row


# (batch, n_q, n_k, embed, n_heads) of the two attention calls of a CineMA-base pretraining step
TRAIN_ENCODER = (16, 769, 769, 768, 12)
TRAIN_DECODER = (16, 2305, 768, 512, 16)
RAGGED = [(2, 1, 1, 768, 12), (2, 127, 127, 768, 12), (2, 129, 129, 768, 12), (2, 129, 200, 512, 16)]


def check_attention_shapes(gen, timed=True) -> list[dict]:
    """The forward kernel against its plain version at the paths' shapes and at
    ragged and cross-attention shapes, bf16 then f32; the first row is the serving shape."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_attention(8, 2305, 2305, 768, 12, dtype, gen, timed))  # serving chunk
        rows.append(check_attention(8, 2305, 2305, 768, 12, dtype, gen, False, q_scale=SHARP_Q))
        rows.append(check_attention(2, 2305, 2305, 768, 12, dtype, gen, timed))  # sliding window
        rows.append(check_attention(*TRAIN_ENCODER, dtype, gen, timed))
        rows.append(check_attention(*TRAIN_DECODER, dtype, gen, timed))
        for shape in RAGGED:
            rows.append(check_attention(*shape, dtype, gen, False))
    return rows


def check_attention_bwd_shapes(gen, timed=True) -> list[dict]:
    """The backward kernel against its plain version at the two train shapes
    (the first two rows), with sharp scores, and at ragged and cross shapes; bf16 then f32."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_attention_bwd(*TRAIN_ENCODER, dtype, gen, timed))
        rows.append(check_attention_bwd(*TRAIN_DECODER, dtype, gen, timed))
        rows.append(check_attention_bwd(*TRAIN_ENCODER, dtype, gen, False, q_scale=SHARP_Q))
        rows.append(check_attention_bwd(*TRAIN_DECODER, dtype, gen, False, q_scale=SHARP_Q))
        for shape in RAGGED:
            rows.append(check_attention_bwd(*shape, dtype, gen, False))
    return rows


def serve_phase(report: dict, smi: str, rng: torch.Generator, profile: bool) -> int:
    """ConvUNetR-base serving at full width; returns the forward launches of the serving run."""
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.factory import get_convunetr_model, init_weights
    from cinema_tpu_torch.inference import sliding_window_forward
    from cinema_tpu_torch.models import vit
    from cinema_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_kv,
        flash_attention_packed_kv_plain,
    )
    from cinema_tpu_torch.serve import segment_cine

    config = from_dict(PACKAGED["segmentation/acdc"])
    model = init_weights(get_convunetr_model(config, dtype=torch.bfloat16, device="cuda"), seed=0)
    x, y, z = model.image_size_dict["sax"]
    n_frames, chunk = 50, 8
    video = (torch.rand((x, y, z, n_frames), generator=rng) * 1000).numpy()
    segment_cine(model, video[..., :chunk], chunk)  # warm-up, one chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention_packed.launches = 0
    t0 = time.perf_counter()
    labels = segment_cine(model, video, chunk)
    serve_s = time.perf_counter() - t0
    serve_launches = flash_attention_packed.launches
    n_chunks = -(-n_frames // chunk)
    expected = len(model.encoder.blocks) * n_chunks
    print(f"serve: {n_frames} frames of {(x, y, z)}, {serve_launches} kernel launches "
          f"(expected {expected})", flush=True)
    check(serve_launches == expected, f"serving launched the kernel {serve_launches} times, expected {expected}")
    check(labels.shape == video.shape and labels.dtype.name == "uint8", f"labels {labels.shape} {labels.dtype}")
    check(int(labels.max()) < config.model.out_chans, "labels out of range")
    repeats = []
    for _ in range(2):
        t0 = time.perf_counter()
        segment_cine(model, video, chunk)
        repeats.append(time.perf_counter() - t0)
    study_s = statistics.median([serve_s, *repeats])
    report["serve"] = {
        "frames": n_frames, "chunk": chunk, "launches": serve_launches, "seconds": [serve_s, *repeats],
        "ms_per_study": study_s * 1e3, "frames_per_s": n_frames / study_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("serve", json.dumps(report["serve"]), f"on {smi}", flush=True)

    study = torch.rand((1, x, y, 24, 1), generator=rng).cuda()
    with torch.no_grad():
        sliding_window_forward(model, {"sax": study}, {"sax": (x, y, z)})  # warm-up
        torch.cuda.synchronize()
        flash_attention_packed.launches = 0
        t0 = time.perf_counter()
        logp = sliding_window_forward(model, {"sax": study}, {"sax": (x, y, z)})["sax"]
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    window_launches = flash_attention_packed.launches
    check(window_launches == len(model.encoder.blocks), f"sliding window launched {window_launches} times")
    check(logp.shape == (1, x, y, 24, config.model.out_chans) and bool(torch.isfinite(logp).all()),
          f"sliding window output {tuple(logp.shape)} not finite or mis-shaped")
    check(bool(torch.allclose(logp.exp().sum(-1), torch.ones(()), atol=1e-4)), "window probabilities do not sum to 1")
    report["window"] = {"image": [x, y, 24], "launches": window_launches, "ms": window_s * 1e3}
    print("window", json.dumps(report["window"]), f"on {smi}", flush=True)

    # one chunk in f32: kernel attention against the plain attention, same weights
    model32 = get_convunetr_model(config, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict())
    frames = torch.rand((chunk, x, y, z, 1), generator=rng).cuda()
    with torch.no_grad():
        got = model32({"sax": frames})["sax"]
        vit.flash_attention_packed_kv = flash_attention_packed_kv_plain
        try:
            want = model32({"sax": frames})["sax"]
        finally:
            vit.flash_attention_packed_kv = flash_attention_packed_kv
    logits_err = (got - want).abs().max().item()
    report["logits_f32"] = {"max_abs_err": logits_err, "atol": LOGITS_ATOL, "max_abs": want.abs().max().item()}
    print("logits_f32", json.dumps(report["logits_f32"]), flush=True)
    check(bool(torch.isfinite(got).all()), "f32 logits are not finite")
    check(logits_err <= LOGITS_ATOL, f"f32 logits through the kernel differ by {logits_err}")
    if profile:
        with torch.no_grad():
            report["profile"] = profile_call(
                "profile", lambda: model.predict_labels({"sax": frames.to(torch.bfloat16)}), smi
            )
    return serve_launches


def write_studies(data_dir: Path, n: int, sizes: dict, seed: int) -> None:
    """Seeded synthetic studies, one .npz each: two frames per view, smooth blobs on noise."""
    rng = torch.Generator().manual_seed(seed)
    for i in range(n):
        study = {}
        for view, size in sizes.items():
            frames = torch.rand((*size, 2), generator=rng)
            axes = torch.meshgrid(*(torch.linspace(-1, 1, s) for s in size), indexing="ij")
            centre = torch.rand(len(size), generator=rng) - 0.5
            blob = torch.exp(-4 * sum((a - c) ** 2 for a, c in zip(axes, centre)))
            study[view] = (500 * (frames * 0.2 + blob[..., None])).numpy()
        np.savez(data_dir / f"study_{i:04d}.npz", **study)


def train_phase(report: dict, smi: str, profile: bool) -> tuple[int, int]:
    """CineMA-base MAE pretraining at full width; returns (forward, backward) launches of the timed steps."""
    import copy

    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.convert import load_safetensors
    from cinema_tpu_torch.factory import get_mae_model, init_weights
    from cinema_tpu_torch.models import vit
    from cinema_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_kv,
        flash_attention_packed_kv_plain,
    )
    from cinema_tpu_torch.ops.masking import random_patch_mask
    from cinema_tpu_torch.tasks import pretrain
    from cinema_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from cinema_tpu_torch.train.optim import build_optimizer
    from cinema_tpu_torch.train.state import TrainState, make_mae_train_step

    batch_size, n_studies, n_timed = 16, 32, 6
    config = from_dict(PACKAGED["mae"])
    config.grad_ckpt = False  # remat off: one forward launch per attention call
    config.train.batch_size = batch_size  # no accumulation: every step is an update
    config.train.n_epochs = 1
    sizes = {v: tuple(config.data.sax.patch_size if v == "sax" else config.data.lax.patch_size)
             for v in config.model.views}
    n_blocks = 12 + 8  # ViT-base encoder and decoder depth: attention calls per step

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp) / "studies"
        data_dir.mkdir()
        write_studies(data_dir, n_studies, sizes, seed=2)
        config.data.dir = str(data_dir)
        config.logging.dir = str(Path(tmp) / "runs")

        # a. the entry point: one epoch of two steps, checkpoint and export
        flash_attention_packed.launches = flash_attention_packed.bwd_launches = 0
        t0 = time.perf_counter()
        out_dir = pretrain.run(config, device="cuda")
        run_s = time.perf_counter() - t0
        steps = n_studies // batch_size
        run_launches = (flash_attention_packed.launches, flash_attention_packed.bwd_launches)
        check(run_launches == (n_blocks * steps, n_blocks * steps),
              f"pretrain.run launched {run_launches}, expected {n_blocks * steps} each way")
        record = json.loads((out_dir / "metrics.jsonl").read_text().splitlines()[-1])
        check(record["n_samples"] == n_studies and record["skipped_nan"] == 0, f"epoch record {record}")
        check(record["loss"] == record["loss"] and abs(record["loss"]) < 1e4, f"epoch loss {record['loss']}")
        ckpt = latest_checkpoint(out_dir)
        check(ckpt is not None and (out_dir / "cinema.safetensors").exists(),
              "checkpoint or cinema.safetensors missing")

        model = init_weights(get_mae_model(config, dtype=torch.bfloat16, device="cuda"), seed=config.seed)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        tx = build_optimizer(dict(model.named_parameters()), lr=config.train.lr, min_lr=config.train.min_lr,
                             warmup_steps=4, max_n_steps=100, betas=tuple(config.train.betas),
                             weight_decay=config.train.weight_decay, clip_grad=config.train.clip_grad)
        state = load_checkpoint(ckpt, TrainState.create(model, tx))
        check(state.step == steps and state.n_samples == n_studies and int(state.opt_state.count) == steps,
              f"reloaded counters {state.step} {state.n_samples} {int(state.opt_state.count)}")
        exported = load_safetensors(out_dir / "cinema.safetensors")
        check(set(exported) == set(initial), "cinema.safetensors keys differ from the model's")
        check(all(torch.equal(torch.from_numpy(exported[k]).cuda(), v) for k, v in model.state_dict().items()),
              "cinema.safetensors differs from the checkpoint's parameters")
        moved = sum(not torch.equal(initial[k], v) for k, v in model.state_dict().items())
        check(moved == len(initial), f"only {moved} of {len(initial)} parameters moved in pretrain.run")
        report["pretrain_run"] = {"steps": steps, "seconds": run_s, "loss": record["loss"], "launches": run_launches,
                                  "ckpt_mib": ckpt.stat().st_size / 2**20}
        print("pretrain_run", json.dumps(report["pretrain_run"]), f"on {smi}", flush=True)

        # b. timed steps from the resumed state, through make_mae_train_step
        loader = pretrain.BatchLoader(
            pretrain.NpzCineDataset(data_dir, config.model.views, sizes, seed=config.seed), batch_size, seed=config.seed
        )
        batches = [{v: torch.from_numpy(x).cuda() for v, x in b.items()} for b in loader.epoch(1)]
    step_fn = make_mae_train_step(model, tx, config.train.enc_mask_ratio, seed=config.seed)
    state, _ = step_fn(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    flash_attention_packed.launches = flash_attention_packed.bwd_launches = 0
    losses, skipped, seconds = [], [], []
    for i in range(n_timed):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        skipped.append(float(metrics["skipped_nan"]))
    fwd, bwd = flash_attention_packed.launches, flash_attention_packed.bwd_launches
    check(fwd == n_blocks * n_timed and bwd == n_blocks * n_timed,
          f"{n_timed} train steps launched {fwd} forward and {bwd} backward kernels, expected {n_blocks} each per step")
    check(all(x == x and abs(x) < 1e4 for x in losses), f"losses not finite: {losses}")
    check(sum(skipped) == 0, f"steps skipped: {skipped}")
    done = steps + 1 + n_timed
    check(state.step == done and state.n_samples == done * batch_size and int(state.opt_state.count) == done,
          f"counters {state.step} {state.n_samples} {int(state.opt_state.count)}, expected {done} steps")
    moved = sum(not torch.equal(before[k], v) for k, v in model.state_dict().items())
    check(moved == len(before), f"only {moved} of {len(before)} parameters moved in the timed steps")
    check(flash_attention_packed.grad_copies == 0, "the backward copied a gradient it should read in place")
    step_s = statistics.median(seconds)
    report["train"] = {
        "batch": batch_size, "steps": n_timed, "launches_fwd": fwd, "launches_bwd": bwd, "losses": losses,
        "seconds": seconds, "ms_per_step": step_s * 1e3, "clips_per_s": batch_size / step_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("train", json.dumps(report["train"]), f"on {smi}", flush=True)

    # c. a batch of NaNs leaves parameters, moments and count bit-identical
    snapshot = copy.deepcopy((model.state_dict(), state.opt_state.state_dict()))
    state, metrics = step_fn(state, {v: torch.full_like(x, float("nan")) for v, x in batches[0].items()})
    check(float(metrics["skipped_nan"]) == 1.0, "the NaN batch was not skipped")
    now = (model.state_dict(), state.opt_state.state_dict())
    same = all(torch.equal(a, b) for a, b in zip(snapshot[0].values(), now[0].values()))
    same &= torch.equal(snapshot[1]["count"], now[1]["count"])
    same &= all(torch.equal(a, b) for name in ("mu", "nu") for a, b in zip(snapshot[1][name], now[1][name]))
    check(same, "the NaN batch changed parameters, moments or count")
    check(state.step == done + 1, "the NaN batch did not advance the step counter")
    print("nan_guard: a NaN batch left parameters, moments and count bit-identical", flush=True)
    if profile:
        report["train_profile"] = profile_call("train_profile", lambda: step_fn(state, batches[0]), smi)
    del snapshot, now, before, initial, state, tx

    # d. one f32 step at batch 2: loss and gradients through the kernels against the plain attention
    model32 = get_mae_model(config, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict())
    del model
    small = {v: x[:2] for v, x in batches[1].items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    masks = {v: random_patch_mask(gen, 2, model32.enc_down_dict[v].n_patches, 0.75, "cuda") for v in small}
    params = list(model32.parameters())

    def loss_and_grads():
        loss = model32(small, 0.75, masks)[0]
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_k, grads_k = loss_and_grads()
    vit.flash_attention_packed_kv = flash_attention_packed_kv_plain
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        vit.flash_attention_packed_kv = flash_attention_packed_kv
    norm_k, norm_p = (torch.linalg.vector_norm(torch.stack([g.norm() for g in gs])).item() for gs in (grads_k, grads_p))
    worst = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item() for a, b in zip(grads_k, grads_p))
    report["train_f32"] = {"loss": loss_k.item(), "loss_plain": loss_p.item(), "grad_norm": norm_k,
                           "grad_norm_plain": norm_p, "max_rel_grad_err": worst, "loss_rtol": TRAIN_LOSS_RTOL,
                           "grad_rtol": TRAIN_GRAD_RTOL}
    print("train_f32", json.dumps(report["train_f32"]), flush=True)
    check(abs(loss_k.item() - loss_p.item()) <= TRAIN_LOSS_RTOL * abs(loss_p.item()), "f32 losses differ")
    check(abs(norm_k - norm_p) <= TRAIN_GRAD_RTOL * norm_p, "f32 gradient norms differ")
    check(worst <= TRAIN_GRAD_RTOL, f"f32 gradients through the kernels differ by {worst} of a parameter's largest")
    return fwd, bwd


def kernel_row(name: str, source: str, replaces: str, launches: int, by_path: dict, rows: list[dict]) -> dict:
    """A kernel's entry of the kernels line: the headline numbers are the first
    row's, every timed shape is listed under ``shapes``."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    timed = [r for r in rows if "ms" in r]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        **{k: timed[0][k] for k in keys}, "launches_by_path": by_path,
        "shapes": [{"shape": r["shape"], "dtype": r["dtype"], **{k: r[k] for k in keys}} for r in timed],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the full report as JSON to this path")
    parser.add_argument("--profile", action="store_true", help="profile one serving chunk and one training step")
    args = parser.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cinema_tpu_torch import build

    report = {"device": smi}

    # 2. build
    t0 = time.perf_counter()
    report["build_s"] = build.build()
    print(f"build {report['build_s']} total {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():  # ptxas -v: registers, shared memory, spills per function
        function = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                function = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {function}: {line.replace('ptxas info    :', '').strip()}", flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_rows = check_attention_shapes(gen)
    bwd_rows = check_attention_bwd_shapes(gen)
    report["attention"], report["attention_bwd"] = fwd_rows, bwd_rows

    # 4. and 5. the two paths at full width, launch counts set to 0 before each and read after
    serve_launches = serve_phase(report, smi, torch.Generator().manual_seed(1), args.profile)
    train_fwd, train_bwd = train_phase(report, smi, args.profile)

    kernels = [
        kernel_row("flash_attention_packed_fwd", "cinema_tpu_torch/csrc/flash_attention_packed.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:483", serve_launches + train_fwd,
                   {"serve": serve_launches, "train": train_fwd}, fwd_rows),
        kernel_row("flash_attention_packed_bwd", "cinema_tpu_torch/csrc/flash_attention_packed_bwd.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:565", train_bwd, {"train": train_bwd}, bwd_rows),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the main paths was never launched")
    report["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


def profile_call(label: str, fn, smi: str) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler recorded no device time")
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in kernels), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    result = {
        "device_ms": total,
        "attention_fwd_ms": sum(ms for key, ms, _ in rows if "packed_fwd" in key),
        "attention_bwd_ms": sum(ms for key, ms, _ in rows if "packed_bwd" in key),
        "top": [{"kernel": key[:100], "ms": ms, "calls": n} for key, ms, n in rows[:25]],
    }
    print(label, json.dumps(result), f"on {smi}", flush=True)
    return result


if __name__ == "__main__":
    main()
