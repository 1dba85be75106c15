"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Drives the port's three paths (``cinema_tpu_torch``), serving, MAE
pretraining and ConvViT fine-tuning, at full width and holds every
hand-written kernel of those paths against its plain PyTorch version on
the card:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles every kernel under ``cinema_tpu_torch/csrc`` with nvcc
   (one process per source, all at once);
3. kernels: the packed and the per-head attention forward and backward
   kernels against their plain versions at the paths' shapes and at ragged
   and cross-attention shapes (the per-head ones with v as the strided v
   half of a fused kv projection and through transposed views), with each
   one's time, the plain version's, one PyTorch library call's (a yardstick
   only) and the card's lower bound;
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
   are held against the plain attention path;
6. fine-tuning: ConvViT-base from the packaged ACDC classification config
   (SAX 192x192x16, two frames as channels, 2305 tokens, batch 4, bf16,
   seeded weights, seeded synthetic studies): steps of the default model
   through the packed kernels, then of the ``rotary=True`` model through the
   per-head kernels (timed, with the launch counts, one step with block
   recomputation, a NaN batch, an f32 step against the plain attention
   path), a short ``run_train`` with evaluations whose checkpoint and
   safetensors are reloaded, and the regression task for one step and one
   evaluation.

Any failed check exits non-zero. The last two lines of stdout are the
kernels JSON line and ``{"ok": true, "device": {...}}``.

Usage:
    python3 chip_smoke.py [--out report.json] [--profile]

``--profile`` adds a torch.profiler pass over one serving chunk, one
pretraining step and one fine-tuning step and prints the device time by kernel.
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
        row["bound_share"] = row["bound_ms"] / row["ms"]
        # the passes apart, through the same entry point: each call also runs the delta pre-pass
        dq, dk, dv = got
        row["dkdv_ms"] = median_ms(lambda: fa._launch_bwd(q, k, v, out, lse, g, n_heads, None, dk, dv))
        row["dq_ms"] = median_ms(lambda: fa._launch_bwd(q, k, v, out, lse, g, n_heads, dq, None, None))
        row["delta_ms"] = median_ms(lambda: fa._launch_bwd(q, k, v, out, lse, g, n_heads, None, None, None))
    print("attention_bwd", json.dumps(row), flush=True)
    for name in ("dq", "dk", "dv"):
        check(row[name]["max_abs_err"] <= row[name]["tol"], f"backward kernel's {name} disagrees with the plain "
                                                           f"version at {row}")
    return row


# (batch, n_q, n_k, embed, n_heads) of the two attention calls of a CineMA-base pretraining step
TRAIN_ENCODER = (16, 769, 769, 768, 12)
TRAIN_DECODER = (16, 2305, 768, 512, 16)
# the attention call of default ConvViT-base: a fine-tuning micro-batch and an evaluation study
FINETUNE_PACKED = (4, 2305, 2305, 768, 12)
EVAL_PACKED = (1, 2305, 2305, 768, 12)
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
        rows.append(check_attention(*FINETUNE_PACKED, dtype, gen, timed))
        rows.append(check_attention(*EVAL_PACKED, dtype, gen, timed))
        for shape in RAGGED:
            rows.append(check_attention(*shape, dtype, gen, False))
    return rows


def check_attention_bwd_shapes(gen, timed=True) -> list[dict]:
    """The backward kernel against its plain version at the two pretraining shapes (the first two
    rows) and the fine-tuning shape, with sharp scores, and at ragged and cross shapes; bf16 then f32."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_attention_bwd(*TRAIN_ENCODER, dtype, gen, timed))
        rows.append(check_attention_bwd(*TRAIN_DECODER, dtype, gen, timed))
        rows.append(check_attention_bwd(*FINETUNE_PACKED, dtype, gen, timed))
        rows.append(check_attention_bwd(*TRAIN_ENCODER, dtype, gen, False, q_scale=SHARP_Q))
        rows.append(check_attention_bwd(*TRAIN_DECODER, dtype, gen, False, q_scale=SHARP_Q))
        for shape in RAGGED:
            rows.append(check_attention_bwd(*shape, dtype, gen, False))
    return rows


# (batch, n_q, n_k, heads, head_dim) of the per-head attention calls of ConvViT-base with rotary:
# a fine-tuning micro-batch and an evaluation study
FINETUNE_HEADS = (4, 2305, 2305, 12, 64)
EVAL_HEADS = (1, 2305, 2305, 12, 64)
# ragged and cross shapes: (shape, layout); "bhtd" reads (batch, heads, tokens, head_dim) storage through
# transposed views, "mixed" only k and v, so that q's strides differ from theirs
HEADS_RAGGED = [((2, 129, 200, 16, 32), "kvhalf"), ((2, 130, 77, 12, 64), "bhtd"), ((2, 130, 77, 12, 64), "mixed"),
                ((2, 1, 1, 12, 64), "kvhalf"), ((2, 127, 127, 12, 64), "kvhalf")]


def _heads_inputs(batch, n_q, n_k, heads, d, dtype, gen, q_scale, layout):
    """q, k fresh tensors; v the strided v half of a fused kv projection, as the model's per-head path passes it."""
    q = (torch.randn(batch, n_q, heads, d, device="cuda", generator=gen) * q_scale).to(dtype)
    k = torch.randn(batch, n_k, heads, d, device="cuda", generator=gen).to(dtype)
    if layout == "kvhalf":
        v = torch.randn(batch, n_k, 2, heads, d, device="cuda", generator=gen).to(dtype)[:, :, 1]
    else:
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
        v = torch.randn(batch, heads, n_k, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
        if layout == "bhtd":
            q = q.transpose(1, 2).contiguous().transpose(1, 2)
    return q, k, v


def heads_bound_ms(batch, n_q, n_k, heads, d, dtype, products: int) -> tuple[float, str]:
    """Least time on an H100 for per-head attention: ``products`` matrix products of 2*B*Tq*Tk*H*D flop
    (2 forward, 5 backward) against each operand read once and each result written once
    (forward q, k, v, out; backward also g, dq, dk, dv)."""
    flop_s = products * 2 * batch * n_q * n_k * heads * d / PEAK_FLOPS[dtype]
    n_tensors = 2 if products == 2 else 4  # tensors of q's size, and as many of k's size
    byte_s = n_tensors * batch * (n_q + n_k) * heads * d * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s >= byte_s else "bytes")


def check_heads(batch, n_q, n_k, heads, d, dtype, gen, timed, q_scale=1.0, layout="kvhalf"):
    """Per-head forward kernel against its plain version: the output and the saved row log-sum-exp."""
    from cinema_tpu_torch.ops import flash_attention as fa

    q, k, v = _heads_inputs(batch, n_q, n_k, heads, d, dtype, gen, q_scale, layout)
    out = fa.flash_attention(q, k, v)
    out_lse, lse = fa.flash_attention_forward(q, k, v, save_lse=True)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v)
    check(out.dtype == dtype and out.shape == q.shape and out.is_contiguous(), f"kernel output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "per-head kernel output is not finite")
    check(torch.equal(out, out_lse), "the per-head forward output changes when the log-sum-exp is saved")
    err = (out.float() - want.float()).abs().max().item()
    want_max = want.float().abs().max().item()
    tol = ATOL_F32 if dtype == torch.float32 else BF16_REL * want_max
    lse_err = (lse - fa.flash_attention_lse_plain(q, k)).abs().max().item()
    row = {"shape": [batch, n_q, n_k, heads, d], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale,
           "layout": layout, "v_strides": list(v.stride()), "max_abs_err": err, "tol": tol,
           "max_abs_plain": want_max, "lse_err": lse_err, "lse_tol": LSE_ATOL}
    if timed:
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        row["ms"] = median_ms(lambda: fa.flash_attention(q, k, v))
        row["plain_ms"] = median_ms(lambda: fa.flash_attention_plain(q, k, v), reps=5)
        row["library_ms"] = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
        row["bound_ms"], row["bound_by"] = heads_bound_ms(batch, n_q, n_k, heads, d, dtype, products=2)
    print("heads_attention", json.dumps(row), flush=True)
    check(err <= tol, f"per-head kernel disagrees with the plain version at {row}")
    check(lse_err <= LSE_ATOL, f"per-head saved log-sum-exp disagrees with the plain one at {row}")
    return row


def check_heads_bwd(batch, n_q, n_k, heads, d, dtype, gen, timed, q_scale=1.0, layout="kvhalf"):
    """Per-head backward kernel against flash_attention_bwd_plain on the same q, k, v, out, g."""
    from cinema_tpu_torch.ops import flash_attention as fa

    q, k, v = _heads_inputs(batch, n_q, n_k, heads, d, dtype, gen, q_scale, layout)
    g = torch.randn(batch, n_q, heads, d, device="cuda", generator=gen).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, save_lse=True)
    got = fa.flash_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, g)
    row = {"shape": [batch, n_q, n_k, heads, d], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale,
           "layout": layout, "dv_strides": list(got[2].stride())}
    if layout == "kvhalf":  # dv lands in the v half of a buffer shaped like the fused kv projection
        check(got[2].stride() == v.stride(), f"dv strides {got[2].stride()} are not those of v {v.stride()}")
    worst = 0.0
    for name, x, w, ref in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        check(x.dtype == dtype and x.shape == ref.shape, f"{name} is {x.dtype} {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name} is not finite at {row}")
        w_max = w.float().abs().max().item()
        err = (x.float() - w.float()).abs().max().item()
        # the tolerances of the packed backward, see check_attention_bwd
        tol = ATOL_F32 * max(1.0, w_max) if dtype == torch.float32 else max(BF16_REL * w_max, ATOL_F32)
        row[name] = {"max_abs_err": err, "tol": tol, "max_abs_plain": w_max}
        worst = max(worst, err)
    row["max_abs_err"] = worst
    again = fa.flash_attention_backward(q, k, v, out, lse, g)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"the per-head backward changes from run to run at {row}")
    if timed:
        row["ms"] = median_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, g))
        row["plain_ms"] = median_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, g), reps=5)
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        gh = g.transpose(1, 2)
        row["library_ms"] = median_ms(lambda: torch.autograd.grad(sdpa, (qh, kh, vh), gh, retain_graph=True))
        row["bound_ms"], row["bound_by"] = heads_bound_ms(batch, n_q, n_k, heads, d, dtype, products=5)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        # the passes apart, as check_attention_bwd
        dq, dk, dv = got
        row["dkdv_ms"] = median_ms(lambda: fa._launch_heads_bwd(q, k, v, out, lse, g, None, dk, dv))
        row["dq_ms"] = median_ms(lambda: fa._launch_heads_bwd(q, k, v, out, lse, g, dq, None, None))
        row["delta_ms"] = median_ms(lambda: fa._launch_heads_bwd(q, k, v, out, lse, g, None, None, None))
    print("heads_attention_bwd", json.dumps(row), flush=True)
    for name in ("dq", "dk", "dv"):
        check(row[name]["max_abs_err"] <= row[name]["tol"], f"per-head backward kernel's {name} disagrees with the "
                                                           f"plain version at {row}")
    return row


def check_heads_shapes(gen, timed=True) -> tuple[list[dict], list[dict]]:
    """The per-head kernels against their plain versions at the fine-tuning and evaluation shapes
    (the first rows), with sharp scores, and at ragged, cross and transposed shapes; bf16 then f32."""
    fwd, bwd = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for rows, fn in ((fwd, check_heads), (bwd, check_heads_bwd)):
            rows.append(fn(*FINETUNE_HEADS, dtype, gen, timed))
            rows.append(fn(*EVAL_HEADS, dtype, gen, timed))
            rows.append(fn(*FINETUNE_HEADS, dtype, gen, False, q_scale=SHARP_Q))
            for shape, layout in HEADS_RAGGED:
                rows.append(fn(*shape, dtype, gen, False, layout=layout))
    return fwd, bwd


def check_kv_gradient(gen) -> dict:
    """The gradient of the fused kv projection on the per-head path: ``split_kv`` hands on the buffer
    that already holds dv and copies dk into it; autograd's own slicing zero-fills and adds two
    buffers of kv's size. Both must give the same bits; both are timed (forward + backward)."""
    from cinema_tpu_torch.ops import flash_attention as fa

    batch, n, heads, d = FINETUNE_HEADS[0], FINETUNE_HEADS[1], FINETUNE_HEADS[3], FINETUNE_HEADS[4]
    q = torch.randn(batch, n, heads, d, device="cuda", generator=gen).bfloat16().requires_grad_()
    kv = torch.randn(batch, n, 2 * heads * d, device="cuda", generator=gen).bfloat16().requires_grad_()

    def run(split: bool):
        if split:
            k, v = fa.split_kv(kv, heads)
        else:
            kv5 = kv.unflatten(-1, (2, heads, d))
            k, v = kv5[:, :, 0], kv5[:, :, 1]
        out = fa.flash_attention(q, k * 1.0, v)  # k changed per head, as qk-norm and rotary change it
        return torch.autograd.grad(out.float().square().mean(), (q, kv))

    reused = fa.split_kv.reused
    a, b = run(True), run(False)
    check(fa.split_kv.reused == reused + 1, "split_kv did not take over the buffer that held dv")
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "split_kv's gradient differs from autograd's slicing")
    row = {"shape": list(FINETUNE_HEADS), "split_kv_ms": median_ms(lambda: run(True)),
           "autograd_slicing_ms": median_ms(lambda: run(False))}
    print("kv_gradient", json.dumps(row), flush=True)
    return row


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
        # a slow warm-up, as the packaged config's ten epochs of it: seeded random weights stay well conditioned
        tx = build_optimizer(dict(model.named_parameters()), lr=config.train.lr, min_lr=config.train.min_lr,
                             warmup_steps=100, max_n_steps=1000, betas=tuple(config.train.betas),
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


def write_edes_studies(data_dir: Path, n: int, size: tuple, seed: int) -> None:
    """Seeded synthetic ED + ES studies, one .npz each: ``sax_image`` (x, y, z, 2) of noise with one
    slab along z brightened by the class, ``label`` the class of five, ``ef`` a target that follows it."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        label = i % 5
        image = rng.random((*size, 2), dtype=np.float32) * 100
        image[:, :, 3 * label : 3 * label + 3] += 150 + 30 * label
        np.savez(data_dir / f"study_{i:04d}.npz", sax_image=image.astype(np.float16), label=np.int64(label),
                 ef=np.float32(20 + 8 * label + rng.normal()))


def _snapshot(model, state):
    return [t.clone() for t in (*model.state_dict().values(), *state.opt_state.mu, *state.opt_state.nu,
                                state.opt_state.count)]


def finetune_phase(report: dict, smi: str, profile: bool) -> dict:
    """ConvViT-base fine-tuning and evaluation at full width; returns each kernel's launches on this path."""
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.convert import load_safetensors
    from cinema_tpu_torch.factory import get_convvit_model, init_weights
    from cinema_tpu_torch.ops import attention
    from cinema_tpu_torch.ops.flash_attention import flash_attention, flash_attention_packed, flash_attention_plain
    from cinema_tpu_torch.tasks.classification import acdc as clf_acdc
    from cinema_tpu_torch.tasks.classification import classification_loss_fn
    from cinema_tpu_torch.tasks.regression import acdc as reg_acdc
    from cinema_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from cinema_tpu_torch.train.loop import to_device
    from cinema_tpu_torch.train.optim import build_optimizer
    from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step

    counters = {"packed_fwd": 0, "packed_bwd": 0, "heads_fwd": 0, "heads_bwd": 0}

    def reset() -> None:
        flash_attention_packed.launches = flash_attention_packed.bwd_launches = 0
        flash_attention.launches = flash_attention.bwd_launches = 0

    def read() -> tuple:
        got = (flash_attention_packed.launches, flash_attention_packed.bwd_launches,
               flash_attention.launches, flash_attention.bwd_launches)
        for key, n in zip(counters, got):
            counters[key] += n
        return got

    def rotary_model(config, dtype=torch.float32, device="cuda", **kwargs):
        """What a user passes as ``get_model_fn`` to train ConvViT with rotary embedding: no config key sets it."""
        return get_convvit_model(config, dtype=dtype, device=device, rotary=True, **kwargs)

    batch_size, n_studies, n_timed, depth = 4, 30, 6, 12
    config = from_dict(PACKAGED["classification/acdc"])
    config.grad_ckpt = False  # recomputation off: one forward launch per attention call
    config.train.batch_size = batch_size  # no accumulation: every step is an update
    size = tuple(config.data.sax.patch_size)

    def make_step(model, **opt):
        # a slow warm-up, as the packaged config's ten epochs of it: seeded random weights stay well conditioned
        tx = build_optimizer(dict(model.named_parameters()), lr=config.train.lr, min_lr=config.train.min_lr,
                             warmup_steps=100, max_n_steps=1000, betas=tuple(config.train.betas),
                             weight_decay=config.train.weight_decay, clip_grad=config.train.clip_grad, **opt)
        return TrainState.create(model, tx), make_supervised_train_step(model, tx, classification_loss_fn, seed=0)

    def timed_steps(model, state, step_fn, batches, n, expected: tuple, what: str) -> dict:
        state, _ = step_fn(state, batches[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        reset()
        losses, skipped, seconds = [], [], []
        for i in range(n):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches[(i + 1) % len(batches)])
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            skipped.append(float(metrics["skipped_nan"]))
        got = read()
        check(got == tuple(n * x for x in expected),
              f"{n} {what} steps launched (packed fwd, packed bwd, per-head fwd, per-head bwd) = {got}, "
              f"expected {expected} per step")
        check(all(x == x and abs(x) < 1e4 for x in losses), f"{what} losses not finite: {losses}")
        check(sum(skipped) == 0, f"{what} steps skipped: {skipped}")
        moved = sum(not torch.equal(before[k], v) for k, v in model.state_dict().items())
        check(moved == len(before), f"only {moved} of {len(before)} parameters moved in the {what} steps")
        step_s = statistics.median(seconds)
        row = {"batch": batch_size, "steps": n, "launches": dict(zip(counters, got)), "losses": losses,
               "seconds": seconds, "ms_per_step": step_s * 1e3, "samples_per_s": batch_size / step_s,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"finetune_{what}", json.dumps(row), f"on {smi}", flush=True)
        return row

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp) / "studies"
        data_dir.mkdir()
        write_edes_studies(data_dir, n_studies, size, seed=4)
        config.data.dir = str(data_dir)
        train_ds, val_ds = clf_acdc.load_dataset(config)
        check((len(train_ds), len(val_ds)) == (n_studies - 10, 10), f"split {len(train_ds)} / {len(val_ds)}")
        from cinema_tpu_torch.data import BatchLoader

        batches = [to_device(b, torch.device("cuda")) for b in BatchLoader(train_ds, batch_size, seed=0).epoch(0)]
        check(batches[0]["sax_image"].shape == (batch_size, *size, 2), f"batch {tuple(batches[0]['sax_image'].shape)}")

        # a. the default model: the packed kernels, as users run it
        model = init_weights(get_convvit_model(config, dtype=torch.bfloat16, device="cuda"), seed=config.seed)
        state, step_fn = make_step(model)
        report["finetune_default"] = timed_steps(model, state, step_fn, batches, 3, (depth, depth, 0, 0), "default")
        del state, step_fn

        # b. rotary=True through get_model_fn: the per-head kernels and no packed launch
        rotary = rotary_model(config, dtype=torch.bfloat16, device="cuda")
        rotary.load_state_dict(model.state_dict())
        del model
        state, step_fn = make_step(rotary)
        report["finetune_rotary"] = timed_steps(rotary, state, step_fn, batches, n_timed, (0, 0, depth, depth), "rotary")
        check(flash_attention.grad_copies == 0, "the per-head backward copied a gradient it should read in place")

        # a NaN batch leaves parameters, moments and count bit-identical
        snapshot = _snapshot(rotary, state)
        steps_before = state.step
        bad = dict(batches[0], sax_image=torch.full_like(batches[0]["sax_image"], float("nan")))
        reset()
        state, metrics = step_fn(state, bad)
        read()
        check(float(metrics["skipped_nan"]) == 1.0, "the NaN fine-tuning batch was not skipped")
        check(all(torch.equal(a, b) for a, b in zip(snapshot, _snapshot(rotary, state))),
              "the NaN fine-tuning batch changed parameters, moments or count")
        check(state.step == steps_before + 1, "the NaN batch did not advance the step counter")
        print("finetune_nan_guard: a NaN batch left parameters, moments and count bit-identical", flush=True)
        if profile:
            reset()
            report["finetune_profile"] = profile_call("finetune_profile", lambda: step_fn(state, batches[0]), smi)
            read()
        del snapshot, state, step_fn

        # the same step with the blocks recomputed in the backward pass: two forward launches per block
        remat = rotary_model(config, dtype=torch.bfloat16, device="cuda", remat=True)
        remat.load_state_dict(rotary.state_dict())
        state, step_fn = make_step(remat)
        report["finetune_rotary_remat"] = timed_steps(remat, state, step_fn, batches, 2, (0, 0, 2 * depth, depth),
                                                      "rotary_remat")
        del remat, state, step_fn

        # c. one f32 step at batch 2: loss and gradients through the per-head kernels against the plain attention
        rotary32 = rotary_model(config, dtype=torch.float32, device="cuda").train()
        rotary32.load_state_dict(rotary.state_dict())
        for module in rotary32.modules():  # no drop-path noise: both passes see the same network
            if hasattr(module, "rate"):
                module.rate = 0.0
        small = {k: v[:2] for k, v in batches[1].items()}
        params = list(rotary32.parameters())

        def loss_and_grads():
            loss = classification_loss_fn(rotary32, small)[0]
            return loss.detach(), torch.autograd.grad(loss, params)

        reset()
        loss_k, grads_k = loss_and_grads()
        check(read() == (0, 0, depth, depth), "the f32 step did not go through the per-head kernels")
        attention.flash_attention = flash_attention_plain
        try:
            reset()
            loss_p, grads_p = loss_and_grads()
            check(read() == (0, 0, 0, 0), "the plain attention path launched a kernel")
        finally:
            attention.flash_attention = flash_attention
        norm_k, norm_p = (torch.linalg.vector_norm(torch.stack([g.norm() for g in gs])).item()
                          for gs in (grads_k, grads_p))
        errs = [((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item() for a, b in zip(grads_k, grads_p)]
        worst = max(errs)
        worst_name = [name for name, _ in rotary32.named_parameters()][errs.index(worst)]
        report["finetune_f32"] = {"loss": loss_k.item(), "loss_plain": loss_p.item(), "grad_norm": norm_k,
                                  "grad_norm_plain": norm_p, "max_rel_grad_err": worst, "worst_parameter": worst_name,
                                  "worst_parameter_max_grad": grads_p[errs.index(worst)].abs().max().item(),
                                  "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL}
        print("finetune_f32", json.dumps(report["finetune_f32"]), flush=True)
        check(abs(loss_k.item() - loss_p.item()) <= TRAIN_LOSS_RTOL * abs(loss_p.item()), "f32 fine-tuning losses differ")
        check(abs(norm_k - norm_p) <= TRAIN_GRAD_RTOL * norm_p, "f32 fine-tuning gradient norms differ")
        check(worst <= TRAIN_GRAD_RTOL, f"f32 gradients through the per-head kernels differ by {worst} of a "
                                        f"parameter's largest")
        del rotary32, params, grads_k, grads_p, rotary

        # d. the entry point: a short run_train of the rotary model with an evaluation per epoch
        n_epochs = 3
        config.logging.dir = str(Path(tmp) / "runs")
        config.train.update(n_epochs=n_epochs, n_warmup_epochs=0, eval_interval=1, lr=1.0e-4)
        reset()
        t0 = time.perf_counter()
        out_dir = clf_acdc.run(config, device="cuda", get_model_fn=rotary_model)
        run_s = time.perf_counter() - t0
        got = read()
        steps = n_epochs * (len(train_ds) // batch_size)
        evals = n_epochs * len(val_ds)  # batch 1: one per-head forward launch per block and study
        check(got == (0, 0, depth * (steps + evals), depth * steps),
              f"run_train launched {got}, expected {depth} per-head forward launches per step and per evaluated "
              f"study and {depth} backward launches per step")
        records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
        train_loss = [r["train_loss"] for r in records if "train_loss" in r]
        val = [r for r in records if "val_accuracy" in r]
        check(len(train_loss) == n_epochs and len(val) == n_epochs, f"metrics.jsonl holds {records}")
        check(all(x == x and abs(x) < 1e4 for x in train_loss), f"run_train losses not finite: {train_loss}")
        check(train_loss[-1] < train_loss[0], f"run_train's loss did not decrease: {train_loss}")
        check(all(0.0 <= r["val_accuracy"] <= 1.0 and r["val_entropy"] == r["val_entropy"] for r in val), f"{val}")
        ckpt = latest_checkpoint(out_dir)
        check(ckpt is not None and Path(f"{ckpt}.meta.json").exists(), "checkpoint or its sidecar missing")
        epoch = json.loads(Path(f"{ckpt}.meta.json").read_text())["epoch"]
        reloaded = rotary_model(config, dtype=torch.bfloat16, device="cuda")
        state, _ = make_step(reloaded)
        state = load_checkpoint(ckpt, state)
        check(state.step == (epoch + 1) * (len(train_ds) // batch_size), f"reloaded step counter {state.step}")
        exported = load_safetensors(out_dir / f"model_{epoch}.safetensors")
        check(set(exported) == set(reloaded.state_dict()), "model safetensors keys differ from the model's")
        check(all(torch.equal(torch.from_numpy(exported[k]).cuda(), v) for k, v in reloaded.state_dict().items()),
              "model safetensors differs from the checkpoint's parameters")
        report["finetune_run"] = {"epochs": n_epochs, "steps": steps, "evaluated_studies": evals, "seconds": run_s,
                                  "train_loss": train_loss, "val_accuracy": [r["val_accuracy"] for r in val],
                                  "launches": dict(zip(counters, got)), "saved_epoch": epoch}
        print("finetune_run", json.dumps(report["finetune_run"]), f"on {smi}", flush=True)
        del reloaded, state

        # e. the regression task, default model: one step and one evaluation of four studies
        reg = from_dict(PACKAGED["regression/acdc"])
        reg.grad_ckpt = False
        reg.data.dir = str(data_dir)
        reg.data.max_n_samples = 4
        reg.logging.dir = str(Path(tmp) / "runs_reg")
        reg.train.update(n_epochs=1, n_warmup_epochs=0, eval_interval=1, batch_size=4)
        reset()
        out_dir = reg_acdc.run(reg, device="cuda")
        got = read()
        check(got == (depth * (1 + 4), depth, 0, 0), f"the regression task launched {got}")
        records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
        val = next(r for r in records if "val_mae" in r)
        check(val["val_mae"] == val["val_mae"] and abs(val["val_denormalised_mae"] - val["val_mae"] * reg.data.ef.std)
              <= 1e-6 * abs(val["val_denormalised_mae"]), f"regression evaluation {val}")
        check((out_dir / "model_0.safetensors").exists(), "the regression run saved no model")
        report["finetune_regression"] = {"train_loss": records[0]["train_loss"], "val_mae": val["val_mae"],
                                         "launches": dict(zip(counters, got))}
        print("finetune_regression", json.dumps(report["finetune_regression"]), f"on {smi}", flush=True)
    report["finetune_launches"] = counters
    return counters


def kernel_row(name: str, source: str, replaces: str, launches: int, by_path: dict, rows: list[dict]) -> dict:
    """A kernel's entry of the kernels line: the headline numbers are the first
    row's, every timed shape is listed under ``shapes``."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    timed = [r for r in rows if "ms" in r]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        **{k: timed[0][k] for k in keys}, "launches_by_path": by_path,
        "shapes": [{"shape": r["shape"], "dtype": r["dtype"], **{k: r[k] for k in keys},
                    **{k: r[k] for k in ("bound_share", "dkdv_ms", "dq_ms", "delta_ms") if k in r}} for r in timed],
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
    heads_fwd_rows, heads_bwd_rows = check_heads_shapes(gen)
    report["heads_attention"], report["heads_attention_bwd"] = heads_fwd_rows, heads_bwd_rows
    report["kv_gradient"] = check_kv_gradient(gen)

    # 4. to 6. the three paths at full width, launch counts set to 0 before each and read after
    serve_launches = serve_phase(report, smi, torch.Generator().manual_seed(1), args.profile)
    train_fwd, train_bwd = train_phase(report, smi, args.profile)
    tune = finetune_phase(report, smi, args.profile)

    kernels = [
        kernel_row("flash_attention_packed_fwd", "cinema_tpu_torch/csrc/flash_attention_packed.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:483", serve_launches + train_fwd + tune["packed_fwd"],
                   {"serve": serve_launches, "train": train_fwd, "finetune": tune["packed_fwd"]}, fwd_rows),
        kernel_row("flash_attention_packed_bwd", "cinema_tpu_torch/csrc/flash_attention_bwd.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:565", train_bwd + tune["packed_bwd"],
                   {"train": train_bwd, "finetune": tune["packed_bwd"]}, bwd_rows),
        kernel_row("flash_attention_heads_fwd", "cinema_tpu_torch/csrc/flash_attention_heads.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:143", tune["heads_fwd"],
                   {"finetune": tune["heads_fwd"]}, heads_fwd_rows),
        kernel_row("flash_attention_heads_bwd", "cinema_tpu_torch/csrc/flash_attention_bwd.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:285", tune["heads_bwd"],
                   {"finetune": tune["heads_bwd"]}, heads_bwd_rows),
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
    """Device time by kernel over one call of ``fn`` (torch.profiler), after one warm-up call and one
    call timed on the host clock without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler recorded no device time")
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in kernels), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    result = {
        "device_ms": total, "wall_ms": wall_ms, "wall_ms_while_profiled": profiled_wall_ms,
        "attention_fwd_ms": sum(ms for key, ms, _ in rows if "packed_fwd" in key or "heads_fwd" in key),
        "attention_bwd_ms": sum(ms for key, ms, _ in rows if "flash_bwd" in key),
        "top": [{"kernel": key[:100], "ms": ms, "calls": n} for key, ms, n in rows[:25]],
    }
    print(label, json.dumps(result), f"on {smi}", flush=True)
    return result


if __name__ == "__main__":
    main()
