"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Drives the port's serving path (``cinema_tpu_torch``) at full width and
holds every hand-written kernel of that path against its plain PyTorch
version on the card:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles every kernel under ``cinema_tpu_torch/csrc`` with nvcc
   (one process per source, all at once);
3. kernels: each kernel against its plain version at the serving shapes and
   at ragged and cross-attention shapes, with its time, the plain version's,
   one PyTorch library call's (a yardstick only) and the card's lower bound;
4. slice: ConvUNetR-base from the packaged ACDC config with seeded random
   weights serves a 50-frame 192x192x16 SAX cine in chunks of 8 and one
   192x192x24 study by sliding window, in bf16; the launch counts of the
   serving run are checked, and one chunk's f32 logits through the kernel
   are held against the plain attention path.

Any failed check exits non-zero. The last two lines of stdout are the
kernels JSON line and ``{"ok": true, "device": {...}}``.

Usage:
    python3 chip_smoke.py [--out report.json] [--profile]

``--profile`` adds a torch.profiler pass over one chunk forward and prints
the device time by kernel.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

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
# f32 ConvUNetR-base logits, kernel attention against the plain attention:
# per-call differences of ~1e-6 carried through 12 blocks and the decoder
LOGITS_ATOL = 1e-3


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


def check_attention(batch, n_q, n_k, embed, n_heads, dtype, gen, timed, q_scale=1.0):
    from cinema_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_packed_plain

    q = (torch.randn(batch, n_q, embed, device="cuda", generator=gen) * q_scale).to(dtype)
    kv = torch.randn(batch, n_k, 2 * embed, device="cuda", generator=gen).to(dtype)
    k, v = kv[..., :embed], kv[..., embed:]  # column slices of the fused kv projection, as the model passes them
    out = flash_attention_packed(q, k, v, n_heads)
    torch.cuda.synchronize()
    want = flash_attention_packed_plain(q, k, v, n_heads)
    check(out.dtype == dtype and out.shape == q.shape, f"kernel output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "kernel output is not finite")
    err = (out.float() - want.float()).abs().max().item()
    want_max = want.float().abs().max().item()
    tol = ATOL_F32 if dtype == torch.float32 else BF16_REL * want_max
    row = {"shape": [batch, n_q, n_k, embed, n_heads], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale,
           "max_abs_err": err, "tol": tol, "max_abs_plain": want_max}
    if timed:
        d = embed // n_heads
        qh, kh, vh = (x.unflatten(-1, (n_heads, d)).transpose(1, 2) for x in (q, k, v))
        row["ms"] = median_ms(lambda: flash_attention_packed(q, k, v, n_heads))
        row["plain_ms"] = median_ms(lambda: flash_attention_packed_plain(q, k, v, n_heads), reps=5)
        row["library_ms"] = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
        row["bound_ms"], row["bound_by"] = attention_bound_ms(batch, n_q, n_k, embed, dtype)
    print("attention", json.dumps(row), flush=True)
    check(err <= tol, f"kernel disagrees with the plain version at {row}")
    return row


def check_attention_shapes(gen, timed=True) -> list[dict]:
    """The kernel against its plain version at the path's shapes and at ragged
    and cross-attention shapes, bf16 then f32; the first row is the serving shape."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_attention(8, 2305, 2305, 768, 12, dtype, gen, timed))  # serving chunk
        rows.append(check_attention(8, 2305, 2305, 768, 12, dtype, gen, False, q_scale=SHARP_Q))
        rows.append(check_attention(2, 2305, 2305, 768, 12, dtype, gen, timed))  # sliding window
        rows.append(check_attention(2, 2305, 769, 512, 16, dtype, gen, timed))  # cross-attention, head_dim 32
        for n in (1, 127, 129):  # ragged tails
            rows.append(check_attention(2, n, n, 768, 12, dtype, gen, False))
        rows.append(check_attention(2, 129, 200, 512, 16, dtype, gen, False))
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the full report as JSON to this path")
    parser.add_argument("--profile", action="store_true", help="profile one chunk forward")
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
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.factory import get_convunetr_model, init_weights
    from cinema_tpu_torch.inference import sliding_window_forward
    from cinema_tpu_torch.models import vit
    from cinema_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_packed_plain
    from cinema_tpu_torch.serve import segment_cine

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
    rows = check_attention_shapes(torch.Generator(device="cuda").manual_seed(0))
    report["attention"] = rows

    # 4. the slice at full width: ConvUNetR-base, seeded random weights
    config = from_dict(PACKAGED["segmentation/acdc"])
    model = init_weights(get_convunetr_model(config, dtype=torch.bfloat16, device="cuda"), seed=0)
    x, y, z = model.image_size_dict["sax"]
    n_frames, chunk = 50, 8
    rng = torch.Generator().manual_seed(1)
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
        vit.flash_attention_packed = flash_attention_packed_plain
        try:
            want = model32({"sax": frames})["sax"]
        finally:
            vit.flash_attention_packed = flash_attention_packed
    logits_err = (got - want).abs().max().item()
    report["logits_f32"] = {"max_abs_err": logits_err, "atol": LOGITS_ATOL, "max_abs": want.abs().max().item()}
    print("logits_f32", json.dumps(report["logits_f32"]), flush=True)
    check(bool(torch.isfinite(got).all()), "f32 logits are not finite")
    check(logits_err <= LOGITS_ATOL, f"f32 logits through the kernel differ by {logits_err}")
    del model32, got, want

    if args.profile:
        report["profile"] = profile_chunk(model, frames.to(torch.bfloat16))

    serving_row = rows[0]
    kernels = [{
        "name": "flash_attention_packed_fwd",
        "route": "cuda",
        "source": "cinema_tpu_torch/csrc/flash_attention_packed.cu",
        "replaces": "cinema_tpu/ops/pallas/flash_attention.py:483",
        "launches": serve_launches,
        "max_abs_err": serving_row["max_abs_err"],
        "ms": serving_row["ms"],
        "plain_ms": serving_row["plain_ms"],
        "bound_ms": serving_row["bound_ms"],
        "bound_by": serving_row["bound_by"],
        "library_ms": serving_row["library_ms"],
    }]
    report["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


def profile_chunk(model, frames) -> dict:
    """Device time by kernel over one chunk forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model.predict_labels({"sax": frames})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.predict_labels({"sax": frames})
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler recorded no device time")
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in kernels), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    attention = sum(ms for key, ms, _ in rows if "packed_fwd" in key)
    top = [{"kernel": key[:100], "ms": ms, "calls": n} for key, ms, n in rows[:15]]
    result = {"device_ms": total, "attention_ms": attention, "top": top}
    print("profile", json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
