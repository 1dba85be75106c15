"""Pair the attention kernels of several checkouts on one CUDA card (needs a card).

Runs the same seeded inputs through the public attention entry points of each
checkout (``cinema_tpu_torch.ops.flash_attention``), each in its own process
and with its own build directory, in the order first .. last, last .. first,
so that a drift of the card's clocks falls on both sides alike:

- the forwards, packed and per-head, at the main paths' shapes (bf16, and f32
  at three of them), timed with the host's time hidden: CUDA events around 20
  launches issued back to back, divided by 20, the median of 5 such readings;
  their outputs and saved log-sum-exp are compared with the first
  checkout's (largest difference, and whether bit for bit equal);
- the backwards at the training shapes (bf16 and f32, f32 also at the
  MyoPS2020 step's 577 tokens), given the same out and log-sum-exp (from the
  plain forward, so that they do not depend on the forward kernel), timed the
  same way; their bf16 gradients are compared bit for bit with the first
  checkout's, their f32 ones within chip_smoke's f32 gate (``ATOL_F32``,
  relative once a gradient exceeds 1): two designs of the f32 kernels sum in
  other orders.

Usage (from the repository root, with another commit unpacked by
``git archive`` into a directory that .gitignore lists):
    python3 tools/torch_attention_ab.py build/parent . [--out summary.json]

Prints one line per checkout and run, then a summary line; exits non-zero if a
run fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# runs in a checkout: times and outputs of its kernels on seeded inputs
RUN = r'''
import json, statistics, sys, torch
sys.path.insert(0, ".")
from cinema_tpu_torch.ops import flash_attention as fa
out_path, save = sys.argv[1], sys.argv[2] == "1"
torch.backends.cuda.matmul.allow_tf32 = False
BF16, F32 = torch.bfloat16, torch.float32
FWD = [("packed", (8, 2305, 2305, 768, 12)), ("packed", (2, 2305, 2305, 768, 12)), ("packed", (16, 769, 769, 768, 12)),
       ("packed", (16, 2305, 768, 512, 16)), ("packed", (4, 2305, 2305, 768, 12)), ("packed", (1, 2305, 2305, 768, 12)),
       ("heads", (4, 2305, 2305, 12, 64)), ("heads", (1, 2305, 2305, 12, 64))]
FWD = [(layout, shape, BF16) for layout, shape in FWD] + [
    ("packed", (8, 2305, 2305, 768, 12), F32), ("packed", (16, 2305, 768, 512, 16), F32),
    ("heads", (4, 2305, 2305, 12, 64), F32)]
BWD = [("packed", (16, 769, 769, 768, 12)), ("packed", (16, 2305, 768, 512, 16)), ("packed", (4, 2305, 2305, 768, 12)),
       ("heads", (4, 2305, 2305, 12, 64))]
BWD = [(layout, shape, dtype) for dtype in (BF16, F32) for layout, shape in BWD] + [
    ("packed", (4, 577, 577, 768, 12), F32)]


def device_ms(fn, n=20, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def inputs(layout, shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "packed":
        batch, n_q, n_k, embed, heads = shape
        q = torch.randn(batch, n_q, embed, device="cuda", generator=gen).to(dtype)
        kv = torch.randn(batch, n_k, 2 * embed, device="cuda", generator=gen).to(dtype)
        g = torch.randn(batch, n_q, embed, device="cuda", generator=gen).to(dtype)
        return q, kv[..., :embed], kv[..., embed:], g
    batch, n_q, n_k, heads, d = shape
    q = torch.randn(batch, n_q, heads, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(batch, n_k, heads, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(batch, n_k, 2, heads, d, device="cuda", generator=gen).to(dtype)[:, :, 1]
    g = torch.randn(batch, n_q, heads, d, device="cuda", generator=gen).to(dtype)
    return q, k, v, g


def name(direction, layout, shape, dtype):
    return f"{direction} {layout} {shape}" + (" float32" if dtype == F32 else "")


tensors, rows = {}, []
for i, (layout, shape, dtype) in enumerate(FWD):
    q, k, v, _ = inputs(layout, shape, dtype, i)
    if layout == "packed":
        fwd = lambda lse: fa.flash_attention_packed_forward(q, k, v, shape[4], save_lse=lse)
    else:
        fwd = lambda lse: fa.flash_attention_forward(q, k, v, save_lse=lse)
    if save:
        tensors[name("fwd", layout, shape, dtype)] = [x.cpu() for x in fwd(True)]
    rows.append({"kernel": name("fwd", layout, shape, dtype), "device_ms": device_ms(lambda: fwd(False))})
for i, (layout, shape, dtype) in enumerate(BWD):
    q, k, v, g = inputs(layout, shape, dtype, 100 + i)
    if layout == "packed":
        out = fa.flash_attention_packed_plain(q, k, v, shape[4])
        lse = fa.flash_attention_packed_lse_plain(q, k, shape[4])
        bwd = lambda: fa.flash_attention_packed_backward(q, k, v, out, lse, g, shape[4])
    else:
        out, lse = fa.flash_attention_plain(q, k, v), fa.flash_attention_lse_plain(q, k)
        bwd = lambda: fa.flash_attention_backward(q, k, v, out, lse, g)
    if save:
        tensors[name("bwd", layout, shape, dtype)] = [x.cpu() for x in bwd()]
    rows.append({"kernel": name("bwd", layout, shape, dtype), "device_ms": device_ms(bwd)})
if save:
    torch.save(tensors, out_path)
print("ROWS " + json.dumps(rows), flush=True)
'''


def run(tree: Path, out: Path, save: bool) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", RUN, str(out), "1" if save else "0"], cwd=tree,
                          capture_output=True, text=True)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("ROWS ")]
    if proc.returncode != 0 or not lines:
        sys.exit(f"{tree}: the run failed (rc {proc.returncode})\n{proc.stderr[-3000:]}")
    return json.loads(lines[0][5:])


def atol_f32() -> float:
    """chip_smoke.py's f32 gate (``ATOL_F32``), from this repository's copy."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.ATOL_F32


def compare(key: str, got: list, want: list, atol: float) -> dict:
    """One case's outputs (forward) or gradients (backward) against the first checkout's; f32 gradients within
    ``atol``, relative once a gradient exceeds 1."""
    import torch

    diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    if key.startswith("fwd"):
        return {"max_abs_diff": diffs, "bit_equal": [torch.equal(a, b) for a, b in zip(got, want)]}
    if key.endswith("float32"):
        tols = [atol * max(1.0, b.abs().max().item()) for b in want]
        return {"max_abs_diff": diffs, "within_atol_f32": [d <= tol for d, tol in zip(diffs, tols)]}
    return {"bit_equal": [torch.equal(a, b) for a, b in zip(got, want)]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="checkout roots; the first is the reference")
    parser.add_argument("--out", help="also write the summary as JSON to this path")
    args = parser.parse_args()
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = [Path(t).resolve() for t in args.trees]
    times: dict[int, list[list[dict]]] = {i: [] for i in range(len(trees))}
    with tempfile.TemporaryDirectory() as tmp:
        saved = [Path(tmp) / f"tree{i}.pt" for i in range(len(trees))]
        order = list(range(len(trees))) + list(reversed(range(len(trees))))
        for n, i in enumerate(order):
            rows = run(trees[i], saved[i], save=n < len(trees))
            times[i].append(rows)
            print(f"run {n}: {args.trees[i]}", json.dumps(rows), flush=True)
        ref = torch.load(saved[0])
        atol = atol_f32()
        compared = {}
        for i in range(1, len(trees)):
            got = torch.load(saved[i])
            compared[args.trees[i]] = {key: compare(key, got[key], want, atol) for key, want in ref.items()}
    summary = {
        "device": smi,
        "device_ms": {args.trees[i]: [[r["device_ms"] for r in rows] for rows in runs] for i, runs in times.items()},
        "cases": [r["kernel"] for r in times[0][0]],
        "against_first": compared,
    }
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
