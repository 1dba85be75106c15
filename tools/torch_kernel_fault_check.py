"""Planted-fault check of chip_smoke.py's attention-kernel gates (needs a CUDA card).

For each fault below, copies ``cinema_tpu_torch/`` and ``chip_smoke.py`` into
a temporary directory, edits the bf16 path of one kernel source there (the
packed or the per-head forward or backward under ``csrc/``), builds that
copy into its own build directory and runs chip_smoke's bf16 checks of
that kernel on it. The unedited copy ("none") must pass every check of
all four kernels; each fault must fail at least one. The checkout
itself is never edited.

Usage (from the repository root):
    python3 tools/torch_kernel_fault_check.py [--only forward|backward|heads_forward|heads_backward] [--out summary.json]

Prints one line per check and a summary line per fault (``--out`` also
writes the summaries as JSON); exits non-zero if the unedited kernel fails
or a fault goes uncaught.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FWD, BWD = "flash_attention_packed.cu", "flash_attention_packed_bwd.cu"
HFWD, HBWD = "flash_attention_heads.cu", "flash_attention_heads_bwd.cu"
HLOOP = "for (int k0 = 0; k0 < n_k; k0 += kTile) {"
V_BASE = "const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;"
LOOP = "for (int k0 = 0; k0 < n_k; k0 += kBlockK) {"
ENTRY = "cudaStream_t st = static_cast<cudaStream_t>(stream);"
# fault -> (source file, which checks to run, [(text, replacement, occurrences)] edits of the bf16 kernels)
FAULTS = {
    "none": (FWD, "both", []),
    "skip_last_key_tile": (FWD, "forward", [(LOOP, "for (int k0 = 0; k0 + kBlockK < n_k; k0 += kBlockK) {", 1)]),
    "skip_key_tile_10": (FWD, "forward", [(LOOP, LOOP + "\n    if (k0 == 10 * kBlockK) continue;", 1)]),
    "scale_plus_3pct": (FWD, "forward", [("s[nt][j] * scale_log2", "s[nt][j] * (scale_log2 * 1.03f)", 1)]),
    "mask_last_key": (FWD, "forward", [("s[nt][j] = key < n_k ?", "s[nt][j] = key < n_k - 1 ?", 1)]),
    "lse_without_row_sum": (FWD, "forward", [("lse_row[row0] = m0 + log2f(l0);", "lse_row[row0] = m0;", 1)]),
    "bwd_skip_last_q_tile": (BWD, "backward", [
        ("for (int i0 = 0; i0 < n_q; i0 += kTile) {", "for (int i0 = 0; i0 + kTile < n_q; i0 += kTile) {", 1)]),
    "bwd_delta_dropped": (BWD, "backward", [
        ("dp[h][j] = p * (dp[h][j] - delta_s[r]);", "dp[h][j] = p * dp[h][j];", 1),
        ("s[h][j] = p * (dp[h][j] - delta_r[j >> 1]);", "s[h][j] = p * dp[h][j];", 1)]),
    "bwd_dk_delta_dropped": (BWD, "backward", [
        ("dp[h][j] = p * (dp[h][j] - delta_s[r]);", "dp[h][j] = p * dp[h][j];", 1)]),
    "bwd_scale_plus_3pct": (BWD, "backward", [(ENTRY, ENTRY + "\n  scale *= 1.03f;", 1)]),
    "bwd_softmax_scale_plus_3pct": (BWD, "backward", [(ENTRY, ENTRY + "\n  scale_log2 *= 1.03f;", 1)]),
    "bwd_dq_mask_last_key": (BWD, "backward", [("key < n_k ? exp2f(", "key < n_k - 1 ? exp2f(", 1)]),
    "bwd_q_tail_lse_minus_inf": (BWD, "backward", [
        ("lse_s[threadIdx.x] = row < n_q ? lse[stat + row] : CUDART_INF_F;",
         "lse_s[threadIdx.x] = row < n_q ? lse[stat + row] : -CUDART_INF_F;", 2)]),
    "heads_skip_last_key_tile": (HFWD, "heads_forward", [
        (HLOOP, "for (int k0 = 0; k0 + kTile < n_k; k0 += kTile) {", 1)]),
    "heads_v_head_stride_of_q": (HFWD, "heads_forward", [(V_BASE, V_BASE.replace("vs.h", "qs.h"), 1)]),
    "heads_v_token_stride_of_k": (HFWD, "heads_forward", [
        ("(long long)(k0 + r) * vs.t + c);\n", "(long long)(k0 + r) * ks.t + c);\n", 2)]),
    "heads_scale_plus_3pct": (HFWD, "heads_forward", [
        ("s[nt][j] * scale_log2", "s[nt][j] * (scale_log2 * 1.03f)", 1)]),
    "heads_bwd_skip_last_key_tile": (HBWD, "heads_backward", [
        (HLOOP, "for (int k0 = 0; k0 + kTile < n_k; k0 += kTile) {", 1)]),
    "heads_bwd_v_head_stride_of_q": (HBWD, "heads_backward", [(V_BASE, V_BASE.replace("vs.h", "qs.h"), 2)]),
    "heads_bwd_delta_dropped": (HBWD, "heads_backward", [
        ("dp[h][j] = p * (dp[h][j] - delta_s[r]);", "dp[h][j] = p * dp[h][j];", 1),
        ("s[h][j] = p * (dp[h][j] - delta_r[j >> 1]);", "s[h][j] = p * dp[h][j];", 1)]),
    "heads_bwd_scale_plus_3pct": (HBWD, "heads_backward", [(ENTRY, ENTRY + "\n  scale *= 1.03f;", 1)]),
}
# runs in the copy: chip_smoke's bf16 checks, one per shape, counting failures
CHECKS = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
which = sys.argv[1]
gen = torch.Generator(device="cuda").manual_seed(0)
sharp = cs.SHARP_Q
shapes = [(cs.TRAIN_ENCODER, 1.0), (cs.TRAIN_DECODER, 1.0), (cs.TRAIN_ENCODER, sharp), (cs.TRAIN_DECODER, sharp),
          *((shape, 1.0) for shape in cs.RAGGED[1:])]
runs = []
if which in ("forward", "both"):
    runs += [(cs.check_attention, ((8, 2305, 2305, 768, 12), q_scale)) for q_scale in (1.0, sharp)]
    runs += [(cs.check_attention, x) for x in shapes]
if which in ("backward", "both"):
    runs += [(cs.check_attention_bwd, x) for x in shapes]
caught = []
for fn, (shape, q_scale) in runs:
    try:
        fn(*shape, torch.bfloat16, gen, False, q_scale=q_scale)
    except SystemExit:
        caught.append([fn.__name__, *shape, q_scale])
heads_runs = [(cs.FINETUNE_HEADS, 1.0, "kvhalf"), (cs.EVAL_HEADS, 1.0, "kvhalf"), (cs.FINETUNE_HEADS, sharp, "kvhalf"),
              *((shape, 1.0, layout) for shape, layout in cs.HEADS_RAGGED if shape[1] > 1)]
for name, fn in (("heads_forward", cs.check_heads), ("heads_backward", cs.check_heads_bwd)):
    if which not in (name, "both"):
        continue
    for shape, q_scale, layout in heads_runs:
        runs.append(None)
        try:
            fn(*shape, torch.bfloat16, gen, False, q_scale=q_scale, layout=layout)
        except SystemExit:
            caught.append([fn.__name__, *shape, q_scale, layout])
print(f"RAN {len(runs)} CAUGHT " + json.dumps(caught), flush=True)
'''


def run_fault(name: str) -> tuple[int, list]:
    """(checks run, the checks that failed) on the copy with this fault's edits."""
    source, which, edits = FAULTS[name]
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(ROOT / "cinema_tpu_torch", Path(d) / "cinema_tpu_torch")
        shutil.copy(ROOT / "chip_smoke.py", d)
        cu = Path(d) / "cinema_tpu_torch" / "csrc" / source
        text = cu.read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} is found {text.count(old)} times in {source}, expected {count}")
            text = text.replace(old, new)
        cu.write_text(text)
        env = dict(os.environ, CINEMA_TORCH_BUILD_DIR=str(Path(d) / "build"))
        proc = subprocess.run([sys.executable, "-c", CHECKS, which], cwd=d, env=env, capture_output=True, text=True)
    print(proc.stdout, end="", flush=True)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("RAN ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{name}: the checks did not run to the end (rc {proc.returncode})\n{proc.stderr[-3000:]}")
    _, n_run, _, caught = lines[0].split(" ", 3)
    return int(n_run), json.loads(caught)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["forward", "backward", "heads_forward", "heads_backward"], help="plant the faults of one kernel only")
    parser.add_argument("--out", help="also write the per-fault summaries as JSON to this path")
    args = parser.parse_args()
    ok = True
    summary = {}
    for name, (_, which, _) in FAULTS.items():
        if args.only and which not in (args.only, "both"):
            continue
        n_run, caught = run_fault(name)
        verdict = "pass" if (not caught) == (name == "none") else "WRONG"
        ok &= verdict == "pass"
        summary[name] = {"ran": n_run, "failed": len(caught), "verdict": verdict, "failed_checks": caught}
        print(f"fault {name}: {len(caught)} of {n_run} checks failed ({verdict})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
