"""Planted-fault check of chip_smoke.py's attention-kernel gates (needs a CUDA card).

For each fault below, copies ``cinema_tpu_torch/`` and ``chip_smoke.py`` into
a temporary directory, edits one kernel source there (the forward or the
backward, each shared by the packed and the per-head layouts, under
``csrc/``): the bf16 path, or the f32 forward's split-TF32 path (faults
named ``f32_*``). It builds that copy into its own build directory and runs
chip_smoke's checks, in the fault's dtype, of the kernels the fault is
planted in: a forward fault against both the packed and the per-head forward
checks (unless it can show in one layout only), unless ``--only`` names one
of them. The unedited copy ("none") must pass every check of all four
kernels (of the one ``--only`` names) in bf16 and in f32; each fault must
fail at least one. The checkout itself is never edited.

Usage (from the repository root):
    python3 tools/torch_kernel_fault_check.py [--only forward|backward|heads_forward|heads_backward] [--out summary.json]

Prints one line per check and a summary line per fault (``--out`` also
writes the summaries as JSON); exits non-zero if the unedited kernel fails
or a fault goes uncaught. A fault whose kernel dies on the card with a CUDA
error is caught by the check that launched it; the checks after it do not run.
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
FWD, BWD = "flash_attention_fwd.cu", "flash_attention_bwd.cu"  # each the kernel of both layouts
KERNELS = ("forward", "backward", "heads_forward", "heads_backward")
BOTH_FWD = ("forward", "heads_forward")
V_BASE = "const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;"
ENTRY = "cudaStream_t st = static_cast<cudaStream_t>(stream);"
# the bf16 forward: its stage count, its key mask and its ring slot's address (k, and v beside it)
F_STAGES = "const int n_iters = (n_k + kStageRows - 1) / kStageRows;"
F_MASK = "if (ragged) x = key < n_k ? x : -CUDART_INF_F;"
F_SLOT = "const uint32_t k_st = base + S::kRing + 2 * slot * S::kTile;"
# the bf16 backward's dS lines: dk/dv pass, then dq pass
DK_DS = ("dp[i] = s[i] * (dp[i] - (i & 1 ? d2.y : d2.x));", "dp[i] = s[i] * dp[i];", 1)
DQ_DS = ("s[i] = s[i] * (dp[i] - delta_r[(i >> 1) & 1]);", "s[i] = s[i] * dp[i];", 1)
Q_STAGES = "const int n_iters = (n_q + kStageRows - 1) / kStageRows;"  # stages of the dk/dv pass
K_STAGES = "const int n_iters = (n_k + kStageRows - 1) / kStageRows;"  # stages of the dq pass
# the f32 forward: its products of split operands, its split, and the read of v's B fragments
F32_PASSES = ("    mma_tf32_zero(d, a_lo, b_hi);\n  } else {\n    mma_tf32(d, a_lo, b_hi);\n  }\n"
              "  mma_tf32(d, a_hi, b_lo);\n  mma_tf32(d, a_hi, b_hi);\n")
F32_ONE_PASS = "    mma_tf32_zero(d, a_hi, b_hi);\n  } else {\n    mma_tf32(d, a_hi, b_hi);\n  }\n"
F32_LO = "lo = __float_as_uint(x - __uint_as_float(hi));"
F32_V_ROW = "const float* v_row = v_st + (8 * (k0 + u) + 2 * t) * S::kVPitch + gi;"
# fault -> (source file, the kernels whose checks run, [(text, replacement, occurrences)] edits of the kernels,
# the dtypes of the checks: bf16 unless the fault is planted in the f32 path)
FAULTS = {
    "none": (FWD, KERNELS, [], ("bfloat16", "float32")),
    "skip_last_key_stage": (FWD, BOTH_FWD, [(F_STAGES, F_STAGES.replace(";", " - 1;"), 1)]),
    "skip_middle_key_stage": (FWD, BOTH_FWD, [
        (F_MASK, F_MASK + "\n      if (it == n_iters / 2) x = -CUDART_INF_F;", 1)]),
    "scale_plus_3pct": (FWD, BOTH_FWD, [(ENTRY, ENTRY + "\n  scale_log2 *= 1.03f;", 1)]),
    "mask_last_key": (FWD, BOTH_FWD, [(F_MASK, F_MASK.replace("key < n_k", "key < n_k - 1"), 1)]),
    "lse_without_row_sum": (FWD, BOTH_FWD, [("= m[h] + log2f(l[h]);", "= m[h];", 1)]),
    # S and P v wait for the right ring slot but read the tiles of the next one
    "ring_slot_off_by_one": (FWD, BOTH_FWD, [(F_SLOT, F_SLOT.replace("* slot", "* ((slot + 1) % kStages)"), 1)]),
    # P v reads v K-major instead of through the transposed (MN-major) descriptor
    "pv_transpose_flag_dropped": (FWD, BOTH_FWD, [("mma_rs<D, 1>(o_acc,", "mma_rs<D, 0>(o_acc,", 1)]),
    # a packed q and v both have head stride head_dim: only the per-head layouts can show this one
    "v_head_stride_of_q": (FWD, ("heads_forward",), [(V_BASE, V_BASE.replace("vs.h", "qs.h"), 1)]),
    "bwd_skip_last_q_tile": (BWD, ("backward",), [(Q_STAGES, Q_STAGES.replace(";", " - 1;"), 1)]),
    "bwd_delta_dropped": (BWD, ("backward",), [DK_DS, DQ_DS]),
    "bwd_dk_delta_dropped": (BWD, ("backward",), [DK_DS]),
    "bwd_scale_plus_3pct": (BWD, ("backward",), [(ENTRY, ENTRY + "\n  scale *= 1.03f;", 1)]),
    "bwd_softmax_scale_plus_3pct": (BWD, ("backward",), [(ENTRY, ENTRY + "\n  scale_log2 *= 1.03f;", 1)]),
    "bwd_dq_mask_last_key": (BWD, ("backward",), [
        ("if (ragged) p = key < n_k ? p : 0.f;", "if (ragged) p = key < n_k - 1 ? p : 0.f;", 1)]),
    "bwd_q_tail_lse_minus_inf": (BWD, ("backward",), [
        ("lse_pad[idx] = CUDART_INF_F;", "lse_pad[idx] = -CUDART_INF_F;", 1)]),
    # both passes wait for the right ring slot but read the tiles of the next one
    "bwd_ring_stage_off_by_one": (BWD, ("backward",), [
        ("base + (2 * slot) * S::kTile;", "base + (2 * ((slot + 1) % kStages)) * S::kTile;", 2)]),
    # dv's product reads g K-major instead of through the transposed (MN-major) descriptor
    "bwd_dv_transpose_flag_dropped": (BWD, ("backward",), [("mma_rs<D, 1>(dv_acc,", "mma_rs<D, 0>(dv_acc,", 1)]),
    "heads_bwd_skip_last_key_tile": (BWD, ("heads_backward",), [(K_STAGES, K_STAGES.replace(";", " - 1;"), 1)]),
    "heads_bwd_v_head_stride_of_q": (BWD, ("heads_backward",), [(V_BASE, V_BASE.replace("vs.h", "qs.h"), 2)]),
    "heads_bwd_delta_dropped": (BWD, ("heads_backward",), [DK_DS, DQ_DS]),
    "heads_bwd_scale_plus_3pct": (BWD, ("heads_backward",), [(ENTRY, ENTRY + "\n  scale *= 1.03f;", 1)]),
    # one TF32 pass: both cross products dropped, a_hi b_hi alone
    "f32_one_tf32_pass": (FWD, BOTH_FWD, [(F32_PASSES, F32_ONE_PASS, 1)], ("float32",)),
    # lo as the residual of x truncated to TF32, where hi is x rounded
    "f32_lo_wrong_residual": (FWD, BOTH_FWD, [
        (F32_LO, "lo = __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));", 1)], ("float32",)),
    # v's B fragments read one column off in the (keys, D) tile
    "f32_v_column_off_by_one": (FWD, BOTH_FWD, [(F32_V_ROW, F32_V_ROW.replace("+ gi;", "+ gi + 1;"), 1)],
                                ("float32",)),
}
# runs in the copy: chip_smoke's checks in the given dtypes, one per shape, counting failures
CHECKS = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
which = set(sys.argv[1].split(","))
dtypes = [getattr(torch, name) for name in sys.argv[2].split(",")]
gen = torch.Generator(device="cuda").manual_seed(0)
sharp = cs.SHARP_Q
shapes = [(cs.TRAIN_ENCODER, 1.0), (cs.TRAIN_DECODER, 1.0), (cs.TRAIN_ENCODER, sharp), (cs.TRAIN_DECODER, sharp),
          (cs.LANDMARK_PACKED, 1.0), (cs.LANDMARK_PACKED, sharp), *((shape, 1.0) for shape in cs.RAGGED[1:])]
runs = []
if "forward" in which:
    runs += [(cs.check_attention, ((8, 2305, 2305, 768, 12), q_scale)) for q_scale in (1.0, sharp)]
    runs += [(cs.check_attention, x) for x in shapes]
if "backward" in which:
    runs += [(cs.check_attention_bwd, x) for x in shapes]
runs = [(dtype, run) for dtype in dtypes for run in runs]
caught = []
for dtype, (fn, (shape, q_scale)) in runs:
    try:
        fn(*shape, dtype, gen, False, q_scale=q_scale)
    except SystemExit:
        caught.append([fn.__name__, *shape, q_scale, str(dtype)])
heads_runs = [(cs.FINETUNE_HEADS, 1.0, "kvhalf"), (cs.EVAL_HEADS, 1.0, "kvhalf"), (cs.FINETUNE_HEADS, sharp, "kvhalf"),
              *((shape, 1.0, layout) for shape, layout in cs.HEADS_RAGGED if shape[1] > 1)]
for name, fn in (("heads_forward", cs.check_heads), ("heads_backward", cs.check_heads_bwd)):
    if name not in which:
        continue
    for dtype in dtypes:
        for shape, q_scale, layout in heads_runs:
            runs.append(None)
            try:
                fn(*shape, dtype, gen, False, q_scale=q_scale, layout=layout)
            except SystemExit:
                caught.append([fn.__name__, *shape, q_scale, layout, str(dtype)])
print(f"RAN {len(runs)} CAUGHT " + json.dumps(caught), flush=True)
'''


def run_fault(name: str, which: list[str]) -> tuple[int, list]:
    """(checks run, the checks that failed) on the copy with this fault's edits, running the checks of
    the kernels in ``which`` in the fault's dtypes."""
    source, _, edits, *dtypes = FAULTS[name]
    dtypes = dtypes[0] if dtypes else ("bfloat16",)
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
        proc = subprocess.run([sys.executable, "-c", CHECKS, ",".join(which), ",".join(dtypes)], cwd=d, env=env,
                              capture_output=True, text=True)
    print(proc.stdout, end="", flush=True)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("RAN ")]
    if proc.returncode != 0 and "CUDA error" in proc.stderr:
        # the kernel faulted on the card (an address out of bounds, a trapped ring wait): the check that
        # launched it fails, and the card's context with it, so no later check runs
        done = sum(line.split(" ", 1)[0] in ("attention", "attention_bwd", "heads_attention", "heads_attention_bwd")
                   for line in proc.stdout.splitlines())
        error = next(line for line in proc.stderr.splitlines() if "CUDA error" in line)
        return done + 1, [["cuda_error", error.strip()]]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{name}: the checks did not run to the end (rc {proc.returncode})\n{proc.stderr[-3000:]}")
    _, n_run, _, caught = lines[0].split(" ", 3)
    return int(n_run), json.loads(caught)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=KERNELS, help="plant the faults of one kernel only and run its checks only")
    parser.add_argument("--out", help="also write the per-fault summaries as JSON to this path")
    args = parser.parse_args()
    ok = True
    summary = {}
    for name, (_, kernels, *_) in FAULTS.items():
        which = [k for k in kernels if args.only in (None, k)]
        if not which:
            continue
        n_run, caught = run_fault(name, which)
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
