"""Planted-fault check of chip_smoke.py's attention-kernel gates (needs a CUDA card).

For each fault below, copies ``cinema_tpu_torch/`` and ``chip_smoke.py`` into
a temporary directory, edits one kernel source there (the forward or the
backward, each shared by the packed and the per-head layouts, under
``csrc/``): the bf16 path, or the f32 split-TF32 path (faults named
``f32_*``, ``f32_bwd_*`` in the backward). It builds that copy into its own
build directory and runs chip_smoke's checks, in the fault's dtype, of the
kernels the fault is planted in: a forward fault, and an f32 backward fault,
against the checks of both layouts (unless it can show in one layout only),
unless ``--only`` names one of them. The unedited copy ("none") must pass
every check of all four kernels (of the one ``--only`` names) in bf16 and in
f32; each fault must fail at least one. The checkout itself is never edited.

Usage (from the repository root):
    python3 tools/torch_kernel_fault_check.py [--only forward|backward|heads_forward|heads_backward]
        [--prefix f32_bwd_] [--out summary.json]

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
# the f32 forward's read of v's B fragments
F32_V_ROW = "const float* v_row = v_st + (8 * (k0 + u) + 2 * t) * S::kVPitch + gi;"
# after a kernel source's include of the TF32 products, a product or a split of its own can stand in for them in
# that source alone (the f32 forward or the f32 backward)
TF32_INCLUDE = '#include "tf32.cuh"\n'
ONE_PASS = TF32_INCLUDE + '''namespace {
template <bool kFirst>
__device__ __forceinline__ void mma_one_pass(float* d, const uint32_t (&a_hi)[4], const uint32_t (&)[4],
                                             const uint32_t (&b_hi)[2], const uint32_t (&)[2]) {
  if constexpr (kFirst) {
    mma_tf32_zero(d, a_hi, b_hi);
  } else {
    mma_tf32(d, a_hi, b_hi);
  }
}
}  // namespace
#define mma_tf32x3 mma_one_pass
'''
LO_TRUNCATED = TF32_INCLUDE + '''namespace {
__device__ __forceinline__ void split_lo_truncated(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}
}  // namespace
#define split_tf32 split_lo_truncated
'''
# the f32 backward's dS lines (dk/dv pass, then dq pass), its key mask and its dq product's read of k
F32_DK_DS = ("dp[i] = (dp[i] - (i & 1 ? d2.y : d2.x)) * s[i];", "dp[i] = dp[i] * s[i];", 1)
F32_DQ_DS = ("s[i] = (dp[i] - delta_r[(i >> 1) & 1]) * s[i];", "s[i] = dp[i] * s[i];", 1)
F32_DQ_MASK = "s[i] = ragged && key >= n_k ? 0.f : exp2_ftz("
F32_DQ_K = "product_cols<D>(dq_acc, s, k_st, gi, t);"
BOTH_BWD = ("backward", "heads_backward")
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
    "f32_one_tf32_pass": (FWD, BOTH_FWD, [(TF32_INCLUDE, ONE_PASS, 1)], ("float32",)),
    # lo as the residual of x truncated to TF32, where hi is x rounded
    "f32_lo_wrong_residual": (FWD, BOTH_FWD, [(TF32_INCLUDE, LO_TRUNCATED, 1)], ("float32",)),
    # v's B fragments read one column off in the (keys, D) tile
    "f32_v_column_off_by_one": (FWD, BOTH_FWD, [(F32_V_ROW, F32_V_ROW.replace("+ gi;", "+ gi + 1;"), 1)],
                                ("float32",)),
    # the split-TF32 backward: one TF32 pass (a_hi b_hi alone) in every product of both passes
    "f32_bwd_one_tf32_pass": (BWD, BOTH_BWD, [(TF32_INCLUDE, ONE_PASS, 1)], ("float32",)),
    # lo as the residual of x truncated to TF32, where hi is x rounded, in every split of both passes
    "f32_bwd_lo_wrong_residual": (BWD, BOTH_BWD, [(TF32_INCLUDE, LO_TRUNCATED, 1)], ("float32",)),
    # dq += dS k reads k's B fragments one row (key) off: rows 8kk + 2t + 1 and + 2
    "f32_bwd_dq_k_row_off_by_one": (BWD, BOTH_BWD, [(F32_DQ_K, F32_DQ_K.replace("k_st,", "k_st + F32Tile<D>::kPitch,"),
                                                     1)], ("float32",)),
    "f32_bwd_delta_dropped": (BWD, BOTH_BWD, [F32_DK_DS, F32_DQ_DS], ("float32",)),
    # the dq pass's key mask on the last stage dropped: a key past n_k has a zero row of k, so its P meets a zero in
    # dq += dS k, and only the checks whose every score is below -128 (log2 domain) show the P that overflows to inf
    "f32_bwd_dq_mask_dropped": (BWD, BOTH_BWD, [(F32_DQ_MASK, "s[i] = exp2_ftz(", 1)], ("float32",)),
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
runs = [(dtype, fn, shape, q_scale, False) for dtype in dtypes for fn, (shape, q_scale) in runs]
if "backward" in which and torch.float32 in dtypes:  # every score near -LOW_SCORES: the f32 dq pass's key mask
    runs.append((torch.float32, cs.check_attention_bwd, cs.RAGGED[2], 1.0, True))
caught = []
for dtype, fn, shape, q_scale, low in runs:
    try:
        fn(*shape, dtype, gen, False, q_scale=q_scale, **({"low_scores": True} if low else {}))
    except SystemExit:
        caught.append([fn.__name__, *shape, q_scale, str(dtype), low])
heads_runs = [(cs.FINETUNE_HEADS, 1.0, "kvhalf"), (cs.EVAL_HEADS, 1.0, "kvhalf"), (cs.FINETUNE_HEADS, sharp, "kvhalf"),
              *((shape, 1.0, layout) for shape, layout in cs.HEADS_RAGGED if shape[1] > 1)]
for name, fn in (("heads_forward", cs.check_heads), ("heads_backward", cs.check_heads_bwd)):
    if name not in which:
        continue
    for dtype in dtypes:
        cases = [(*run, False) for run in heads_runs]
        if name == "heads_backward" and dtype == torch.float32:  # every score near -LOW_SCORES
            cases.append((cs.HEADS_RAGGED[1][0], 1.0, cs.HEADS_RAGGED[1][1], True))
        for shape, q_scale, layout, low in cases:
            runs.append(None)
            try:
                fn(*shape, dtype, gen, False, q_scale=q_scale, layout=layout, low_scores=low)
            except SystemExit:
                caught.append([fn.__name__, *shape, q_scale, layout, str(dtype), low])
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
    parser.add_argument("--prefix", default="", help="plant only the faults whose names start with this (and none)")
    args = parser.parse_args()
    ok = True
    summary = {}
    for name, (_, kernels, *_) in FAULTS.items():
        which = [k for k in kernels if args.only in (None, k)]
        if not which or not (name == "none" or name.startswith(args.prefix)):
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
