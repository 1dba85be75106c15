"""Planted-fault check of chip_smoke.py's attention-kernel gate (needs a CUDA card).

For each fault below, copies ``cinema_tpu_torch/`` and ``chip_smoke.py`` into
a temporary directory, edits the bf16 path of
``csrc/flash_attention_packed.cu`` there, builds that copy into its own build
directory and runs chip_smoke's bf16 kernel checks on it. The unedited copy
("none") must pass every check; each fault must fail at least one. The
checkout itself is never edited.

Usage (from the repository root):
    python3 tools/torch_kernel_fault_check.py

Prints one line per check and a summary line per fault; exits non-zero if
the unedited kernel fails or a fault goes uncaught.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOOP = "for (int k0 = 0; k0 < n_k; k0 += kBlockK) {"
# fault -> (text, replacement) edits of the bf16 kernel
FAULTS = {
    "none": [],
    "skip_last_key_tile": [(LOOP, "for (int k0 = 0; k0 + kBlockK < n_k; k0 += kBlockK) {")],
    "skip_key_tile_10": [(LOOP, LOOP + "\n    if (k0 == 10 * kBlockK) continue;")],
    "scale_plus_3pct": [("s[nt][j] * scale_log2", "s[nt][j] * (scale_log2 * 1.03f)")],
    "mask_last_key": [("s[nt][j] = key < n_k ?", "s[nt][j] = key < n_k - 1 ?")],
}
# runs in the copy: chip_smoke's bf16 checks, one per shape, counting failures
CHECKS = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
gen = torch.Generator(device="cuda").manual_seed(0)
shapes = [(8, 2305, 2305, 768, 12, 1.0), (8, 2305, 2305, 768, 12, cs.SHARP_Q), (2, 2305, 769, 512, 16, 1.0),
          (2, 127, 127, 768, 12, 1.0), (2, 129, 129, 768, 12, 1.0), (2, 129, 200, 512, 16, 1.0)]
caught = []
for b, nq, nk, e, h, s in shapes:
    try:
        cs.check_attention(b, nq, nk, e, h, torch.bfloat16, gen, False, q_scale=s)
    except SystemExit:
        caught.append([b, nq, nk, e, h, s])
print("CAUGHT " + json.dumps(caught), flush=True)
'''


def run_fault(name: str, edits: list[tuple[str, str]]) -> int:
    """Number of checks that failed on the copy with these edits."""
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(ROOT / "cinema_tpu_torch", Path(d) / "cinema_tpu_torch")
        shutil.copy(ROOT / "chip_smoke.py", d)
        cu = Path(d) / "cinema_tpu_torch" / "csrc" / "flash_attention_packed.cu"
        text = cu.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not found exactly once in the kernel source")
            text = text.replace(old, new)
        cu.write_text(text)
        env = dict(os.environ, CINEMA_TORCH_BUILD_DIR=str(Path(d) / "build"))
        proc = subprocess.run([sys.executable, "-c", CHECKS], cwd=d, env=env, capture_output=True, text=True)
    print(proc.stdout, end="", flush=True)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("CAUGHT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{name}: the checks did not run to the end (rc {proc.returncode})\n{proc.stderr[-3000:]}")
    return len(json.loads(lines[0][len("CAUGHT "):]))


def main() -> None:
    ok = True
    for name, edits in FAULTS.items():
        caught = run_fault(name, edits)
        verdict = "pass" if (caught == 0) == (name == "none") else "WRONG"
        ok &= verdict == "pass"
        print(f"fault {name}: {caught} checks failed ({verdict})", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
