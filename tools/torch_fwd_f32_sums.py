"""How often the f32 flash-attention forward should move the tensor core's sums to the CUDA cores (needs a card).

The tensor core rounds its sums toward zero, so ``flash_fwd_tf32x3`` (``cinema_tpu_torch/csrc/
flash_attention_fwd.cu``) lets it sum ``kStepsPerSum`` k-steps' products from zero and adds those sums on
the CUDA cores. For each value given, this copies ``cinema_tpu_torch/`` and ``chip_smoke.py`` into a
temporary directory, sets ``kStepsPerSum`` there, builds the copy into its own build directory and prints
one JSON line: ptxas's registers and spills at head_dim 64, the instruction counts of its machine code
(``cuobjdump``), the output's bias against the plain version (<o - plain, plain> / <plain, plain>) and
largest error at the pretraining decoder's and the serving shape, the largest error with sharp scores
(q x 4), the device time at (8, 2305^2) and (1, 2305^2) beside SDPA's (TF32 off), and the largest
gradient error, relative to each parameter's largest entry, of one f32 CineMA-base step at batch 2
(seeded weights and images) through the kernels against the plain attention path. The checkout itself
is never edited.

Usage (from the repository root):
    python3 tools/torch_fwd_f32_sums.py [1 2 4]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETTING = "constexpr int kStepsPerSum = 4;"
# runs in the copy
MEASURE = r'''
import collections, json, re, subprocess, sys
from pathlib import Path
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from cinema_tpu_torch import build
from cinema_tpu_torch.config import PACKAGED, from_dict
from cinema_tpu_torch.factory import get_mae_model, init_weights
from cinema_tpu_torch.models import vit
from cinema_tpu_torch.ops import flash_attention as fa
from cinema_tpu_torch.ops.masking import random_patch_mask

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build(["flash_attention_fwd"])
out = {}
function = ""
for line in build.build_logs["flash_attention_fwd"].splitlines():
    if "Compiling entry function" in line:
        function = line
    elif "tf32x3ILi64" in function and ("registers" in line or "spill" in line):
        out.setdefault("ptxas_d64", []).append(line.split(":", 1)[-1].strip())
sass = subprocess.run([str(Path(build.nvcc()).with_name("cuobjdump")), "--dump-sass",
                       str(build.library_path("flash_attention_fwd"))], capture_output=True, text=True, check=True).stdout
counts, function = collections.Counter(), ""
for line in sass.splitlines():
    if "Function :" in line:
        function = line
    elif "tf32x3ILi64" in function and (m := re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)):
        counts[m.group(1).split(".")[0]] += 1
out["sass_d64"] = dict(counts.most_common(12))
gen = torch.Generator(device="cuda").manual_seed(0)
for shape in [(16, 2305, 768, 512, 16), (8, 2305, 2305, 768, 12)]:
    q, k, v = cs._attention_inputs(*shape[:4], torch.float32, gen, 1.0)
    got, want = fa.flash_attention_packed(q, k, v, shape[4]), fa.flash_attention_packed_plain(q, k, v, shape[4])
    name = "x".join(map(str, shape[:3]))
    out[f"bias_{name}"] = ((got - want) * want).sum().item() / (want * want).sum().item()
    out[f"max_err_{name}"] = (got - want).abs().max().item()
q, k, v = cs._attention_inputs(8, 2305, 2305, 768, torch.float32, gen, cs.SHARP_Q)
out["max_err_sharp"] = (fa.flash_attention_packed(q, k, v, 12) - fa.flash_attention_packed_plain(q, k, v, 12)).abs().max().item()
for batch in (8, 1):
    q, k, v = cs._attention_inputs(batch, 2305, 2305, 768, torch.float32, gen, 1.0)
    qh, kh, vh = (x.unflatten(-1, (12, 64)).transpose(1, 2) for x in (q, k, v))
    out[f"device_ms_{batch}x2305"] = cs.device_ms(lambda: fa.flash_attention_packed(q, k, v, 12))
    out[f"sdpa_device_ms_{batch}x2305"] = cs.device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
config = from_dict(PACKAGED["mae"])
sizes = {v: tuple(config.data.sax.patch_size if v == "sax" else config.data.lax.patch_size)
         for v in config.model.views}
model = init_weights(get_mae_model(config, dtype=torch.float32, device="cuda"), seed=config.seed)
gen = torch.Generator(device="cuda").manual_seed(5)
batch = {v: torch.rand((2, *size, 1), generator=gen, device="cuda") for v, size in sizes.items()}
masks = {v: random_patch_mask(gen, 2, model.enc_down_dict[v].n_patches, 0.75, "cuda") for v in batch}
params = list(model.parameters())
grads = torch.autograd.grad(model(batch, 0.75, masks)[0], params)
with cs.swapped(vit, "flash_attention_packed_kv", fa.flash_attention_packed_kv_plain):
    plain = torch.autograd.grad(model(batch, 0.75, masks)[0], params)
out["mae_f32_grad_err"] = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()
                              for a, b in zip(grads, plain))
print("RESULT " + json.dumps(out), flush=True)
'''


def measure(steps: int) -> str:
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(ROOT / "cinema_tpu_torch", Path(d) / "cinema_tpu_torch")
        shutil.copy(ROOT / "chip_smoke.py", d)
        cu = Path(d) / "cinema_tpu_torch" / "csrc" / "flash_attention_fwd.cu"
        text = cu.read_text()
        if text.count(SETTING) != 1:
            raise RuntimeError(f"{SETTING!r} is not found once in {cu.name}")
        cu.write_text(text.replace(SETTING, f"constexpr int kStepsPerSum = {steps};"))
        env = dict(os.environ, CINEMA_TORCH_BUILD_DIR=str(Path(d) / "build"))
        proc = subprocess.run([sys.executable, "-c", MEASURE], cwd=d, env=env, capture_output=True, text=True)
    lines = [line[len("RESULT "):] for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"kStepsPerSum={steps}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    return lines[0]


def main() -> None:
    for steps in [int(x) for x in sys.argv[1:]] or [1, 2, 4]:
        print(f"kStepsPerSum={steps} {measure(steps)}", flush=True)


if __name__ == "__main__":
    main()
