"""Settings of the split-TF32 flash-attention kernels, measured one against another (needs a card).

The tensor core rounds its sums toward zero, so the f32 forward (``flash_fwd_tf32x3``) and backward
(``flash_bwd_dkdv_tf32x3``, ``flash_bwd_dq_tf32x3``) let it sum a few k-steps' products from zero and add those
sums on the CUDA cores: ``kStepsPerSum`` (``cinema_tpu_torch/csrc/tf32.cuh``) k-steps in the forward,
``kBwdStepsPerSum`` (``csrc/flash_attention_bwd.cu``) in the backward. For each setting given, this copies
``cinema_tpu_torch/`` and ``chip_smoke.py`` into a temporary directory, sets those constants there, builds the
copy into its own build directory and prints one JSON line:

- ptxas's registers and spills of the direction's f32 functions, and the instruction counts of the head_dim-64
  machine code (``cuobjdump``; the dk/dv pass of the backward);
- the outputs' (forward) or each gradient's (backward) bias against the plain version
  (<got - plain, plain> / <plain, plain>) and largest error, also with sharp scores (q x 4);
- the device time at realistic shapes beside SDPA's (TF32 off): the forward at (8, 2305^2) and (1, 2305^2), the
  backward at (4, 2305^2), (16, 769^2), the pretraining decoder's (16, 2305 x 768, E 512) and (4, 577^2);
- the largest gradient error, relative to each parameter's largest entry, of one f32 CineMA-base step at batch 2
  (seeded weights and images) through the kernels against the plain attention path.

The checkout itself is never edited.

Usage (from the repository root); each setting is a comma-separated list of NAME=VALUE, "default" the source as
it is; with no setting, 1 and 2 k-steps a sum and the source's setting (and 4 for the backward):
    python3 tools/torch_f32_sums.py fwd [kStepsPerSum=2] ...
    python3 tools/torch_f32_sums.py bwd [default] [kBwdStepsPerSum=4] ...
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# direction -> (the source that holds its settings, the settings measured when none is given)
DIRECTIONS = {
    "fwd": ("tf32.cuh", ["kStepsPerSum=1", "kStepsPerSum=2", "default"]),
    "bwd": ("flash_attention_bwd.cu", ["kBwdStepsPerSum=1", "kBwdStepsPerSum=2", "kBwdStepsPerSum=4", "default"]),
}
# runs in the copy, with the direction as its argument
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
fwd = sys.argv[1] == "fwd"
library = "flash_attention_fwd" if fwd else "flash_attention_bwd"
build.build([library])
out = {"ptxas": {}}
function = ""
for line in build.build_logs[library].splitlines():
    if "Compiling entry function" in line:
        function = re.search(r"flash_\w+?ILi\d+", line).group(0) if "tf32x3" in line else ""
    elif function and ("registers" in line or "spill" in line):
        out["ptxas"].setdefault(function, []).append(line.split(":", 1)[-1].strip())
sass = subprocess.run([str(Path(build.nvcc()).with_name("cuobjdump")), "--dump-sass",
                       str(build.library_path(library))], capture_output=True, text=True, check=True).stdout
counts, function = collections.Counter(), ""
for line in sass.splitlines():
    if "Function :" in line:
        function = line
    elif ("fwd_tf32x3ILi64" if fwd else "dkdv_tf32x3ILi64") in function and (
            m := re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)):
        counts[m.group(1).split(".")[0]] += 1
out["sass_d64"] = dict(counts.most_common(12))


def bias(got, want):
    return ((got - want) * want).sum().item() / (want * want).sum().item()


gen = torch.Generator(device="cuda").manual_seed(0)
if fwd:
    for shape, q_scale in [(cs.TRAIN_DECODER, 1.0), ((8, 2305, 2305, 768, 12), 1.0), ((8, 2305, 2305, 768, 12), cs.SHARP_Q)]:
        q, k, v = cs._attention_inputs(*shape[:4], torch.float32, gen, q_scale)
        got, want = fa.flash_attention_packed(q, k, v, shape[4]), fa.flash_attention_packed_plain(q, k, v, shape[4])
        name = "x".join(map(str, shape[:3])) + ("_sharp" if q_scale != 1.0 else "")
        if q_scale == 1.0:
            out[f"bias_{name}"] = bias(got, want)
        out[f"max_err_{name}"] = (got - want).abs().max().item()
    for batch in (8, 1):
        q, k, v = cs._attention_inputs(batch, 2305, 2305, 768, torch.float32, gen, 1.0)
        qh, kh, vh = (x.unflatten(-1, (12, 64)).transpose(1, 2) for x in (q, k, v))
        out[f"device_ms_{batch}x2305"] = cs.device_ms(lambda: fa.flash_attention_packed(q, k, v, 12))
        out[f"sdpa_device_ms_{batch}x2305"] = cs.device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
else:
    for shape, q_scale in [(cs.FINETUNE_PACKED, 1.0), (cs.TRAIN_DECODER, 1.0), (cs.FINETUNE_PACKED, cs.SHARP_Q)]:
        q, k, v = cs._attention_inputs(*shape[:4], torch.float32, gen, q_scale)
        g = torch.randn(q.shape, device="cuda", generator=gen)
        o, lse = fa.flash_attention_packed_forward(q, k, v, shape[4], save_lse=True)
        got = fa.flash_attention_packed_backward(q, k, v, o, lse, g, shape[4])
        want = fa.flash_attention_packed_bwd_plain(q, k, v, o, g, shape[4])
        name = "x".join(map(str, shape[:3])) + ("_sharp" if q_scale != 1.0 else "")
        for grad, a, b in zip(("dq", "dk", "dv"), got, want):
            if q_scale == 1.0:
                out[f"bias_{grad}_{name}"] = bias(a, b)
            out[f"max_err_{grad}_{name}"] = (a - b).abs().max().item()
    for shape in (cs.FINETUNE_PACKED, cs.TRAIN_ENCODER, cs.TRAIN_DECODER, cs.MYOPS_PACKED):
        q, k, v = cs._attention_inputs(*shape[:4], torch.float32, gen, 1.0)
        g = torch.randn(q.shape, device="cuda", generator=gen)
        o, lse = fa.flash_attention_packed_forward(q, k, v, shape[4], save_lse=True)
        d = shape[3] // shape[4]
        qh, kh, vh = (x.unflatten(-1, (shape[4], d)).transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        gh = g.unflatten(-1, (shape[4], d)).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        name = "x".join(map(str, shape[:3]))
        out[f"device_ms_{name}"] = cs.device_ms(lambda: fa.flash_attention_packed_backward(q, k, v, o, lse, g, shape[4]))
        out[f"sdpa_device_ms_{name}"] = cs.device_ms(lambda: torch.autograd.grad(sdpa, (qh, kh, vh), gh, retain_graph=True))
        del sdpa
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


def edited(text: str, setting: str, source: str) -> str:
    """The source with each NAME=VALUE of ``setting`` replacing its ``constexpr int NAME = ...;`` line."""
    for item in [] if setting == "default" else setting.split(","):
        name, value = item.split("=")
        pattern = re.compile(rf"constexpr int {re.escape(name)} = [^;]+;")
        if len(pattern.findall(text)) != 1:
            raise RuntimeError(f"constexpr {name} is not found once in {source}")
        text = pattern.sub(f"constexpr int {name} = {value};", text)
    return text


def measure(direction: str, setting: str) -> tuple:
    """(the setting's JSON line, None), or (None, the error) where it did not build or run."""
    source = DIRECTIONS[direction][0]
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(ROOT / "cinema_tpu_torch", Path(d) / "cinema_tpu_torch")
        shutil.copy(ROOT / "chip_smoke.py", d)
        path = Path(d) / "cinema_tpu_torch" / "csrc" / source
        path.write_text(edited(path.read_text(), setting, source))
        env = dict(os.environ, CINEMA_TORCH_BUILD_DIR=str(Path(d) / "build"))
        proc = subprocess.run([sys.executable, "-c", MEASURE, direction], cwd=d, env=env, capture_output=True,
                              text=True)
    lines = [line[len("RESULT "):] for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        return None, f"rc {proc.returncode}: {proc.stderr[-3000:]}"
    return lines[0], None


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in DIRECTIONS:
        sys.exit(__doc__.rsplit("Usage", 1)[-1])
    direction = sys.argv[1]
    failed = False
    for setting in sys.argv[2:] or DIRECTIONS[direction][1]:
        result, error = measure(direction, setting)
        failed |= result is None
        print(f"{direction} {setting} {result if result is not None else 'FAILED ' + error}", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
