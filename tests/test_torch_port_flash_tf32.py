"""The f32 flash-attention forward's arithmetic, split TF32, emulated in torch on the CPU.

The kernel (``flash_fwd_tf32x3`` of ``cinema_tpu_torch/csrc/flash_attention_fwd.cu``) runs on the card
only. Its numbers are emulated here: TF32 by masking the low 13 mantissa bits of an f32; each operand
x split into hi = x rounded to TF32 (``cvt.rna``: half a TF32 ulp added to the magnitude, then
masked) and lo = x - hi, which the tensor core reads truncated (as measured on an H100); each product
as a_lo b_hi + a_hi b_lo + a_hi b_hi in f32. At a reduced sharp shape (q scaled by chip_smoke's
``SHARP_Q``) the three passes stay within chip_smoke's f32 gate (``ATOL_F32``) of the float64
attention, and one pass, or a lo formed as the residual of the truncated x, do not.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

_SPEC = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
ATOL_F32, SHARP_Q = chip_smoke.ATOL_F32, chip_smoke.SHARP_Q
_LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor, nearest: bool) -> torch.Tensor:
    """x with its low 13 mantissa bits dropped (toward zero), or first rounded to nearest, ties away."""
    bits = x.view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, variant: str) -> torch.Tensor:
    """a @ b as the kernel (``three_passes``) or a fault of it computes it on the tensor cores."""
    a_hi, b_hi = _tf32(a, True), _tf32(b, True)
    if variant == "one_pass":
        return a_hi @ b_hi
    if variant == "lo_from_truncated_x":
        a_lo, b_lo = a - _tf32(a, False), b - _tf32(b, False)
    else:
        a_lo, b_lo = a - a_hi, b - b_hi
    return _tf32(a_lo, False) @ b_hi + a_hi @ _tf32(b_lo, False) + a_hi @ b_hi


def _attention(q, k, v, variant: str) -> torch.Tensor:
    """(batch, heads, tokens, head_dim) f32: q scaled into the log2 domain, S and P v in split TF32."""
    s = _product(q * (q.shape[-1] ** -0.5 * _LOG2E), k.transpose(-1, -2), variant)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    return _product(p, v, variant) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("variant,within", [("three_passes", True), ("one_pass", False),
                                            ("lo_from_truncated_x", False)])
def test_three_tf32_passes_keep_the_f32_gate_and_one_pass_does_not(variant, within):
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 257, 64)).astype(np.float32)) for _ in range(3))
    q = q * SHARP_Q
    want = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 8.0, -1) @ v.double()
    err = (_attention(q, k, v, variant).double() - want).abs().max().item()
    assert (err <= ATOL_F32) == within, err
    if within:  # as close as a plain f32 softmax(q k^T / 8) v
        plain = torch.softmax(q @ k.transpose(-1, -2) / 8.0, -1) @ v
        assert err <= 4 * (plain.double() - want).abs().max().item()
