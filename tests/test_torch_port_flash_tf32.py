"""The f32 flash-attention forward's arithmetic, split TF32, emulated in torch on the CPU.

The kernel (``flash_fwd_tf32x3`` of ``cinema_tpu_torch/csrc/flash_attention_fwd.cu``) runs on the card
only. Its numbers are emulated here: TF32 by masking the low 13 mantissa bits of an f32; each operand
x split into hi = x rounded to TF32 (``cvt.rna``: half a TF32 ulp added to the magnitude, then
masked) and lo = x - hi, which the tensor core reads truncated (as measured on an H100); each product
as a_lo b_hi + a_hi b_lo + a_hi b_hi, one ``mma.sync`` of eight k columns at a time, whose sum the
tensor core cuts toward zero to f32 (as ``tf32_probe`` measured it), over ``kStepsPerSum``
(``csrc/tf32.cuh``) k-steps from zero before f32 additions add those sums. At a reduced sharp shape
(q scaled by chip_smoke's ``SHARP_Q``) the three passes stay within chip_smoke's f32 gate
(``ATOL_F32``) of the float64 attention, and one pass, or a lo formed as the residual of the
truncated x, do not.

The emulation (``tf32``, ``product``, ``constexpr_int``) also serves the backward's test,
``test_torch_port_flash_bwd_tf32.py``.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

_ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
ATOL_F32, SHARP_Q = chip_smoke.ATOL_F32, chip_smoke.SHARP_Q
LOG2E = 1.4426950408889634


def constexpr_int(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in a kernel source of the port (``csrc/<source>``)."""
    text = (_ROOT / "cinema_tpu_torch" / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def tf32(x: torch.Tensor, nearest: bool) -> torch.Tensor:
    """x with its low 13 mantissa bits dropped (toward zero), or first rounded to nearest, ties away."""
    bits = x.view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, cut toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _mma(c: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """c (..., M, N) f32 plus the sum over the last axis of ``terms`` (..., M, N, 8), the exact products, as the
    tensor core gives it: the exact sum cut toward zero to f32."""
    return _toward_zero(c.double() + terms.sum(-1))


def product(a: torch.Tensor, b: torch.Tensor, variant: str, steps) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as the kernels (``three_passes``) or a fault of them compute it on the
    tensor cores: eight k columns an ``mma``, the tensor core's sum moved to an f32 one every ``steps`` k-steps
    (None: never, the whole depth in its accumulator)."""
    pad = -a.shape[-1] % 8
    a, b = torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, 0, 0, pad))
    a_hi, b_hi = tf32(a, True), tf32(b, True)
    if variant == "lo_from_truncated_x":
        a_lo, b_lo = a - tf32(a, False), b - tf32(b, False)
    else:
        a_lo, b_lo = a - a_hi, b - b_hi
    a_lo, b_lo = tf32(a_lo, False), tf32(b_lo, False)
    passes = [(a_hi, b_hi)] if variant == "one_pass" else [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    shape = (*a.shape[:-1], b.shape[-1])
    total, part = torch.zeros(shape), torch.zeros(shape)
    for kk in range(a.shape[-1] // 8):
        if steps is not None and kk > 0 and kk % steps == 0:
            total, part = total + part, torch.zeros(shape)
        cols = slice(8 * kk, 8 * kk + 8)
        for x, y in passes:  # terms (..., M, N, 8): products of TF32 values, exact in float64
            part = _mma(part, x[..., :, None, cols].double() * y[..., cols, :].transpose(-1, -2)[..., None, :, :])
    return total + part


def _attention(q, k, v, variant: str) -> torch.Tensor:
    """(batch, heads, tokens, head_dim) f32: q scaled into the log2 domain, S and P v in split TF32."""
    steps = constexpr_int("tf32.cuh", "kStepsPerSum")
    s = product(q * (q.shape[-1] ** -0.5 * LOG2E), k.transpose(-1, -2), variant, steps)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    return product(p, v, variant, steps) / p.sum(-1, keepdim=True)


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
