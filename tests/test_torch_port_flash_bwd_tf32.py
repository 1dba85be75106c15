"""The f32 flash-attention backward's arithmetic, split TF32, emulated in torch on the CPU.

The kernels (``flash_bwd_dkdv_tf32x3`` and ``flash_bwd_dq_tf32x3`` of ``cinema_tpu_torch/csrc/
flash_attention_bwd.cu``) run on the card only. Their numbers are emulated here: TF32 by masking the low 13
mantissa bits of an f32; each operand x split into hi = x rounded to TF32 (half a TF32 ulp added to the
magnitude, then masked) and lo = x - hi, which the tensor core reads truncated; each product as
a_lo b_hi + a_hi b_lo + a_hi b_hi, one ``mma.sync`` of eight k columns at a time, whose sum the tensor core
cuts toward zero to f32 (as ``tf32_probe`` measured it on an H100; this model gives the ~2e-5 relative bias
that the f32 forward showed on the card with its sums over a whole 2305-key panel). As the kernels do, the
tensor core sums ``kBwdStepsPerSum`` (read from the source) k-steps from zero and f32 additions (to nearest)
add those sums; the emulation is ``test_torch_port_flash_tf32.py``'s, shared with the forward's test. Both
passes are emulated as the kernels order them: k (or q) scaled into the log2 domain, P = exp2(S - lse) from
the forward's row log-sum-exp, dS = P (dP - delta) with delta = rowsum(g o), dv = P^T g, dk = dS^T q / sqrt(d),
dq = dS k / sqrt(d).

At a reduced sharp shape (q scaled by chip_smoke's ``SHARP_Q``) three passes with sums every stage keep
dq, dk and dv within chip_smoke's f32 gate (``ATOL_F32``, relative once a gradient exceeds 1) of float64
gradients, and one pass, or a lo formed as the residual of the truncated x, do not. Sums left in the tensor
core's accumulator over a whole panel stay within that gate, but over the 2305 q rows or keys of a
fine-tuning panel (one warp's 16 rows of each pass) they bias every gradient toward zero by more than 1e-5 of
its size, as they biased the forward: the drift that took an f32 training step's gradients past their gate.
The emulated gradients are also held to the JAX package's own backward (``jax.grad`` through the Pallas
kernel in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_flash_tf32 import ATOL_F32, LOG2E, SHARP_Q, constexpr_int, product

STEPS_PER_SUM = constexpr_int("flash_attention_bwd.cu", "kBwdStepsPerSum")


def _backward(q, k, v, g, variant: str, steps, rows=slice(None)):
    """(dq, dk, dv) of softmax(q k^T / sqrt(d)) v for output gradient g, (batch, heads, tokens, head_dim) f32, as
    the kernels' two passes compute them from the forward's row log-sum-exp and output (float64, rounded), for
    the q rows and keys ``rows``."""
    scale = q.shape[-1] ** -0.5
    s64 = q.double() @ k.double().transpose(-1, -2) * scale
    lse = (torch.logsumexp(s64, -1) * LOG2E).float()
    out = (torch.softmax(s64, -1) @ v.double()).float()
    delta = (g * out).sum(-1)
    # dk, dv: S^T = (k scaled) q^T, one row a key
    kr, vr = k[..., rows, :], v[..., rows, :]
    p_t = torch.exp2(product(kr * (scale * LOG2E), q.transpose(-1, -2), variant, steps) - lse[..., None, :])
    ds_t = p_t * (product(vr, g.transpose(-1, -2), variant, steps) - delta[..., None, :])
    dv = product(p_t, g, variant, steps)
    dk = product(ds_t, q, variant, steps) * scale
    # dq: S = (q scaled) k^T, one row a q row
    qr, gr = q[..., rows, :], g[..., rows, :]
    p = torch.exp2(product(qr * (scale * LOG2E), k.transpose(-1, -2), variant, steps) - lse[..., rows, None])
    ds = p * (product(gr, v.transpose(-1, -2), variant, steps) - delta[..., rows, None])
    dq = product(ds, k, variant, steps) * scale
    return dq, dk, dv


def _inputs(n: int, head_dim: int, q_scale: float):
    rng = np.random.default_rng(13)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(1, 2, n, head_dim)).astype(np.float32)) for _ in range(4))
    return q * q_scale, k, v, g


def _exact(q, k, v, g, rows=slice(None)):
    """float64 gradients of sum(attention(q, k, v) * g) from the same f32 inputs, for the q rows and keys ``rows``."""
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    out = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, -1) @ v
    return [x[..., rows, :] for x in torch.autograd.grad((out * g.double()).sum(), (q, k, v))]


def _worst(got, want) -> float:
    """The largest error of the three gradients over chip_smoke's f32 gate (within where <= 1)."""
    return max((a.double() - b).abs().max().item() / (ATOL_F32 * max(1.0, b.abs().max().item()))
               for a, b in zip(got, want))


@pytest.mark.parametrize("variant,head_dim,within", [
    ("three_passes", 64, True), ("three_passes", 32, True), ("one_pass", 64, False),
    ("lo_from_truncated_x", 64, False),
], ids=["three_passes-d64", "three_passes-d32", "one_pass", "lo_from_truncated_x"])
def test_three_tf32_passes_keep_the_f32_gate_and_one_pass_does_not(variant, head_dim, within):
    q, k, v, g = _inputs(257, head_dim, SHARP_Q)
    ratio = _worst(_backward(q, k, v, g, variant, STEPS_PER_SUM), _exact(q, k, v, g))
    assert (ratio <= 1.0) == within, ratio


@pytest.mark.parametrize("steps,biased", [(STEPS_PER_SUM, False), (None, True)], ids=["every_8_k_steps", "whole_panel"])
def test_sums_over_the_whole_panel_bias_the_gradients_toward_zero(steps, biased):
    q, k, v, g = _inputs(2305, 64, 1.0)
    rows = slice(0, 16)  # one warp's keys in the dk/dv pass and q rows in the dq pass, against all 2305
    got, want = _backward(q, k, v, g, "three_passes", steps, rows), _exact(q, k, v, g, rows)
    assert _worst(got, want) <= 1.0
    bias = [((a.double() - b) * b).sum().item() / (b * b).sum().item() for a, b in zip(got, want)]
    if biased:
        assert all(b < 0 for b in bias), bias
    assert (max(abs(b) for b in bias) > 1e-5) == biased, bias


@pytest.fixture
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("head_dim", [64, 32])
def test_emulated_gradients_match_the_jax_backward(_interpret_mode, head_dim):
    from cinema_tpu.ops.pallas.flash_attention import flash_attention_packed

    q, k, v, g = _inputs(257, head_dim, SHARP_Q)
    packed = [x.transpose(1, 2).flatten(2).numpy() for x in (q, k, v, g)]  # (batch, tokens, heads * head_dim)

    def loss(q, k, v):
        return jnp.sum(flash_attention_packed(q, k, v, 2) * packed[3])

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in packed[:3]))
    want = [torch.from_numpy(np.asarray(x)).unflatten(-1, (2, head_dim)).transpose(1, 2).double() for x in want]
    assert _worst(_backward(q, k, v, g, "three_passes", STEPS_PER_SUM), want) <= 1.0
