"""Port parity of the per-head flash attention, (batch, tokens, heads, head_dim):
the port's plain forward and backward and its autograd Function against the JAX
Pallas ``flash_attention`` and ``jax.grad`` through it (interpret mode on the
CPU), f32.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds them
against ``flash_attention_plain`` and ``flash_attention_bwd_plain`` there. On
CPU tensors the Function takes those plain versions both ways, so these tests
pin the formulas the kernels implement. v is passed as the model passes it: a
strided view of the fused kv projection.

Tolerances: 2e-5 on the output and 3e-4 on the gradients (f32 on both sides;
the summation order differs, and the Pallas kernel corrects the mass of its
padded keys in closed form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu_torch.ops import flash_attention as fa
from cinema_tpu_torch.ops.attention import dot_product_attention

ATOL, GRAD_ATOL = 2e-5, 3e-4

# (n_q, n_k, heads, head_dim): the JAX tests' own shapes, cross-attention and ragged lengths
SHAPES = [(256, 256, 4, 32), (200, 200, 3, 64), (130, 300, 2, 64), (129, 77, 4, 32)]
IDS = ["aligned", "ragged", "cross-ragged", "cross-short-keys"]


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(n_q, n_k, heads, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, n_q, heads, d)).astype(np.float32)
    k = rng.normal(size=(2, n_k, heads, d)).astype(np.float32)
    kv = rng.normal(size=(2, n_k, 2 * heads * d)).astype(np.float32)
    w = rng.normal(size=(2, n_q, heads, d)).astype(np.float32)
    return q, k, kv, w


def _v_of(kv_t, heads):
    """v as the model's per-head path takes it: the strided v half of the fused projection."""
    return fa.split_kv(kv_t, heads)[1]


def _jax_out_and_grads(q, k, v, w):
    from cinema_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

    out = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda q, k, v: jnp.sum(jax_flash(q, k, v) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n_q,n_k,heads,d", SHAPES, ids=IDS)
def test_plain_forward_and_backward_match_pallas(n_q, n_k, heads, d):
    q, k, kv, w = _inputs(n_q, n_k, heads, d)
    kv_t = torch.from_numpy(kv)
    v_t = _v_of(kv_t, heads)
    assert not v_t.is_contiguous() and v_t.stride(1) == 2 * heads * d
    want_out, want = _jax_out_and_grads(q, k, v_t.numpy(), w)
    q_t, k_t = torch.from_numpy(q), torch.from_numpy(k)
    out = fa.flash_attention_plain(q_t, k_t, v_t)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=0)
    for g, w_ in zip(fa.flash_attention_bwd_plain(q_t, k_t, v_t, out, torch.from_numpy(w)), want):
        np.testing.assert_allclose(g.numpy(), w_, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("n_q,n_k,heads,d", SHAPES, ids=IDS)
def test_function_matches_pallas_and_returns_the_gradient_of_kv_in_one_buffer(n_q, n_k, heads, d):
    q, k, kv, w = _inputs(n_q, n_k, heads, d, seed=1)
    kv_t = torch.from_numpy(kv).requires_grad_()
    q_t, k_t = torch.from_numpy(q).requires_grad_(), torch.from_numpy(k).requires_grad_()
    k_half, v_t = fa.split_kv(kv_t, heads)
    want_out, want = _jax_out_and_grads(q, k, v_t.detach().numpy(), w)
    reused = fa.split_kv.reused
    out = fa.flash_attention(q_t, k_t, v_t)
    assert "HeadsAttention" in type(out.grad_fn).__name__ and out.is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(q_t.grad.numpy(), want[0], atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(k_t.grad.numpy(), want[1], atol=GRAD_ATOL, rtol=0)
    grad_kv = kv_t.grad.view(2, n_k, 2, heads, d)
    np.testing.assert_allclose(grad_kv[:, :, 1].numpy(), want[2], atol=GRAD_ATOL, rtol=0)
    # the k half of kv was not used: its gradient is zero, and dv's buffer was taken over as kv's gradient
    assert not grad_kv[:, :, 0].any() and fa.split_kv.reused == reused + 1


@pytest.mark.parametrize("n_q,n_k,heads,d", [*SHAPES, (1, 1, 2, 32), (5, 3, 2, 32)], ids=[*IDS, "one-token", "few"])
def test_function_backward_is_the_plain_backward_and_autograd_of_the_plain_forward(n_q, n_k, heads, d):
    q, k, kv, w = _inputs(n_q, n_k, heads, d, seed=2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, kv)]
    q_t, k_t, kv_t = leaves
    v_t = _v_of(kv_t, heads)
    got = torch.autograd.grad(fa.flash_attention(q_t, k_t, v_t), leaves, torch.from_numpy(w))
    out = fa.flash_attention_plain(q_t, k_t, v_t)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(w))
    plain = fa.flash_attention_bwd_plain(q_t.detach(), k_t.detach(), v_t.detach(), out.detach(), torch.from_numpy(w))
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert torch.equal(got[2].view(2, n_k, 2, heads, d)[:, :, 1], plain[2])
    for g, a in zip(got, auto):
        torch.testing.assert_close(g, a, atol=ATOL, rtol=0)


def test_transposed_views_and_no_grad_path():
    q, k, kv, _ = _inputs(33, 47, 2, 32, seed=3)
    q_t, k_t = torch.from_numpy(q), torch.from_numpy(k)
    v_t = _v_of(torch.from_numpy(kv), 2)
    want = fa.flash_attention_plain(q_t, k_t, v_t)
    # (batch, heads, tokens, head_dim) storage read through a transposed view
    q_bhtd = q_t.transpose(1, 2).contiguous().transpose(1, 2)
    assert not q_bhtd.is_contiguous()
    assert torch.equal(fa.flash_attention(q_bhtd, k_t, v_t), want)
    assert torch.equal(dot_product_attention(q_t, k_t, v_t), want)
    assert fa.flash_attention(q_t, k_t, v_t).grad_fn is None


def test_lse_plain_is_log2_of_the_softmax_denominator():
    q, k, _, _ = _inputs(9, 13, 2, 32, seed=4)
    q_t, k_t = torch.from_numpy(q), torch.from_numpy(k)
    scores = torch.einsum("bqhd,bkhd->bhqk", q_t, k_t) * 32**-0.5
    want = torch.log2(torch.exp(scores).sum(-1))
    torch.testing.assert_close(fa.flash_attention_lse_plain(q_t, k_t), want, atol=1e-5, rtol=0)


def test_wrapper_raises_on_what_it_does_not_take():
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="batch, tokens, heads, head_dim"):
        fa.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="Incompatible shapes"):
        fa.flash_attention(q, q, torch.zeros(1, 5, 2, 32))
    with pytest.raises(ValueError, match="kv must be"):
        fa.split_kv(torch.zeros(1, 4, 30), 4)
    # what the CUDA launch checks, on any device: dtype, alignment, head_dim
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_forward(q, q, q, save_lse=False)
    assert fa._kernel_ready(q) and not fa._kernel_ready(q[..., 1:]) and not fa._kernel_ready(q.transpose(2, 3))
