"""Port parity of the packed flash-attention backward: the port's autograd
Function and its plain backward against ``jax.grad`` through the JAX Pallas
kernel (interpret mode on the CPU), f32.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against ``flash_attention_packed_bwd_plain`` there. On CPU tensors the
Function's backward is that plain version, so these tests pin the formula
the kernel implements (recompute P, delta = rowsum(g * out), f32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu_torch import trace
from cinema_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5  # f32 on both sides; only the summation order differs

SHAPES = [(200, 200, 32, 2), (129, 129, 64, 2), (200, 77, 32, 2), (130, 300, 64, 2)]
IDS = ["self-d16", "self-d32-ragged", "cross-d16", "cross-d32-ragged"]
# against torch autograd also one query and one key, where dq and dk are exactly zero
# (the Pallas kernel's closed-form correction for 127 padded keys leaves ~2e-5 there)
AUTOGRAD_SHAPES = [*SHAPES, (1, 1, 32, 2), (5, 3, 32, 2)]
AUTOGRAD_IDS = [*IDS, "one-token", "few-tokens"]


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(n_q, n_k, embed, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, n_q, embed)).astype(np.float32)
    kv = rng.normal(size=(2, n_k, 2 * embed)).astype(np.float32)
    w = rng.normal(size=(2, n_q, embed)).astype(np.float32)
    return q, kv, w


def _jax_grads(q, kv, w, n_heads):
    from cinema_tpu.ops.pallas.flash_attention import flash_attention_packed as jax_packed

    embed = q.shape[-1]

    def loss(q, k, v):
        return jnp.sum(jax_packed(q, k, v, n_heads) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(kv[..., :embed]), jnp.asarray(kv[..., embed:]))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n_q,n_k,embed,n_heads", SHAPES, ids=IDS)
def test_function_backward_matches_pallas_grad(n_q, n_k, embed, n_heads):
    q, kv, w = _inputs(n_q, n_k, embed)
    want = _jax_grads(q, kv, w, n_heads)
    q_t = torch.from_numpy(q).requires_grad_()
    kv_t = torch.from_numpy(kv).requires_grad_()
    # k, v as strided column slices of the fused kv projection, as the model passes them
    out = fa.flash_attention_packed(q_t, kv_t[..., :embed], kv_t[..., embed:], n_heads)
    assert out.grad_fn is not None and "PackedAttention" in type(out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(q_t.grad.numpy(), want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kv_t.grad[..., :embed].numpy(), want[1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kv_t.grad[..., embed:].numpy(), want[2], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_q,n_k,embed,n_heads", SHAPES, ids=IDS)
def test_fused_kv_function_matches_pallas_grad(n_q, n_k, embed, n_heads):
    q, kv, w = _inputs(n_q, n_k, embed, seed=1)
    want = _jax_grads(q, kv, w, n_heads)
    q_t = torch.from_numpy(q).requires_grad_()
    kv_t = torch.from_numpy(kv).requires_grad_()
    out = fa.flash_attention_packed_kv(q_t, kv_t, n_heads)
    assert "FusedKV" in type(out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(q_t.grad.numpy(), want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kv_t.grad.numpy(), np.concatenate(want[1:], axis=-1), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_q,n_k,embed,n_heads", SHAPES, ids=IDS)
def test_plain_backward_matches_pallas_grad(n_q, n_k, embed, n_heads):
    q, kv, w = _inputs(n_q, n_k, embed, seed=2)
    want = _jax_grads(q, kv, w, n_heads)
    q_t, kv_t = torch.from_numpy(q), torch.from_numpy(kv)
    k_t, v_t = kv_t[..., :embed], kv_t[..., embed:]
    out = fa.flash_attention_packed_plain(q_t, k_t, v_t, n_heads)
    got = fa.flash_attention_packed_bwd_plain(q_t, k_t, v_t, out, torch.from_numpy(w), n_heads)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_q,n_k,embed,n_heads", AUTOGRAD_SHAPES, ids=AUTOGRAD_IDS)
def test_plain_backward_matches_autograd_of_plain_forward(n_q, n_k, embed, n_heads):
    q, kv, w = _inputs(n_q, n_k, embed, seed=3)
    q_t = torch.from_numpy(q).requires_grad_()
    k_t = torch.from_numpy(kv[..., :embed].copy()).requires_grad_()
    v_t = torch.from_numpy(kv[..., embed:].copy()).requires_grad_()
    out = fa.flash_attention_packed_plain(q_t, k_t, v_t, n_heads)
    want = torch.autograd.grad(out, (q_t, k_t, v_t), torch.from_numpy(w))
    got = fa.flash_attention_packed_bwd_plain(q_t.detach(), k_t.detach(), v_t.detach(), out.detach(), torch.from_numpy(w), n_heads)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=ATOL, rtol=0)


def test_lse_plain_is_log2_of_the_softmax_denominator():
    q, kv, _ = _inputs(33, 20, 32, seed=4)
    q_t, k_t = torch.from_numpy(q), torch.from_numpy(kv[..., :32])
    lse = fa.flash_attention_packed_lse_plain(q_t, k_t, 2)
    assert lse.shape == (2, 2, 33) and lse.dtype == torch.float32
    scores = torch.einsum("bqhd,bkhd->bhqk", q_t.reshape(2, 33, 2, 16), k_t.reshape(2, 20, 2, 16)) / 4.0
    torch.testing.assert_close(torch.exp2(lse), scores.exp().sum(-1), rtol=1e-5, atol=0)


def test_only_needed_gradients_are_returned_and_cpu_counts_no_launch():
    q, kv, w = _inputs(9, 7, 32, seed=5)
    q_t = torch.from_numpy(q)
    kv_t = torch.from_numpy(kv).requires_grad_()
    packed = ("attention.packed.launches", "attention.packed.bwd_launches")
    before = tuple(map(trace.counter, packed))
    out = fa.flash_attention_packed_kv(q_t, kv_t, 2)
    (out * torch.from_numpy(w)).sum().backward()
    assert q_t.grad is None and kv_t.grad is not None
    assert tuple(map(trace.counter, packed)) == before
    with torch.no_grad():  # no gradient wanted: no Function, no saved tensors
        assert fa.flash_attention_packed_kv(q_t, kv_t, 2).grad_fn is None


def test_expanded_output_gradient_is_handled():
    """sum().backward() hands the Function a gradient with all strides 0."""
    q, kv, _ = _inputs(9, 7, 32, seed=6)
    q_t = torch.from_numpy(q).requires_grad_()
    fa.flash_attention_packed_kv(q_t, torch.from_numpy(kv), 2).sum().backward()
    q_p = torch.from_numpy(q).requires_grad_()
    fa.flash_attention_packed_kv_plain(q_p, torch.from_numpy(kv), 2).sum().backward()
    torch.testing.assert_close(q_t.grad, q_p.grad, atol=ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["kv-width", "kv-rank"])
def test_fused_kv_shape_errors(bad):
    q = torch.zeros(2, 8, 32)
    kv = torch.zeros(2, 8, 48) if bad == "kv-width" else torch.zeros(2, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_packed_kv(q, kv, 2)


def test_cuda_wrappers_raise_on_cpu_tensors():
    """The raw kernel wrappers never fall back: CPU tensors are refused before any build."""
    q = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_packed_forward(q, q, q, 2, save_lse=True)
    with pytest.raises(ValueError):
        fa.flash_attention_packed_backward(q, q, q, q, torch.zeros(1, 2, 4), q, 2)
