"""Port parity: the packed flash-attention plain version against the JAX
Pallas kernel (interpret mode on the CPU), and the wrapper's CPU dispatch.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu_torch import trace
from cinema_tpu_torch.ops.attention import dot_product_attention
from cinema_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_packed_plain

ATOL = 2e-5  # f32 on both sides; only summation order differs


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize(
    "n_q,n_k,embed,n_heads",
    [(200, 200, 32, 2), (129, 129, 64, 2), (200, 77, 32, 2), (130, 300, 64, 2)],
    ids=["self-d16", "self-d32", "cross-d16", "cross-d32"],
)
def test_packed_plain_matches_pallas(n_q, n_k, embed, n_heads):
    from cinema_tpu.ops.pallas.flash_attention import flash_attention_packed as jax_packed

    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, n_q, embed)).astype(np.float32)
    kv = rng.normal(size=(2, n_k, 2 * embed)).astype(np.float32)
    want = np.asarray(jax_packed(jnp.asarray(q), jnp.asarray(kv[..., :embed]), jnp.asarray(kv[..., embed:]), n_heads))
    kv_t = torch.from_numpy(kv)
    # k, v as strided column slices of the fused kv projection, as the model passes them
    got = flash_attention_packed(torch.from_numpy(q), kv_t[..., :embed], kv_t[..., embed:], n_heads)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        flash_attention_packed_plain(torch.from_numpy(q), kv_t[..., :embed], kv_t[..., embed:], n_heads).numpy(),
        want, atol=ATOL, rtol=0,
    )


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 33, 32)).astype(np.float32)) for _ in range(3))
    before = trace.counter("attention.packed.launches")
    out = flash_attention_packed(q, k, v, 2)
    assert trace.counter("attention.packed.launches") == before
    per_head = dot_product_attention(q.reshape(1, 33, 2, 16), k.reshape(1, 33, 2, 16), v.reshape(1, 33, 2, 16))
    torch.testing.assert_close(out, per_head.reshape(1, 33, 32), atol=ATOL, rtol=0)


def test_bf16_output_keeps_q_dtype():
    q = torch.randn(1, 5, 64, generator=torch.Generator().manual_seed(0)).bfloat16()
    assert flash_attention_packed(q, q, q, 2).dtype == torch.bfloat16


@pytest.mark.parametrize(
    "shapes,n_heads",
    [(((2, 8, 32), (2, 8, 16), (2, 8, 16)), 2), (((2, 8, 32), (2, 9, 32), (2, 8, 32)), 2), (((2, 8, 30),) * 3, 4)],
)
def test_shape_errors(shapes, n_heads):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        flash_attention_packed(q, k, v, n_heads)


def test_mixed_devices_raise():
    q = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError):
        flash_attention_packed(q, q.to("meta"), q, 2)
