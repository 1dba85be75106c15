"""Tests of the port that need the card: the CUDA kernels have no CPU or interpret mode.

Run them on a machine with a CUDA device and nvcc:
``python -m pytest tests/test_torch_port_gpu.py -m gpu``. This file imports the port
and torch only. ``chip_smoke.py`` holds the same kernels against their plain versions
at the main paths' shapes.
"""

import numpy as np
import pytest
import torch

from cinema_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_per_head_kernels_agree_with_their_plain_versions(card, dtype, atol):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 130, 2, 64)).astype(np.float32)).to(card, dtype).requires_grad_()
    k = torch.from_numpy(rng.normal(size=(2, 77, 2, 64)).astype(np.float32)).to(card, dtype).requires_grad_()
    kv = torch.from_numpy(rng.normal(size=(2, 77, 256)).astype(np.float32)).to(card, dtype).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 130, 2, 64)).astype(np.float32)).to(card, dtype)
    v = fa.split_kv(kv, 2)[1]
    before = (fa.flash_attention.launches, fa.flash_attention.bwd_launches)
    out = fa.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, kv), g)
    assert (fa.flash_attention.launches, fa.flash_attention.bwd_launches) == (before[0] + 1, before[1] + 1)
    want_out = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol, rtol=0)
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), want_out.detach(), g)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=0)
    torch.testing.assert_close(got[1].float(), want[1].float(), atol=atol, rtol=0)
    torch.testing.assert_close(got[2].view(2, 77, 2, 2, 64)[:, :, 1].float(), want[2].float(), atol=atol, rtol=0)


@pytest.mark.gpu
def test_a_cuda_tensor_the_kernel_does_not_take_raises(card):
    q = torch.zeros(1, 8, 2, 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_packed_backward_at_a_ragged_shape_agrees_with_its_plain_version(card, dtype, atol):
    """dq, dk, dv of the packed kernels at n_q = 129, n_k = 200 (ragged last tiles of both passes),
    head_dim 32, with k and v the column halves of a fused kv projection."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 129, 512)).astype(np.float32)).to(card, dtype).requires_grad_()
    kv = torch.from_numpy(rng.normal(size=(2, 200, 1024)).astype(np.float32)).to(card, dtype).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 129, 512)).astype(np.float32)).to(card, dtype)
    before = fa.flash_attention_packed.bwd_launches
    out = fa.flash_attention_packed_kv(q, kv, 16)
    dq, dkv = torch.autograd.grad(out, (q, kv), g)
    assert fa.flash_attention_packed.bwd_launches == before + 1
    want = fa.flash_attention_packed_bwd_plain(q.detach(), kv[..., :512].detach(), kv[..., 512:].detach(),
                                               out.detach(), g, 16)
    torch.testing.assert_close(dq.float(), want[0].float(), atol=atol, rtol=0)
    torch.testing.assert_close(dkv[..., :512].float(), want[1].float(), atol=atol, rtol=0)
    torch.testing.assert_close(dkv[..., 512:].float(), want[2].float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", ["packed", "bhtd"])
def test_forward_at_a_ragged_cross_shape_agrees_with_its_plain_version(card, dtype, atol, layout):
    """The forward of both layouts at ragged cross shapes: packed n_q = 129, n_k = 200, head_dim 32, with
    k and v the column halves of a fused kv projection; per-head n_q = 130, n_k = 77, head_dim 64, every
    operand read through a (batch, heads, tokens, head_dim) transpose. The output is the same with and
    without the saved log-sum-exp, and the log-sum-exp is held to its plain version (atol 1e-3)."""
    rng = np.random.default_rng(7)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card, dtype)

    if layout == "packed":
        q, kv = tensor(2, 129, 512), tensor(2, 200, 1024)
        k, v = kv[..., :512], kv[..., 512:]
        counter = fa.flash_attention_packed
        before = counter.launches
        out = fa.flash_attention_packed(q, k, v, 16)
        out_lse, lse = fa.flash_attention_packed_forward(q, k, v, 16, save_lse=True)
        want, want_lse = fa.flash_attention_packed_plain(q, k, v, 16), fa.flash_attention_packed_lse_plain(q, k, 16)
    else:
        q, k, v = (tensor(2, 12, n, 64).transpose(1, 2) for n in (130, 77, 77))
        counter = fa.flash_attention
        before = counter.launches
        out = fa.flash_attention(q, k, v)
        out_lse, lse = fa.flash_attention_forward(q, k, v, save_lse=True)
        want, want_lse = fa.flash_attention_plain(q, k, v), fa.flash_attention_lse_plain(q, k)
    assert counter.launches == before + 2
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(out, out_lse)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
