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
