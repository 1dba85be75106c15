"""Packed multi-head flash attention: the CUDA kernel's wrapper and its plain version.

Replaces ``cinema_tpu/ops/pallas/flash_attention.py`` ``flash_attention_packed``
(forward, ``_packed_forward`` / ``_packed_fwd_kernel``). The kernel is
``csrc/flash_attention_packed.cu``: one block per (q-tile, head, batch), an
online softmax over key tiles, bf16 products on the tensor cores
(``mma.sync``) and f32 on the CUDA cores.

Bound on an H100 at the serving shape (B=8, Tq=Tk=2305, E=768, H=12, D=64,
bf16): 4*B*Tq*Tk*E = 1.31e11 flop take 0.13 ms at 989 TFLOP/s dense bf16;
the bytes, 4*B*T*E*2 = 113 MB, take 0.034 ms at 3.35 TB/s. The kernel is
compute-bound, so its design keeps scores and probabilities in registers
and feeds the tensor cores straight from them.

The TPU kernel's block policy (``_auto_block_q*``, ``_pick_head_groups``,
the ``CINEMA_TPU_PACKED_*_BUDGET`` knobs) is VMEM tiling for v5e and has no
counterpart here. Only the forward is ported; the backward is training work.
"""

from __future__ import annotations

import ctypes

import torch

from cinema_tpu_torch import build

_LOG2E = 1.4426950408889634
HEAD_DIMS = (32, 64)  # head_dim values the kernel is compiled for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"q, k, v must be (batch, tokens, embed), got {q.shape}, {k.shape}, {v.shape}.")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"Incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}.")
    if q.shape[2] % n_heads != 0:
        raise ValueError(f"embed {q.shape[2]} is not divisible by n_heads {n_heads}.")


def flash_attention_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head in plain torch, f32 softmax.

    Args:
        q: (batch, n_q, embed); k, v: (batch, n_k, embed), embed = n_heads * d.

    Returns:
        (batch, n_q, embed) in q's dtype.
    """
    _check(q, k, v, n_heads)
    batch, n_q, embed = q.shape
    n_k = k.shape[1]
    d = embed // n_heads
    qh = q.reshape(batch, n_q, n_heads, d).float()
    kh = k.reshape(batch, n_k, n_heads, d).float()
    vh = v.reshape(batch, n_k, n_heads, d).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * d**-0.5
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return out.reshape(batch, n_q, embed).to(q.dtype)


def _bind() -> ctypes.CDLL:
    lib = build.load("flash_attention_packed")
    fn = lib.cinema_flash_attention_packed_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Multi-head attention on packed (batch, tokens, embed) tensors.

    CUDA tensors go to the hand-written kernel (each launch adds one to
    ``flash_attention_packed.launches``); CPU tensors go to
    :func:`flash_attention_packed_plain`. Any other case raises: there is no
    fallback from the card to the plain version.

    k and v may be strided column slices (e.g. of a fused kv projection):
    only the last axis must be contiguous.
    """
    _check(q, k, v, n_heads)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, n_heads)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v must all be on one CUDA device or all on the CPU, got "
                         f"{q.device}, {k.device}, {v.device}.")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"The kernel takes float32 or bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}.")
    batch, n_q, embed = q.shape
    n_k = k.shape[1]
    head_dim = embed // n_heads
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"The kernel is built for head_dim in {HEAD_DIMS}, got {head_dim}.")
    # vector loads: 16 bytes per access
    align = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1 or x.stride(0) % align or x.stride(1) % align or x.data_ptr() % 16:
            raise ValueError(f"{name} must have a contiguous last axis and 16-byte aligned rows, "
                             f"got strides {x.stride()}.")
    out = torch.empty((batch, n_q, embed), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            batch, n_q, n_k, n_heads, head_dim, strides, head_dim**-0.5 * _LOG2E, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_packed kernel launch failed with CUDA error {rc}.")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0

