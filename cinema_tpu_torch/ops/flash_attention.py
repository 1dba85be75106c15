"""Packed multi-head flash attention: the CUDA kernels' wrappers and their plain versions.

Replaces ``cinema_tpu/ops/pallas/flash_attention.py`` ``flash_attention_packed``:
the forward (``_packed_forward`` / ``_packed_fwd_kernel``) and the backward
(``_packed_bwd_rule`` / ``_packed_bwd_kernel``).

- forward, ``csrc/flash_attention_packed.cu``: one block per (q-tile, head,
  batch), an online softmax over key tiles, bf16 products on the tensor
  cores (``mma.sync``) and f32 on the CUDA cores. When a gradient is needed
  it also writes each row's log-sum-exp (log2 domain, (batch, heads, n_q)
  f32), which the backward recomputes the probabilities from;
- backward, ``csrc/flash_attention_packed_bwd.cu``: three launches with no
  atomics (delta = rowsum(g * o); dk and dv per key tile; dq per q tile), so
  gradients do not change from run to run.

Bounds on an H100, bf16 (989 TFLOP/s dense, 3.35 TB/s): the forward does
4*B*Tq*Tk*E flop, the backward 10*B*Tq*Tk*E (five products). At the serving
shape (B=8, Tq=Tk=2305, E=768) the forward's 1.31e11 flop take 0.13 ms
against 0.034 ms for its bytes; at the two shapes of a CineMA-base
pretraining step, (B=16, Tq=Tk=769, E=768) and (B=16, Tq=2305, Tk=768,
E=512), the backward's flop take 0.074 and 0.147 ms against 0.045 and 0.043
ms for its bytes. Both kernels are bounded by tensor-core operations, so
scores and probabilities stay in registers and feed the tensor cores from
there.

The TPU kernel's block policy (``_auto_block_q*``, ``_pick_head_groups``,
the ``CINEMA_TPU_PACKED_*_BUDGET`` knobs) and its closed-form pad-mass
correction are VMEM tiling for v5e and have no counterpart here: ragged
tails are masked exactly.

CUDA tensors go to the kernels or raise; CPU tensors take the plain
versions. ``flash_attention_packed.launches`` and ``.bwd_launches`` count
the kernel launches per direction.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cinema_tpu_torch import build

_LOG2E = 1.4426950408889634
HEAD_DIMS = (32, 64)  # head_dim values the kernels are compiled for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"q, k, v must be (batch, tokens, embed), got {q.shape}, {k.shape}, {v.shape}.")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"Incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}.")
    if q.shape[2] % n_heads != 0:
        raise ValueError(f"embed {q.shape[2]} is not divisible by n_heads {n_heads}.")


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(batch, tokens, embed) -> f32 (batch, n_heads, tokens, head_dim)."""
    return x.float().unflatten(-1, (n_heads, -1)).transpose(1, 2)


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


def flash_attention_packed_lse_plain(q: torch.Tensor, k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Row log-sum-exp of the scaled scores in the log2 domain, (batch, n_heads, n_q) f32:
    what the forward kernel saves for the backward."""
    scale = (q.shape[-1] // n_heads) ** -0.5
    scores = _heads(q, n_heads) @ _heads(k, n_heads).transpose(-1, -2) * scale
    return torch.logsumexp(scores, dim=-1) * _LOG2E


def flash_attention_packed_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor, n_heads: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention_packed_plain` by the backward kernel's own formula.

    P is recomputed from q and k; delta = rowsum(g * out) replaces the row
    sum of P * dP; dS = P * (g v^T - delta); every product accumulates in
    f32 and each gradient is cast once to its operand's dtype.

    Args:
        q, out, g: (batch, n_q, embed); k, v: (batch, n_k, embed).

    Returns:
        (dq, dk, dv) shaped and typed like (q, k, v).
    """
    _check(q, k, v, n_heads)
    scale = (q.shape[-1] // n_heads) ** -0.5
    qh, kh, vh, oh, gh = (_heads(x, n_heads) for x in (q, k, v, out, g))
    probs = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    delta = (gh * oh).sum(-1, keepdim=True)
    ds = probs * (gh @ vh.transpose(-1, -2) - delta)
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    dv = probs.transpose(-1, -2) @ gh
    return tuple(x.transpose(1, 2).flatten(2).to(ref.dtype) for x, ref in ((dq, q), (dk, k), (dv, v)))


def _bind(name: str):
    """The kernel library's C entry point with its argument types set."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    if name == "fwd":
        fn = build.load("flash_attention_packed").cinema_flash_attention_packed_fwd
        argtypes = [p, p, p, p, i, i, i, i, i, i, strides, f, p, p]
    else:
        fn = build.load("flash_attention_packed_bwd").cinema_flash_attention_packed_bwd
        argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, strides, f, f, p]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(n_heads: int, **tensors: torch.Tensor) -> int:
    """Raise on what the kernels do not take; returns head_dim."""
    first = next(iter(tensors.values()))
    for name, x in tensors.items():
        if not x.is_cuda or x.device != first.device:
            devices = ", ".join(str(t.device) for t in tensors.values())
            raise ValueError(f"All operands must be on one CUDA device or all on the CPU, got {devices}.")
        if x.dtype not in _DTYPE_CODES or x.dtype != first.dtype:
            dtypes = ", ".join(str(t.dtype) for t in tensors.values())
            raise TypeError(f"The kernel takes float32 or bfloat16 operands of one dtype, got {dtypes}.")
        # vector loads: 16 bytes per access
        align = 16 // x.element_size()
        if x.stride(2) != 1 or x.stride(0) % align or x.stride(1) % align or x.data_ptr() % 16:
            raise ValueError(f"{name} must have a contiguous last axis and 16-byte aligned rows, "
                             f"got strides {x.stride()}.")
    head_dim = first.shape[2] // n_heads
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"The kernel is built for head_dim in {HEAD_DIMS}, got {head_dim}.")
    return head_dim


def _strides(*tensors: torch.Tensor):
    flat = [s for x in tensors for s in (x.stride(0), x.stride(1))]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_packed_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int, save_lse: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel on CUDA tensors: (out, lse), lse None unless ``save_lse``."""
    head_dim = _check_cuda(n_heads, q=q, k=k, v=v)
    batch, n_q, embed = q.shape
    out = torch.empty((batch, n_q, embed), dtype=q.dtype, device=q.device)
    lse = torch.empty((batch, n_heads, n_q), dtype=torch.float32, device=q.device) if save_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind("fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            batch, n_q, k.shape[1], n_heads, head_dim, _strides(q, k, v, out), head_dim**-0.5 * _LOG2E,
            lse.data_ptr() if save_lse else None, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_packed kernel launch failed with CUDA error {rc}.")
    flash_attention_packed.launches += 1
    return out, lse


def _launch_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, n_heads: int, dq: Optional[torch.Tensor], dk: Optional[torch.Tensor],
    dv: Optional[torch.Tensor],
) -> None:
    """Fill the given gradient buffers (None: not computed; dk and dv go together).

    The stream and the device are taken here, on the thread that autograd
    runs the backward on.
    """
    wanted = {name: x for name, x in (("dq", dq), ("dk", dk), ("dv", dv)) if x is not None}
    head_dim = _check_cuda(n_heads, q=q, k=k, v=v, out=out, g=g, **wanted)
    batch, n_q, _ = q.shape
    delta = torch.empty_like(lse)
    none = q  # strides of an absent gradient are never read
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind("bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(None if x is None else x.data_ptr() for x in (dq, dk, dv)),
            _DTYPE_CODES[q.dtype], batch, n_q, k.shape[1], n_heads, head_dim,
            _strides(q, k, v, out, g, *(none if x is None else x for x in (dq, dk, dv))),
            head_dim**-0.5 * _LOG2E, head_dim**-0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_packed backward kernel launch failed with CUDA error {rc}.")
    flash_attention_packed.bwd_launches += 1


def flash_attention_packed_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, n_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the backward kernels on CUDA tensors: (dq, dk, dv), contiguous."""
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v))
    _launch_bwd(q, k, v, out, lse, _kernel_ready_grad(g), n_heads, dq, dk, dv)
    return dq, dk, dv


def _kernel_ready_grad(g: torch.Tensor) -> torch.Tensor:
    """The output gradient as the kernel reads it: any batch and row strides,
    but a contiguous, 16-byte aligned last axis. Autograd may hand over an
    expanded or transposed gradient; that one is copied, and the copy is
    counted in ``flash_attention_packed.grad_copies``."""
    align = 16 // g.element_size()
    if g.stride(2) == 1 and g.stride(0) % align == 0 and g.stride(1) % align == 0 and g.data_ptr() % 16 == 0:
        return g
    flash_attention_packed.grad_copies += 1
    return g.contiguous()


def _backward(ctx, q, k, v, out, lse, g, dkv: Optional[torch.Tensor]):
    """dq, dk, dv for the two autograd Functions; ``dkv`` is the fused
    (batch, n_k, 2 * embed) buffer that receives dk and dv, or None."""
    need_q = ctx.needs_input_grad[0]
    need_kv = any(ctx.needs_input_grad[1:3])
    if not q.is_cuda:
        dq, dk, dv = flash_attention_packed_bwd_plain(q, k, v, out, g, ctx.n_heads)
        if dkv is not None:
            dkv[..., : q.shape[2]], dkv[..., q.shape[2] :] = dk, dv
        return (dq if need_q else None), dk, dv
    embed = q.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) if need_q else None
    dk = dv = None
    if need_kv and dkv is not None:
        dk, dv = dkv[..., :embed], dkv[..., embed:]
    elif need_kv:
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(q, k, v, out, lse, _kernel_ready_grad(g), ctx.n_heads, dq, dk, dv)
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """Attention over separate q, k, v with the kernels (or plain versions) both ways."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads):
        if q.is_cuda:
            out, lse = flash_attention_packed_forward(q, k, v, n_heads, save_lse=True)
        else:
            out, lse = flash_attention_packed_plain(q, k, v, n_heads), None
        ctx.n_heads = n_heads
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(ctx, q, k, v, out, lse, g, None)
        return dq, (dk if ctx.needs_input_grad[1] else None), (dv if ctx.needs_input_grad[2] else None), None


class _PackedAttentionFusedKV(torch.autograd.Function):
    """The same over q and the fused kv projection (batch, n_k, 2 * embed).

    k and v are the two column halves of kv, read in place through their row
    stride. The backward writes dk and dv into the two halves of one buffer,
    so autograd neither zero-fills nor adds two (batch, n_k, 2 * embed)
    tensors per call, as it does for gradients of two slices.
    """

    @staticmethod
    def forward(ctx, q, kv, n_heads):
        embed = q.shape[2]
        k, v = kv[..., :embed], kv[..., embed:]
        if q.is_cuda:
            out, lse = flash_attention_packed_forward(q, k, v, n_heads, save_lse=True)
        else:
            out, lse = flash_attention_packed_plain(q, k, v, n_heads), None
        ctx.n_heads = n_heads
        ctx.save_for_backward(q, kv, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, kv, out, lse = ctx.saved_tensors
        embed = q.shape[2]
        dkv = torch.empty(kv.shape, dtype=kv.dtype, device=kv.device) if ctx.needs_input_grad[1] else None
        dq, _, _ = _backward(ctx, q, kv[..., :embed], kv[..., embed:], out, lse, g, dkv)
        return dq, dkv, None


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _check_devices(*tensors: torch.Tensor) -> bool:
    """True when all are on the CPU, False when all are on one CUDA device; raises otherwise."""
    if all(x.device.type == "cpu" for x in tensors):
        return True
    if not all(x.is_cuda and x.device == tensors[0].device for x in tensors):
        raise ValueError(f"q, k, v must all be on one CUDA device or all on the CPU, got "
                         f"{', '.join(str(x.device) for x in tensors)}.")
    return False


def flash_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Multi-head attention on packed (batch, tokens, embed) tensors, differentiable.

    CUDA tensors go to the hand-written kernels: each forward launch adds
    one to ``flash_attention_packed.launches`` and each backward one to
    ``flash_attention_packed.bwd_launches``. CPU tensors go to
    :func:`flash_attention_packed_plain` and
    :func:`flash_attention_packed_bwd_plain`. Any other case raises: there is
    no fallback from the card to the plain versions.

    k and v may be strided column slices (e.g. of a fused kv projection):
    only the last axis must be contiguous. The row log-sum-exp is written
    only when a gradient is needed.
    """
    _check(q, k, v, n_heads)
    on_cpu = _check_devices(q, k, v)
    if _needs_grad(q, k, v):
        return _PackedAttention.apply(q, k, v, n_heads)
    if on_cpu:
        return flash_attention_packed_plain(q, k, v, n_heads)
    return flash_attention_packed_forward(q, k, v, n_heads, save_lse=False)[0]


def flash_attention_packed_kv(q: torch.Tensor, kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """:func:`flash_attention_packed` on q (batch, n_q, embed) and the fused
    kv projection (batch, n_k, 2 * embed), k in the first half of the columns
    and v in the second. Same kernels and the same launch counters; the
    gradient of kv is written in one piece."""
    if kv.ndim != 3 or kv.shape[-1] != 2 * q.shape[-1]:
        raise ValueError(f"kv must be (batch, n_k, 2 * embed), got {tuple(kv.shape)} for q {tuple(q.shape)}.")
    embed = q.shape[2]
    if _needs_grad(q, kv):
        _check(q, kv[..., :embed], kv[..., embed:], n_heads)
        _check_devices(q, kv)
        return _PackedAttentionFusedKV.apply(q, kv, n_heads)
    return flash_attention_packed(q, kv[..., :embed], kv[..., embed:], n_heads)


def flash_attention_packed_kv_plain(q: torch.Tensor, kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """:func:`flash_attention_packed_plain` on q and the fused kv projection,
    differentiated by torch's autograd: the reference that a whole model
    through the kernels is held against."""
    embed = q.shape[2]
    return flash_attention_packed_plain(q, kv[..., :embed], kv[..., embed:], n_heads)


flash_attention_packed.launches = 0
flash_attention_packed.bwd_launches = 0
flash_attention_packed.grad_copies = 0
