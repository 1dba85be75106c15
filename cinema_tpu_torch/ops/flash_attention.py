"""Flash attention, packed and per-head: the CUDA kernels' wrappers and their plain versions.

Two layouts of the same function, softmax(q k^T / sqrt(d)) v per head:

- packed ``(batch, tokens, embed)`` operands with the heads split inside the
  kernel (:func:`flash_attention_packed`, :func:`flash_attention_packed_kv`),
  the model's default path, described first below;
- per-head ``(batch, tokens, heads, head_dim)`` operands
  (:func:`flash_attention`), the path attention takes once q and k were
  changed per head (qk-norm, rotary embedding), described at its section.

The packed layout replaces ``cinema_tpu/ops/pallas/flash_attention.py`` ``flash_attention_packed``:
the forward (``_packed_forward`` / ``_packed_fwd_kernel``) and the backward
(``_packed_bwd_rule`` / ``_packed_bwd_kernel``).

- forward, ``csrc/flash_attention_fwd.cu``, shared with the per-head
  layout (a packed operand is a per-head one with head stride head_dim):
  one block per 128-row q tile of one (batch, head), two warpgroups of 64
  rows, an online softmax over 64-key stages of k and v streamed by
  ``cp.async`` through an mbarrier ring of shared-memory slots, bf16
  products on ``wgmma`` (v read through the transposed, MN-major
  descriptor), f32 ones in split TF32 (each operand as a TF32 hi and lo
  part, three TF32 passes) on ``mma.sync``, eight warps of 16 rows a
  block. When a gradient is needed it also
  writes each row's log-sum-exp (log2 domain, (batch, heads, n_q) f32),
  which the backward recomputes the probabilities from.
  :func:`fwd_launch_description` is what both layouts hand to it;
- backward, ``csrc/flash_attention_bwd.cu``, shared in the same way:
  three launches with no atomics (delta = rowsum(g * o); dk and dv per
  128-key tile; dq per 128-row q tile), so gradients do not change from run
  to run; bf16 products on ``wgmma`` with tiles streamed through the same
  kind of ring (``csrc/hopper.cuh`` holds what the two share), f32 ones in
  split TF32 on ``mma.sync`` as in the forward (``csrc/tf32.cuh``), eight
  warps of 16 rows a block.
  :func:`bwd_launch_description` is what both layouts hand to it.

Bounds on an H100, bf16 (989 TFLOP/s dense, 3.35 TB/s): the forward does
4*B*Tq*Tk*E flop, the backward 10*B*Tq*Tk*E (five products). At the serving
shape (B=8, Tq=Tk=2305, E=768) the forward's 1.31e11 flop take 0.13 ms
against 0.034 ms for its bytes; at the two shapes of a CineMA-base
pretraining step, (B=16, Tq=Tk=769, E=768) and (B=16, Tq=2305, Tk=768,
E=512), the backward's flop take 0.074 and 0.147 ms against 0.045 and 0.043
ms for its bytes. Both kernels are bounded by tensor-core operations, so
scores and probabilities stay in registers and feed the tensor cores from
there. The f32 forward's three TF32 passes, 3*4*B*Tq*Tk*E flop at 495
TFLOP/s, take 0.79 ms at the serving shape against 0.068 ms for its bytes;
the f32 backward's, 3*10*B*Tq*Tk*E, 0.99 ms at the fine-tuning shape (B=4,
Tq=Tk=2305, E=768) against 0.068 ms.

The TPU kernel's block policy (``_auto_block_q*``, ``_pick_head_groups``,
the ``CINEMA_TPU_PACKED_*_BUDGET`` knobs) and its closed-form pad-mass
correction are VMEM tiling for v5e and have no counterpart here: ragged
tails are masked exactly.

CUDA tensors go to the kernels or raise; CPU tensors take the plain
versions. The counters ``attention.{packed,heads}.launches`` and ``.bwd_launches`` of
:mod:`cinema_tpu_torch.trace` count the kernel launches per direction.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from cinema_tpu_torch import build, trace

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
    """The C entry point of a library, ``"flash_attention_fwd"`` or ``"flash_attention_bwd"`` (each
    serves both layouts), with its argument types set."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    fn = getattr(build.load(name), f"cinema_{name}")
    if fn.argtypes is None:
        fn.argtypes = {
            "flash_attention_fwd": [p, p, p, p, i, i, i, i, i, i, strides, f, p, p],
            "flash_attention_bwd": [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, strides, f, f, p],
        }[name]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_packed_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int, save_lse: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel on packed CUDA tensors: (out, lse), lse None unless ``save_lse``."""
    _check_on_card(q=q, k=k, v=v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _run_fwd(q, k, v, out, save_lse, n_heads)
    trace.count("attention.packed.launches")
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
    _check_on_card(q=q, k=k, v=v, out=out, g=g, dq=dq, dk=dk, dv=dv)
    _run_bwd(q, k, v, out, g, dq, dk, dv, lse, n_heads)
    trace.count("attention.packed.bwd_launches")


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
    counted in the counter ``attention.packed.grad_copies``."""
    align = 16 // g.element_size()
    if g.stride(2) == 1 and g.stride(0) % align == 0 and g.stride(1) % align == 0 and g.data_ptr() % 16 == 0:
        return g
    trace.count("attention.packed.grad_copies")
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
    one to the counter ``attention.packed.launches`` and each backward one to
    ``attention.packed.bwd_launches``. CPU tensors go to
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




# ---------------------------------------------------------------------------
# Per-head layout: (batch, tokens, heads, head_dim).
#
# Replaces ``cinema_tpu/ops/pallas/flash_attention.py`` ``flash_attention``:
# the forward (``_flash_forward`` / ``_flash_kernel``) and the backward
# (``_bwd`` / ``_flash_bwd_kernel``), with the kernels the packed layout
# takes, ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``:
# every operand and gradient is addressed through its own (batch, token,
# head) strides with a contiguous head_dim axis, so q and k are fresh tensors
# here, v is still a strided view of the fused kv projection, a (batch,
# heads, tokens, head_dim) transpose is read in place, and dv is written into
# the v half of a buffer shaped like kv (see :func:`split_kv`). The TPU
# kernel's transposes, its padding to 128 and ``_auto_block_q*`` are VMEM
# tiling and are not ported.
#
# Bounds on an H100, bf16, at ConvViT-base fine-tuning (B=4, Tq=Tk=2305, H=12,
# D=64): forward 4*B*Tq*Tk*H*D flop = 0.066 ms, backward 10*B*Tq*Tk*H*D =
# 0.165 ms at 989 TFLOP/s, against 0.017 and 0.034 ms for the bytes: both are
# bounded by tensor-core operations.
# ---------------------------------------------------------------------------


def _check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (batch, tokens, heads, head_dim), got {q.shape}, {k.shape}, {v.shape}.")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"Incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}.")


def _bhtd(x: torch.Tensor) -> torch.Tensor:
    """(batch, tokens, heads, head_dim) -> f32 (batch, heads, tokens, head_dim)."""
    return x.float().transpose(1, 2)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head in plain torch, f32 softmax.

    Args:
        q: (batch, n_q, heads, head_dim); k, v: (batch, n_k, heads, head_dim).

    Returns:
        (batch, n_q, heads, head_dim) in q's dtype, contiguous.
    """
    _check_heads(q, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype).contiguous()


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Row log-sum-exp of the scaled scores in the log2 domain, (batch, heads, n_q) f32."""
    scores = _bhtd(q) @ _bhtd(k).transpose(-1, -2) * q.shape[-1] ** -0.5
    return torch.logsumexp(scores, dim=-1) * _LOG2E


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention_plain` by the backward kernel's own formula
    (P recomputed, delta = rowsum(g * out), dS = P * (g v^T - delta), f32 sums, one cast).

    Returns:
        (dq, dk, dv), contiguous, shaped and typed like (q, k, v).
    """
    _check_heads(q, k, v)
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, oh, gh = (_bhtd(x) for x in (q, k, v, out, g))
    probs = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    delta = (gh * oh).sum(-1, keepdim=True)
    ds = probs * (gh @ vh.transpose(-1, -2) - delta)
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    dv = probs.transpose(-1, -2) @ gh
    return tuple(x.transpose(1, 2).contiguous().to(ref.dtype) for x, ref in ((dq, q), (dk, k), (dv, v)))


def _kernel_ready(x: torch.Tensor) -> bool:
    """Whether a kernel reads this tensor in place: any leading strides that keep
    rows 16-byte aligned, and a contiguous last axis."""
    align = 16 // x.element_size()
    return x.stride(-1) == 1 and all(s % align == 0 for s in x.stride()[:-1]) and x.data_ptr() % 16 == 0


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, save_lse: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel on per-head CUDA tensors: (out, lse), lse None unless ``save_lse``."""
    _check_on_card(q=q, k=k, v=v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _run_fwd(q, k, v, out, save_lse)
    trace.count("attention.heads.launches")
    return out, lse


# ---------------------------------------------------------------------------
# The kernels of both layouts: one C entry point per direction takes (batch, token, head) element
# strides of every operand; a packed (batch, tokens, embed) operand is passed with head stride head_dim.


class _Dims(NamedTuple):
    packed: bool
    batch: int
    n_q: int
    n_k: int
    n_heads: int
    head_dim: int
    dtype: torch.dtype


def _dims(q: torch.Tensor, k: torch.Tensor, n_heads: Optional[int], what: str) -> _Dims:
    """The sizes of a call, raising on a rank, dtype or head_dim the kernels are not built for."""
    packed = n_heads is not None
    layout = "(batch, tokens, embed)" if packed else "(batch, tokens, heads, head_dim)"
    if q.ndim != 3 + (not packed) or k.ndim != q.ndim:
        raise ValueError(f"The {what} takes {layout} operands.")
    if packed:
        batch, n_q, embed = q.shape
        head_dim = embed // n_heads
        if embed != n_heads * head_dim:
            raise ValueError(f"embed {embed} is not divisible by n_heads {n_heads}.")
    else:
        batch, n_q, n_heads, head_dim = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"The kernel takes float32 or bfloat16 operands of one dtype, got {q.dtype}.")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"The kernel is built for head_dim in {HEAD_DIMS}, got {head_dim}.")
    return _Dims(packed, batch, n_q, k.shape[1], n_heads, head_dim, q.dtype)


def _operand(name: str, x: torch.Tensor, n: int, dims: _Dims) -> Tuple[Tuple[int, int, int], int]:
    """(batch, token, head) element strides of an operand of ``n`` tokens and the byte offset of its
    first element, raising on what the kernels cannot copy: another shape or dtype, a non-contiguous
    head_dim axis, a stride or a base address that is not a multiple of 16 bytes (every row is copied
    16 bytes a thread)."""
    if dims.packed:
        layout, want = "(batch, tokens, embed)", (dims.batch, n, dims.n_heads * dims.head_dim)
    else:
        layout, want = "(batch, tokens, heads, head_dim)", (dims.batch, n, dims.n_heads, dims.head_dim)
    if x.shape != want:
        raise ValueError(f"{name} is {tuple(x.shape)}, expected {layout} {want}.")
    if x.dtype != dims.dtype:
        raise TypeError(f"The kernel takes float32 or bfloat16 operands of one dtype, got {name} {x.dtype} "
                        f"with q {dims.dtype}.")
    if dims.packed:
        (sb, st, sd), sh = x.stride(), dims.head_dim
    else:
        sb, st, sh, sd = x.stride()
    # the kernel never steps along a dimension of size 1, whatever stride torch gave it
    sb, st, sh = (0 if m == 1 else z for m, z in ((dims.batch, sb), (n, st), (dims.n_heads, sh)))
    size = x.element_size()
    if sd != 1 or (sb * size) % 16 or (st * size) % 16 or (sh * size) % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name} must have a contiguous head_dim axis and 16-byte aligned (batch, token, head) "
                         f"strides and base, got strides {x.stride()} at offset {x.storage_offset()}.")
    return (sb, st, sh), x.storage_offset() * size


FWD_BLOCK_ROWS = 128  # q rows per block: two warpgroups of 64 (bf16), or eight warps of 16 (f32)
FWD_OPERANDS = ("q", "k", "v", "out")
_FwdStrides = ctypes.c_longlong * 12  # (batch, token, head) element strides of the four operands


class FwdLaunch(NamedTuple):
    """What the forward's C entry point is handed for one call, apart from the addresses.

    ``strides`` and ``byte_strides`` are the (batch, token, head) strides of q, k, v and out in
    elements and in bytes; ``base_offsets`` the byte offset of each one's first element in its
    storage; ``grid`` the blocks of the launch, (q tiles, heads, batch).
    """

    dtype: int
    batch: int
    n_q: int
    n_k: int
    n_heads: int
    head_dim: int
    strides: Tuple[Tuple[int, int, int], ...]
    byte_strides: Tuple[Tuple[int, int, int], ...]
    base_offsets: Tuple[int, ...]
    grid: Tuple[int, int, int]


def fwd_launch_description(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, n_heads: Optional[int] = None
) -> FwdLaunch:
    """The forward kernel's launch on any device, for (batch, tokens, heads, head_dim) operands, or for
    packed (batch, tokens, embed) ones when ``n_heads`` is given: those are described as their
    (batch, tokens, heads, head_dim) views, whose head stride is head_dim.

    Raises on what the kernels do not take: mismatched shapes or dtypes, a head_dim they are not
    built for, a non-contiguous head_dim axis, a (batch, token, head) stride or a base address that
    is not a multiple of 16 bytes.
    """
    d = _dims(q, k, n_heads, "forward")
    strides, offsets = zip(*(_operand(name, x, n, d)
                             for name, x, n in zip(FWD_OPERANDS, (q, k, v, out), (d.n_q, d.n_k, d.n_k, d.n_q))))
    size = q.element_size()
    return FwdLaunch(
        dtype=_DTYPE_CODES[d.dtype], batch=d.batch, n_q=d.n_q, n_k=d.n_k, n_heads=d.n_heads, head_dim=d.head_dim,
        strides=strides, byte_strides=tuple(tuple(size * s for s in x) for x in strides), base_offsets=offsets,
        grid=(-(-d.n_q // FWD_BLOCK_ROWS), d.n_heads, d.batch),
    )


def _run_fwd(q, k, v, out, save_lse: bool, n_heads: Optional[int] = None) -> Optional[torch.Tensor]:
    """One call of the forward kernel on CUDA tensors (per-head, or packed when ``n_heads`` is given),
    writing ``out``; returns the row log-sum-exp when ``save_lse``, else None."""
    launch = fwd_launch_description(q, k, v, out, n_heads)
    lse = None
    if save_lse:
        lse = torch.empty((launch.batch, launch.n_heads, launch.n_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind("flash_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), launch.dtype, launch.batch, launch.n_q,
            launch.n_k, launch.n_heads, launch.head_dim, _FwdStrides(*(s for x in launch.strides for s in x)),
            launch.head_dim**-0.5 * _LOG2E, None if lse is None else lse.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash-attention forward kernel launch failed with CUDA error {rc}.")
    return lse


# keys (dk/dv pass) or q rows (dq pass) per block: two warpgroups of 64 (bf16), or eight warps of 16 (f32)
BWD_BLOCK_ROWS = 128
BWD_OPERANDS = ("q", "k", "v", "out", "g", "dq", "dk", "dv")
_BwdStrides = ctypes.c_longlong * 24  # (batch, token, head) element strides of the eight operands


class BwdLaunch(NamedTuple):
    """What the backward's C entry point is handed for one call, apart from the addresses.

    ``strides`` and ``byte_strides`` are the (batch, token, head) strides of
    q, k, v, out, g, dq, dk, dv in elements and in bytes (zeros for a gradient
    not computed); ``base_offsets`` the byte offset of each one's first element
    in its storage (None for a gradient not computed); ``n_q_pad`` the rows of
    the padded log-sum-exp and delta per (batch, head) in the scratch buffer of
    ``scratch_floats`` f32; ``grid_dkdv`` and ``grid_dq`` the blocks of the two
    passes, (tiles, heads, batch), None for a pass not run.
    """

    dtype: int
    batch: int
    n_q: int
    n_k: int
    n_heads: int
    head_dim: int
    strides: Tuple[Tuple[int, int, int], ...]
    byte_strides: Tuple[Tuple[int, int, int], ...]
    base_offsets: Tuple[Optional[int], ...]
    n_q_pad: int
    scratch_floats: int
    grid_dkdv: Optional[Tuple[int, int, int]]
    grid_dq: Optional[Tuple[int, int, int]]


def bwd_launch_description(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    dq: Optional[torch.Tensor], dk: Optional[torch.Tensor], dv: Optional[torch.Tensor],
    n_heads: Optional[int] = None,
) -> BwdLaunch:
    """The backward kernel's launch on any device (dq None: not computed; dk and dv None
    together: neither is computed), for (batch, tokens, heads, head_dim) operands, or for
    packed (batch, tokens, embed) ones when ``n_heads`` is given: those are described as
    their (batch, tokens, heads, head_dim) views, whose head stride is head_dim.

    Raises on what the kernels do not take: mismatched shapes or dtypes, a head_dim
    they are not built for, a non-contiguous head_dim axis, a (batch, token, head)
    stride or a base address that is not a multiple of 16 bytes (every row is
    copied 16 bytes a thread).
    """
    if (dk is None) != (dv is None):
        raise ValueError("dk and dv are computed together: pass both or neither.")
    d = _dims(q, k, n_heads, "backward")
    batch, n_q, n_k, n_heads, head_dim, dtype = d.batch, d.n_q, d.n_k, d.n_heads, d.head_dim, d.dtype
    size = q.element_size()
    strides, offsets = [], []
    for i, (name, x) in enumerate(zip(BWD_OPERANDS, (q, k, v, out, g, dq, dk, dv))):
        st, offset = ((0, 0, 0), None) if x is None else _operand(name, x, n_k if i in (1, 2, 6, 7) else n_q, d)
        strides.append(st)
        offsets.append(offset)
    n_q_pad = -(-n_q // BWD_BLOCK_ROWS) * BWD_BLOCK_ROWS
    return BwdLaunch(
        dtype=_DTYPE_CODES[dtype], batch=batch, n_q=n_q, n_k=n_k, n_heads=n_heads, head_dim=head_dim,
        strides=tuple(strides), byte_strides=tuple((a * size, b * size, c * size) for a, b, c in strides),
        base_offsets=tuple(offsets), n_q_pad=n_q_pad, scratch_floats=2 * batch * n_heads * n_q_pad,
        grid_dkdv=None if dk is None else (-(-n_k // BWD_BLOCK_ROWS), n_heads, batch),
        grid_dq=None if dq is None else (-(-n_q // BWD_BLOCK_ROWS), n_heads, batch),
    )


def _check_on_card(**tensors: Optional[torch.Tensor]) -> None:
    device = tensors["q"].device
    if device.type != "cuda" or any(x is not None and x.device != device for x in tensors.values()):
        devices = ", ".join(str(x.device) for x in tensors.values() if x is not None)
        raise ValueError(f"All operands must be on one CUDA device or all on the CPU, got {devices}.")


def _run_bwd(q, k, v, out, g, dq, dk, dv, lse: torch.Tensor, n_heads: Optional[int] = None) -> BwdLaunch:
    """One call of the backward kernels on CUDA tensors (per-head, or packed when ``n_heads`` is
    given), filling the given gradient buffers. The stream and the device are taken here, on the
    thread that autograd runs the backward on."""
    launch = bwd_launch_description(q, k, v, out, g, dq, dk, dv, n_heads)
    if lse.dtype != torch.float32 or lse.shape != (launch.batch, launch.n_heads, launch.n_q) \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 (batch, heads, n_q), got {lse.dtype} {tuple(lse.shape)}.")
    scratch = torch.empty(launch.scratch_floats, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bind("flash_attention_bwd")(
            *(None if x is None else x.data_ptr() for x in (q, k, v, out, g)), lse.data_ptr(), scratch.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (dq, dk, dv)), launch.dtype, launch.batch, launch.n_q,
            launch.n_k, launch.n_heads, launch.head_dim,
            _BwdStrides(*(st for x in launch.strides for st in x)),
            launch.head_dim**-0.5 * _LOG2E, launch.head_dim**-0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash-attention backward kernel launch failed with CUDA error {rc}.")
    return launch


def _launch_heads_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
    dq: Optional[torch.Tensor], dk: Optional[torch.Tensor], dv: Optional[torch.Tensor],
) -> None:
    """Fill the given gradient buffers (None: not computed; dk and dv go together)."""
    _check_on_card(q=q, k=k, v=v, out=out, g=g, dq=dq, dk=dk, dv=dv)
    _run_bwd(q, k, v, out, g, dq, dk, dv, lse)
    trace.count("attention.heads.bwd_launches")


def _is_v_half(v: torch.Tensor) -> bool:
    """Whether v is laid out as ``kv.view(batch, n_k, 2, heads, head_dim)[:, :, 1]`` of a fused kv projection."""
    batch, n_k, n_heads, head_dim = v.shape
    row = 2 * n_heads * head_dim
    return v.stride() == (n_k * row, row, head_dim, 1) and v.storage_offset() >= n_heads * head_dim


def _empty_like_v(v: torch.Tensor) -> torch.Tensor:
    """Where dv is written: for the v half of a fused kv projection the v half of a new
    (batch, n_k, 2, heads, head_dim) buffer (which :func:`split_kv`'s backward completes
    with dk and hands on as the gradient of kv), else a contiguous tensor."""
    batch, n_k, n_heads, head_dim = v.shape
    if _is_v_half(v):
        return torch.empty((batch, n_k, 2, n_heads, head_dim), dtype=v.dtype, device=v.device)[:, :, 1]
    return torch.empty(v.shape, dtype=v.dtype, device=v.device)


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the per-head backward kernels on CUDA tensors: (dq, dk, dv); dq and dk
    contiguous, dv laid out like v where v is the v half of a fused kv projection."""
    dq, dk = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k))
    dv = _empty_like_v(v)
    if not _kernel_ready(g):
        trace.count("attention.heads.grad_copies")
        g = g.contiguous()
    _launch_heads_bwd(q, k, v, out, lse, g, dq, dk, dv)
    return dq, dk, dv


class _HeadsAttention(torch.autograd.Function):
    """Per-head attention with the kernels (or plain versions) both ways."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.is_cuda:
            out, lse = flash_attention_forward(q, k, v, save_lse=True)
        else:
            out, lse = flash_attention_plain(q, k, v), None
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad
        if not q.is_cuda:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, g)
            if need_v and _is_v_half(v):
                dv = _empty_like_v(v).copy_(dv)
        else:
            dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) if need_q else None
            dk = dv = None
            if need_k or need_v:
                dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
                dv = _empty_like_v(v)
            if not _kernel_ready(g):
                trace.count("attention.heads.grad_copies")
                g = g.contiguous()
            _launch_heads_bwd(q, k, v, out, lse, g, dq, dk, dv)
        return (dq if need_q else None), (dk if need_k else None), (dv if need_v else None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention on (batch, tokens, heads, head_dim) tensors, differentiable.

    CUDA tensors go to the hand-written per-head kernels: each forward launch
    adds one to the counter ``attention.heads.launches`` and each backward one to
    ``attention.heads.bwd_launches``. CPU tensors go to
    :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`. Any
    other case raises: there is no fallback from the card to the plain versions.

    Each operand may be any strided view with a contiguous head_dim axis (the
    v half of a fused kv projection, a (batch, heads, tokens, head_dim)
    transpose): nothing is copied. n_q and n_k may differ. The row
    log-sum-exp is written only when a gradient is needed. The gradient of a
    v that is the v half of a fused kv projection comes back as the v half of
    a buffer shaped like that projection (see :func:`split_kv`).

    Returns:
        (batch, n_q, heads, head_dim) in q's dtype, contiguous.
    """
    _check_heads(q, k, v)
    on_cpu = _check_devices(q, k, v)
    if _needs_grad(q, k, v):
        return _HeadsAttention.apply(q, k, v)
    if on_cpu:
        return flash_attention_plain(q, k, v)
    return flash_attention_forward(q, k, v, save_lse=False)[0]




class _SplitKV(torch.autograd.Function):
    """kv (batch, n_k, 2 * heads * head_dim) -> its k and v halves as
    (batch, n_k, heads, head_dim) views. The backward assembles the gradient of
    kv in one buffer: where the gradient of v already is the v half of a buffer
    shaped like kv (as :func:`flash_attention`'s backward returns it), the
    gradient of k is copied into that buffer's k half and the buffer is the
    result; autograd's own slicing would zero-fill and add two such buffers."""

    @staticmethod
    def forward(ctx, kv, n_heads):
        batch, n_k, width = kv.shape
        kv5 = kv.view(batch, n_k, 2, n_heads, width // (2 * n_heads))
        return kv5[:, :, 0], kv5[:, :, 1]

    @staticmethod
    def backward(ctx, gk, gv):
        batch, n_k, n_heads, head_dim = gk.shape if gk is not None else gv.shape
        shape = (batch, n_k, 2, n_heads, head_dim)
        base = None if gv is None else gv._base
        if base is not None and base.shape == shape and base.is_contiguous() and _is_v_half(gv):
            split_kv.reused += 1
            buf = base
        else:
            ref = gk if gv is None else gv
            buf = torch.empty(shape, dtype=ref.dtype, device=ref.device)
            if gv is None:
                buf[:, :, 1].zero_()
            else:
                buf[:, :, 1].copy_(gv)
        if gk is None:
            buf[:, :, 0].zero_()
        else:
            buf[:, :, 0].copy_(gk)
        return buf.view(batch, n_k, 2 * n_heads * head_dim), None


def split_kv(kv: torch.Tensor, n_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k and v halves of the fused kv projection (batch, n_k, 2 * embed), each a
    (batch, n_k, heads, head_dim) view; the outputs order (2, heads, head_dim) along the
    last axis. Under autograd the gradient of kv is assembled in one buffer
    (``split_kv.reused`` counts the backward calls that took over the buffer that already held dv)."""
    if kv.ndim != 3 or kv.shape[-1] % (2 * n_heads) != 0:
        raise ValueError(f"kv must be (batch, n_k, 2 * embed) with embed divisible by {n_heads}, got {tuple(kv.shape)}.")
    if _needs_grad(kv) and kv.is_contiguous():
        return _SplitKV.apply(kv, n_heads)
    kv5 = kv.unflatten(-1, (2, n_heads, -1))
    return kv5[:, :, 0], kv5[:, :, 1]


split_kv.reused = 0
