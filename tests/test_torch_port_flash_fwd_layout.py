"""The flash-attention forward's launch description, on the CPU: no kernel runs here.

Both layouts go to one CUDA forward (``csrc/flash_attention_fwd.cu``), which
takes (batch, token, head) element strides of q, k, v and out and copies every
row 16 bytes a thread. ``fwd_launch_description`` computes what it is handed;
these tests hold it to the layouts the model's paths pass (packed q and out;
the column halves of the fused kv projection, at the serving and at the MAE
decoder's cross shape; the per-head v half of it; (batch, heads, tokens,
head_dim) transposes), show that the packed and the per-head entry points hand
the kernel the same call for the same memory, and that what the kernel cannot
take raises. Tensors are made with ``torch.empty_strided``; the kernel itself
is held to its plain version on the card (``tests/test_torch_port_gpu.py``,
``chip_smoke.py``).
"""

import contextlib
import types

import pytest
import torch

from cinema_tpu_torch import trace
from cinema_tpu_torch.ops import flash_attention as fa

BATCH = 2
BF16 = torch.bfloat16


def _empty(shape, strides, offset=0, dtype=BF16):
    """A view of ``shape`` and ``strides`` at element ``offset`` of a fresh buffer just large enough."""
    size = offset + 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    return torch.empty_strided((size,), (1,), dtype=dtype).as_strided(shape, strides, offset)


def _packed(n_q, n_k, embed):
    """Packed q and out, and k and v as the column halves of a fused kv projection."""
    q, out = (_empty((BATCH, n_q, embed), (n_q * embed, embed, 1)) for _ in range(2))
    kv = _empty((BATCH, n_k, 2 * embed), (n_k * 2 * embed, 2 * embed, 1))
    return q, kv[..., :embed], kv[..., embed:], out


def _layout(name, n):
    """(q, k, v, out) of one path's layout, n_heads for a packed one (else None), and the expected
    (batch, token, head) element strides and element offsets of each."""
    if name in ("packed", "packed_decoder"):
        embed, heads, n_k = (768, 12, n) if name == "packed" else (512, 16, 768)
        d = embed // heads
        row_q, row_kv = (n * embed, embed, d), (n_k * 2 * embed, 2 * embed, d)
        return _packed(n, n_k, embed), heads, (row_q, row_kv, row_kv, row_q), (0, 0, embed, 0)
    heads, d = 12, 64
    fresh = (n * heads * d, heads * d, d)
    transposed = (heads * n * d, d, n * d)
    q, k, out = (_empty((BATCH, n, heads, d), fresh + (1,)) for _ in range(3))
    if name == "kvhalf":  # v: the v half of a (batch, n, 2, heads, head_dim) buffer
        half = (n * 2 * heads * d, 2 * heads * d, d)
        v = _empty((BATCH, n, heads, d), half + (1,), offset=heads * d)
        return (q, k, v, out), None, (fresh, fresh, half, fresh), (0, 0, heads * d, 0)
    k, v = (_empty((BATCH, n, heads, d), transposed + (1,)) for _ in range(2))
    if name == "bhtd":
        q = _empty((BATCH, n, heads, d), transposed + (1,))
        return (q, k, v, out), None, (transposed,) * 3 + (fresh,), (0,) * 4
    return (q, k, v, out), None, (fresh, transposed, transposed, fresh), (0,) * 4  # "mixed"


@pytest.mark.parametrize("n", [1, 127, 129, 2305])
@pytest.mark.parametrize("layout", ["packed", "packed_decoder", "kvhalf", "bhtd", "mixed"])
def test_description_of_each_path_layout(layout, n):
    ops, n_heads, strides, offsets = _layout(layout, n)
    launch = fa.fwd_launch_description(*ops, n_heads=n_heads)
    heads = n_heads or ops[0].shape[2]
    d = ops[0].shape[-1] // n_heads if n_heads else ops[0].shape[3]
    n_k = ops[1].shape[1]
    assert (launch.dtype, launch.batch, launch.n_q, launch.n_k, launch.n_heads, launch.head_dim) == (
        1, BATCH, n, n_k, heads, d)
    # torch may give a dimension of size 1 any stride; the kernel never steps along it
    sizes = [(BATCH, x.shape[1], heads) for x in ops]
    used = [[s if m > 1 else None for m, s in zip(size, st)] for size, st in zip(sizes, launch.strides)]
    assert used == [[s if m > 1 else None for m, s in zip(size, st)] for size, st in zip(sizes, strides)]
    assert launch.byte_strides == tuple(tuple(2 * s for s in x) for x in launch.strides)
    assert launch.base_offsets == tuple(2 * o for o in offsets)
    assert all(s % 16 == 0 for x in launch.byte_strides for s in x)
    assert launch.grid == (-(-n // 128), heads, BATCH)


@pytest.mark.parametrize("n_q,n_k,embed,heads", [(2305, 2305, 768, 12), (2305, 768, 512, 16), (129, 200, 512, 16)])
def test_a_packed_operand_is_described_as_its_per_head_view(n_q, n_k, embed, heads):
    packed = _packed(n_q, n_k, embed)
    per_head = [x.unflatten(-1, (heads, embed // heads)) for x in packed]
    assert fa.fwd_launch_description(*packed, n_heads=heads) == fa.fwd_launch_description(*per_head)


@pytest.mark.parametrize("n", [1, 129])
def test_f32_operands_take_one_thread_a_row_in_blocks_of_128(n):
    """f32 operands take the bf16 kernel's grid, a block per 128 q rows (eight warps of 16 rows on the tensor
    cores, where the f32 kernel once gave one CUDA-core thread a row), with strides in their own bytes."""
    q = _empty((BATCH, n, 2, 32), (n * 64, 64, 32, 1), dtype=torch.float32)
    q16 = _empty((BATCH, n, 2, 32), (n * 64, 64, 32, 1))
    launch = fa.fwd_launch_description(q, q, q, q)
    assert fa.FWD_BLOCK_ROWS == 8 * 16
    assert launch.dtype == 0 and launch.grid == fa.fwd_launch_description(q16, q16, q16, q16).grid
    assert launch.grid == (-(-n // fa.FWD_BLOCK_ROWS), 2, BATCH)
    assert launch.strides == fa.fwd_launch_description(q16, q16, q16, q16).strides
    assert launch.byte_strides == tuple(tuple(4 * s for s in x) for x in launch.strides)


@pytest.fixture
def captured(monkeypatch):
    """Record the C entry point's arguments instead of calling it; CPU tensors pass for the card."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(fa, "_bind", lambda name: entry)
    monkeypatch.setattr(fa, "_check_on_card", lambda **tensors: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


def _as_call(args):
    """The call's arguments without the addresses of out and lse (allocated by each entry), the strides
    array as a tuple."""
    args = list(args)
    del args[12], args[3]
    return tuple(tuple(a) if hasattr(a, "_length_") else a for a in args)


@pytest.mark.parametrize("n_q,n_k,embed,heads", [(129, 129, 768, 12), (2305, 768, 512, 16), (1, 1, 768, 12)])
def test_packed_and_per_head_entries_make_the_same_call_for_the_same_memory(captured, n_q, n_k, embed, heads):
    q, k, v, _ = _packed(n_q, n_k, embed)
    fwd = ("attention.packed.launches", "attention.heads.launches")
    before = tuple(map(trace.counter, fwd))
    out, lse = fa.flash_attention_packed_forward(q, k, v, heads, save_lse=False)
    assert tuple(map(trace.counter, fwd)) == (before[0] + 1, before[1])
    per_head = [x.view(*x.shape[:2], heads, embed // heads) for x in (q, k, v)]
    out_h, lse_h = fa.flash_attention_forward(*per_head, save_lse=False)
    assert tuple(map(trace.counter, fwd)) == (before[0] + 1, before[1] + 1)
    assert len(captured) == 2 and _as_call(captured[0]) == _as_call(captured[1])
    assert captured[0][:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert captured[1][3] == out_h.data_ptr()
    # the log-sum-exp is a null pointer unless asked for
    assert lse is None and lse_h is None and captured[0][12] is None and captured[1][12] is None
    assert out.shape == q.shape and out_h.shape == per_head[0].shape and out.dtype == out_h.dtype == BF16
    assert captured[0][4:10] == (1, BATCH, n_q, n_k, heads, embed // heads)
    assert captured[0][11] == pytest.approx((embed // heads) ** -0.5 * 1.4426950408889634)


def test_the_log_sum_exp_is_written_only_when_asked_for(captured):
    q, k, v, _ = _packed(200, 77, 512)
    out, lse = fa.flash_attention_packed_forward(q, k, v, 16, save_lse=True)
    assert lse.shape == (BATCH, 16, 200) and lse.dtype == torch.float32 and lse.is_contiguous()
    assert captured[-1][12] == lse.data_ptr()
    per_head = [x.unflatten(-1, (16, 32)).transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    out_h, lse_h = fa.flash_attention_forward(*per_head, save_lse=True)
    assert captured[-1][12] == lse_h.data_ptr() and lse_h.shape == (BATCH, 16, 200)
    # (batch, heads, tokens, head_dim) storage is read in place: its strides reach the kernel
    launch = fa.fwd_launch_description(*per_head, out_h)
    assert tuple(captured[-1][10]) == tuple(s for x in launch.strides for s in x)
    assert launch.strides[0] == (16 * 200 * 32, 32, 200 * 32)


@pytest.mark.parametrize("fault", ["token_stride", "batch_stride", "head_stride", "base", "head_dim_axis"])
def test_what_the_kernel_cannot_copy_raises(fault):
    n, heads, d = 129, 12, 64
    good = _empty((BATCH, n, heads, d), (n * heads * d, heads * d, d, 1))
    bad = {
        "token_stride": lambda: _empty((BATCH, n, heads, d), (n * 776, 776 + 1, d, 1)),
        "batch_stride": lambda: _empty((BATCH, n, heads, d), (n * heads * d + 4, heads * d, d, 1)),
        "head_stride": lambda: _empty((BATCH, n, heads, d), (n * heads * 72, heads * 72, 68, 1)),
        "base": lambda: _empty((BATCH, n, heads, d), (n * heads * d, heads * d, d, 1), offset=1),
        "head_dim_axis": lambda: _empty((BATCH, n, heads, d), (n * heads * d, heads * d, 1, heads)),
    }[fault]()
    for position in range(4):  # q, k, v and out are each checked
        ops = [good] * 4
        ops[position] = bad
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.fwd_launch_description(*ops)


def test_a_packed_row_the_kernel_cannot_copy_raises():
    q, k, v, out = _packed(9, 9, 512)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fwd_launch_description(q, k, v, _empty((BATCH, 9, 512), (9 * 516, 516, 1)), 16)
    kv = _empty((BATCH, 9, 1028), (9 * 1028, 1028, 1))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fwd_launch_description(q, kv[..., :512], kv[..., 512:1024], out, 16)


def test_shapes_dtypes_ranks_and_head_dims_the_kernel_is_not_built_for_raise():
    x = _empty((1, 8, 2, 64), (1024, 128, 64, 1))
    with pytest.raises(ValueError, match="expected"):
        fa.fwd_launch_description(x, x, x, _empty((1, 9, 2, 64), (1152, 128, 64, 1)))
    with pytest.raises(ValueError, match="expected"):
        fa.fwd_launch_description(x, x, _empty((1, 9, 2, 64), (1152, 128, 64, 1)), x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.fwd_launch_description(x, x, x.half(), x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.fwd_launch_description(*(x.half(),) * 4)
    y = _empty((1, 8, 2, 48), (768, 96, 48, 1))
    with pytest.raises(ValueError, match="head_dim"):
        fa.fwd_launch_description(y, y, y, y)
    with pytest.raises(ValueError, match="batch, tokens, heads, head_dim"):
        fa.fwd_launch_description(x[0], x, x, x)
    p = _empty((1, 8, 96), (768, 96, 1))
    with pytest.raises(ValueError, match="head_dim"):
        fa.fwd_launch_description(p, p, p, p, n_heads=2)
    with pytest.raises(ValueError, match="not divisible"):
        fa.fwd_launch_description(p, p, p, p, n_heads=5)
    with pytest.raises(ValueError, match="batch, tokens, embed"):
        fa.fwd_launch_description(x, x, x, x, n_heads=2)
