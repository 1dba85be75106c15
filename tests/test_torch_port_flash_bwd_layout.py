"""The flash-attention backward's launch description, on the CPU: no kernel runs here.

Both layouts go to one CUDA backward (``csrc/flash_attention_bwd.cu``), which
takes (batch, token, head) element strides of every operand and copies every
row 16 bytes a thread. ``bwd_launch_description`` computes what it is handed;
these tests hold it to the layouts the model's paths pass (packed q, o, g;
the column halves of the fused kv projection; the per-head v half of it;
(batch, heads, tokens, head_dim) transposes), show that the packed and the
per-head entry points hand the kernel the same call for the same memory, and
that what the kernel cannot take raises. Tensors are made with
``torch.empty_strided``; the kernels themselves are held to their plain
versions on the card (``tests/test_torch_port_gpu.py``, ``chip_smoke.py``).
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


def _layout(name, n):
    """(q, k, v, out, g, dq, dk, dv) as (batch, tokens, heads, head_dim) views, and the expected
    (batch, token, head) element strides and element offsets of each, for one path's layout."""
    if name in ("packed", "packed_decoder"):
        embed, heads, n_k = (768, 12, n) if name == "packed" else (512, 16, 768)
        d = embed // heads
        row_q, row_kv = (n * embed, embed, d), (n_k * 2 * embed, 2 * embed, d)
        q, out, g, dq = (_empty((BATCH, n, embed), (n * embed, embed, 1)) for _ in range(4))
        kv, dkv = (_empty((BATCH, n_k, 2 * embed), (n_k * 2 * embed, 2 * embed, 1)) for _ in range(2))
        packed = (q, kv[..., :embed], kv[..., embed:], out, g, dq, dkv[..., :embed], dkv[..., embed:])
        views = tuple(x.unflatten(-1, (heads, d)) for x in packed)
        want = (row_q, row_kv, row_kv, row_q, row_q, row_q, row_kv, row_kv)
        return views, want, (0, 0, embed, 0, 0, 0, 0, embed)
    heads, d = 12, 64
    fresh = (n * heads * d, heads * d, d)
    transposed = (heads * n * d, d, n * d)
    q, k, out, g, dq, dk = (_empty((BATCH, n, heads, d), fresh + (1,)) for _ in range(6))
    if name == "kvhalf":  # v and dv: the v half of a (batch, n, 2, heads, head_dim) buffer
        half = (n * 2 * heads * d, 2 * heads * d, d)
        v, dv = (_empty((BATCH, n, heads, d), half + (1,), offset=heads * d) for _ in range(2))
        return (q, k, v, out, g, dq, dk, dv), (fresh,) * 2 + (half,) + (fresh,) * 4 + (half,), (0, 0, heads * d, 0,
                                                                                            0, 0, 0, heads * d)
    v = _empty((BATCH, n, heads, d), transposed + (1,))
    k = _empty((BATCH, n, heads, d), transposed + (1,))
    dv = _empty((BATCH, n, heads, d), fresh + (1,))
    if name == "bhtd":
        q = _empty((BATCH, n, heads, d), transposed + (1,))
        return (q, k, v, out, g, dq, dk, dv), (transposed,) * 3 + (fresh,) * 5, (0,) * 8
    return (q, k, v, out, g, dq, dk, dv), (fresh,) + (transposed,) * 2 + (fresh,) * 5, (0,) * 8  # "mixed"


@pytest.mark.parametrize("n", [1, 127, 129, 2305])
@pytest.mark.parametrize("layout", ["packed", "packed_decoder", "kvhalf", "bhtd", "mixed"])
def test_description_of_each_path_layout(layout, n):
    ops, strides, offsets = _layout(layout, n)
    launch = fa.bwd_launch_description(*ops)
    batch, n_q, heads, d = ops[0].shape
    n_k = ops[1].shape[1]
    assert (launch.dtype, launch.batch, launch.n_q, launch.n_k, launch.n_heads, launch.head_dim) == (
        1, BATCH, n, n_k, heads, d)
    # torch may give a dimension of size 1 any stride; the kernel never steps along it
    used = [[s if x.shape[i] > 1 else None for i, s in enumerate(st)] for x, st in zip(ops, launch.strides)]
    assert used == [[s if x.shape[i] > 1 else None for i, s in enumerate(st)] for x, st in zip(ops, strides)]
    assert launch.byte_strides == tuple(tuple(2 * s for s in x) for x in launch.strides)
    assert launch.base_offsets == tuple(2 * o for o in offsets)
    assert all(s % 16 == 0 for x in launch.byte_strides for s in x)
    pad = -(-n // 128) * 128
    assert launch.n_q_pad == pad and launch.scratch_floats == 2 * BATCH * heads * pad
    assert launch.grid_dkdv == (-(-n_k // 128), heads, BATCH)
    assert launch.grid_dq == (-(-n // 128), heads, BATCH)


@pytest.mark.parametrize("n", [1, 129])
def test_absent_gradients_and_f32_tiles(n):
    q = _empty((BATCH, n, 2, 32), (n * 64, 64, 32, 1), dtype=torch.float32)
    launch = fa.bwd_launch_description(q, q, q, q, q, None, q, q)
    assert launch.grid_dq is None and launch.base_offsets[5] is None and launch.strides[5] == (0, 0, 0)
    assert fa.BWD_BLOCK_ROWS == 8 * 16  # eight warps of 16 keys or q rows, as the bf16 passes' two warpgroups
    assert launch.grid_dkdv == (-(-n // fa.BWD_BLOCK_ROWS), 2, BATCH) and launch.dtype == 0
    launch = fa.bwd_launch_description(q, q, q, q, q, q, None, None)
    assert launch.grid_dkdv is None and launch.grid_dq == (-(-n // fa.BWD_BLOCK_ROWS), 2, BATCH)


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
    """The call's arguments without the scratch buffer's address, the strides array as a tuple."""
    args = list(args)
    del args[6]
    return tuple(tuple(a) if hasattr(a, "_length_") else a for a in args)


@pytest.mark.parametrize("n_q,n_k,embed,heads", [(129, 129, 768, 12), (2305, 768, 512, 16), (1, 1, 768, 12)])
def test_packed_and_per_head_entries_make_the_same_call_for_the_same_memory(captured, n_q, n_k, embed, heads):
    d = embed // heads
    q, out, g, dq = (_empty((BATCH, n_q, embed), (n_q * embed, embed, 1)) for _ in range(4))
    kv, dkv = (_empty((BATCH, n_k, 2 * embed), (n_k * 2 * embed, 2 * embed, 1)) for _ in range(2))
    lse = torch.empty(BATCH, heads, n_q)
    k, v, dk, dv = kv[..., :embed], kv[..., embed:], dkv[..., :embed], dkv[..., embed:]
    bwd = ("attention.packed.bwd_launches", "attention.heads.bwd_launches")
    before = tuple(map(trace.counter, bwd))
    fa._launch_bwd(q, k, v, out, lse, g, heads, dq, dk, dv)
    per_head = [x.view(*x.shape[:2], heads, d) for x in (q, k, v, out, g, dq, dk, dv)]
    fa._launch_heads_bwd(*per_head[:4], lse, per_head[4], *per_head[5:])
    assert len(captured) == 2 and _as_call(captured[0]) == _as_call(captured[1])
    assert captured[0][:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
                               lse.data_ptr())
    assert captured[0][7:10] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert tuple(map(trace.counter, bwd)) == (before[0] + 1, before[1] + 1)
    fa._launch_bwd(q, k, v, out, lse, g, heads, None, dk, dv)  # dq not computed: a null pointer
    assert captured[2][7] is None and captured[2][8] == dk.data_ptr()


def test_the_kernels_scratch_holds_the_padded_statistics(captured):
    q = _empty((1, 200, 2, 64), (200 * 128, 128, 64, 1))
    launch = fa._run_bwd(q, q, q, q, q, q, None, None, torch.empty(1, 2, 200))
    assert launch.n_q_pad == 256 and launch.scratch_floats == 2 * 2 * 256


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
    for position in range(8):  # every operand and every gradient buffer is checked
        ops = [good] * 8
        ops[position] = bad
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.bwd_launch_description(*ops)


def test_shapes_dtypes_and_head_dims_the_kernel_is_not_built_for_raise():
    x = _empty((1, 8, 2, 64), (1024, 128, 64, 1))
    with pytest.raises(ValueError, match="dk and dv"):
        fa.bwd_launch_description(x, x, x, x, x, x, x, None)
    with pytest.raises(ValueError, match="expected"):
        fa.bwd_launch_description(x, x, x, x, _empty((1, 9, 2, 64), (1152, 128, 64, 1)), x, x, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.bwd_launch_description(x, x, x, x, x.half(), x, x, x)
    y = _empty((1, 8, 2, 48), (768, 96, 48, 1))
    with pytest.raises(ValueError, match="head_dim"):
        fa.bwd_launch_description(y, y, y, y, y, y, y, y)
    with pytest.raises(ValueError, match="batch, tokens, heads, head_dim"):
        fa.bwd_launch_description(x[0], x, x, x, x, x, x, x)
