"""Depthwise 5^nd convolution of the ConvMAE stems: the CUDA kernels' wrapper and their plain versions.

``MaskedConvBlock.dw_conv`` is a convolution with groups == channels, kernel 5, stride 1 and "same"
padding, in 2-D and 3-D. On the card it runs on three hand-written kernels (``csrc/depthwise_conv.cu``;
the source's note gives the bound and the design): the forward, the data gradient (the forward's kernel
with the filter flipped) and the weight gradient (f32 partials per tile and run of samples, summed by a
second kernel in a fixed order, with the bias gradient beside them). No TPU kernel is replaced: the JAX
package leaves this convolution to XLA, and the port left it to cuDNN, whose fallback kernels ran it at
about 1 % of the card's bound.

The operands are the modules' (batch, chans, *spatial) tensors with the channels innermost in memory
(PyTorch's channels_last formats, which the port's convolutions keep) and any other strides, as the sparse
MAE stem's densified image has them; another layout is copied to channels_last first. A 2-D image (H, W)
is handed to the kernels as (1, H, W) with a kernel extent of 1 along x. Inputs and outputs keep their
dtype, bf16 or f32; the filter is rounded to the input's dtype as the modules' other convolutions round
theirs, and every sum is f32. The weight and bias gradients are f32, handed straight to the f32
parameters (the straight-through gradient of that rounding).

CUDA tensors go to the kernels or raise; CPU tensors take the plain versions, forward and backward. The
counters ``depthwise.launches``, ``depthwise.dgrad_launches`` and ``depthwise.wgrad_launches`` of
:mod:`cinema_tpu_torch.trace` count the kernel calls per direction.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.nn import functional as F

from cinema_tpu_torch import build, trace

KERNEL = 5  # taps along every axis
PAD = (KERNEL - 1) // 2  # "same" padding at stride 1
LANES = 32  # channels a block owns, one a lane
# outputs of a block's tile, (x, y, z), by the kernel's extent along x: 5 in 3-D, 1 for a 2-D image. The
# library is built with these (``cinema_depthwise_conv_tile``, checked once when it loads); launches are
# described from them on any device, so that the CPU tests can check the blocks' cover
TILES = {5: (4, 4, 16), 1: (1, 16, 16)}
# the weight gradient's blocks per call it aims at: 132 SMs, two blocks each, four waves; below that it
# splits the samples into runs, each run a block and a partial of its own
TARGET_BLOCKS = 132 * 2 * 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

IntOrTuple = Union[int, Sequence[int]]


def _conv(nd: int):
    return F.conv2d if nd == 2 else F.conv3d


def depthwise_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward in plain torch: ``F.conv{2,3}d`` with groups == channels, the filter and bias in x's dtype."""
    bias = None if bias is None else bias.to(x.dtype)
    return _conv(x.ndim - 2)(x, weight.to(x.dtype), bias, padding=PAD, groups=x.shape[1])


def depthwise_conv_dgrad_plain(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The data gradient: the forward of the output gradient ``g`` with the filter flipped, in g's dtype."""
    flipped = weight.to(g.dtype).flip(tuple(range(2, weight.ndim)))
    return _conv(g.ndim - 2)(g, flipped, padding=PAD, groups=g.shape[1])


def depthwise_conv_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight and bias gradients from the forward's input ``x`` and its output's gradient ``g``, summed in
    f32 (float64 stays float64): ``(dw (C, 1, 5, 5[, 5]), dbias (C,))``, one sum over the samples and positions
    per tap, dw[c, k] = sum_b sum_p g[b, c, p] x[b, c, p + k - 2] (zeros outside the image)."""
    nd, chans = x.ndim - 2, x.shape[1]
    dtype = torch.promote_types(x.dtype, torch.float32)
    gf = g.to(dtype)
    xp = F.pad(x.to(dtype), (PAD,) * 2 * nd)
    dims = (0, *range(2, x.ndim))
    dw = torch.stack([
        (gf * xp[(slice(None), slice(None), *(slice(k, k + n) for k, n in zip(tap, x.shape[2:])))]).sum(dim=dims)
        for tap in itertools.product(range(KERNEL), repeat=nd)
    ], dim=1)
    return dw.reshape(chans, 1, *(KERNEL,) * nd), gf.sum(dim=dims)


def _as_tuple(value: IntOrTuple, nd: int) -> Tuple[int, ...]:
    return (value,) * nd if isinstance(value, int) else tuple(value)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: IntOrTuple,
           padding: Union[str, IntOrTuple], dilation: IntOrTuple, groups: Optional[int]) -> None:
    """Raise on anything but a depthwise 5^nd convolution at stride 1 with "same" padding."""
    if x.ndim not in (4, 5):
        raise ValueError(f"x must be (batch, chans, *spatial) in 2-D or 3-D, got shape {tuple(x.shape)}.")
    nd, chans = x.ndim - 2, x.shape[1]
    if tuple(weight.shape) != (chans, 1, *(KERNEL,) * nd):
        raise ValueError(f"weight must be (chans, 1{', 5' * nd}) = {(chans, 1, *(KERNEL,) * nd)} for x of "
                         f"{chans} channels, got {tuple(weight.shape)}.")
    if bias is not None and tuple(bias.shape) != (chans,):
        raise ValueError(f"bias must be ({chans},), got {tuple(bias.shape)}.")
    if _as_tuple(stride, nd) != (1,) * nd or _as_tuple(dilation, nd) != (1,) * nd:
        raise ValueError(f"The depthwise convolution takes stride 1 and dilation 1, got {stride} and {dilation}.")
    if padding != "same" and _as_tuple(padding, nd) != (PAD,) * nd:
        raise ValueError(f"The depthwise convolution takes 'same' padding, got {padding}.")
    if groups is not None and groups != chans:
        raise ValueError(f"The depthwise convolution takes groups == chans ({chans}), got {groups}.")
    devices = {t.device for t in (x, weight, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"x, weight and bias must be on one device, got {sorted(map(str, devices))}.")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"The depthwise convolution runs on CPU or CUDA tensors, got {x.device}.")
    if x.device.type == "cuda" and x.dtype not in _DTYPE_CODES:
        raise TypeError(f"The depthwise kernels take float32 or bfloat16, got {x.dtype}.")


# ---------------------------------------------------------------------------
# The kernels' launches


class Launch(NamedTuple):
    """What a kernel's C entry point is handed for one call, apart from the addresses.

    Tensors are seen as (batch, x, y, z, chans) with the channels contiguous: ``size`` is (x, y, z), a 2-D
    image being (1, H, W) with ``taps_x`` 1 (5 in 3-D); ``in_strides`` and ``out_strides`` are the (batch, x,
    y, z) element strides of the input (the forward's x, the data gradient's g, the weight gradient's x) and
    of the output (forward and data gradient) or of g (weight gradient); ``in_vec`` / ``out_vec`` whether that
    operand's voxels are copied 16 bytes a thread (aligned base and strides). ``tile`` is a block's outputs
    (x, y, z) and ``tiles`` their count along each axis; ``grid`` the blocks, (tiles, channel groups, samples)
    for the forward and (tiles, channel groups, runs) for the weight gradient, whose blocks each sum
    ``samples_per_block`` samples into ``parts`` = tiles * runs f32 partials per channel and tap.
    """

    dtype: int
    taps_x: int
    batch: int
    chans: int
    size: Tuple[int, int, int]
    tile: Tuple[int, int, int]
    tiles: Tuple[int, int, int]
    in_strides: Tuple[int, int, int, int]
    out_strides: Tuple[int, int, int, int]
    in_vec: bool
    out_vec: bool
    grid: Tuple[int, int, int]
    samples_per_block: int
    parts: int

    @property
    def taps(self) -> int:
        return self.taps_x * KERNEL * KERNEL


def _view(t: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...], bool]:
    """Shape, strides and 16-byte alignment of an operand, as a call's launch is cached by."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"The depthwise kernels take the channels innermost (stride 1), got strides {t.stride()}.")
    return tuple(t.shape), t.stride(), t.data_ptr() % 16 == 0


def _spatial(shape: Tuple[int, ...], strides: Tuple[int, ...], aligned: bool, element_size: int):
    """(x, y, z) sizes, (batch, x, y, z) element strides and 16-byte copies of a channels-innermost operand; a 2-D
    image is (1, H, W), and a stride along an axis of size 1 is never stepped on and reads as 0."""
    if len(shape) == 4:
        shape, strides = (shape[0], shape[1], 1, *shape[2:]), (strides[0], strides[1], 0, *strides[2:])
    strides = tuple(0 if shape[i] == 1 else strides[i] for i in (0, 2, 3, 4))
    return shape[2:], strides, aligned and all(s % (16 // element_size) == 0 for s in strides)


@functools.lru_cache(maxsize=256)
def _describe(dtype: torch.dtype, x: tuple, other: tuple, weight_grad: bool, target_blocks: int) -> Launch:
    shape = x[0]
    size, in_strides, in_vec = _spatial(*x, dtype.itemsize)
    _, out_strides, out_vec = _spatial(*other, dtype.itemsize)
    taps_x = KERNEL if len(shape) == 5 else 1
    tile = TILES[taps_x]
    tiles = tuple(-(-s // t) for s, t in zip(size, tile))
    batch, chans = shape[:2]
    n_tiles, groups = math.prod(tiles), -(-chans // LANES)
    samples = 1
    if weight_grad:
        runs = min(batch, max(1, -(-target_blocks // (n_tiles * groups))))
        samples = -(-batch // runs)
    runs = -(-batch // samples)
    return Launch(
        dtype=_DTYPE_CODES[dtype], taps_x=taps_x, batch=batch, chans=chans, size=size, tile=tile, tiles=tiles,
        in_strides=in_strides, out_strides=out_strides, in_vec=in_vec, out_vec=out_vec and weight_grad,
        grid=(n_tiles, groups, runs), samples_per_block=samples, parts=n_tiles * runs if weight_grad else 0,
    )


def launch_description(x: torch.Tensor, other: torch.Tensor, weight_grad: bool = False) -> Launch:
    """The launch of the forward kernel (``other`` the output; also the data gradient's, with g as ``x``), or
    of the weight gradient's first kernel (``other`` the output's gradient g), on any device. Launches are
    cached by the operands' shapes, strides, dtype and alignment.

    Raises on what the kernels do not take: another dtype than float32 or bfloat16, operands of other shapes
    or dtypes, channels that are not innermost.
    """
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"The depthwise kernels take float32 or bfloat16, got {x.dtype}.")
    if other.shape != x.shape or other.dtype != x.dtype:
        raise ValueError(f"Operands of shape {tuple(x.shape)} {x.dtype} and {tuple(other.shape)} {other.dtype} "
                         "must agree.")
    return _describe(x.dtype, _view(x), _view(other), weight_grad, TARGET_BLOCKS)


class Block(NamedTuple):
    """What one block of a launch covers: samples ``batch``, channels ``chans`` and output positions
    ``x``, ``y``, ``z`` (ranges, clipped to the tensor), and for the weight gradient the row ``part`` of
    the partials it writes (None for the forward)."""

    batch: range
    chans: range
    x: range
    y: range
    z: range
    part: Optional[int]


def blocks(launch: Launch) -> Iterator[Block]:
    """Every block of ``launch`` as the kernels map blockIdx to their work: tiles z fastest, then y, then x."""
    n_tiles, groups, third = launch.grid
    ty, tz = launch.tiles[1], launch.tiles[2]
    weight_grad = launch.parts > 0
    for tile in range(n_tiles):
        origin = (tile // (tz * ty), (tile // tz) % ty, tile % tz)
        spans = [range(o * t, min((o + 1) * t, s)) for o, t, s in zip(origin, launch.tile, launch.size)]
        for group in range(groups):
            chans = range(group * LANES, min((group + 1) * LANES, launch.chans))
            for k in range(third):
                first = k * launch.samples_per_block
                samples = range(first, min(first + launch.samples_per_block, launch.batch))
                yield Block(samples, chans, *spans, tile * third + k if weight_grad else None)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernels' library with its entry points' argument types set; raises where it was built with other
    tiles than ``TILES``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    ints, longs = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
    lib = build.load("depthwise_conv")
    lib.cinema_depthwise_conv_tile.argtypes = [i, ints]
    lib.cinema_depthwise_conv_fwd.argtypes = [p, p, p, p, i, i, i, i, ints, longs, longs, i, i, p]
    lib.cinema_depthwise_conv_wgrad.argtypes = [p, p, p, p, p, p, i, i, i, i, ints, longs, longs, i, i, i, p]
    for fn in (lib.cinema_depthwise_conv_tile, lib.cinema_depthwise_conv_fwd, lib.cinema_depthwise_conv_wgrad):
        fn.restype = ctypes.c_int
    tile = (ctypes.c_int * 3)()
    for taps_x, want in TILES.items():
        if lib.cinema_depthwise_conv_tile(taps_x, tile) != 0 or tuple(tile) != want:
            raise RuntimeError(f"The depthwise kernels are built with tile {tuple(tile)} for a kernel extent of "
                               f"{taps_x} along x, this module describes {want}.")
    return lib


@functools.lru_cache(maxsize=256)
def _c_arrays(launch: Launch) -> tuple:
    """The launch's sizes and strides as the C entry points read them: (size, in_strides, out_strides) ctypes
    arrays, made once per launch."""
    ints, longs = ctypes.c_int * 3, ctypes.c_longlong * 4
    return ints(*launch.size), longs(*launch.in_strides), longs(*launch.out_strides)


def _channels_inside(t: torch.Tensor) -> torch.Tensor:
    """t itself where its channels are innermost, else a channels_last copy."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        return t.contiguous(memory_format=torch.channels_last_3d if t.ndim == 5 else torch.channels_last)
    return t


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, memory_format=torch.channels_last_3d if t.ndim == 5 else torch.channels_last)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A parameter as the kernels read it: contiguous f32 (the port's parameters already are)."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _run_fwd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], flip: bool) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors, the filter's taps read in reverse when ``flip``; the
    kernel rounds the f32 filter and bias to x's dtype."""
    x = _channels_inside(x)
    out = _empty_like(x)
    launch = launch_description(x, out)
    weight = _f32(weight)
    bias = None if bias is None else _f32(bias)
    size, in_strides, out_strides = _c_arrays(launch)
    with torch.cuda.device(x.device):
        rc = _library().cinema_depthwise_conv_fwd(
            x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), launch.dtype,
            launch.taps_x, launch.batch, launch.chans, size, in_strides, out_strides, int(launch.in_vec),
            int(flip), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"depthwise convolution kernel launch failed with CUDA error {rc}.")
    return out


def depthwise_conv_forward(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward kernel on CUDA tensors: out in x's dtype and channels_last layout."""
    out = _run_fwd(x, weight, bias, flip=False)
    trace.count("depthwise.launches")
    return out


def depthwise_conv_dgrad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The data gradient kernel (the forward's, with the filter flipped) on CUDA tensors, in g's dtype."""
    dx = _run_fwd(g, weight, None, flip=True)
    trace.count("depthwise.dgrad_launches")
    return dx


def depthwise_conv_wgrad(x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight gradient kernels on CUDA tensors: f32 ``(dw (C, 1, 5, 5[, 5]), dbias (C,))``."""
    x, g = _channels_inside(x), _channels_inside(g)
    launch = launch_description(x, g, weight_grad=True)
    chans = launch.chans
    partial = torch.empty((launch.parts, chans, launch.taps), dtype=torch.float32, device=x.device)
    bias_partial = torch.empty((launch.parts, chans), dtype=torch.float32, device=x.device)
    dw = torch.empty((chans, 1, *(KERNEL,) * (x.ndim - 2)), dtype=torch.float32, device=x.device)
    dbias = torch.empty((chans,), dtype=torch.float32, device=x.device)
    size, in_strides, out_strides = _c_arrays(launch)
    with torch.cuda.device(x.device):
        rc = _library().cinema_depthwise_conv_wgrad(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), bias_partial.data_ptr(), dw.data_ptr(),
            dbias.data_ptr(), launch.dtype, launch.taps_x, launch.batch, chans, size, in_strides, out_strides,
            int(launch.in_vec), int(launch.out_vec), launch.samples_per_block,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"depthwise weight-gradient kernel launch failed with CUDA error {rc}.")
    trace.count("depthwise.wgrad_launches")
    return dw, dbias


class _DepthwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = None if bias is None else bias.dtype
        if x.device.type == "cpu":
            return depthwise_conv_plain(x, weight, bias)
        return depthwise_conv_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        on_cpu = x.device.type == "cpu"
        dx = dw = db = None
        if need_x:
            dx = depthwise_conv_dgrad_plain(g, weight) if on_cpu else depthwise_conv_dgrad(g, weight)
        if need_w or need_b:
            dw, db = depthwise_conv_wgrad_plain(x, g) if on_cpu else depthwise_conv_wgrad(x, g)
            dw = dw.to(weight.dtype) if need_w else None
            db = db.to(ctx.bias_dtype) if need_b else None
        return dx, dw, db


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   stride: IntOrTuple = 1, padding: Union[str, IntOrTuple] = "same", dilation: IntOrTuple = 1,
                   groups: Optional[int] = None) -> torch.Tensor:
    """Depthwise 5^nd convolution of (batch, chans, *spatial) ``x`` with ``weight`` (chans, 1, 5, 5[, 5]) and
    ``bias`` (chans,), "same" padding, differentiable in all three: the kernels for CUDA tensors, the plain
    versions for CPU tensors. ``stride``, ``padding``, ``dilation`` and ``groups`` are a module's settings,
    checked: anything but 1, "same" (or 2), 1 and chans raises."""
    _check(x, weight, bias, stride, padding, dilation, groups)
    return _DepthwiseConv.apply(x, weight, bias)
