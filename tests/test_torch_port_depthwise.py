"""The depthwise 5^nd convolution of the conv stems (cinema_tpu_torch/ops/depthwise_conv.py) on the CPU.

The CUDA kernels run only on the card (tests/test_torch_port_gpu.py, chip_smoke.py); here the plain
versions are held to torch.autograd of F.conv{2,3}d with groups == channels in float64, the op's checks
and its CPU path are exercised, and the launch description is shown to cover every output voxel, and
every partial of the weight gradient, exactly once.
"""

import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F

from cinema_tpu_torch import trace
from cinema_tpu_torch.models import layers
from cinema_tpu_torch.ops import depthwise_conv as dc

COUNTERS = ("depthwise.launches", "depthwise.dgrad_launches", "depthwise.wgrad_launches")
# (batch, chans, *spatial): the main paths' shapes scaled down in batch and channels, and odd ones
SHAPES = [
    (2, 8, 12, 12, 16), (2, 16, 6, 6, 16), (2, 8, 16, 16), (2, 16, 8, 8),
    (3, 5, 7, 5, 3), (2, 1, 7, 5, 3), (2, 4, 6, 5, 1), (1, 3, 1, 1, 1), (2, 3, 7, 5), (2, 1, 1, 9),
]


def _inputs(shape, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    nd, chans = len(shape) - 2, shape[1]
    x = torch.randn(shape, generator=gen, dtype=dtype)
    g = torch.randn(shape, generator=gen, dtype=dtype)
    w = torch.randn((chans, 1, *(5,) * nd), generator=gen, dtype=dtype)
    b = torch.randn((chans,), generator=gen, dtype=dtype)
    return x, g, w, b


def _autograd(x, g, w, b):
    """Output and (dx, dw, db) by torch.autograd of F.conv{2,3}d with groups == channels."""
    x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
    conv = F.conv2d if x.ndim == 4 else F.conv3d
    out = conv(x, w, b, padding="same", groups=x.shape[1])
    return out.detach(), torch.autograd.grad(out, (x, w, b), g)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_autograd_in_float64(shape):
    x, g, w, b = _inputs(shape)
    want, (want_dx, want_dw, want_db) = _autograd(x, g, w, b)
    torch.testing.assert_close(dc.depthwise_conv_plain(x, w, b), want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dc.depthwise_conv_dgrad_plain(g, w), want_dx, rtol=1e-12, atol=1e-12)
    dw, db = dc.depthwise_conv_wgrad_plain(x, g)
    assert dw.dtype == db.dtype == torch.float64
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, want_db, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 8, 12, 12, 16), (2, 16, 8, 8), (2, 1, 7, 5, 3)])
def test_the_op_on_cpu_tensors_takes_the_plain_path_and_counts_no_launch(shape):
    x, g, w, b = _inputs(shape)
    want, want_grads = _autograd(x, g, w, b)
    x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
    before = tuple(map(trace.counter, COUNTERS))
    out = dc.depthwise_conv(x, w, b)
    grads = torch.autograd.grad(out, (x, w, b), g)
    assert tuple(map(trace.counter, COUNTERS)) == before
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
    for got, ref in zip(grads, want_grads):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_bf16_inputs_give_bf16_outputs_and_f32_parameter_gradients():
    """The filter and bias are rounded to the input's dtype, as the modules' other convolutions round theirs;
    the weight and bias gradients are summed in f32 and handed to the f32 parameters as they are."""
    x, g, w, b = _inputs((2, 8, 6, 6, 4), torch.float32)
    xb, gb = x.bfloat16().requires_grad_(), g.bfloat16()
    w, b = w.requires_grad_(), b.requires_grad_()
    out = dc.depthwise_conv(xb, w, b)
    dx, dw, db = torch.autograd.grad(out, (xb, w, b), gb)
    assert out.dtype == dx.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    torch.testing.assert_close(out, F.conv3d(xb.detach(), w.detach().bfloat16(), b.detach().bfloat16(), padding=2,
                                             groups=8))
    want_dw, want_db = dc.depthwise_conv_wgrad_plain(xb.detach().double(), gb.double())
    torch.testing.assert_close(dw, want_dw.float(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, want_db.float(), rtol=1e-5, atol=1e-5)


def test_gradients_not_asked_for_are_not_computed():
    x, g, w, b = _inputs((2, 4, 5, 5, 5))
    w = w.requires_grad_()
    out = dc.depthwise_conv(x, w, None)
    (dw,) = torch.autograd.grad(out, (w,), g)
    torch.testing.assert_close(dw, _autograd(x, g, w.detach(), b)[1][1])


@pytest.mark.parametrize("change,error", [
    (dict(weight_shape=(4, 1, 3, 3, 3)), "weight must be"),
    (dict(weight_shape=(4, 4, 5, 5, 5)), "weight must be"),
    (dict(weight_shape=(4, 1, 5, 5)), "weight must be"),
    (dict(bias_shape=(5,)), "bias must be"),
    (dict(stride=2), "stride 1"),
    (dict(stride=(1, 1, 2)), "stride 1"),
    (dict(dilation=2), "dilation 1"),
    (dict(padding=1), "'same' padding"),
    (dict(padding="valid"), "'same' padding"),
    (dict(groups=1), "groups == chans"),
    (dict(groups=2), "groups == chans"),
    (dict(x_shape=(2, 4, 5, 5)), "weight must be"),
    (dict(x_shape=(2, 4, 5)), "2-D or 3-D"),
    (dict(weight_device="meta"), "one device"),
    (dict(x_device="meta", weight_device="meta"), "CPU or CUDA"),
])
def test_the_op_raises_on_what_is_not_its_convolution(change, error):
    x = torch.zeros(change.get("x_shape", (2, 4, 5, 5, 5)), device=change.get("x_device", "cpu"))
    w = torch.zeros(change.get("weight_shape", (4, 1, 5, 5, 5)), device=change.get("weight_device", "cpu"))
    b = torch.zeros(change.get("bias_shape", (4,)), device=change.get("weight_device", "cpu"))
    settings = {k: change[k] for k in ("stride", "padding", "dilation", "groups") if k in change}
    with pytest.raises(ValueError, match=error):
        dc.depthwise_conv(x, w, b, **settings)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_the_kernels_refuse_other_dtypes(dtype):
    x = torch.zeros((2, 8, 4, 4, 4), dtype=dtype).contiguous(memory_format=torch.channels_last_3d)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dc.launch_description(x, x)


def test_the_kernels_refuse_operands_that_do_not_agree_or_whose_channels_are_not_innermost():
    x = torch.zeros((2, 8, 4, 4, 4)).contiguous(memory_format=torch.channels_last_3d)
    with pytest.raises(ValueError, match="must agree"):
        dc.launch_description(x, x.bfloat16())
    with pytest.raises(ValueError, match="must agree"):
        dc.launch_description(x, x[:1])
    with pytest.raises(ValueError, match="channels innermost"):
        dc.launch_description(x.contiguous(), x)
    copied = dc._channels_inside(x.contiguous())
    assert copied.is_contiguous(memory_format=torch.channels_last_3d)
    assert dc._channels_inside(x) is x


def _operand(shape, dtype=torch.bfloat16, layout="channels_last"):
    x = torch.empty(shape, dtype=dtype)
    if layout == "densified":  # (batch, z, x, y, chans) in memory, as the sparse MAE stem hands it over
        return x.permute(0, 4, 2, 3, 1).contiguous().permute(0, 4, 2, 3, 1)
    return x.contiguous(memory_format=torch.channels_last_3d if x.ndim == 5 else torch.channels_last)


@pytest.mark.parametrize("shape", [
    (2, 64, 48, 48, 16), (2, 128, 24, 24, 16), (3, 64, 64, 64), (2, 128, 32, 32),
    (2, 40, 9, 7, 18), (3, 5, 7, 5, 3), (2, 33, 5, 6, 1), (2, 40, 19, 21), (1, 1, 1, 1),
])
def test_the_forward_launch_covers_every_output_voxel_once(shape):
    x = _operand(shape)
    launch = dc.launch_description(x, x)
    assert launch.parts == 0 and launch.samples_per_block == 1 and launch.grid[2] == shape[0]
    seen = np.zeros((shape[0], shape[1], *launch.size), np.int32)
    for block in dc.blocks(launch):
        assert len(block.batch) == 1 and 0 < len(block.chans) <= dc.LANES and block.part is None
        seen[block.batch[0], block.chans.start:block.chans.stop, block.x.start:block.x.stop,
             block.y.start:block.y.stop, block.z.start:block.z.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,target", [
    ((4, 64, 48, 48, 16), None), ((16, 128, 24, 24, 16), None), ((16, 64, 64, 64), None), ((16, 128, 32, 32), None),
    ((5, 40, 9, 7, 18), 72), ((5, 35, 19, 21), 12), ((3, 5, 7, 5, 3), 1), ((1, 1, 1, 1), None),
])
def test_the_weight_gradient_launch_sums_every_voxel_once_into_partials_written_once(shape, target, monkeypatch):
    """Every (sample, channel, position) is summed by exactly one block, and each block writes its own row of
    partials: tiles x runs rows, each channel once. ``target`` lowers the blocks a call aims at, so that
    blocks sum several samples and the last run is short."""
    if target is not None:
        monkeypatch.setattr(dc, "TARGET_BLOCKS", target)
    x = _operand(shape)
    launch = dc.launch_description(x, x, weight_grad=True)
    assert launch.parts == launch.grid[0] * launch.grid[2]
    assert launch.grid[2] == -(-shape[0] // launch.samples_per_block)
    seen = np.zeros((shape[0], shape[1], *launch.size), np.int32)
    written = np.zeros((launch.parts, shape[1]), np.int32)
    for block in dc.blocks(launch):
        for b in block.batch:
            seen[b, block.chans.start:block.chans.stop, block.x.start:block.x.stop, block.y.start:block.y.stop,
                 block.z.start:block.z.stop] += 1
        written[block.part, block.chans.start:block.chans.stop] += 1
    assert (seen == 1).all() and (written == 1).all()


def test_main_shapes_split_the_weight_gradient_by_the_blocks_they_fill():
    """The weight gradient's runs of samples adapt to the shape: small grids get a block per sample."""
    finetune = dc.launch_description(_operand((4, 64, 48, 48, 16)), _operand((4, 64, 48, 48, 16)), weight_grad=True)
    assert finetune.grid == (144, 2, 4) and finetune.samples_per_block == 1
    pretrain = dc.launch_description(_operand((16, 64, 48, 48, 16)), _operand((16, 64, 48, 48, 16)),
                                     weight_grad=True)
    assert pretrain.grid == (144, 2, 4) and pretrain.samples_per_block == 4
    assert pretrain.parts == 576


@pytest.mark.parametrize("shape,layout,strides,vec", [
    ((4, 64, 48, 48, 16), "channels_last", (64 * 48 * 48 * 16, 64 * 48 * 16, 64 * 16, 64), True),
    ((4, 64, 48, 48, 16), "densified", (64 * 48 * 48 * 16, 64 * 48, 64, 64 * 48 * 48), True),
    ((4, 64, 64, 64), "channels_last", (64 * 64 * 64, 0, 64 * 64, 64), True),
    ((2, 5, 7, 5, 3), "channels_last", (5 * 7 * 5 * 3, 5 * 5 * 3, 5 * 3, 5), False),
    ((1, 4, 1, 1, 6), "channels_last", (0, 0, 0, 4), False),
])
def test_the_launch_reads_the_operands_layout(shape, layout, strides, vec):
    """(batch, x, y, z) element strides as the memory has them, 0 along an axis of size 1, and 16-byte copies
    where every stride is a multiple of 16 bytes."""
    x = _operand(shape, layout=layout)
    launch = dc.launch_description(x, x)
    assert launch.in_strides == strides and launch.in_vec is vec
    assert launch.size == ((1, *shape[2:]) if len(shape) == 4 else shape[2:])
    assert launch.taps_x == (5 if len(shape) == 5 else 1) and launch.taps == 5 ** (len(shape) - 2)
    assert launch.tile == dc.TILES[launch.taps_x]


@pytest.mark.parametrize("nd", [2, 3])
def test_masked_conv_block_keeps_its_parameters(nd):
    """dw_conv keeps the names, shapes and initialisation of torch's grouped Conv{2,3}d, so checkpoints and the
    JAX package's converted weights load as before."""
    torch.manual_seed(7)
    block = layers.MaskedConvBlock(nd, 16)
    torch.manual_seed(7)
    reference = layers.MaskedConvBlock(nd, 16)
    reference.dw_conv = {2: nn.Conv2d, 3: nn.Conv3d}[nd](16, 16, 5, padding="same", groups=16)
    torch.manual_seed(7)
    conv1_first = layers.Conv(nd, 16, 16, 1)  # the order the block draws its parameters in
    want_dw = {2: nn.Conv2d, 3: nn.Conv3d}[nd](16, 16, 5, padding="same", groups=16)
    del conv1_first
    state = block.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in reference.state_dict().items()}
    assert tuple(state["dw_conv.weight"].shape) == (16, 1, *(5,) * nd) and tuple(state["dw_conv.bias"].shape) == (16,)
    assert isinstance(block.dw_conv, (nn.Conv2d, nn.Conv3d))
    torch.testing.assert_close(block.dw_conv.weight, want_dw.weight, rtol=0, atol=0)
    x = torch.randn((2, 16, *(6,) * nd))
    reference.load_state_dict(block.state_dict())
    torch.testing.assert_close(block(x), reference(x), rtol=1e-6, atol=1e-6)
