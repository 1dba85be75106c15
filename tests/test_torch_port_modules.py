"""Port parity, module by module: the same numpy inputs and the same weights
(through ``state_dict_from_jax``) go through each JAX module and its port.

f32 on both sides (tests/conftest.py pins XLA matmuls to "highest"). The
default tolerance 2e-4 absorbs the JAX package's Abramowitz-Stegun GELU
(abs err 1.5e-7 per activation) against torch's exact erf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu_torch.convert import state_dict_from_jax, torch_key
from cinema_tpu_torch.models import layers as port_layers
from cinema_tpu_torch.ops import patch as port_patch
from cinema_tpu_torch.ops import pos_embed as port_pos
from cinema_tpu_torch.ops import window as port_window

ATOL = 2e-4


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=True)
    return module.eval()


def _channels_first(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).movedim(-1, 1)


def _channels_last(x: torch.Tensor) -> np.ndarray:
    return x.movedim(1, -1).detach().numpy()


@pytest.fixture(params=["1", "0"], ids=["zfold-on", "zfold-off"])
def zfold(request, monkeypatch):
    """The JAX package's z-folded conv layouts, on and off: the port's plain
    convolutions must match both."""
    monkeypatch.setenv("CINEMA_TPU_ZFOLD", request.param)
    return request.param


@pytest.mark.parametrize("shape,patch", [((2, 8, 12, 3), (4, 4)), ((2, 8, 8, 4, 2), (4, 2, 2)), ((1, 4, 4, 2, 2, 1), (2, 2, 1, 2))])
def test_patchify(shape, patch):
    from cinema_tpu.ops.patch import patchify

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(port_patch.patchify(torch.from_numpy(x), patch).numpy(), np.asarray(patchify(jnp.asarray(x), patch)))


@pytest.mark.parametrize("embed_dim,grid", [(32, (4, 6)), (30, (3, 4, 5)), (768, (12, 12, 16))])
def test_sincos_pos_embed(embed_dim, grid):
    from cinema_tpu.ops.pos_embed import get_nd_sincos_pos_embed

    np.testing.assert_array_equal(
        port_pos.get_nd_sincos_pos_embed(embed_dim, grid), get_nd_sincos_pos_embed(embed_dim, grid)
    )


@pytest.mark.parametrize("src,dst", [((4, 6), (5, 9)), ((3, 4, 5), (6, 2, 5)), ((4, 4), (4, 4))])
def test_interpolate_pos_embed(src, dst):
    from cinema_tpu.ops.pos_embed import get_nd_sincos_pos_embed, interpolate_pos_embed

    table = get_nd_sincos_pos_embed(16, src)[None]
    np.testing.assert_array_equal(port_pos.interpolate_pos_embed(table, src, dst), interpolate_pos_embed(table, src, dst))


def test_interpolate_pos_embed_is_torch_interpolate():
    """The numpy resize is torch's own bicubic (A=-0.75) / trilinear."""
    table = port_pos.get_nd_sincos_pos_embed(8, (4, 6))[None]
    got = port_pos.interpolate_pos_embed(table, (4, 6), (7, 5))
    grid = torch.from_numpy(table).reshape(1, 4, 6, 8).permute(0, 3, 1, 2)
    want = torch.nn.functional.interpolate(grid, size=(7, 5), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got, want.permute(0, 2, 3, 1).reshape(1, 35, 8).numpy(), atol=1e-6)


def test_layer_norm():
    from cinema_tpu.models.layers import LayerNorm

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 6, 3, 8)).astype(np.float32) * 3 + 1
    mod = LayerNorm(epsilon=1e-6, dtype=None)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda p: p + rng.normal(size=p.shape).astype(np.float32), params)
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    port = _load(port_layers.ConvLayerNorm(8, eps=1e-6), params)
    np.testing.assert_allclose(_channels_last(port(_channels_first(x))), want, atol=ATOL)


@pytest.mark.parametrize("shape,out_chans", [((2, 8, 8, 16, 8), 8), ((2, 6, 6, 4, 3), 5), ((2, 6, 6, 4), 4)])
def test_conv_res_block(shape, out_chans, zfold):
    from cinema_tpu.models.layers import ConvResBlock

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    mod = ConvResBlock(out_chans=out_chans)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    port = _load(port_layers.ConvResBlock(len(shape) - 2, shape[-1], out_chans), params)
    np.testing.assert_allclose(_channels_last(port(_channels_first(x))), want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4, 4), (2, 10, 6, 8)])
def test_masked_conv_block(shape, zfold):
    from cinema_tpu.models.layers import MaskedConvBlock

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    mod = MaskedConvBlock()
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x), None))
    port = _load(port_layers.MaskedConvBlock(len(shape) - 2, shape[-1]), params)
    np.testing.assert_allclose(_channels_last(port(_channels_first(x))), want, atol=ATOL)


@pytest.mark.parametrize("shape,kernel,out_chans", [((2, 4, 4, 16, 8), (2, 2, 1), 8), ((2, 3, 5, 6), (2, 2), 3)])
def test_conv_transpose(shape, kernel, out_chans, zfold):
    from cinema_tpu.models.layers import ConvTranspose

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    mod = ConvTranspose(out_chans, kernel, strides=kernel)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    port = _load(port_layers.ConvTranspose(len(kernel), shape[-1], out_chans, kernel), params)
    np.testing.assert_allclose(_channels_last(port(_channels_first(x))), want, atol=ATOL)


@pytest.mark.parametrize(
    "path,key",
    [
        (("enc_down_dict_sax", "conv_blocks_0", "patch_embed", "conv", "conv", "kernel"), "enc_down_dict.sax.conv_blocks.0.patch_embed.conv.weight"),
        (("encoder", "blocks_3", "attn", "kv", "linear", "bias"), "encoder.blocks.3.attn.kv.bias"),
        (("decoder_dict_lax_2c", "blocks_0", "up", "conv", "kernel"), "decoder_dict.lax_2c.blocks.0.up.weight"),
        (("dec_down_blocks_dict_sax_0", "conv", "kernel"), "dec_down_blocks_dict.sax.0.weight"),
        (("encoder", "norm", "scale"), "encoder.norm.weight"),
        (("encoder", "cls_token"), "encoder.cls_token"),
    ],
)
def test_torch_key_matches_jax_bridge(path, key):
    from cinema_tpu.bridge.torch_loader import flax_path_to_torch_key

    assert torch_key(path) == key == flax_path_to_torch_key(path)


def test_patch_grid_sample_aggregate_crop():
    from cinema_tpu.ops import window

    rng = np.random.default_rng(0)
    grid = window.get_patch_grid((10, 7, 24), (6, 7, 16), (3, 3, 8))
    np.testing.assert_array_equal(port_window.get_patch_grid((10, 7, 24), (6, 7, 16), (3, 3, 8)), grid)
    x = rng.normal(size=(10, 7, 24, 2)).astype(np.float32)
    patches = port_window.patch_grid_sample(torch.from_numpy(x), grid, (6, 7, 16))
    np.testing.assert_array_equal(patches.numpy(), np.asarray(window.patch_grid_sample(jnp.asarray(x), grid, (6, 7, 16))))
    noisy = patches.numpy() + rng.normal(size=patches.shape).astype(np.float32)
    np.testing.assert_allclose(
        port_window.aggregate_patches(torch.from_numpy(noisy), grid, (10, 7, 24)).numpy(),
        np.asarray(window.aggregate_patches(jnp.asarray(noisy), grid, (10, 7, 24))),
        atol=1e-6,
    )
    np.testing.assert_array_equal(port_window.crop_start(x, (4, 7, 3, 2)), np.asarray(window.crop_start(jnp.asarray(x), (4, 7, 3, 2))))
    with pytest.raises(ValueError):
        port_window.get_patch_grid((4,), (6,), (0,))
