"""Port parity of the MAE masking, the cell bookkeeping and the masked conv
stems: the port against the JAX package on numpy inputs, with masks drawn by
JAX and handed to both.

f32 on both sides; index and layout functions must agree exactly, modules
within 2e-4 (the JAX package's Abramowitz-Stegun GELU against torch's erf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu.ops import masking as jax_masking
from cinema_tpu.ops import patch as jax_patch
from cinema_tpu.ops import sparse_cells as jax_cells
from cinema_tpu_torch.convert import state_dict_from_jax
from cinema_tpu_torch.models import convvit as port_convvit
from cinema_tpu_torch.models import layers as port_layers
from cinema_tpu_torch.ops import masking, patch, sparse_cells

ATOL = 2e-4


def port_mask(m) -> masking.PatchMask:
    """A JAX PatchMask as the port's."""
    return masking.PatchMask(
        bool_mask=torch.from_numpy(np.array(m.bool_mask)),
        keep_ids=torch.from_numpy(np.array(m.keep_ids)).long(),
        mask_ids=torch.from_numpy(np.array(m.mask_ids)).long(),
    )


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize("n_patches,ratio", [(16, 0.75), (64, 0.75), (10, 0.5), (7, 0.3), (4, 1.0)])
def test_random_patch_mask_counts_and_ids(n_patches, ratio):
    m = masking.random_patch_mask(torch.Generator().manual_seed(0), 3, n_patches, ratio)
    n_keep = jax_masking.n_keep_for_ratio(n_patches, ratio)
    assert masking.n_keep_for_ratio(n_patches, ratio) == n_keep
    assert (m.n_patches, m.n_keep, m.n_masked) == (n_patches, n_keep, n_patches - n_keep)
    for b in range(3):
        keep, masked = m.keep_ids[b].tolist(), m.mask_ids[b].tolist()
        assert keep == sorted(keep) and masked == sorted(masked)
        assert sorted(keep + masked) == list(range(n_patches))
        assert m.bool_mask[b].nonzero().flatten().tolist() == masked
    assert m.keep_ids.dtype == torch.int64 and m.bool_mask.dtype == torch.bool


def test_random_patch_mask_is_seeded_and_varies_over_the_batch():
    a = masking.random_patch_mask(torch.Generator().manual_seed(3), 4, 64, 0.75)
    b = masking.random_patch_mask(torch.Generator().manual_seed(3), 4, 64, 0.75)
    c = masking.random_patch_mask(torch.Generator().manual_seed(4), 4, 64, 0.75)
    assert torch.equal(a.keep_ids, b.keep_ids) and not torch.equal(a.keep_ids, c.keep_ids)
    assert not torch.equal(a.keep_ids[0], a.keep_ids[1])


def test_mask_ratio_zero_and_errors():
    m = masking.random_patch_mask(None, 2, 6, 0.0)
    want = jax_masking.full_patch_mask(2, 6)
    assert m.n_masked == 0 and not m.bool_mask.any()
    np.testing.assert_array_equal(m.keep_ids.numpy(), np.asarray(want.keep_ids))
    with pytest.raises(ValueError):
        masking.random_patch_mask(None, 2, 6, 1.5)


@pytest.mark.parametrize("shared", [False, True], ids=["per-sample", "shared-table"])
def test_gather_tokens_is_boolean_indexing(shared):
    rng = np.random.default_rng(0)
    jm = jax_masking.random_patch_mask(jax.random.PRNGKey(0), 3, 12, 0.75)
    m = port_mask(jm)
    x = rng.normal(size=(12, 5) if shared else (3, 12, 5)).astype(np.float32)
    got = masking.gather_tokens(torch.from_numpy(x), m.keep_ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_masking.gather_tokens(jnp.asarray(x), jm.keep_ids)))
    full = torch.from_numpy(np.broadcast_to(x, (3, 12, 5)).copy())
    torch.testing.assert_close(got, full[~m.bool_mask].reshape(3, -1, 5), rtol=0, atol=0)
    masked = masking.gather_tokens(torch.from_numpy(x), m.mask_ids)
    torch.testing.assert_close(masked, full[m.bool_mask].reshape(3, -1, 5), rtol=0, atol=0)


@pytest.mark.parametrize("grid,scale", [((2, 3), (4, 2)), ((2, 2, 4), (2, 2, 1)), ((3,), (5,))])
def test_upsample_and_visible_grid_mask(grid, scale):
    n = int(np.prod(grid))
    jm = jax_masking.random_patch_mask(jax.random.PRNGKey(1), 2, n, 0.5)
    got = masking.visible_grid_mask(port_mask(jm), grid, scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_masking.visible_grid_mask(jm, grid, scale)))
    with pytest.raises(ValueError):
        masking.upsample_mask(torch.zeros(2, 3, 3), (2,))


@pytest.mark.parametrize("shape,cell", [((2, 8, 12, 3), (4, 4)), ((2, 8, 8, 4, 2), (4, 2, 1))])
def test_cells_and_unpatchify_round_trip(shape, cell):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    cells = patch.split_into_cells(torch.from_numpy(x), cell)
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jax_patch.split_into_cells(jnp.asarray(x), cell)))
    grid = tuple(s // c for s, c in zip(shape[1:-1], cell))
    np.testing.assert_array_equal(patch.merge_cells(cells, grid).numpy(), x)
    tokens = patch.patchify(torch.from_numpy(x), cell)
    np.testing.assert_array_equal(patch.unpatchify(tokens, cell, grid).numpy(), x)
    np.testing.assert_array_equal(
        patch.unpatchify(tokens, cell, grid).numpy(), np.asarray(jax_patch.unpatchify(jnp.asarray(tokens.numpy()), cell, grid))
    )
    with pytest.raises(ValueError):
        patch.unpatchify(tokens, cell, tuple(g + 1 for g in grid))


@pytest.mark.parametrize("shape,grid", [((2, 8, 12, 3), (2, 3)), ((2, 8, 8, 4, 2), (2, 2, 4))])
def test_sparse_cells_match_jax_and_round_trip(shape, grid):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    n = int(np.prod(grid))
    jm = jax_masking.random_patch_mask(jax.random.PRNGKey(2), 2, n, 0.5)
    m = port_mask(jm)
    cells = sparse_cells.image_to_cells(torch.from_numpy(x), grid)
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jax_cells.image_to_cells(jnp.asarray(x), grid)))
    vis = sparse_cells.gather_cells(cells, m.keep_ids)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jax_cells.gather_cells(jnp.asarray(cells.numpy()), jm.keep_ids)))
    dense = sparse_cells.scatter_cells(vis, m.keep_ids, n)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jax_cells.scatter_cells(jnp.asarray(vis.numpy()), jm.keep_ids, n)))
    # the ctx works on the conv modules' (batch, chans, *spatial)
    ctx = sparse_cells.CellDenseCtx(grid, m.keep_ids)
    jctx = jax_cells.CellDenseCtx(grid, jm.keep_ids)
    sparse = ctx.sparsify(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_array_equal(sparse.movedim(1, -1).numpy(), np.asarray(jctx.sparsify(jnp.asarray(x))))
    image = ctx.densify(sparse).movedim(1, -1)
    np.testing.assert_array_equal(image.numpy(), np.asarray(jctx.densify(jctx.sparsify(jnp.asarray(x)))))
    vis_mask = masking.visible_grid_mask(m, grid, tuple(s // g for s, g in zip(shape[1:-1], grid)))
    np.testing.assert_array_equal(image.numpy(), x * vis_mask[..., None].numpy())
    with pytest.raises(ValueError):
        sparse_cells.image_to_cells(torch.from_numpy(x), tuple(g + 1 for g in grid))


@pytest.mark.parametrize("shape", [(2, 8, 8, 4, 4), (2, 8, 12, 8)])
def test_masked_conv_block_with_mask_and_with_dense_ctx(shape):
    from cinema_tpu.models.layers import MaskedConvBlock

    rng = np.random.default_rng(0)
    nd = len(shape) - 2
    grid = tuple(s // 4 for s in shape[1:3]) + ((shape[3],) if nd == 3 else ())
    cell = tuple(s // g for s, g in zip(shape[1:-1], grid))
    jm = jax_masking.random_patch_mask(jax.random.PRNGKey(3), 2, int(np.prod(grid)), 0.5)
    m = port_mask(jm)
    x = rng.normal(size=shape).astype(np.float32)
    mod = MaskedConvBlock()
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = _load(port_layers.MaskedConvBlock(nd, shape[-1]), params)

    jvis = jax_masking.visible_grid_mask(jm, grid, cell)
    want = np.asarray(mod.apply(params, jnp.asarray(x), jvis))
    got = port(torch.from_numpy(x).movedim(-1, 1), masking.visible_grid_mask(m, grid, cell))
    np.testing.assert_allclose(got.movedim(1, -1).detach().numpy(), want, atol=ATOL)

    jctx = jax_cells.CellDenseCtx(grid, jm.keep_ids)
    ctx = sparse_cells.CellDenseCtx(grid, m.keep_ids)
    xs = jctx.sparsify(jnp.asarray(x))
    want = np.asarray(mod.apply(params, xs, None, dense_ctx=jctx))
    got = port(ctx.sparsify(torch.from_numpy(x).movedim(-1, 1)), None, dense_ctx=ctx)
    np.testing.assert_allclose(got.movedim(1, -1).detach().numpy(), want, atol=ATOL)
    with pytest.raises(ValueError):
        port(torch.from_numpy(x).movedim(-1, 1), masking.visible_grid_mask(m, grid, cell), dense_ctx=ctx)


STEMS = {
    "sax": dict(image_size=(32, 32, 4), patch_size=(4, 4, 1), scale_factor=(2, 2, 1)),
    "lax": dict(image_size=(32, 32), patch_size=(4, 4), scale_factor=(2, 2)),
}


@pytest.mark.parametrize("view", ["sax", "lax"])
@pytest.mark.parametrize("sparse", [False, True], ids=["masked-dense", "sparse"])
def test_downsample_encoder_and_fusion_with_mask(view, sparse):
    """Masked-dense and sparse stems against the JAX DownsampleEncoder on JAX-drawn masks;
    the two port paths agree at the visible tokens; the fusion takes both kinds of skips."""
    from cinema_tpu.models.convvit import DownsampleEncoder, MultiScaleFusion

    geo = STEMS[view]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *geo["image_size"], 1)).astype(np.float32)
    jmod = DownsampleEncoder(**geo, conv_chans=(4, 8), conv_n_blocks=2, embed_dim=16, sparse_masking=sparse)
    jm = jax_masking.random_patch_mask(jax.random.PRNGKey(4), 2, jmod.n_patches, 0.75)
    m = port_mask(jm)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_skips, want = jmod.apply(params, jnp.asarray(x), jm)

    port = _load(port_convvit.DownsampleEncoder(geo["image_size"], 1, geo["patch_size"], geo["scale_factor"], (4, 8), 2,
                                                16, sparse_masking=sparse), params)
    assert port.n_patches == jmod.n_patches and port.grid_size == jmod.grid_size
    skips, got = port(torch.from_numpy(x).movedim(-1, 1), m)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    for s, w in zip(skips, want_skips):
        np.testing.assert_allclose(s.movedim(-len(geo["image_size"]) - 1, -1).detach().numpy(), np.asarray(w), atol=ATOL)
    assert got.shape[1] == (m.n_keep if sparse else m.n_patches)

    other = port_convvit.DownsampleEncoder(geo["image_size"], 1, geo["patch_size"], geo["scale_factor"], (4, 8), 2, 16,
                                           sparse_masking=not sparse)
    other.load_state_dict(port.state_dict())
    _, twin = other.eval()(torch.from_numpy(x).movedim(-1, 1), m)
    visible = (lambda t: t if t.shape[1] == m.n_keep else masking.gather_tokens(t, m.keep_ids))
    torch.testing.assert_close(visible(got), visible(twin), atol=1e-5, rtol=0)

    jfus = MultiScaleFusion(**geo, conv_chans=(4, 8), embed_dim=16)
    tokens = rng.normal(size=(2, m.n_keep, 16)).astype(np.float32)
    fparams = jfus.init(jax.random.PRNGKey(1), want_skips, jnp.asarray(tokens), jm)
    want_fused = jfus.apply(fparams, want_skips, jnp.asarray(tokens), jm)
    fus = _load(port_convvit.MultiScaleFusion(geo["image_size"], geo["patch_size"], geo["scale_factor"], (4, 8), 16), fparams)
    got_fused = fus(skips, torch.from_numpy(tokens), m)
    np.testing.assert_allclose(got_fused.detach().numpy(), np.asarray(want_fused), atol=ATOL)


def test_stem_drop_path_disables_the_sparse_path():
    port = port_convvit.DownsampleEncoder((32, 32), 1, (4, 4), (2, 2), (4, 8), 1, 16, sparse_masking=True)
    m = masking.random_patch_mask(torch.Generator().manual_seed(0), 2, port.n_patches, 0.75)
    x = torch.zeros(2, 1, 32, 32)
    assert port(x, m)[1].shape[1] == m.n_keep
    port.conv_blocks[0].conv[0].drop_path1.rate = 0.1
    assert port.eval()(x, m)[1].shape[1] == m.n_patches


@pytest.mark.parametrize(
    "key,layer_id",
    [("enc_down_dict.sax.linear.weight", 0), ("encoder.cls_token", 0), ("encoder.blocks.0.attn.q.weight", 1),
     ("encoder.blocks.11.mlp.fc2.bias", 12), ("encoder.norm.weight", 13), ("decoder.blocks.3.norm1.weight", 13),
     ("dec_embed_dict.sax.mask_token", 13)],
)
def test_layer_id_for_vit_matches_jax_on_bridge_keys(key, layer_id):
    from cinema_tpu.models.convvit import get_layer_id_for_vit

    assert port_convvit.get_layer_id_for_vit(key, 13) == layer_id
    flax_path = key.replace("enc_down_dict.sax", "enc_down_dict_sax").replace("dec_embed_dict.sax", "dec_embed_dict_sax")
    flax_path = flax_path.replace("blocks.", "blocks_").replace(".", "/")
    assert get_layer_id_for_vit(flax_path, 13) == layer_id
