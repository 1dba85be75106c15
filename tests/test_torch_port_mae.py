"""Port parity of CineMA: loss, predictions, features and the gradient of the
loss for every parameter, the port against ``cinema_tpu`` on the tiny
``mae-c8da747c826c`` fixture checkpoint, with masks drawn by JAX and fed to
both.

f32 on both sides (tests/conftest.py pins XLA matmuls to "highest"). The
tolerances absorb the JAX package's Abramowitz-Stegun GELU (abs err 1.5e-7
per activation) against torch's exact erf: 2e-4 relative on the loss, 5e-4
on predictions and features, and on each gradient 2e-4 of that parameter's
largest entry plus 1e-6.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu.config import load_config as jax_load_config
from cinema_tpu.factory import get_mae_model as jax_get_mae_model
from cinema_tpu.ops.masking import random_patch_mask
from cinema_tpu_torch.config import load_config
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
from cinema_tpu_torch.factory import get_mae_model
from cinema_tpu_torch.models import mae as port_mae
from cinema_tpu_torch.models import vit as port_vit
from test_torch_port_masking import port_mask

FIXTURE = next((Path(__file__).parent / "fixtures" / "example_ckpts").glob("mae-*"))
VIEWS = ("sax", "lax_2c")


@pytest.fixture(scope="module")
def setup():
    """JAX model + params from the fixture checkpoint, numpy images, JAX-drawn masks."""
    from cinema_tpu.bridge.torch_loader import load_torch_state_dict

    jconfig = jax_load_config(FIXTURE / "mae.yaml")
    jmodel = jax_get_mae_model(jconfig)
    rng = np.random.default_rng(0)
    images = {
        "sax": rng.normal(size=(2, 16, 16, 4, 1)).astype(np.float32),
        "lax_2c": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
    }
    template = jmodel.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, {k: jnp.asarray(v) for k, v in images.items()}, 0.75
    )
    state = load_safetensors(FIXTURE / "mae.safetensors")
    params, _, _ = load_torch_state_dict(template, state, strict=True)
    masks = {
        v: random_patch_mask(jax.random.PRNGKey(7 + i), 2, n, 0.75)
        for i, (v, n) in enumerate([("sax", 4), ("lax_2c", 4)])
    }
    return jconfig, params, images, masks, state


def _port_model(state, **overrides):
    model = get_mae_model(load_config(FIXTURE / "mae.yaml"), device="cpu")
    for key, value in overrides.items():
        setattr(model, key, value)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def _jax_model(jconfig, **overrides):
    return jax_get_mae_model(jconfig).clone(**overrides)


def _torch_images(images):
    return {k: torch.from_numpy(v) for k, v in images.items()}


def test_fixture_state_is_the_jax_tree_under_reference_names(setup):
    _, params, _, _, state = setup
    converted = state_dict_from_jax(params)
    assert len(converted) == 133 and set(converted) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(converted[key], value, err_msg=key)
    assert set(_port_model(state).state_dict()) == set(state)


@pytest.mark.parametrize("cross_attn", [True, False], ids=["cross-attn", "self-attn"])
@pytest.mark.parametrize("norm_target", [False, True], ids=["raw-target", "norm-target"])
def test_loss_and_preds_match_jax(setup, cross_attn, norm_target):
    jconfig, params, images, masks, state = setup
    jmodel = _jax_model(jconfig, cross_attn=cross_attn, norm_target=norm_target)
    want_loss, want_preds, _, want_metrics = jmodel.apply(params, {k: jnp.asarray(v) for k, v in images.items()}, 0.75, masks)
    model = _port_model(state, cross_attn=cross_attn, norm_target=norm_target)
    loss, preds, out_masks, metrics = model(_torch_images(images), 0.75, {v: port_mask(m) for v, m in masks.items()})
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=2e-4)
    for v in VIEWS:
        assert preds[v].shape == (2, masks[v].n_masked, 256)
        np.testing.assert_allclose(preds[v].detach().numpy(), np.asarray(want_preds[v]), atol=5e-4, rtol=1e-3)
        assert torch.equal(out_masks[v].mask_ids, torch.from_numpy(np.array(masks[v].mask_ids)).long())
    assert set(metrics) == set(want_metrics)
    for key, value in want_metrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=2e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse-stem", "masked-dense-stem"])
def test_loss_gradients_match_jax_for_every_parameter(setup, sparse):
    jconfig, params, images, masks, state = setup
    jmodel = _jax_model(jconfig, sparse_masking=sparse)
    jimages = {k: jnp.asarray(v) for k, v in images.items()}
    want = state_dict_from_jax(jax.grad(lambda p: jmodel.apply(p, jimages, 0.75, masks)[0])(params))

    model = _port_model(state)
    for enc in model.enc_down_dict.values():
        enc.sparse_masking = sparse
    loss = model(_torch_images(images), 0.75, {v: port_mask(m) for v, m in masks.items()})[0]
    loss.backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want) and len(got) == 133
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=2e-4 * np.abs(want[key]).max() + 1e-6, rtol=0, err_msg=key)


def test_feature_forward_matches_jax(setup):
    jconfig, params, images, _, state = setup
    want = jax_get_mae_model(jconfig).apply(params, {k: jnp.asarray(v) for k, v in images.items()}, method="feature_forward")
    with torch.no_grad():
        got = _port_model(state).eval().feature_forward(_torch_images(images))
    assert list(got) == ["cls", *VIEWS]
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=5e-4, rtol=1e-3)


def test_remat_gives_the_same_loss_and_gradients(setup):
    _, _, images, masks, state = setup
    pmasks = {v: port_mask(m) for v, m in masks.items()}
    plain, remat = _port_model(state), _port_model(state)
    remat.encoder.remat = remat.decoder.remat = True
    grads = []
    for model in (plain, remat):
        loss = model(_torch_images(images), 0.75, pmasks)[0]
        grads.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_masks_drawn_from_a_generator_are_seeded(setup):
    _, _, images, _, state = setup
    model = _port_model(state)
    a = model(_torch_images(images), 0.75, generator=torch.Generator().manual_seed(5))
    b = model(_torch_images(images), 0.75, generator=torch.Generator().manual_seed(5))
    c = model(_torch_images(images), 0.75, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a[0], b[0]) and all(torch.equal(a[2][v].keep_ids, b[2][v].keep_ids) for v in VIEWS)
    assert any(not torch.equal(a[2][v].keep_ids, c[2][v].keep_ids) for v in VIEWS)
    assert a[2]["sax"].n_keep == 1 and a[2]["sax"].n_masked == 3


def test_loss_is_the_mean_of_the_finite_view_losses_and_unknown_views_raise(setup):
    _, _, images, masks, state = setup
    model = _port_model(state)
    pmasks = {v: port_mask(m) for v, m in masks.items()}
    with torch.no_grad():
        loss, _, _, metrics = model(_torch_images(images), 0.75, pmasks)
        torch.testing.assert_close(loss, (metrics["sax_mse_loss"] + metrics["lax_2c_mse_loss"]) / 2)
        model.pred_head_dict["sax"].bias.fill_(float("nan"))
        loss, _, _, metrics = model(_torch_images(images), 0.75, pmasks)
        assert torch.isnan(metrics["sax_mse_loss"]) and torch.equal(loss, metrics["lax_2c_mse_loss"])
        model.pred_head_dict["lax_2c"].bias.fill_(float("nan"))
        assert torch.isnan(model(_torch_images(images), 0.75, pmasks)[0])
    with pytest.raises(ValueError):
        model({"lax_9c": torch.zeros(2, 32, 32, 1)}, 0.75)


@pytest.mark.parametrize(
    "image_size,n_conv,patch,scale,want",
    [((192, 192, 16), 2, (4, 4, 1), (2, 2, 1), (16, 16, 1)), ((256, 256), 2, (4, 4), (2, 2), (16, 16)), ((8, 8), 0, (2, 2), (2, 2), (2, 2))],
)
def test_decoder_patch_size(image_size, n_conv, patch, scale, want):
    from cinema_tpu.models.mae import get_decoder_patch_size

    assert port_mae.get_decoder_patch_size(image_size, n_conv, patch, scale) == want
    assert get_decoder_patch_size(image_size, n_conv, patch, scale) == want


@pytest.mark.parametrize("norm_target", [False, True])
def test_mse_loss_matches_jax(norm_target):
    from cinema_tpu.models.mae import mse_loss

    rng = np.random.default_rng(0)
    target = rng.normal(size=(2, 8, 6)).astype(np.float32) * 2 + 1
    jm = random_patch_mask(jax.random.PRNGKey(0), 2, 8, 0.75)
    pred = rng.normal(size=(2, jm.n_masked, 6)).astype(np.float32)
    want, want_metrics = mse_loss(jnp.asarray(target), jnp.asarray(pred), jm, norm_target)
    got, metrics = port_mae.mse_loss(torch.from_numpy(target), torch.from_numpy(pred), port_mask(jm), norm_target)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(metrics) == set(want_metrics)
    for key, value in want_metrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5, err_msg=key)


def test_vit_decoder_matches_jax_and_rejects_no_masked_tokens():
    from cinema_tpu.models.vit import ViTDecoder

    rng = np.random.default_rng(0)
    x_q = rng.normal(size=(2, 7, 16)).astype(np.float32)
    x_k = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jmod = ViTDecoder(embed_dim=16, depth=2, n_heads=2, norm_eps=1e-6)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x_q), jnp.asarray(x_k), 4)
    port = port_vit.ViTDecoder(16, 2, 2, norm_eps=1e-6)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=True)
    assert port.norm.eps == 1e-5 and port.blocks[0].norm1.eps == 1e-6
    for keys in (x_k, None):
        want = jmod.apply(params, jnp.asarray(x_q), None if keys is None else jnp.asarray(keys), 4)
        got = port(torch.from_numpy(x_q), None if keys is None else torch.from_numpy(keys), 4)
        assert got.shape == (2, 4, 16)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4)
    with pytest.raises(ValueError):
        port(torch.from_numpy(x_q), None, 0)


def test_pos_embed_array_matches_jax():
    from cinema_tpu.models.vit import get_pos_embed_array

    got = port_vit.get_pos_embed_array(16, (2, 3, 4))
    assert got.shape == (1, 24, 16)
    np.testing.assert_array_equal(got, np.asarray(get_pos_embed_array(16, (2, 3, 4))))
