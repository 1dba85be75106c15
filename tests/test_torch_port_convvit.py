"""Port parity of ConvViT, the classification and regression model: the ``clf`` and
``reg`` fixture checkpoints through ``from_finetuned`` on both sides, every ``reduce``,
with and without a mask, the default model (packed attention) and ``rotary=True``
(per-head attention); the weight converters; the MAE -> ConvViT transfer.

The JAX side runs its Pallas kernels in interpret mode (``attn_impl="pallas"``); the
port's wrappers take their plain versions on CPU tensors. f32, outputs to 2e-4.
"""

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu.ops.masking import random_patch_mask
from cinema_tpu_torch import convert, factory
from cinema_tpu_torch.config import load_config
from test_torch_port_masking import port_mask

CKPTS = Path(__file__).parent / "fixtures" / "example_ckpts"
ATOL = 2e-4


def _fixture(kind):
    folder = next(CKPTS.glob(f"{kind}-*"))
    return folder / f"{kind}.safetensors", folder / f"{kind}.yaml"


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _images(model, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return {v: rng.random((batch, *model.image_size_dict[v], model.n_frames * model.in_chans_dict[v])).astype(np.float32)
            for v in model.views}


@pytest.fixture(scope="module", params=["clf", "reg"])
def pair(request):
    """(kind, JAX model, JAX params, port model) from one fixture checkpoint."""
    from cinema_tpu.factory import from_finetuned as jax_from_finetuned

    model_path, config_path = _fixture(request.param)
    jmodel, jparams = jax_from_finetuned("convvit", model_path, config_path)
    model = factory.from_finetuned("convvit", model_path, config_path, device="cpu")
    return request.param, jmodel, jparams, model


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("reduce", ["patch", "all", "cls"])
def test_from_finetuned_forward_matches_jax(pair, reduce, masked):
    kind, jmodel, jparams, model = pair
    assert not model.training and model.pred_head_dict["cls"].out_features == (5 if kind == "clf" else 1)
    images = _images(model)
    jmask = mask = None
    if masked:
        n_patches = {v: model.enc_down_dict[v].n_patches for v in model.views}
        jmask = {v: random_patch_mask(jax.random.PRNGKey(3 + i), 2, n, 0.5) for i, (v, n) in enumerate(n_patches.items())}
        mask = {v: port_mask(m) for v, m in jmask.items()}
    want = jmodel.clone(attn_impl="pallas").apply(jparams, {v: jnp.asarray(x) for v, x in images.items()}, jmask, reduce)
    with torch.no_grad():
        got = model({v: torch.from_numpy(x) for v, x in images.items()}, mask, reduce)
    assert got.shape == want.shape == (2, model.pred_head_dict["cls"].out_features)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_rotary_convvit_takes_the_per_head_path_and_matches_jax(pair):
    from cinema_tpu_torch.ops import flash_attention as fa

    kind, jmodel, jparams, model = pair
    model_path, config_path = _fixture(kind)
    rotary = factory.get_convvit_model(load_config(config_path), device="cpu", remat=False, rotary=True)
    rotary.load_state_dict(model.state_dict())  # the rotation has no parameter
    images = _images(model, seed=1)
    want = jmodel.clone(rotary=True, attn_impl="pallas").apply(jparams, {v: jnp.asarray(x) for v, x in images.items()})
    default = jmodel.apply(jparams, {v: jnp.asarray(x) for v, x in images.items()})
    torch_images = {v: torch.from_numpy(x).requires_grad_() for v, x in images.items()}
    got = rotary(torch_images)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.abs(np.asarray(want) - np.asarray(default)).max() > 10 * ATOL  # the rotation does change the output
    # every block went through the per-head Function, none through the packed one
    names = []
    todo, seen = [got.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    assert names.count("_HeadsAttentionBackward") == len(rotary.encoder.blocks)
    assert names.count("_SplitKVBackward") == len(rotary.encoder.blocks) and not any("Packed" in n for n in names)
    reused = fa.split_kv.reused
    got.sum().backward()
    assert fa.split_kv.reused == reused + len(rotary.encoder.blocks)


def test_feature_forward_and_errors(pair):
    _, jmodel, jparams, model = pair
    images = _images(model, seed=2)
    want = jmodel.apply(jparams, {v: jnp.asarray(x) for v, x in images.items()}, method=jmodel.feature_forward)
    with torch.no_grad():
        got = model.feature_forward({v: torch.from_numpy(x) for v, x in images.items()})
    assert list(got) == list(want) == ["cls", *model.views]
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0, err_msg=key)
    with pytest.raises(ValueError, match="must be in"):
        model({"lax_9c": torch.zeros(1, 4, 4, 2)})
    with pytest.raises(NotImplementedError, match="reduce"):
        model({v: torch.from_numpy(x) for v, x in images.items()}, reduce="max")
    headless = factory.get_convvit_model(load_config(_fixture("clf")[1]), device="cpu", use_head=False)
    assert not hasattr(headless, "pred_head_dict")


def test_state_dict_from_jax_round_trip(pair):
    """JAX params -> port names and layouts -> the fixture's own tensors (frozen pos-embeds aside)."""
    kind, _, jparams, model = pair
    state = convert.state_dict_from_jax(jparams)
    saved = convert.load_safetensors(_fixture(kind)[0])
    assert set(state) == set(model.state_dict()) == {k for k in saved if not k.endswith("pos_embed")}
    for key, value in state.items():
        np.testing.assert_array_equal(value, saved[key], err_msg=key)
    assert "pred_head_dict.cls.weight" in state and "pred_head_dict.sax.bias" in state


def test_state_dict_from_jax_names_the_optional_parameters():
    from cinema_tpu.models.vit import Block

    params = Block(n_heads=2, qk_norm=True, init_values=0.1, mlp_type="swiglu").init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16)))
    keys = set(convert.state_dict_from_jax(params))
    assert {"attn.q_norm.weight", "attn.k_norm.bias", "mlp.fc1_g.weight", "mlp.fc1_x.bias", "ls1_gamma", "ls2_gamma"} <= keys


def test_from_finetuned_rejects_a_wrong_frozen_table_and_an_unknown_kind(tmp_path):
    model_path, config_path = _fixture("clf")
    state = convert.load_safetensors(model_path)
    model = factory.from_finetuned("convvit", model_path, config_path, device="cpu")
    # the reference's checkpoints carry the frozen sincos tables: a right one is dropped, a wrong one raises
    (key, table), = factory.expected_frozen_pos_embeds(model).items()
    assert key == "enc_down_dict.sax.pos_embed"
    convert.save_safetensors(tmp_path / "good.safetensors", {**state, key: table.astype(np.float32)})
    again = factory.from_finetuned("convvit", tmp_path / "good.safetensors", config_path, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))
    convert.save_safetensors(tmp_path / "bad.safetensors", {**state, key: table.astype(np.float32) + 1.0})
    with pytest.raises(ValueError, match="Frozen constant"):
        factory.from_finetuned("convvit", tmp_path / "bad.safetensors", config_path, device="cpu")
    with pytest.raises(ValueError, match="kind must be"):
        factory.from_finetuned("resnet", model_path, config_path, device="cpu")


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_load_pretrain_weights_matches_the_jax_loader(kind):
    """MAE fixture -> ConvViT: same tensors, same loaded keys, same freeze mask; the first conv
    of the stem is inflated from one frame to ``n_frames`` channels."""
    from cinema_tpu.bridge.torch_loader import load_pretrain_weights, loaded_freeze_mask
    from cinema_tpu.config import load_config as jax_load_config
    from cinema_tpu.factory import get_convvit_model, init_params

    config_path = _fixture(kind)[1]
    mae_state = convert.load_safetensors(_fixture("mae")[0])
    jmodel = get_convvit_model(jax_load_config(config_path))
    template = init_params(jmodel)
    jparams, jloaded = load_pretrain_weights(template, "sax", mae_state, keep_fusion=False)
    jmask = {convert.torch_key(path): bool(v)
             for path, v in convert._flatten(loaded_freeze_mask(template, jloaded)["params"]).items()}

    model = factory.init_weights(factory.get_convvit_model(load_config(config_path), device="cpu"), seed=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = convert.load_pretrain_weights(model, "sax", mae_state, keep_fusion=False)
    assert loaded == jloaded and len(loaded) > 50
    mask = convert.loaded_freeze_mask(model, loaded)
    assert mask == jmask
    want = convert.state_dict_from_jax(jparams)
    inflated = "enc_down_dict.sax.conv_blocks.0.patch_embed.conv.weight"
    assert mae_state[inflated].shape[1] == 1 and model.state_dict()[inflated].shape[1] == 2 and mask[inflated]
    for key, value in model.state_dict().items():
        if mask[key]:
            np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)
        else:
            assert torch.equal(value, before[key]), key  # not loaded: left as initialised
    assert not mask["pred_head_dict.cls.weight"] and not any(mask[k] for k in mask if "fusion" in k)
    with pytest.raises(ValueError, match="Unexpected keys"):
        convert.load_pretrain_weights(model, "sax", {"encoder.blocks.99.norm1.weight": np.zeros(4, np.float32)})


def test_cinema_with_rotary_fails_in_the_decoder_on_both_sides():
    """Rotary needs one sequence for q and k; CineMA's decoder cross-attends, so it raises in both packages."""
    from cinema_tpu.config import load_config as jax_load_config
    from cinema_tpu.factory import get_mae_model as jax_get_mae_model

    config_path = _fixture("mae")[1]
    jmodel = jax_get_mae_model(jax_load_config(config_path)).clone(rotary=True)
    rng = np.random.default_rng(0)
    batch = {"sax": rng.random((1, 16, 16, 4, 1)).astype(np.float32), "lax_2c": rng.random((1, 32, 32, 1)).astype(np.float32)}
    with pytest.raises(ValueError, match="different query and key"):
        jmodel.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, {k: jnp.asarray(v) for k, v in batch.items()}, 0.75)
    port = factory.get_mae_model(load_config(config_path), device="cpu", rotary=True, mlp_type="swiglu")
    assert all(b.attn.rotary and "fc1_g" in dict(b.mlp.named_children()) for b in [*port.encoder.blocks, *port.decoder.blocks])
    with pytest.raises(ValueError, match="different query and key"):
        port({k: torch.from_numpy(v) for k, v in batch.items()}, 0.75, generator=torch.Generator().manual_seed(0))
    unet = factory.get_convunetr_model(load_config(_fixture("seg_sax")[1]), device="cpu", rotary=True)
    assert all(b.attn.rotary for b in unet.encoder.blocks)
