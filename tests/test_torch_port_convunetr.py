"""Port parity, whole model: ConvUNetR and its inference wrappers against the
JAX package, whose attention runs the Pallas packed flash kernel in
interpret mode (``attn_impl="pallas"``), on the same numpy inputs and the
same weights (through ``state_dict_from_jax``).

f32 on both sides (tests/conftest.py pins XLA matmuls to "highest"); the
tolerance 2e-4 absorbs the JAX package's Abramowitz-Stegun GELU against
torch's exact erf, as tests/test_torch_parity_convunetr.py does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu_torch import inference as port_inference
from cinema_tpu_torch import trace
from cinema_tpu_torch.convert import state_dict_from_jax
from cinema_tpu_torch.models.convunetr import ConvUNetR as PortConvUNetR

ATOL = 2e-4
SIZES = {"sax": (32, 32, 4), "lax_2c": (32, 32)}
# ViT grid 2x2x4 (+ 2x2 for lax_2c): 17 or 21 tokens with cls, not a multiple
# of the kernel's 128-row blocks; head_dim 16
ARCH = dict(
    in_chans_dict={"sax": 1, "lax_2c": 1},
    out_chans=4,
    enc_patch_size_dict={"sax": (4, 4, 1), "lax_2c": (4, 4)},
    enc_scale_factor_dict={"sax": (2, 2, 1), "lax_2c": (2, 2)},
    enc_conv_chans=(8, 16),
    enc_conv_n_blocks=1,
    enc_embed_dim=32,
    enc_depth=2,
    enc_n_heads=2,
    dec_chans=(4, 8, 16, 24, 32),
    dec_patch_size_dict={"sax": (2, 2, 1), "lax_2c": (2, 2)},
    dec_scale_factor_dict={"sax": (2, 2, 1), "lax_2c": (2, 2)},
)


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _arch(views):
    return {k: ({v: val[v] for v in views} if isinstance(val, dict) else val) for k, val in ARCH.items()}


@functools.cache
def _models(views):
    """The JAX model (Pallas attention), its params, its jitted apply and the
    port loaded with the same params; built once per views for the module."""
    from cinema_tpu.models.convunetr import ConvUNetR
    from jax.experimental.pallas import tpu as pltpu

    image_size_dict = {v: SIZES[v] for v in views}
    jax_model = ConvUNetR(image_size_dict=image_size_dict, attn_impl="pallas", **_arch(views))
    example = {v: jnp.zeros((2, *SIZES[v], 1), jnp.float32) for v in views}
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), example)
    port = PortConvUNetR(image_size_dict=image_size_dict, **_arch(views))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=True)
    return jax_model, params, jax.jit(jax_model.apply), port.eval()


def _images(views, batch=2, seed=0, sax_size=None):
    rng = np.random.default_rng(seed)
    sizes = dict(SIZES, sax=sax_size or SIZES["sax"])
    return {v: rng.normal(size=(batch, *sizes[v], 1)).astype(np.float32) for v in views}


def _torch(images):
    return {k: torch.from_numpy(v) for k, v in images.items()}


@pytest.mark.parametrize("views", [("sax",), ("sax", "lax_2c")], ids=["sax", "sax+lax_2c"])
def test_convunetr_logits_match_jax(views):
    _, params, apply, port = _models(views)
    images = _images(views)
    want = apply(params, {k: jnp.asarray(v) for k, v in images.items()})
    before = trace.counter("attention.packed.launches")
    with torch.no_grad():
        got = port(_torch(images))
    assert trace.counter("attention.packed.launches") == before  # CPU tensors take the plain version
    for v in views:
        assert got[v].shape == (2, *SIZES[v], 4)
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want[v]), atol=ATOL, rtol=0, err_msg=v)


def test_predict_labels_match_jax():
    views = ("sax", "lax_2c")
    jax_model, params, _, port = _models(views)
    images = _images(views, seed=1)
    want = jax.jit(lambda p, x: jax_model.apply(p, x, method=jax_model.predict_labels))(
        params, {k: jnp.asarray(v) for k, v in images.items()}
    )
    with torch.no_grad():
        got = port.predict_labels(_torch(images))
    for v in views:
        assert got[v].dtype == torch.uint8
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(want[v]), err_msg=v)


def test_sliding_window_forward_matches_jax():
    """One oversized SAX view (z = 6 against patch z = 4: two patches that
    overlap in z = 2..3), the LAX view repeated per patch."""
    from cinema_tpu.inference import sliding_window_forward

    views = ("sax", "lax_2c")
    _, params, apply, port = _models(views)
    images = _images(views, batch=1, seed=2, sax_size=(32, 32, 6))
    patch_size = {v: SIZES[v] for v in views}
    want = sliding_window_forward(lambda x: apply(params, x), {k: jnp.asarray(v) for k, v in images.items()}, patch_size)
    with torch.no_grad():
        got = port_inference.sliding_window_forward(port, _torch(images), patch_size)
    for v in views:
        assert got[v].shape == (1, *images[v].shape[1:-1], 4)
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want[v]), atol=ATOL, rtol=0, err_msg=v)


def test_video_forward_matches_jax():
    """5 frames in chunks of 2: the last chunk is filled by wrap-indexing."""
    from cinema_tpu.inference import video_forward

    jax_model, params, _, port = _models(("sax", "lax_2c"))
    video = np.random.default_rng(3).normal(size=(5, *SIZES["sax"], 1)).astype(np.float32)
    want = video_forward(lambda x: jax_model.apply(params, {"sax": x})["sax"], jnp.asarray(video), 2)
    with torch.no_grad():
        got = port_inference.video_forward(lambda x: port({"sax": x})["sax"], torch.from_numpy(video), 2)
    assert got.shape == (5, *SIZES["sax"], 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_video_forward_wraps_short_videos():
    """Fewer frames than one chunk: the chunk is filled by wrap-indexing."""
    calls = []

    def forward(x):
        calls.append(x.shape[0])
        return x * 2

    video = torch.arange(3, dtype=torch.float32).reshape(3, 1)
    out = port_inference.video_forward(forward, video, 8)
    assert calls == [8]
    torch.testing.assert_close(out, video * 2)


def test_pad_to_multiple_matches_jax():
    from cinema_tpu.inference import pad_to_multiple

    x = np.random.default_rng(0).normal(size=(13, 7, 5, 1)).astype(np.float32)
    got, shape = port_inference.pad_to_multiple(x, (8, 1, 4))
    want, want_shape = pad_to_multiple(x, (8, 1, 4))
    assert shape == want_shape == (13, 7, 5)
    np.testing.assert_array_equal(got, want)
