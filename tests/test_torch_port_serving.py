"""Port parity on the serving path: the baked tiny ``seg_sax`` checkpoint
(reference key names) loaded by both packages, the SAX cine pipeline of
``cinema_tpu_torch.serve`` against the JAX package's transforms and model,
and the packaged ACDC config against its YAML.

f32 on both sides; tolerance 2e-4 for the GELU approximation of the JAX
package (see tests/test_torch_port_convunetr.py).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu_torch import factory as port_factory
from cinema_tpu_torch import serve
from cinema_tpu_torch.config import PACKAGED, from_dict, load_config
from cinema_tpu_torch.convert import drop_frozen_pos_embeds, load_safetensors, state_dict_from_jax

ATOL = 2e-4
REPO = Path(__file__).resolve().parents[1]
FIXTURE = next((REPO / "tests" / "fixtures" / "example_ckpts").glob("seg_sax-*"))
CKPT, CONFIG = FIXTURE / "seg_sax.safetensors", FIXTURE / "seg_sax.yaml"


# The fixture's own 16x16x4 geometry is degenerate: its ViT grid (1, 1, 4) is
# smaller than the decoder's extra stride-(2, 2, 1) downsample conv, which
# torch refuses (as the reference CineMA does) while XLA returns an empty
# level. Its weights are size-independent, so the models that run them are
# built for 32x32x4 images; loading at the fixture's own size is tested too.
SIZE = (32, 32, 4)


def _config():
    config = load_config(CONFIG)
    config.data.sax.patch_size = list(SIZE)
    return config


@pytest.fixture(scope="module")
def jax_seg_sax():
    from cinema_tpu.bridge.torch_loader import load_torch_state_dict
    from cinema_tpu.factory import get_convunetr_model, init_params
    from jax.experimental.pallas import tpu as pltpu

    model = get_convunetr_model(_config(), remat=False).clone(attn_impl="pallas")
    with pltpu.force_tpu_interpret_mode():
        params = init_params(model)
    params, _, _ = load_torch_state_dict(params, load_safetensors(CKPT), strict=True)
    return model, params


@pytest.fixture(scope="module")
def port_seg_sax():
    model = port_factory.get_convunetr_model(_config(), device="cpu")
    state = drop_frozen_pos_embeds(load_safetensors(CKPT), {})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def test_from_finetuned_loads_the_fixture_as_jax_does(port_seg_sax):
    """Both packages' from_finetuned at the fixture's own size: the same
    weights (the port's own safetensors reader; frozen pos-embeds checked)."""
    from cinema_tpu.factory import from_finetuned

    _, params = from_finetuned("convunetr", CKPT, CONFIG)
    port = port_factory.from_finetuned("convunetr", CKPT, CONFIG, device="cpu")
    want = state_dict_from_jax(params)
    got = port.state_dict()
    assert sorted(got) == sorted(want) == sorted(port_seg_sax.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_safetensors_reader_matches_the_library():
    from safetensors.numpy import load_file

    want = load_file(str(CKPT))
    got = load_safetensors(CKPT)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_seg_sax_fixture_logits_match_jax(jax_seg_sax, port_seg_sax):
    model, params = jax_seg_sax
    image = np.random.default_rng(0).normal(size=(3, *SIZE, 1)).astype(np.float32)
    want = jax.jit(model.apply)(params, {"sax": jnp.asarray(image)})["sax"]
    with torch.no_grad():
        got = port_seg_sax({"sax": torch.from_numpy(image)})["sax"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_state_dict_from_jax_inverts_the_bridge(jax_seg_sax, port_seg_sax):
    """The JAX params loaded from the checkpoint convert back to the
    checkpoint's own tensors, ConvTranspose kernels included."""
    _, params = jax_seg_sax
    converted = state_dict_from_jax(params)
    checkpoint = {k: v for k, v in load_safetensors(CKPT).items() if not k.endswith("pos_embed")}
    assert sorted(converted) == sorted(checkpoint) == sorted(port_seg_sax.state_dict())
    assert any(".up.weight" in k for k in converted)
    for k, v in checkpoint.items():
        np.testing.assert_array_equal(converted[k], v, err_msg=k)


def test_frozen_pos_embed_is_checked(tmp_path):
    """A checkpoint's frozen sincos table is checked against the recomputed
    one and dropped (the fixture has none; reference checkpoints do)."""
    table = port_factory.expected_frozen_pos_embeds(
        port_factory.get_convunetr_model(load_config(CONFIG), device="cpu")
    )
    for name, offset in (("good", 0.0), ("bad", 1.0)):
        state = load_safetensors(CKPT) | {k: v + offset for k, v in table.items()}
        _write_safetensors(tmp_path / f"{name}.safetensors", state)
    port_factory.from_finetuned("convunetr", tmp_path / "good.safetensors", CONFIG, device="cpu")
    with pytest.raises(ValueError, match="pos_embed"):
        port_factory.from_finetuned("convunetr", tmp_path / "bad.safetensors", CONFIG, device="cpu")


def _write_safetensors(path, arrays):
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v) for k, v in arrays.items()}, str(path))


def _jax_serve(model, params, video):
    """examples/inference/segmentation_sax.py's pipeline, the reference."""
    from cinema_tpu.data.transforms import ScaleIntensityd, SpatialPadd
    from cinema_tpu.inference import video_forward
    from cinema_tpu.ops.window import crop_start

    patch_size = tuple(model.image_size_dict["sax"])
    frames = []
    for t in range(video.shape[-1]):
        data = {"sax_image": video[..., t][..., None].astype(np.float32)}
        data = ScaleIntensityd("sax_image")(data, None)
        data = SpatialPadd("sax_image", patch_size)(data, None)
        frames.append(data["sax_image"])
    labels = video_forward(
        lambda x: model.apply(params, {"sax": x}, method=model.predict_labels)["sax"], jnp.asarray(np.stack(frames)), 8
    )
    labels = np.asarray(crop_start(np.asarray(labels), (video.shape[-1], *video.shape[:3])))
    return np.moveaxis(labels, 0, -1)


def test_segment_cine_matches_the_jax_pipeline(jax_seg_sax, port_seg_sax):
    """11 frames (one full chunk of 8 and a wrapped one) of a cine smaller
    than the patch in x and z: scaled, end-padded, segmented, cropped back."""
    model, params = jax_seg_sax
    video = np.random.default_rng(1).uniform(-50, 300, size=(27, 32, 3, 11)).astype(np.float32)
    want = _jax_serve(model, params, video)
    got = serve.segment_cine(port_seg_sax, video)
    assert got.shape == video.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_serve_main_writes_labels(tmp_path, monkeypatch, port_seg_sax):
    import yaml

    config, ckpt = tmp_path / "config.yaml", tmp_path / "model.safetensors"
    config.write_text(yaml.safe_dump(_to_plain(_config())))
    state = {k: v.numpy() for k, v in port_seg_sax.state_dict().items()}
    _write_safetensors(ckpt, state | port_factory.expected_frozen_pos_embeds(port_seg_sax))
    video = np.random.default_rng(2).uniform(0, 1, size=(*SIZE, 3)).astype(np.float32)
    np.save(tmp_path / "cine.npy", video)
    out = tmp_path / "out" / "labels.npy"
    argv = ["serve", "--config", str(config), "--model", str(ckpt), "--video", str(tmp_path / "cine.npy"),
            "--out", str(out), "--device", "cpu"]
    monkeypatch.setattr("sys.argv", argv)
    serve.main()
    np.testing.assert_array_equal(np.load(out), serve.segment_cine(port_seg_sax, video))


def _to_plain(x):
    if isinstance(x, dict):
        return {k: _to_plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_plain(v) for v in x]
    return x


def test_scale_intensity_matches_jax():
    from cinema_tpu.data.transforms import ScaleIntensityd, SpatialPadd

    x = np.random.default_rng(3).uniform(-10, 10, size=(5, 6, 3, 1)).astype(np.float32)
    want = SpatialPadd("x", (8, 6, 4))(ScaleIntensityd("x")({"x": x}, None), None)["x"]
    np.testing.assert_allclose(serve.spatial_pad(serve.scale_intensity(x), (8, 6, 4)), want, atol=1e-7)
    flat = np.full((2, 2, 1), 3.0, np.float32)
    np.testing.assert_array_equal(serve.scale_intensity(flat), ScaleIntensityd("x")({"x": flat}, None)["x"])


def test_packaged_acdc_config_matches_yaml():
    yaml_config = load_config(REPO / "cinema_tpu" / "configs" / "segmentation" / "acdc.yaml")
    packaged = from_dict(PACKAGED["segmentation/acdc"])
    assert packaged.model.convunetr == yaml_config.model.convunetr
    for key in ("name", "views", "out_chans"):
        assert packaged.model[key] == yaml_config.model[key]
    assert packaged.data.sax == yaml_config.data.sax
    assert packaged.data.name == yaml_config.data.name
