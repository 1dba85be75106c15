"""The port's inference examples against the JAX package's scripts, in float32 on the CPU.

Each JAX script (``examples/inference/<name>.py``, imported by path) runs its own ``main`` on the same files
as the port's ``cinema_tpu_torch.examples.inference.<name>``, with the same weights: the baked tiny
checkpoints of ``tests/fixtures/example_ckpts``, at 32x32(x4) where the fixture's 16x16 is degenerate in
torch (the weights do not depend on the size). The JAX script's model loader is wrapped, only to build the
model in float32 (the script asks for bfloat16) and to record what the script feeds it. So the tests hold:

- the port's preprocessing bit-equal to the JAX script's;
- the port's model outputs within 2e-4 of the JAX model's on those inputs (the JAX package's GELU
  approximation);
- the port's artifacts equal to the port's outputs, and to the JAX script's where no argmax tie is near
  (labels and coordinates are compared where the top two logits differ by more than twice the tolerance).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cinema_tpu_torch.data import load_nifti, save_nifti
from cinema_tpu_torch.examples.inference import edes, landmark_heatmap, mae, segmentation_lax_4c
from cinema_tpu_torch.factory import from_finetuned, mae_from_pretrained
from cinema_tpu_torch.serve import preprocess as serve_preprocess
from test_torch_port_masking import port_mask

ATOL = 2e-4
REPO = Path(__file__).resolve().parents[1]
CKPTS = REPO / "tests" / "fixtures" / "example_ckpts"
JAX_EXAMPLES = REPO / "examples" / "inference"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _checkpoint(tmp_path, name, patch_size=None):
    """(weights, config) of the fixture ``name``; with ``patch_size`` the config is rewritten for it."""
    folder = next(CKPTS.glob(f"{name}-*"))
    config = folder / f"{name}.yaml"
    if patch_size is not None:
        data = yaml.safe_load(config.read_text())
        view = data["model"]["views"]
        data["data"]["sax" if view == "sax" else "lax"]["patch_size"] = list(patch_size)
        config = tmp_path / f"{name}.yaml"
        config.write_text(yaml.safe_dump(data))
    return folder / f"{name}.safetensors", config


class _Recorder:
    """A JAX model that records the images of each ``apply`` (through a host callback, so inside ``jit``
    too) and, outside ``jit``, its outputs."""

    def __init__(self, model):
        self._model, self.inputs, self.outputs = model, [], []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, params, images, *args, **kwargs):
        jax.debug.callback(lambda x: self.inputs.append(jax.tree_util.tree_map(np.asarray, x)), images)
        out = self._model.apply(params, images, *args, **kwargs)
        if not any(isinstance(x, jax.core.Tracer) for x in jax.tree_util.tree_leaves(out)):
            self.outputs.append(out)
        return out


def _run_jax_script(name, argv, monkeypatch, loader="from_finetuned"):
    """Run the JAX script's ``main`` with ``argv``; its model is built in float32 and recorded. Returns
    (the recorder, the JAX params)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", JAX_EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    load = getattr(module, loader)
    built = {}

    def float32_loader(*args, dtype=None):
        model, params = load(*args, dtype=jnp.float32)
        built["model"], built["params"] = _Recorder(model), params
        return built["model"], params

    monkeypatch.setattr(module, loader, float32_loader)
    monkeypatch.setattr(sys, "argv", [name, *map(str, argv)])
    module.main()
    jax.effects_barrier()
    return built["model"], built["params"]


def _printed(capsys):
    """The lines a script printed, without the JAX package's log lines."""
    return [line for line in capsys.readouterr().out.splitlines() if " | INFO | " not in line]


def _assert_labels_agree(got, want, logits):
    """Labels equal wherever the top two of the port's ``logits`` (labels' shape + classes) differ by more than
    twice the tolerance; and there are such voxels."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * ATOL
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])


# --- segmentation ----------------------------------------------------------------------------------------------

def test_segmentation_sax_matches_the_jax_script(tmp_path, monkeypatch):
    from cinema_tpu_torch.examples.inference import segmentation_sax

    weights, config = _checkpoint(tmp_path, "seg_sax", (32, 32, 4))
    video = np.random.default_rng(0).uniform(0, 255, size=(30, 28, 3, 10)).astype(np.float32)
    spacing = (1.5, 1.25, 8.0, 1.0)
    save_nifti(tmp_path / "sax_t.nii.gz", video, spacing=spacing)
    common = ["--model", weights, "--config", config, "--image", tmp_path / "sax_t.nii.gz", "--t_step", 2]
    recorder, params = _run_jax_script("segmentation_sax", [*common, "--out", tmp_path / "jax"], monkeypatch)
    segmentation_sax.main([*map(str, common), "--out", str(tmp_path / "port"), "--device", "cpu"])

    # preprocessing: the JAX script's chunks of 8 (the pad repeats the first frames)
    frames = serve_preprocess(video, (32, 32, 4))
    chunks = np.concatenate([x["sax"] for x in recorder.inputs])
    np.testing.assert_array_equal(chunks, np.concatenate([frames, frames[:6]]))

    model = from_finetuned("convunetr", weights, config, device="cpu")
    with torch.no_grad():
        logits = model({"sax": torch.from_numpy(frames)})["sax"].numpy()
    want = np.asarray(jax.jit(recorder._model.apply)(params, {"sax": jnp.asarray(frames)})["sax"])
    np.testing.assert_allclose(logits, want, atol=ATOL, rtol=0)

    got, header = load_nifti(tmp_path / "port" / "segmentation_sax_t.nii.gz")
    jax_labels, jax_header = load_nifti(tmp_path / "jax" / "segmentation_sax_t.nii.gz")
    assert header.spacing == jax_header.spacing == spacing
    assert got.dtype == np.uint8 and got.shape == video.shape
    port_logits = np.moveaxis(logits[:, :30, :28, :3], 0, -2)  # (x, y, z, t, classes)
    np.testing.assert_array_equal(got, port_logits.argmax(-1))
    _assert_labels_agree(got, jax_labels, port_logits)

    gif = (tmp_path / "port" / "segmentation_sax.gif").read_bytes()
    assert gif.startswith(b"GIF89a") and (tmp_path / "port" / "ventricle_volumes.png").read_bytes()[:4] == b"\x89PNG"
    from PIL import Image

    assert Image.open(tmp_path / "port" / "segmentation_sax.gif").n_frames == 5  # t_step 2 of 10 frames


def test_segmentation_lax_4c_matches_the_jax_script(tmp_path, monkeypatch):
    from cinema_tpu_torch.examples.inference import segmentation_lax_4c as script

    weights, config = _checkpoint(tmp_path, "seg_lax", (32, 32))
    video = np.random.default_rng(1).uniform(0, 255, size=(29, 32, 1, 4)).astype(np.float32)
    save_nifti(tmp_path / "lax_t.nii.gz", video, spacing=(1.25, 1.25, 6.0, 1.0))
    common = ["--model", weights, "--config", config, "--image", tmp_path / "lax_t.nii.gz"]
    recorder, params = _run_jax_script("segmentation_lax_4c", [*common, "--out", tmp_path / "jax"], monkeypatch)
    script.main([*map(str, common), "--out", str(tmp_path / "port"), "--device", "cpu"])

    frames = segmentation_lax_4c.preprocess_frames(video, (32, 32))
    (inputs,) = recorder.inputs
    np.testing.assert_array_equal(inputs["lax_4c"], frames)
    model = from_finetuned("convunetr", weights, config, device="cpu")
    logits, labels = script.segment_lax(model, video)
    want = jax.jit(recorder._model.apply)(params, {"lax_4c": jnp.asarray(frames)})["lax_4c"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    got, header = load_nifti(tmp_path / "port" / "segmentation_lax_4c_t.nii.gz")
    jax_labels, _ = load_nifti(tmp_path / "jax" / "segmentation_lax_4c_t.nii.gz")
    assert got.shape == (29, 32, 1, 4) and header.spacing == (1.25, 1.25, 6.0, 1.0)
    np.testing.assert_array_equal(got, labels)
    _assert_labels_agree(got, jax_labels, np.moveaxis(logits.numpy()[:, :29, :32], 0, -2)[:, :, None])
    for artifact in ("segmentation_lax_4c.gif", "lax_4c_areas.png"):
        assert (tmp_path / "port" / artifact).stat().st_size > 0


# --- classification and regression -------------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["classification_cvd", "classification_sex", "classification_vendor",
                                  "regression_age", "regression_bmi", "regression_ef"])
def test_edes_examples_match_the_jax_scripts(tmp_path, monkeypatch, name):
    import importlib

    task = name.split("_")[0]
    weights, config = _checkpoint(tmp_path, "clf" if task == "classification" else "reg")
    rng = np.random.default_rng(len(name))
    for frame in ("ed", "es"):
        save_nifti(tmp_path / f"{frame}.nii.gz", rng.uniform(0, 255, size=(14, 13, 3)).astype(np.float32),
                   spacing=(1, 1, 10))
    argv = ["--model", weights, "--config", config, "--ed", tmp_path / "ed.nii.gz", "--es", tmp_path / "es.nii.gz"]
    recorder, params = _run_jax_script(name, argv, monkeypatch)
    out = importlib.import_module(f"cinema_tpu_torch.examples.inference.{name}").main([*map(str, argv),
                                                                                      "--device", "cpu"])

    image = edes.edes_image(tmp_path / "ed.nii.gz", tmp_path / "es.nii.gz", (16, 16, 4))
    (inputs,) = recorder.inputs
    np.testing.assert_array_equal(inputs["sax"], image)
    want = np.asarray(jax.jit(recorder._model.apply)(params, {"sax": jnp.asarray(image)}), np.float64)[0]
    if task == "classification":
        want = np.exp(want - want.max()) / np.exp(want - want.max()).sum()
        np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(out, want[0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_edes_studies_deeper_than_the_patch_go_through_the_patched_forwards(tmp_path, task):
    """z 7 > 4: the JAX package's ``classification_forward`` / ``regression_forward`` over the patches."""
    from cinema_tpu.bridge.torch_loader import load_torch_state_dict
    from cinema_tpu.factory import get_convvit_model, init_params
    from cinema_tpu.tasks.classification import classification_forward as jax_classification_forward
    from cinema_tpu.tasks.regression import regression_forward as jax_regression_forward
    from cinema_tpu_torch.config import load_config
    from cinema_tpu_torch.convert import load_safetensors

    weights, config = _checkpoint(tmp_path, "clf" if task == "classification" else "reg")
    rng = np.random.default_rng(3)
    for frame in ("ed", "es"):
        save_nifti(tmp_path / f"{frame}.nii.gz", rng.uniform(0, 255, size=(16, 15, 7)).astype(np.float32))
    image = edes.edes_image(tmp_path / "ed.nii.gz", tmp_path / "es.nii.gz", (16, 16, 4))
    assert image.shape == (1, 16, 16, 7, 2)
    got = edes.edes_forward(from_finetuned("convvit", weights, config, device="cpu"), task, image)

    from cinema_tpu.config import load_config as jax_load_config

    jax_model = get_convvit_model(jax_load_config(config), remat=False)
    params, _, _ = load_torch_state_dict(init_params(jax_model), load_safetensors(weights), strict=True)
    forward = jax_classification_forward if task == "classification" else jax_regression_forward
    want = forward(lambda p, imgs: jax_model.apply(p, imgs), params, {"sax": jnp.asarray(image)},
                   {"sax": (16, 16, 4)})
    want = np.asarray(want, np.float64)[0]
    if task == "classification":
        want = np.exp(want) / np.exp(want).sum()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert load_config(config).model.name == "convvit"


# --- landmarks ---------------------------------------------------------------------------------------------------

def _landmark_png(tmp_path, mode, size=(30, 27)):
    """A PNG of ``size`` (rows, columns) that the JAX scripts read through PIL's ``convert("L")``: gray, or RGB
    as ``viz.write_png`` writes it."""
    from cinema_tpu_torch import viz

    rng = np.random.default_rng(9)
    image = rng.integers(0, 90, size=size if mode == "gray" else (*size, 3)).astype(np.uint8)
    image[8:12, 5:9] = 240
    path = tmp_path / f"landmark_{mode}.png"
    viz.write_png(path, image)
    return path


@pytest.mark.parametrize("mode", ["gray", "rgb"])
def test_landmark_heatmap_matches_the_jax_script(tmp_path, monkeypatch, capsys, mode):
    from cinema_tpu.metrics import heatmap_argmax as jax_heatmap_argmax

    weights, config = _checkpoint(tmp_path, "lmk_heat", (32, 32))
    png = _landmark_png(tmp_path, mode)
    argv = ["--model", weights, "--config", config, "--image", png]
    recorder, params = _run_jax_script("landmark_heatmap", argv, monkeypatch)
    jax_lines = _printed(capsys)
    coords = landmark_heatmap.main([*map(str, argv), "--device", "cpu"])
    port_lines = _printed(capsys)

    image, size = landmark_heatmap.png_input(png, (32, 32))
    assert size == (27, 30)
    (inputs,) = recorder.inputs
    np.testing.assert_array_equal(inputs["lax_2c"], image)
    model = from_finetuned("convunetr", weights, config, device="cpu")
    logits = landmark_heatmap.heatmap_logits(model, image, size)
    want = np.asarray(jax.jit(recorder._model.apply)(params, {"lax_2c": jnp.asarray(image)})["lax_2c"])[:, :27, :30]
    np.testing.assert_allclose(logits.numpy(), want, atol=ATOL, rtol=0)
    jax_coords = np.asarray(jax_heatmap_argmax(jnp.asarray(want)))[0].reshape(3, 2)
    flat = np.sort(logits.numpy()[0].reshape(-1, 3), axis=0)
    clear = (flat[-1] - flat[-2]) > 2 * ATOL  # per landmark: no tie near the top
    assert clear.any()
    np.testing.assert_array_equal(coords[clear], jax_coords[clear])
    if clear.all():
        assert port_lines == jax_lines


def test_landmark_coordinate_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    from cinema_tpu_torch.examples.inference import landmark_coordinate

    weights, config = _checkpoint(tmp_path, "lmk_coord")
    png = _landmark_png(tmp_path, "rgb", size=(15, 13))  # within the fixture's 16x16 patch
    argv = ["--model", weights, "--config", config, "--image", png]
    recorder, params = _run_jax_script("landmark_coordinate", argv, monkeypatch)
    jax_lines = _printed(capsys)
    coords = landmark_coordinate.main([*map(str, argv), "--device", "cpu"])
    assert _printed(capsys)[0] == jax_lines[0] == "landmark coordinates (x, y):"

    image, (w, h) = landmark_heatmap.png_input(png, (16, 16))
    (inputs,) = recorder.inputs
    np.testing.assert_array_equal(inputs["lax_2c"], image)
    model = from_finetuned("convvit", weights, config, device="cpu")
    with torch.no_grad():
        out = model({"lax_2c": torch.from_numpy(image)}).numpy()
    want = np.asarray(jax.jit(recorder._model.apply)(params, {"lax_2c": jnp.asarray(image)}))
    np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
    scaled = out[0].reshape(3, 2) * np.array([w, h])
    np.testing.assert_array_equal(coords, scaled.astype(int))
    near = np.abs(scaled - np.round(scaled)) < 2 * ATOL * max(w, h)  # truncation near an integer
    jax_coords = (want[0].reshape(3, 2) * np.array([w, h])).astype(int)
    np.testing.assert_array_equal(coords[~near], jax_coords[~near])


# --- MAE -----------------------------------------------------------------------------------------------------------

@pytest.fixture
def study(tmp_path):
    """A study folder of the ``mae`` fixture's views, 3 frames each."""
    rng = np.random.default_rng(12)
    folder = tmp_path / "study07"
    folder.mkdir()
    save_nifti(folder / "study07_sax_t.nii.gz", rng.uniform(0, 255, size=(14, 16, 3, 3)).astype(np.float32))
    save_nifti(folder / "study07_lax_2c_t.nii.gz", rng.uniform(0, 255, size=(30, 32, 1, 3)).astype(np.float32))
    return folder


def test_mae_from_pretrained_matches_the_jax_one_on_jax_masks():
    from cinema_tpu.factory import mae_from_pretrained as jax_mae_from_pretrained
    from cinema_tpu.ops.masking import random_patch_mask

    weights, config = _checkpoint(None, "mae")
    jax_model, params = jax_mae_from_pretrained(weights, config)
    model = mae_from_pretrained(weights, config, device="cpu")
    assert not model.training and model.views == ["sax", "lax_2c"]
    rng = np.random.default_rng(13)
    images = {"sax": rng.random((2, 16, 16, 4, 1), np.float32), "lax_2c": rng.random((2, 32, 32, 1), np.float32)}
    masks = {v: random_patch_mask(jax.random.PRNGKey(20 + i), 2, 4, 0.75) for i, v in enumerate(images)}
    loss, preds, _, _ = jax.jit(jax_model.apply, static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in images.items()}, 0.75, masks)
    with torch.no_grad():
        got_loss, got_preds, _, _ = model({k: torch.from_numpy(v) for k, v in images.items()}, 0.75,
                                          {v: port_mask(m) for v, m in masks.items()})
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=ATOL)
    for view in images:
        np.testing.assert_allclose(got_preds[view].numpy(), np.asarray(preds[view]), atol=ATOL, rtol=0)


def test_mae_example_matches_the_jax_script_on_its_masks(tmp_path, monkeypatch, capsys, study):
    weights, config = _checkpoint(tmp_path, "mae")
    argv = ["--model", weights, "--config", config, "--study_dir", study]
    recorder, _ = _run_jax_script("mae", [*argv, "--out", tmp_path / "jax"], monkeypatch,
                                  loader="mae_from_pretrained")
    jax_loss = float(capsys.readouterr().out.split("loss=")[1].split(";")[0])
    (inputs,) = recorder.inputs
    (jax_out,) = recorder.outputs

    model = mae_from_pretrained(weights, config, device="cpu")
    images = mae.study_images(model, study)
    for view in model.views:
        np.testing.assert_array_equal(images[view], inputs[view])
    loss, _, _, recons, mask_vols = mae.reconstruct(model, images, 0.75,
                                                    {v: port_mask(m) for v, m in jax_out[2].items()})
    np.testing.assert_allclose(float(loss), float(jax_out[0]), rtol=ATOL)
    np.testing.assert_allclose(float(loss), jax_loss, atol=1e-4)  # the printed loss, 4 decimals
    for view in model.views:
        np.testing.assert_allclose(recons[view], np.load(tmp_path / "jax" / f"recon_{view}.npy"), atol=ATOL, rtol=0)
        n_masked = np.asarray(jax_out[2][view].mask_ids).shape[1]
        assert mask_vols[view].mean() == pytest.approx(n_masked / 4)  # 3 of the 4 patches masked

    # the port's own run: masks from a generator seeded 0; its files are what ``reconstruct`` gives for them
    result = mae.main([*map(str, argv), "--out", str(tmp_path / "port"), "--device", "cpu"])
    again = mae.reconstruct(model, images, 0.75, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(result[3]["sax"], again[3]["sax"])
    for view in model.views:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"recon_{view}.npy"), result[3][view])
    assert (tmp_path / "port" / "mae_reconstruction.png").read_bytes()[:4] == b"\x89PNG"


def test_mae_feature_extraction_matches_the_jax_script(tmp_path, monkeypatch, study):
    from cinema_tpu_torch.examples.inference import mae_feature_extraction

    weights, config = _checkpoint(tmp_path, "mae")
    argv = ["--model", weights, "--config", config, "--study_dir", study, "--frame", 2]
    recorder, _ = _run_jax_script("mae_feature_extraction", [*argv, "--out", tmp_path / "jax.npz"], monkeypatch,
                                  loader="mae_from_pretrained")
    out = mae_feature_extraction.main([*map(str, argv), "--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    model = mae_from_pretrained(weights, config, device="cpu")
    (inputs,) = recorder.inputs
    for view, image in mae.study_images(model, study, frame=2).items():
        np.testing.assert_array_equal(image, inputs[view])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files) == ["cls", "lax_2c", "sax"]
    for key in want.files:
        assert got[key].dtype == np.float32 and got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got[key], out[key])
