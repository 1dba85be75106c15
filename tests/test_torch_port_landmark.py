"""The landmark slice as a whole: the heatmap and coordinate losses, the argmax metrics,
the sigmoid sliding window, the PNG reader, the landmark datasets, the two task loss
functions, supervised train steps and both evaluation functions of tiny 2-D ConvUNetR
and ConvViT models against ``cinema_tpu`` from the same weights and inputs, the
``lmk_coord`` fixture's forward, and rehearsals of both entry points on the CPU with
synthetic PNGs.

f32 on both sides (tests/conftest.py pins XLA matmuls to "highest"); the JAX side runs
its packed Pallas kernels in interpret mode. Loss values agree to 1e-6 relative and
their input gradients to 1e-5 relative; logits, task losses and parameters after the
train steps to 2e-4, as in the other port tests (the JAX package's approximate GELU
against torch's exact erf). The k half of every ``attn.kv.bias`` and the weight of
ConvUNetR's LayerNorm over the one-channel input image are left out of the parameter
comparison: both have a zero gradient analytically and rounding noise on either side,
which Adam turns into full steps (tests/test_torch_port_segmentation.py).

The argmax tie rule: coordinates of the two packages are compared exactly only where
every channel's gap between its two largest logits exceeds twice the logits'
tolerance, and the tests assert that gap.
"""

import functools
import json
import struct
import warnings
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cinema_tpu_torch import data, factory, inference, losses, metrics
from cinema_tpu_torch.config import PACKAGED, from_dict
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
from cinema_tpu_torch.data import BatchLoader, LandmarkDetectionDataset, LandmarkRegressionDataset
from cinema_tpu_torch.tasks.classification import get_classification_model
from cinema_tpu_torch.tasks.regression import landmark as reg_landmark
from cinema_tpu_torch.tasks.segmentation import landmark as seg_landmark
from cinema_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from cinema_tpu_torch.train.optim import build_optimizer
from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step

ATOL = 2e-4
VIEW = "lax_2c"
PATCH = (32, 32)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_steps=1, max_n_steps=10, weight_decay=0.05, clip_grad=5.0, layer_decay=0.75,
           n_blocks=1)
# zero gradient analytically, see the module docstring
ONE_CHANNEL_NORM_WEIGHTS = {f"dec_image_conv_block_dict.{VIEW}.norm1.weight"}
CKPTS = Path(__file__).parent / "fixtures" / "example_ckpts"
TASKS = ("segmentation", "regression")


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _tiny_config(task):
    """The packaged landmark config at 32x32 with a tiny ViT (embed 16, one block, two heads),
    narrow stems, no dropout and no recomputation."""
    config = from_dict(PACKAGED[f"{task}/landmark"])
    config.grad_ckpt = False
    config.data.lax.patch_size = list(PATCH)
    if task == "segmentation":
        config.model.convunetr.update(size="tiny", enc_conv_chans=[8, 16], enc_conv_n_blocks=1,
                                      dec_chans=[4, 8, 16, 24, 32], dropout=0.0, drop_path=0.0)
    else:
        config.model.convvit.update(size="tiny", enc_conv_chans=[8, 16], enc_conv_n_blocks=1, dropout=0.0,
                                    drop_path=0.0)
    return config


def _jax_config(config):
    from cinema_tpu.config import from_dict as jax_from_dict

    return jax_from_dict(json.loads(json.dumps(config)))


@functools.cache
def _jax_model(task):
    """The JAX package's model of the tiny config through its own factory (Pallas attention), its
    seeded parameters and its jitted apply."""
    from cinema_tpu.factory import get_segmentation_model as jax_segmentation_model
    from cinema_tpu.factory import init_params
    from cinema_tpu.tasks.classification import get_classification_model as jax_classification_model

    jconfig = _jax_config(_tiny_config(task))
    build = jax_segmentation_model if task == "segmentation" else jax_classification_model
    model = build(jconfig).clone(attn_impl="pallas")
    params = init_params(model)
    return model, params, jax.jit(model.apply)


def _port_model(task):
    """The port's model of the tiny config through its own factory, with the JAX model's parameters."""
    config = _tiny_config(task)
    build = factory.get_segmentation_model if task == "segmentation" else get_classification_model
    model = build(config, device="cpu")
    _, params, _ = _jax_model(task)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=True)
    return model


# --- heatmaps, losses and metrics ---------------------------------------------------

@pytest.mark.parametrize("shape,centers,sigma", [
    ((32, 32), [[5, 6], [20, 10], [15, 25]], 3.0),
    ((48, 40), [[0.5, 39.25], [47, 0], [23.7, 19.2]], 2.0),
])
def test_gaussian_heatmap_matches_jax(shape, centers, sigma):
    from cinema_tpu.data.datasets import gaussian_heatmap

    centers = np.asarray(centers, np.float32)
    want = gaussian_heatmap(shape, centers, sigma)
    got = data.gaussian_heatmap(shape, centers, sigma)
    assert got.dtype == np.float32 and got.shape == (*shape, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got[5, 6, 0] == 1.0 if shape == (32, 32) else True  # (x, y) indexing: the peak at (x1, y1)


def _value_and_grad(jax_fn, torch_fn, *arrays):
    """Loss, metrics and the gradient of the loss with respect to the first array, on both sides."""
    (want, want_metrics), want_grad = jax.value_and_grad(jax_fn, has_aux=True)(*map(jnp.asarray, arrays))
    x = torch.from_numpy(arrays[0]).requires_grad_()
    got, got_metrics = torch_fn(x, *map(torch.from_numpy, arrays[1:]))
    (got_grad,) = torch.autograd.grad(got, x)
    return (float(got), got_metrics, got_grad.numpy()), (float(want), want_metrics, np.asarray(want_grad))


def _assert_loss_close(got, want, metric_names):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert set(got[1]) == set(want[1]) == set(metric_names)
    for key in want[1]:
        np.testing.assert_allclose(float(got[1][key]), float(want[1][key]), rtol=1e-6, err_msg=key)
    scale = np.abs(want[2]).max()
    assert scale > 0
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_landmark_heatmap_loss_and_its_gradient_match_jax(seed):
    from cinema_tpu import losses as jlosses

    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(2, 12, 10, 3)) * 4).astype(np.float32)
    labels = rng.random((2, 12, 10, 3)).astype(np.float32) ** 4
    got, want = _value_and_grad(jlosses.landmark_heatmap_loss, losses.landmark_heatmap_loss, logits, labels)
    _assert_loss_close(got, want, {"bce_loss", "dice_loss", "loss"})


@pytest.mark.parametrize("low,high", [(0.1, 9.5), (0.1, 40.0), (10.5, 60.0)], ids=["below-w", "both-sides", "above-w"])
def test_wing_loss_and_its_gradient_match_jax(low, high):
    """Errors below the Wing loss's w = 10 (the log branch), above it (the linear branch) and on both sides."""
    from cinema_tpu import losses as jlosses

    rng = np.random.default_rng(2)
    target = (rng.normal(size=(4, 6)) * 50).astype(np.float32)
    pred = (target + rng.choice([-1.0, 1.0], size=(4, 6)) * rng.uniform(low, high, size=(4, 6))).astype(np.float32)
    below = np.abs(pred - target) < 10
    assert below.all() if high < 10 else (~below).all() if low > 10 else below.any() and (~below).any()
    got, want = _value_and_grad(lambda p, t: (jlosses.wing_loss(p, t), {}),
                                lambda p, t: (losses.wing_loss(p, t), {}), pred, target)
    _assert_loss_close(got, want, set())


def test_landmark_coordinate_loss_and_its_gradient_match_jax():
    from cinema_tpu import losses as jlosses

    rng = np.random.default_rng(3)
    true = (rng.random((5, 6)) * 256).astype(np.float32)
    pred = true + (rng.normal(size=(5, 6)) * 12).astype(np.float32)
    np.testing.assert_array_equal(losses._REL_DIST_MATRIX, jlosses._REL_DIST_MATRIX)
    np.testing.assert_allclose(losses.get_relative_distances(torch.from_numpy(true)).numpy(),
                               np.asarray(jlosses.get_relative_distances(jnp.asarray(true))), rtol=1e-6, atol=1e-4)
    got, want = _value_and_grad(jlosses.landmark_coordinate_loss, losses.landmark_coordinate_loss, pred, true)
    _assert_loss_close(got, want, {"landmark_wing_loss", "relative_distance_wing_loss", "landmark_mae",
                                   "relative_distance_mae", "loss"})


def _top_two_gap(heatmap):
    """The smallest gap, over the batch and the channels, between the two largest values of a channel."""
    flat = np.sort(heatmap.reshape(heatmap.shape[0], -1, heatmap.shape[-1]), axis=1)
    return float((flat[:, -1] - flat[:, -2]).min())


@pytest.mark.parametrize("shape", [(3, 9, 7, 3), (2, 32, 32, 3), (1, 48, 40, 3)])
def test_heatmap_argmax_matches_jax(shape):
    from cinema_tpu import metrics as jmetrics

    heatmap = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    assert _top_two_gap(heatmap) > 0  # no tie
    want = np.asarray(jmetrics.heatmap_argmax(jnp.asarray(heatmap)))
    got = metrics.heatmap_argmax(torch.from_numpy(heatmap))
    assert got.shape == (shape[0], 6) and not got.is_floating_point()
    np.testing.assert_array_equal(got.numpy(), want)
    x0, y0 = got[0, :2].tolist()
    assert heatmap[0, x0, y0, 0] == heatmap[0, ..., 0].max()  # [x, y] = [idx // h, idx % h]


@pytest.mark.parametrize("shape", [(3, 9, 7, 3), (2, 32, 32, 3)])
def test_heatmap_soft_argmax_matches_jax(shape):
    """Each channel's peak stands 0.05 above the rest: with beta 1000 the other positions weigh e^-50,
    so both packages' expectations lie on the peak's integer coordinates."""
    from cinema_tpu import metrics as jmetrics

    rng = np.random.default_rng(5)
    heatmap = rng.random(shape).astype(np.float32)
    flat = heatmap.reshape(shape[0], -1, shape[-1])
    peaks = rng.integers(0, flat.shape[1], size=(shape[0], shape[-1]))
    for b in range(shape[0]):
        for c in range(shape[-1]):
            flat[b, peaks[b, c], c] = flat[b, :, c].max() + 0.05
    assert _top_two_gap(heatmap) >= 0.05 - 1e-6
    want = np.asarray(jmetrics.heatmap_soft_argmax(jnp.asarray(heatmap)))
    got = metrics.heatmap_soft_argmax(torch.from_numpy(heatmap))
    assert got.dtype == torch.int32 and got.shape == (shape[0], 6)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), metrics.heatmap_argmax(torch.from_numpy(heatmap)).numpy())


# --- sliding window ------------------------------------------------------------------

# image sizes of the 2-D sliding window at a 32x32 patch (half overlap): exactly one patch, two
# patches along x, and a 2 x 2 grid whose last starts are tail-aligned
WINDOW_SIZES = {"one-patch": (32, 32), "two-patches": (48, 32), "four-patches": (48, 40)}


@pytest.mark.parametrize("size", list(WINDOW_SIZES))
def test_sigmoid_sliding_window_matches_jax(size):
    from cinema_tpu.inference import sliding_window_forward as jax_window

    _, params, apply = _jax_model("segmentation")
    port = _port_model("segmentation").eval()
    images = (np.random.default_rng(6).random((1, *WINDOW_SIZES[size], 1)) * 255).astype(np.float32)
    want = jax_window(lambda imgs: apply(params, imgs), {VIEW: jnp.asarray(images)}, {VIEW: PATCH}, "sigmoid")[VIEW]
    with torch.no_grad():
        got = inference.sliding_window_forward(port, {VIEW: torch.from_numpy(images)}, {VIEW: PATCH}, "sigmoid")[VIEW]
        if size == "one-patch":  # nothing to patch: the forward's logits, unchanged
            assert torch.equal(got, port({VIEW: torch.from_numpy(images)})[VIEW])
    assert got.shape == (1, *WINDOW_SIZES[size], 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _elementwise_forward(xp):
    """A forward of three channels per view that is elementwise in the image (numpy-like ``xp``)."""
    def forward(image_dict):
        return {v: xp.concatenate([x * 3.0, x * x - 0.5, -2.0 * x], -1) for v, x in image_dict.items()}
    return forward


@pytest.mark.parametrize("aggregation", ["softmax", "sigmoid"])
def test_sliding_window_averages_an_unpatched_view_in_the_same_space_as_jax(aggregation):
    """One view patched 2 x 2, the other not: its copies are averaged over the patches as probabilities."""
    from cinema_tpu.inference import sliding_window_forward as jax_window

    rng = np.random.default_rng(7)
    images = {"a": rng.normal(size=(2, 48, 40, 1)).astype(np.float32),
              "b": rng.normal(size=(2, 16, 16, 1)).astype(np.float32)}
    patch = {"a": PATCH, "b": (16, 16)}
    want = jax_window(_elementwise_forward(jnp), {k: jnp.asarray(v) for k, v in images.items()}, patch, aggregation)
    torch_cat = type("xp", (), {"concatenate": staticmethod(lambda xs, dim: torch.cat(xs, dim))})
    got = inference.sliding_window_forward(_elementwise_forward(torch_cat), {k: torch.from_numpy(v)
                                                                            for k, v in images.items()},
                                           patch, aggregation)
    for view in images:
        np.testing.assert_allclose(got[view].numpy(), np.asarray(want[view]), atol=1e-5, rtol=1e-5, err_msg=view)
    if aggregation == "softmax":  # the default is the softmax path, bit for bit
        default = inference.sliding_window_forward(_elementwise_forward(torch_cat), {k: torch.from_numpy(v) for k, v
                                                                                     in images.items()}, patch)
        assert all(torch.equal(default[v], got[v]) for v in images)
    with pytest.raises(ValueError, match="aggregation"):
        inference.sliding_window_forward(_elementwise_forward(torch_cat), {"b": torch.from_numpy(images["b"])},
                                         {"b": (16, 16)}, "mean")


# --- PNG reader ------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filtered_row(kind, row, prior):
    """The PNG filter ``kind`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) applied to one 8-bit row."""
    out = []
    for i, x in enumerate(row):
        a, b, c = (row[i - 1] if i else 0), prior[i], (prior[i - 1] if i else 0)
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
        out.append((x - pred) % 256)
    return bytes([kind, *out])


def _handmade_png(image, kinds, bit_depth=8, colour_type=0, interlace=0):
    """An 8-bit grayscale PNG of ``image`` (rows = y) with the filter ``kinds[r % len(kinds)]`` on row r."""
    height, width = image.shape
    prior = [0] * width
    raw = b""
    for r in range(height):
        row = [int(v) for v in image[r]]
        raw += _filtered_row(kinds[r % len(kinds)], row, prior)
        prior = row
    header = struct.pack(">IIBBBBB", width, height, bit_depth, colour_type, 0, 0, interlace)
    idat = zlib.compress(raw, 6)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"tEXt", b"Comment\x00test")
            + _chunk(b"IDAT", idat[:10]) + _chunk(b"IDAT", idat[10:]) + _chunk(b"IEND", b""))


def _pil_gray(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), dtype=np.float32).T


def _test_image(rng, height, width):
    """Smooth gradients, flat runs and noise, so that every filter has work and PIL picks several."""
    yy, xx = np.mgrid[:height, :width]
    image = (xx * 3 + yy * 5) % 256
    image[: height // 3] = rng.integers(0, 256, size=(height // 3, width))
    image[height // 2 : height // 2 + 2] = 255
    return image.astype(np.uint8)


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "all-five"])
def test_read_png_gray_undoes_each_filter_as_pil_does(tmp_path, kinds):
    image = _test_image(np.random.default_rng(8), 23, 37)
    path = tmp_path / "handmade.png"
    path.write_bytes(_handmade_png(image, kinds))
    np.testing.assert_array_equal(_pil_gray(path), image.T.astype(np.float32))  # the file is what it claims
    got = data.read_png_gray(path)
    assert got.dtype == np.float32 and got.shape == (37, 23)
    np.testing.assert_array_equal(got, image.T.astype(np.float32))


@pytest.mark.parametrize("shape,optimize", [((256, 256), False), ((256, 256), True), ((45, 61), False), ((1, 7), True)])
def test_read_png_gray_is_bit_equal_to_pil_on_pngs_that_pil_writes(tmp_path, shape, optimize):
    from PIL import Image

    image = _test_image(np.random.default_rng(9), *shape)
    path = tmp_path / "pil.png"
    Image.fromarray(image).save(path, optimize=optimize)
    np.testing.assert_array_equal(data.read_png_gray(path), _pil_gray(path))


@pytest.mark.parametrize("mode", ["RGB", "P", "I;16", "interlaced", "bad-crc", "not-a-png"])
def test_read_png_gray_refuses_other_pngs(tmp_path, mode):
    """PNGs other than 8-bit plain gray or colour: 16-bit RGB, palette, 16-bit gray and interlaced ones read as
    PIL reads them; a file PIL refuses (a chunk whose CRC fails, another format) is refused."""
    from PIL import Image

    from tests.test_torch_port_png import encode, pil_gray

    path = tmp_path / "other.png"
    image = _test_image(np.random.default_rng(10), 8, 8)
    if mode == "P":
        Image.fromarray(image).convert(mode).save(path)
    elif mode == "RGB":  # 16-bit RGB: PIL keeps each sample's high byte
        wide = image.astype(np.int64) * 256 + np.random.default_rng(11).integers(0, 256, size=(8, 8))
        path.write_bytes(encode(np.stack([wide, wide[::-1], wide.T], axis=-1), 2, 16))
    elif mode == "I;16":
        Image.fromarray(image.astype(np.uint16) * 257).save(path)
    elif mode == "interlaced":
        path.write_bytes(encode(image[..., None], 0, 8, interlace=1))
    elif mode == "bad-crc":
        png = bytearray(_handmade_png(image, [0]))
        png[40] ^= 1
        path.write_bytes(bytes(png))
    else:
        path.write_bytes(b"GIF89a" + bytes(20))
    want = pil_gray(path.read_bytes())
    if mode in ("RGB", "P", "I;16", "interlaced"):
        np.testing.assert_array_equal(data.read_png_gray(path), want)
    else:
        assert isinstance(want, Exception)
        with pytest.raises(ValueError, match="CRC|not a PNG"):
            data.read_png_gray(path)


# --- datasets ----------------------------------------------------------------------------

def _write_landmark_data(root, sizes, with_view=True, seed=11, names=("train", "val"), other_view_rows=2,
                         noise=60, disc=250):
    """Seeded PNGs under ``lax_2c/images/`` (noise below ``noise`` with three discs of ``disc`` at the
    landmarks) and the metadata tables of the JAX preprocessing; ``sizes[name]`` lists the (x, y) size of
    each image. With ``with_view`` the tables also hold ``other_view_rows`` rows of ``lax_4c`` each, which
    the datasets must leave out."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for view in ("lax_2c", "lax_4c"):
        (root / view / "images").mkdir(parents=True, exist_ok=True)
    for name in names:
        rows = []
        views = [VIEW] * len(sizes[name]) + (["lax_4c"] * other_view_rows if with_view else [])
        for i, view in enumerate(views):
            w, h = sizes[name][i % len(sizes[name])]
            coords = np.stack([rng.integers(3, w - 3, size=3), rng.integers(3, h - 3, size=3)], axis=-1)
            xx, yy = np.mgrid[:w, :h]
            image = rng.integers(0, noise, size=(w, h))
            for cx, cy in coords:
                image[(xx - cx) ** 2 + (yy - cy) ** 2 <= 4] = disc
            uid = f"{name}{i:03d}"
            Image.fromarray(image.T.astype(np.uint8)).save(root / view / "images" / f"{uid}.png")  # PIL: (h, w)
            row = {"uid": uid, "view": view, "path": f"{view}/images/{uid}.png"}
            row.update({f"{a}{k + 1}": int(coords[k, j]) for k in range(3) for j, a in enumerate("xy")})
            if not with_view:
                del row["view"]
            rows.append(row)
        pd.DataFrame(rows).to_csv(root / f"{name}_metadata.csv", index=False)
    return root


@pytest.mark.parametrize("with_view", [True, False], ids=["view-column", "no-view-column"])
def test_landmark_datasets_match_jax_item_for_item(tmp_path, with_view):
    from cinema_tpu.data.datasets import LandmarkDetectionDataset as JaxDetection
    from cinema_tpu.data.datasets import LandmarkRegressionDataset as JaxRegression

    root = _write_landmark_data(tmp_path, {"train": [(32, 32), (48, 40), (40, 36)]}, with_view, names=("train",))
    rows = data.read_metadata(root / "train_metadata.csv")
    assert len(rows) == (5 if with_view else 3)
    for port_cls, jax_cls in ((LandmarkDetectionDataset, JaxDetection), (LandmarkRegressionDataset, JaxRegression)):
        port = port_cls(root, rows, VIEW)
        want = jax_cls(root, pd.read_csv(root / "train_metadata.csv"), VIEW)
        assert len(port) == len(want) == 3
        for i in range(3):
            got, ref = port.load(i, epoch=0), want[i]
            assert list(got) == list(ref)
            for key in ref:
                assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
                np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


# --- loss functions and train steps ---------------------------------------------------

def _heat_batches(n, batch=2, seed=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coords = rng.integers(2, 30, size=(batch, 3, 2))
        out.append({f"{VIEW}_image": (rng.random((batch, *PATCH, 1)) * 255).astype(np.float32),
                    f"{VIEW}_label": np.stack([data.gaussian_heatmap(PATCH, c) for c in coords])})
    return out


def _coord_batches(n, batch=2, seed=13):
    rng = np.random.default_rng(seed)
    return [{f"{VIEW}_image": (rng.random((batch, *PATCH, 1)) * 255).astype(np.float32),
             "label": rng.random((batch, 6)).astype(np.float32),
             f"{VIEW}_width": np.full(batch, PATCH[0]), f"{VIEW}_height": np.full(batch, PATCH[1])}
            for _ in range(n)]


def _loss_fns(task):
    if task == "segmentation":
        from cinema_tpu.tasks.segmentation.landmark import landmark_loss_fn as jax_loss_fn

        return jax_loss_fn, seg_landmark.landmark_loss_fn, _heat_batches
    from cinema_tpu.tasks.regression.landmark import landmark_regression_loss_fn as jax_loss_fn

    return jax_loss_fn, reg_landmark.landmark_regression_loss_fn, _coord_batches


@pytest.mark.parametrize("task", TASKS)
def test_landmark_train_steps_match_jax(task):
    """Three supervised steps of the task's loss function from the same weights, with layer decay and
    clipping: every metric of the loss function and the gradient norm at every step, then every parameter."""
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer
    from cinema_tpu.train.state import TrainState as JaxTrainState
    from cinema_tpu.train.state import make_supervised_train_step as jax_make_step

    model, params, _ = _jax_model(task)
    jax_loss_fn, port_loss_fn, make_batches = _loss_fns(task)
    batches = make_batches(3)
    tx = jax_build_optimizer(params["params"], accum_steps=1, fused=True, **OPT)
    state = JaxTrainState.create(params["params"], tx)
    step = jax_make_step(model, tx, lambda m, p, batch, rng: jax_loss_fn(m, {"params": p}, batch, rng), donate=False)
    records = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        records.append({k: float(v) for k, v in m.items()})
    want = state_dict_from_jax(state.params)

    port = _port_model(task)
    ptx = build_optimizer(dict(port.named_parameters()), **OPT)
    pstate, step_fn = TrainState.create(port, ptx), make_supervised_train_step(port, ptx, port_loss_fn)
    expected = ({f"{VIEW}_bce_loss", f"{VIEW}_dice_loss", f"{VIEW}_loss", "loss"} if task == "segmentation" else
                {"landmark_wing_loss", "relative_distance_wing_loss", "landmark_mae", "relative_distance_mae", "loss"})
    for batch, record in zip(batches, records):
        pstate, m = step_fn(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(record) == expected | {"grad_norm", "skipped_nan"}
        for key in expected:
            np.testing.assert_allclose(float(m[key]), record[key], rtol=ATOL, err_msg=key)
        np.testing.assert_allclose(float(m["grad_norm"]), record["grad_norm"], rtol=1e-3)
        assert float(m["skipped_nan"]) == 0.0
    start = state_dict_from_jax(params)
    moved = 0.0
    for key, p in port.named_parameters():
        got, ref = p.detach().numpy(), want[key]
        moved = max(moved, float(np.abs(got - start[key]).max()))
        if key.endswith("attn.kv.bias"):
            got, ref = got[got.shape[0] // 2 :], ref[ref.shape[0] // 2 :]
        if key in ONE_CHANNEL_NORM_WEIGHTS:
            continue
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=key)
    assert moved > 5 * ATOL  # the steps moved the parameters by far more than the tolerance


# --- evaluation --------------------------------------------------------------------------

def _assert_tie_rule(got_logits, want_logits, got_coords, want_coords):
    """Per image and channel: where the gap between the channel's two largest logits (the JAX package's)
    exceeds 2 * ATOL, the coordinates are equal; elsewhere, where they differ, the logits at the two
    positions are equal within ATOL (a tie). Returns the number of channels held to equal coordinates."""
    n_exact = 0
    for b in range(want_logits.shape[0]):
        for c in range(want_logits.shape[-1]):
            gx, gy, wx, wy = *got_coords[b, 2 * c : 2 * c + 2], *want_coords[b, 2 * c : 2 * c + 2]
            if _top_two_gap(want_logits[b : b + 1, ..., c : c + 1]) > 2 * ATOL:
                assert (gx, gy) == (wx, wy), (b, c)
                n_exact += 1
            else:
                assert abs(got_logits[b, gx, gy, c] - got_logits[b, wx, wy, c]) <= ATOL, (b, c)
                assert abs(want_logits[b, gx, gy, c] - want_logits[b, wx, wy, c]) <= ATOL, (b, c)
    return n_exact


def _heatmap_evaluation(tmp_path, jax_metrics=True, **intensities):
    """The port's evaluation of images of one, two and four patches against the JAX package's: per image
    the sigmoid-window logits (to ATOL) and the coordinates under the tie rule; returns the port's metrics,
    the JAX package's (``jax_metrics``) and the number of channels compared exactly."""
    from cinema_tpu.inference import sliding_window_forward as jax_window
    from cinema_tpu.tasks.segmentation.landmark import landmark_eval_dataloader as jax_eval

    model, params, apply = _jax_model("segmentation")
    port = _port_model("segmentation")
    root = _write_landmark_data(tmp_path, {"val": list(WINDOW_SIZES.values())}, names=("val",), **intensities)
    config = _tiny_config("segmentation")
    loader = BatchLoader(LandmarkDetectionDataset(root, data.read_metadata(root / "val_metadata.csv"), VIEW),
                         1, shuffle=False, drop_last=False)
    batches = list(loader.epoch(0))
    assert [b[f"{VIEW}_image"].shape[1:3] for b in batches] == list(WINDOW_SIZES.values())
    n_exact = 0
    with torch.no_grad():
        for batch in batches:
            want = np.asarray(jax_window(lambda imgs: apply(params, imgs), {VIEW: jnp.asarray(batch[f"{VIEW}_image"])},
                                         {VIEW: PATCH}, "sigmoid")[VIEW])
            logits, pred, true = seg_landmark.landmark_eval_batch(
                port.eval(), dict(batch, **{f"{VIEW}_image": torch.from_numpy(batch[f"{VIEW}_image"])}), VIEW, PATCH)
            np.testing.assert_allclose(logits.numpy(), want, atol=ATOL, rtol=0)
            n_exact += _assert_tie_rule(logits.numpy(), want, pred.numpy(),
                                        metrics.heatmap_argmax(torch.from_numpy(want)).numpy())
            np.testing.assert_array_equal(true, metrics.heatmap_argmax(torch.from_numpy(batch[f"{VIEW}_label"])))
    got = seg_landmark.landmark_eval_dataloader(port, loader, config)
    assert not port.training
    want = jax_eval(model, params, batches, _jax_config(config)) if jax_metrics else {}
    assert set(got) == {"mean_coordinate_error", "mean_landmark_distance"} and set(want) <= set(got)
    return got, want, n_exact


def test_landmark_heatmap_evaluation_matches_jax(tmp_path):
    """Dim images (noise below 8, discs of 16): every channel's top-two gap exceeds 2 * ATOL, so every
    coordinate and both metrics are held to the JAX package's exactly. At full contrast the untrained
    model's sigmoid saturates and the window's clip at 1 - 1e-7 ties positions exactly (next test)."""
    got, want, n_exact = _heatmap_evaluation(tmp_path, noise=8, disc=16)
    assert n_exact == len(WINDOW_SIZES) * 3 and set(want) == set(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=key)


def test_landmark_heatmap_evaluation_keeps_the_tie_rule_at_full_contrast(tmp_path):
    """Images of full contrast: channels whose largest logits sit at the clip are ties; the coordinates
    follow the tie rule and the metrics are finite."""
    got, _, n_exact = _heatmap_evaluation(tmp_path, jax_metrics=False)
    assert n_exact < len(WINDOW_SIZES) * 3  # some channels are ties here
    assert all(np.isfinite(v) for v in got.values())


def test_landmark_coordinate_evaluation_matches_jax(tmp_path):
    from cinema_tpu.tasks.regression.landmark import landmark_regression_eval_dataloader as jax_eval

    model, params, _ = _jax_model("regression")
    port = _port_model("regression")
    root = _write_landmark_data(tmp_path, {"val": [PATCH] * 3}, names=("val",))
    config = _tiny_config("regression")
    loader = BatchLoader(LandmarkRegressionDataset(root, data.read_metadata(root / "val_metadata.csv"), VIEW),
                         1, shuffle=False, drop_last=False)
    got = reg_landmark.landmark_regression_eval_dataloader(port, loader, config)
    assert not port.training
    wanted = jax_eval(model, params, list(loader.epoch(0)), _jax_config(config))
    assert set(got) == set(wanted) == {"mean_coordinate_error", "mean_landmark_distance"}
    for key in wanted:
        np.testing.assert_allclose(got[key], wanted[key], rtol=ATOL, err_msg=key)


def test_lmk_coord_fixture_forward_matches_jax():
    """The baked tiny ``lmk_coord`` checkpoint at its own 16x16, through ``from_finetuned`` on both sides."""
    from cinema_tpu.factory import from_finetuned as jax_from_finetuned

    folder = next(CKPTS.glob("lmk_coord-*"))
    model_path, config_path = folder / "lmk_coord.safetensors", folder / "lmk_coord.yaml"
    jmodel, jparams = jax_from_finetuned("convvit", model_path, config_path)
    port = factory.from_finetuned("convvit", model_path, config_path, device="cpu")
    images = (np.random.default_rng(14).random((2, 16, 16, 1)) * 255).astype(np.float32)
    want = jax.jit(jmodel.clone(attn_impl="pallas").apply)(jparams, {VIEW: jnp.asarray(images)})
    with torch.no_grad():
        got = port({VIEW: torch.from_numpy(images)})
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# --- entry points ------------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_landmark_task_rehearsal_on_the_cpu(tmp_path, task):
    """``python -m cinema_tpu_torch.tasks.{segmentation,regression}.landmark --device cpu --config <tiny>
    data.dir=<dir>``: train two epochs, evaluate each (the heatmap task a 48x40 image by sliding window
    too), save, and reload the checkpoint and the saved weights."""
    import yaml

    val_sizes = [PATCH, (48, 40)] if task == "segmentation" else [PATCH, PATCH]
    root = _write_landmark_data(tmp_path / "data", {"train": [PATCH] * 8, "val": val_sizes})
    config = _tiny_config(task)
    config.train.update(n_epochs=2, n_warmup_epochs=1, eval_interval=1, batch_size=4, batch_size_per_device=4,
                        lr=3e-3)
    config_path = tmp_path / "tiny.yaml"
    config_path.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    entry = seg_landmark if task == "segmentation" else reg_landmark
    entry.main(["--device", "cpu", "--config", str(config_path), f"data.dir={root}",
                f"logging.dir={tmp_path / 'runs'}"])
    (out_dir,) = (tmp_path / "runs").iterdir()
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "train_loss" in r]
    val = [r for r in records if "val_mean_landmark_distance" in r]
    assert [r["epoch"] for r in train] == [0, 1] and len(val) == 2
    assert all(np.isfinite(r["train_loss"]) and r["train_skipped_nan"] == 0.0 for r in train)
    assert train[-1]["n_samples"] == 2 * 8
    want_keys = {"train_lax_2c_bce_loss", "train_lax_2c_dice_loss"} if task == "segmentation" else {
        "train_landmark_wing_loss", "train_relative_distance_mae"}
    assert want_keys <= set(train[0])
    assert all(np.isfinite(r["val_mean_landmark_distance"]) and np.isfinite(r["val_mean_coordinate_error"])
               for r in val)
    ckpt = latest_checkpoint(out_dir)
    meta = json.loads(Path(f"{ckpt}.meta.json").read_text())
    assert meta["best_metric"] == pytest.approx(min(r["val_mean_landmark_distance"] for r in val))
    build = factory.get_segmentation_model if task == "segmentation" else get_classification_model
    model = build(config, device="cpu")
    state = load_checkpoint(ckpt, TrainState.create(model, build_optimizer(dict(model.named_parameters()), lr=1e-3)))
    assert state.step == (meta["epoch"] + 1) * 2
    exported = load_safetensors(out_dir / f"model_{meta['epoch']}.safetensors")
    assert set(exported) == set(model.state_dict())
    assert all(np.array_equal(exported[k], v.numpy()) for k, v in model.state_dict().items())
