"""The segmentation slice as a whole: its loss and metrics against the JAX package's;
``segmentation_eval_batch`` (sliding window, z bucket, crop back) and supervised train steps
of a tiny ConvUNetR against ``cinema_tpu.tasks.segmentation`` and
``cinema_tpu.train.state.make_supervised_train_step`` from the same weights and inputs; the
ED/ES dataset, the seeded ``data.max_n_samples`` subset, and a rehearsal of the task's entry
point on the CPU with synthetic processed NIfTI studies.

f32 on both sides (tests/conftest.py pins XLA matmuls to "highest"); the JAX side runs its
packed Pallas kernels in interpret mode. Logits and losses agree to 2e-4, as in the other
port tests (the JAX package's approximate GELU against torch's exact erf); the volume metrics
are computed from the same argmax and agree to float32 rounding. Train steps: losses to 2e-4
relative, parameters to 2e-4 absolute after the steps, the k half of every ``attn.kv.bias``
left out (see tests/test_torch_port_finetune.py), and the weight of the LayerNorm over the
one-channel input image (``ONE_CHANNEL_NORM_WEIGHTS``) likewise: both have a zero gradient
analytically and rounding noise on either side, which Adam turns into full steps.
"""

import functools
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cinema_tpu_torch import factory, losses, metrics
from cinema_tpu_torch.config import PACKAGED, from_dict
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
from cinema_tpu_torch.data import EDESSegmentationDataset, load_nifti, read_metadata, save_nifti
from cinema_tpu_torch.data.transforms import get_segmentation_transforms
from cinema_tpu_torch.models.convunetr import ConvUNetR as PortConvUNetR
from cinema_tpu_torch.models.unet import UNet
from cinema_tpu_torch.tasks import segmentation
from cinema_tpu_torch.tasks.classification import acdc as clf_acdc
from cinema_tpu_torch.tasks.segmentation import acdc as seg_acdc
from cinema_tpu_torch.train import loop
from cinema_tpu_torch.train.optim import build_optimizer
from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step

ATOL = 2e-4
PATCH = (32, 32, 4)
SPACING = (1.0, 1.0, 10.0)
# ViT grid 2x2x4: 17 tokens with cls, head_dim 16, as tests/test_torch_port_convunetr.py
ARCH = dict(
    image_size_dict={"sax": PATCH},
    in_chans_dict={"sax": 1},
    out_chans=4,
    enc_patch_size_dict={"sax": (4, 4, 1)},
    enc_scale_factor_dict={"sax": (2, 2, 1)},
    enc_conv_chans=(8, 16),
    enc_conv_n_blocks=1,
    enc_embed_dim=32,
    enc_depth=2,
    enc_n_heads=2,
    dec_chans=(4, 8, 16, 24, 32),
    dec_patch_size_dict={"sax": (2, 2, 1)},
    dec_scale_factor_dict={"sax": (2, 2, 1)},
)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_steps=1, max_n_steps=10, weight_decay=0.05, clip_grad=5.0, layer_decay=0.75,
           n_blocks=2)
PARAM_ATOL = 2e-4
# the LayerNorm of the one-channel input image: its output is its bias, so the weight's gradient
# is zero analytically; torch's layer_norm backward leaves rounding noise there (~1e-3 of the
# bias's), which Adam turns into a full step, where the JAX package's stays at exactly 0
ONE_CHANNEL_NORM_WEIGHTS = {"dec_image_conv_block_dict.sax.norm1.weight"}


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@functools.cache
def _jax_model():
    """The JAX ConvUNetR (Pallas attention), its initial parameters and its jitted apply."""
    from cinema_tpu.models.convunetr import ConvUNetR
    from jax.experimental.pallas import tpu as pltpu

    model = ConvUNetR(attn_impl="pallas", **ARCH)
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(model.init)(jax.random.PRNGKey(0), {"sax": jnp.zeros((1, *PATCH, 1), jnp.float32)})
    return model, params, jax.jit(model.apply)


def _port_model(params):
    port = PortConvUNetR(**ARCH)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=True)
    return port


def _labels(rng, shape, n_classes=4):
    """Three nested boxes, jittered per voxel: classes with surfaces, not salt and pepper."""
    label = np.zeros(shape, dtype=np.int8)
    for cls in range(1, n_classes):
        lo = [int(s * 0.1 * cls) for s in shape[-3:-1]]
        hi = [max(l + 2, int(s * (1 - 0.12 * cls))) for l, s in zip(lo, shape[-3:-1])]
        label[..., lo[0] : hi[0], lo[1] : hi[1], :] = cls
    flip = rng.random(shape) < 0.05
    label[flip] = rng.integers(0, n_classes, size=int(flip.sum()))
    return label


# --- losses and metrics --------------------------------------------------------------

@pytest.mark.parametrize("include_background", [False, True])
def test_soft_dice_loss_matches_jax(include_background):
    from cinema_tpu import losses as jlosses

    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(4), size=(3, 6, 5, 2)).astype(np.float32)
    target = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(3, 6, 5, 2))]
    want = jlosses.soft_dice_loss(jnp.asarray(probs), jnp.asarray(target), include_background)
    got = losses.soft_dice_loss(torch.from_numpy(probs), torch.from_numpy(target), include_background)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("ignored", [0.0, 0.3], ids=["no-ignore", "ignore-30pct"])
def test_segmentation_loss_matches_jax(ignored):
    """Cross entropy skips label -1; the Dice target counts it as background (one-hot of max(label, 0))."""
    from cinema_tpu import losses as jlosses

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 8, 7, 3, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, size=(2, 8, 7, 3))
    labels[rng.random(labels.shape) < ignored] = -1
    want, wmetrics = jlosses.segmentation_loss(jnp.asarray(logits), jnp.asarray(labels))
    got, gmetrics = losses.segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels).to(torch.int8))
    assert set(gmetrics) == set(wmetrics) == {"cross_entropy", "mean_dice_loss", "loss"}
    for key in wmetrics:
        np.testing.assert_allclose(float(gmetrics[key]), float(wmetrics[key]), rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("spatial", [(9, 7, 3), (12, 10)], ids=["3d", "2d"])
def test_mask_metrics_match_jax(spatial):
    """one_hot, dice_score, iou_score, stability_score and get_volumes, with a class absent from
    both masks (NaN) and a label -1 (a row of zeros)."""
    from cinema_tpu import metrics as jmetrics

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, *spatial, 5)).astype(np.float32) * 2
    pred = logits.argmax(-1)
    pred[pred == 4] = 3
    true = rng.integers(0, 4, size=(2, *spatial))
    true[0, 0] = -1
    spacing = (1.5, 0.8, 10.0)[: len(spatial)]
    jp, jt = jmetrics.one_hot(jnp.asarray(pred), 5), jmetrics.one_hot(jnp.asarray(true), 5)
    tp, tt = metrics.one_hot(torch.from_numpy(pred), 5), metrics.one_hot(torch.from_numpy(true), 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    pairs = [
        (metrics.dice_score(tp, tt), jmetrics.dice_score(jp, jt)),
        (metrics.iou_score(tp, tt), jmetrics.iou_score(jp, jt)),
        (metrics.stability_score(torch.from_numpy(logits)), jmetrics.stability_score(jnp.asarray(logits))),
        (metrics.get_volumes(tt, spacing), jmetrics.get_volumes(jt, spacing)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.isnan(pairs[0][0][:, 4].numpy()).all()


def test_ejection_fraction_region_and_cv_match_jax():
    from cinema_tpu import constants
    from cinema_tpu import metrics as jmetrics

    assert (metrics.REDUCED_EF, metrics.NORMAL_EF) == (constants.REDUCED_EF, constants.NORMAL_EF)
    edv, esv = np.array([120.0, 80.0, 150.0]), np.array([50.0, 60.0, 40.0])
    np.testing.assert_allclose(metrics.ejection_fraction(torch.from_numpy(edv), torch.from_numpy(esv)).numpy(),
                               np.asarray(jmetrics.ejection_fraction(edv, esv)))
    for ef in (10.0, 40.0, 40.5, 55.0, 55.1, 70.0):
        assert metrics.get_ef_region(ef) == jmetrics.get_ef_region(ef)
    assert metrics.coefficient_of_variance(edv, esv) == jmetrics.coefficient_of_variance(edv, esv)


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (1.25, 0.7, 10.0)], ids=["iso", "acdc"])
def test_hausdorff_distance_95_matches_jax(spacing):
    """Empty classes (NaN), a one-voxel class whose surface is itself, and the voxel spacing."""
    from cinema_tpu import metrics as jmetrics

    rng = np.random.default_rng(3)
    true = _labels(rng, (3, 20, 18, 5))
    pred = _labels(rng, (3, 20, 18, 5))
    pred[0][pred[0] == 2] = 1  # class 2 predicted nowhere in sample 0
    true[1][true[1] == 3] = 0
    true[1, 10, 9, 2] = 3  # one voxel of class 3
    eye = np.eye(4, dtype=np.float32)
    want = jmetrics.hausdorff_distance_95(eye[pred], eye[true], spacing)
    got = metrics.hausdorff_distance_95(eye[pred], eye[true], spacing)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 1]) and np.isfinite(got[1, 2]) and np.isfinite(got).sum() >= 7
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("seed", [4, 5])
def test_segmentation_metrics_match_jax(seed):
    from cinema_tpu import metrics as jmetrics

    rng = np.random.default_rng(seed)
    labels = _labels(rng, (2, 16, 14, 3))
    logits = (np.eye(4, dtype=np.float32)[_labels(rng, (2, 16, 14, 3))] * 3
              + rng.normal(size=(2, 16, 14, 3, 4)).astype(np.float32))
    want = jmetrics.segmentation_metrics(jnp.asarray(logits), jnp.asarray(labels), SPACING)
    got = metrics.segmentation_metrics(torch.from_numpy(logits), torch.from_numpy(labels), SPACING)
    assert set(got) == set(want) and "class_3_hausdorff_distance_95" in got
    for key in want:
        assert got[key].shape == (2,), key
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-6, atol=1e-7, err_msg=key)


# --- evaluation by sliding window --------------------------------------------------------

# (image spatial size after the dataset's padding, (width, height, n_slices) before it, z bucket):
# an exact patch cropped back; z 6 padded to 8 by the bucket and patched along z; 40 x 36 patched
# in x and y with the half overlap not dividing the size
GEOMETRIES = {
    "exact": ((32, 32, 4), (30, 29, 3), 4),
    "z-bucket": ((32, 32, 6), (32, 31, 6), 4),
    "in-plane": ((40, 36, 4), (40, 36, 4), 4),
}


def _eval_batch(geometry, seed):
    size, (w, h, n), _ = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    image = np.zeros((2, *size, 1), np.float32)
    image[:, :w, :h, :n] = rng.random((2, w, h, n, 1))
    label = np.zeros((2, *size), np.int8)
    label[:, :w, :h, :n] = _labels(rng, (2, w, h, n))
    return {"sax_image": image, "sax_label": label, "sax_width": np.array([w, w]), "sax_height": np.array([h, h]),
            "n_slices": np.array([n, n])}


@pytest.mark.parametrize("per_sample", [False, True], ids=["frame-0", "per-sample"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_segmentation_eval_batch_matches_jax(geometry, per_sample):
    from cinema_tpu.tasks.segmentation import segmentation_eval_batch as jax_eval_batch

    _, params, apply = _jax_model()
    port = _port_model(params).eval()
    batch = _eval_batch(geometry, seed=6)
    z_bucket = GEOMETRIES[geometry][2]
    want_logits, want = jax_eval_batch(apply, params, batch, {"sax": PATCH}, {"sax": SPACING}, z_bucket=z_bucket,
                                       per_sample=per_sample)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items() if k.endswith(("_image", "_label"))}
    with torch.no_grad():
        got_logits, got = segmentation.segmentation_eval_batch(port, {**batch, **tensors}, {"sax": PATCH},
                                                               {"sax": SPACING}, z_bucket=z_bucket,
                                                               per_sample=per_sample)
    w, h, n = GEOMETRIES[geometry][1]
    assert got_logits["sax"].shape == (2, w, h, n, 4)
    np.testing.assert_allclose(got_logits["sax"].numpy(), np.asarray(want_logits["sax"]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_logits["sax"].argmax(-1).numpy(), np.asarray(want_logits["sax"]).argmax(-1))
    rows_got, rows_want = (got, want) if per_sample else ([got], [want])
    assert len(rows_got) == len(rows_want) == (2 if per_sample else 1)
    for g, wnt in zip(rows_got, rows_want):
        assert set(g) == set(wnt) and {"mean_dice_score", "sax_mean_dice_score", "class_1_hausdorff_distance_95"} <= set(g)
        for key in wnt:
            np.testing.assert_allclose(g[key], wnt[key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_segmentation_eval_batch_without_labels_returns_the_cropped_logits():
    _, params, _ = _jax_model()
    port = _port_model(params).eval()
    batch = _eval_batch("z-bucket", seed=7)
    del batch["sax_label"]
    with torch.no_grad():
        logits, rows = segmentation.segmentation_eval_batch(
            port, dict(batch, sax_image=torch.from_numpy(batch["sax_image"])), {"sax": PATCH}, {"sax": SPACING},
            z_bucket=4, per_sample=True)
    assert rows == [] and logits["sax"].shape == (2, 32, 31, 6, 4)
    assert torch.allclose(logits["sax"].exp().sum(-1), torch.ones(()), atol=1e-5)  # aggregated probabilities


# --- train steps -------------------------------------------------------------------------

def _train_batches(n, batch=2, seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = _labels(rng, (batch, *PATCH))
        label[rng.random(label.shape) < 0.05] = -1
        out.append({"sax_image": rng.random((batch, *PATCH, 1)).astype(np.float32), "sax_label": label})
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_segmentation_train_steps_match_jax(n_steps):
    from cinema_tpu.tasks.segmentation import segmentation_loss_fn as jax_loss_fn
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer
    from cinema_tpu.train.state import TrainState as JaxTrainState
    from cinema_tpu.train.state import make_supervised_train_step as jax_make_step

    model, params, _ = _jax_model()
    port = _port_model(params)
    batches = _train_batches(n_steps)
    tx = jax_build_optimizer(params["params"], accum_steps=1, fused=True, **OPT)
    state = JaxTrainState.create(params["params"], tx)
    step = jax_make_step(model, tx, lambda m, p, batch, rng: jax_loss_fn(m, {"params": p}, batch, rng), donate=False)
    records = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        records.append({k: float(v) for k, v in m.items()})
    want = state_dict_from_jax(state.params)

    ptx = build_optimizer(dict(port.named_parameters()), **OPT)
    pstate, step_fn = TrainState.create(port, ptx), make_supervised_train_step(port, ptx, segmentation.segmentation_loss_fn)
    for batch, record in zip(batches, records):
        pstate, m = step_fn(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert {"sax_cross_entropy", "sax_mean_dice_loss", "sax_loss", "loss"} <= set(m)
        for key in ("loss", "sax_cross_entropy", "sax_mean_dice_loss"):
            np.testing.assert_allclose(float(m[key]), record[key], rtol=2e-4, err_msg=key)
        np.testing.assert_allclose(float(m["grad_norm"]), record["grad_norm"], rtol=1e-3)
        assert float(m["skipped_nan"]) == 0.0
    assert pstate.step == n_steps and pstate.n_samples == 2 * n_steps
    start = state_dict_from_jax(params)
    moved = 0.0
    for key, p in port.named_parameters():
        got, ref = p.detach().numpy(), want[key]
        moved = max(moved, float(np.abs(got - start[key]).max()))
        if key.endswith("attn.kv.bias"):  # the k half: zero gradient, see the module docstring
            got, ref = got[got.shape[0] // 2 :], ref[ref.shape[0] // 2 :]
        if key in ONE_CHANNEL_NORM_WEIGHTS:  # zero gradient, see the module docstring
            continue
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0, err_msg=key)
    # the first step's learning rate is 0 (linear warm-up from 0); later steps move the parameters far
    assert moved > 5 * PARAM_ATOL if n_steps > 1 else moved == 0.0


def _tiny_config(**data):
    config = from_dict(PACKAGED["segmentation/acdc"])
    config.model.convunetr.update(size="tiny", enc_conv_chans=[8, 16], enc_conv_n_blocks=1,
                                  dec_chans=[4, 8, 16, 24, 32], dropout=0.0, drop_path=0.0)
    config.data.sax.patch_size = list(PATCH)
    config.data.update(data)
    return config


def test_convunetr_factory_honours_grad_ckpt_with_the_same_gradients():
    config = _tiny_config()
    assert config.grad_ckpt
    remat = factory.init_weights(factory.get_convunetr_model(config, device="cpu"), seed=1)
    plain = factory.get_convunetr_model(config, device="cpu", remat=False)
    plain.load_state_dict(remat.state_dict())
    assert remat.encoder.remat and not plain.encoder.remat
    assert isinstance(factory.get_segmentation_model(config, device="cpu"), PortConvUNetR)
    batch = {k: torch.from_numpy(v) for k, v in _train_batches(1, seed=9)[0].items()}
    grads = []
    for model in (remat, plain):
        loss, _ = segmentation.segmentation_loss_fn(model.train(), batch)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for (name, _), a, b in zip(remat.named_parameters(), *grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    seg_sax = next((Path(__file__).parent / "fixtures" / "example_ckpts").glob("seg_sax-*"))
    served = factory.from_finetuned("convunetr", seg_sax / "seg_sax.safetensors", seg_sax / "seg_sax.yaml", device="cpu")
    assert not served.encoder.remat  # the fixture's config sets grad_ckpt: serving recomputes nothing
    config.model.name = "unet"
    assert isinstance(factory.get_segmentation_model(config, device="cpu"), UNet)
    config.model.name = "vgg"
    with pytest.raises(ValueError, match="Invalid model name"):
        factory.get_segmentation_model(config, device="cpu")


# --- data ----------------------------------------------------------------------------

ACDC = PACKAGED["classification/acdc"]["data"]["pathology"]


def _write_seg_studies(data_dir, sizes, n_per_class=3, n_classes=5, seed=10):
    """Seeded studies in the processed ACDC layout (``train/<pid>/<pid>_sax_{ed,es}[_gt].nii.gz``, uint8,
    and ``train_metadata.csv``): per frame three nested boxes (LV, myocardium, RV) on noise, the image
    brightest where the label is highest, so that image and label can be told apart and matched.
    Returns the pids in their table's order."""
    rng = np.random.default_rng(seed)
    lines, pids = ["pid,n_slices,pathology"], []
    for i in range(n_per_class * n_classes):
        size = sizes[i % len(sizes)]
        pid = f"patient{i:03d}"
        (data_dir / "train" / pid).mkdir(parents=True)
        for frame in ("ed", "es"):
            label = _labels(rng, size).astype(np.uint8)
            image = (label * 50.0 + rng.random(size) * 20 + 40).astype(np.uint8)
            save_nifti(data_dir / "train" / pid / f"{pid}_sax_{frame}.nii.gz", image)
            save_nifti(data_dir / "train" / pid / f"{pid}_sax_{frame}_gt.nii.gz", label)
        lines.append(f"{pid},{size[2]},{ACDC[i % n_classes]}")
        pids.append(pid)
    (data_dir / "train_metadata.csv").write_text("\n".join(lines) + "\n")
    return pids


def _cut_of(part, whole):
    """The offsets at which ``part`` is a cut of ``whole`` (the leading axes)."""
    ranges = [range(w - p + 1) for p, w in zip(part.shape, whole.shape)]
    return [o for o in np.ndindex(*map(len, ranges))
            if np.array_equal(whole[tuple(slice(a, a + n) for a, n in zip(o, part.shape))], part)]


def test_dataset_indexes_ed_es_and_crops_image_and_label_together(tmp_path):
    _write_seg_studies(tmp_path / "studies", [(40, 36, 6), (30, 20, 3)], n_per_class=1, n_classes=2)
    rows = read_metadata(tmp_path / "studies" / "train_metadata.csv")
    config = _tiny_config()
    config.transform.prob = 0.0  # contrast, noise, affine and dropout off: the crop alone moves the voxels
    train_tf, val_tf = get_segmentation_transforms(config)
    train = EDESSegmentationDataset(tmp_path / "studies" / "train", rows, "sax", train_tf, seed=3)
    val = EDESSegmentationDataset(tmp_path / "studies" / "train", rows, "sax", val_tf, seed=3)
    assert len(train) == len(val) == 4

    def frame_of(index):
        pid, frame = rows[index // 2]["pid"], ("ed", "es")[index % 2]
        folder = tmp_path / "studies" / "train" / pid
        return (load_nifti(folder / f"{pid}_sax_{frame}.nii.gz")[0].astype(np.float32),
                load_nifti(folder / f"{pid}_sax_{frame}_gt.nii.gz")[0].astype(np.int8))

    for index in range(4):
        image, label = frame_of(index)
        item = val.load(index, epoch=0)
        w, h, n = image.shape
        assert (int(item["sax_width"]), int(item["sax_height"]), int(item["n_slices"])) == (w, h, n)
        assert item["sax_image"].shape[:3] == item["sax_label"].shape == tuple(max(a, b) for a, b in zip((w, h, n), PATCH))
        assert item["sax_image"].dtype == np.float32 and item["sax_label"].dtype == np.int8
        np.testing.assert_array_equal(item["sax_label"][:w, :h, :n], label)  # frame i % 2 of study i // 2
        assert item["sax_image"].max() == 1.0 and item["sax_image"].min() == 0.0
        assert not item["sax_label"][w:].any() and not item["sax_image"][w:].any()
    image, label = frame_of(0)
    scaled = (image - image.min()) / np.ptp(image)
    cuts = set()
    for epoch in (0, 1, 2):
        item = train.load(0, epoch)
        assert item["sax_image"].shape == (*PATCH, 1) and item["sax_label"].shape == PATCH
        at = [o for o in _cut_of(item["sax_label"], label) if o in _cut_of(item["sax_image"][..., 0], scaled)]
        assert at, "the image and the label are not one cut of the ED frame of study 0"
        cuts.add(at[0])
        np.testing.assert_array_equal(train.load(0, epoch)["sax_image"], item["sax_image"])  # seeded
    assert len(cuts) > 1  # another epoch cuts elsewhere
    small = train.load(2, 0)  # the smaller study is padded where it is short
    assert small["sax_label"].shape == PATCH and not small["sax_label"][30:].any() and not small["sax_label"][:, :, 3:].any()
    config.transform.prob = 1.0  # every augmentation fires, with the same draws for image and label
    augmented = EDESSegmentationDataset(tmp_path / "studies" / "train", rows, "sax",
                                        get_segmentation_transforms(config)[0], seed=3).load(0, 0)
    assert augmented["sax_image"].shape == (*PATCH, 1) and augmented["sax_label"].dtype == np.int8
    assert not np.array_equal(augmented["sax_label"], train.load(0, 0)["sax_label"])


# --- the seeded max_n_samples subset ---------------------------------------------------------

def _cap_config(cap, proportion=1.0):
    return from_dict({"seed": 0, "data": {"max_n_samples": cap, "proportion": proportion}})


@pytest.mark.parametrize("cap", [1, 5, 9, 13, 40])
def test_subset_per_class_counts_match_pandas(cap):
    rng = np.random.default_rng(11)
    train_groups = np.sort(rng.integers(0, 5, size=31))
    val_groups = np.repeat(np.arange(5), 2)
    train, val = loop.maybe_subset_dataset(_cap_config(cap), list(range(31)), list(range(10)), train_groups, val_groups)
    for items, groups in ((train, train_groups), (val, val_groups)):
        frame = pd.DataFrame({"g": groups})
        want = frame.groupby("g").sample(frac=min(cap / len(groups), 1.0), random_state=0)
        assert items == want.index.tolist()  # pandas' rows, group by group in the order it draws them
        got = pd.Series(groups[items]).value_counts()
        assert got.reindex(want["g"].value_counts().index, fill_value=0).to_dict() == want["g"].value_counts().to_dict()


@pytest.mark.parametrize("cap", [1, 7, 15, 31])
def test_subset_whole_list_count_matches_pandas(cap):
    train, val = loop.maybe_subset_dataset(_cap_config(cap), [f"t{i}" for i in range(31)], [f"v{i}" for i in range(9)])
    assert len(train) == len(pd.DataFrame({"x": range(31)}).sample(frac=min(cap / 31, 1.0), random_state=0))
    assert len(val) == len(pd.DataFrame({"x": range(9)}).sample(frac=min(cap / 9, 1.0), random_state=0))
    assert set(train) <= {f"t{i}" for i in range(31)} and len(set(train)) == len(train)


def test_subset_is_seeded_and_the_proportion_follows_the_cap():
    items, groups = list(range(40)), np.arange(40) // 8
    a = loop.maybe_subset_dataset(_cap_config(20, proportion=0.5), items, items[:10], groups, groups[:10])
    b = loop.maybe_subset_dataset(_cap_config(20, proportion=0.5), items, items[:10], groups, groups[:10])
    assert a == b and len(a[0]) == int(0.5 * 20) and len(a[1]) == 10
    assert loop.maybe_subset_dataset(_cap_config(-1), items, items[:10]) == (items, items[:10])
    assert loop.maybe_subset_dataset(_cap_config(20), items, items[:10])[0] != list(range(20))  # not a prefix


def test_a_cap_of_half_keeps_every_class_of_a_class_sorted_list(tmp_path):
    """Studies named in class order, as ACDC numbers its patients by pathology: the cap draws
    from every class, where a prefix of the sorted list would keep two classes."""
    data_dir = tmp_path / "studies"
    lines = ["pid,n_slices,pathology"] + [f"patient{i:03d},4,{ACDC[i // 8]}" for i in range(40)]
    data_dir.mkdir()
    (data_dir / "train_metadata.csv").write_text("\n".join(lines) + "\n")
    config = from_dict(PACKAGED["classification/acdc"])
    config.data.dir = str(data_dir)
    config.data.max_n_samples = 15  # half of the 30 training studies
    train, val = clf_acdc.load_dataset(config)
    labels = [ACDC.index(r["pathology"]) for r in train.rows]
    assert len(train) == 15 and sorted(set(labels)) == [0, 1, 2, 3, 4] and all(labels.count(c) == 3 for c in range(5))
    assert len(val) == 10
    pids = _write_seg_studies(tmp_path / "seg", [(16, 16, 4)], n_per_class=6)
    config = _tiny_config(dir=str(tmp_path / "seg"), max_n_samples=10)
    train, val = seg_acdc.load_dataset(config)
    train_pids, val_pids = [r["pid"] for r in train.rows], [r["pid"] for r in val.rows]
    assert len(train_pids) == 10 and len(val_pids) == 10 and not set(train_pids) & set(val_pids)
    assert set(train_pids) | set(val_pids) <= set(pids)
    assert sorted(ACDC.index(r["pathology"]) for r in val.rows) == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]


# --- the task entry point --------------------------------------------------------------

def test_segmentation_task_rehearsal_on_the_cpu(tmp_path):
    """``python -m cinema_tpu_torch.tasks.segmentation.acdc --device cpu --config <tiny> data.dir=<dir>``:
    train, evaluate by sliding window with the z bucket, save, and reload the saved weights."""
    import yaml

    _write_seg_studies(tmp_path / "studies", [(32, 32, 4), (40, 36, 3), (34, 32, 6)])
    config = _tiny_config()
    config.train.update(n_epochs=2, n_warmup_epochs=1, eval_interval=1, batch_size=4, lr=3e-3)
    config_path = tmp_path / "tiny.yaml"
    config_path.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    seg_acdc.main(["--device", "cpu", "--config", str(config_path), f"data.dir={tmp_path / 'studies'}",
                   f"logging.dir={tmp_path / 'runs'}"])
    (out_dir,) = (tmp_path / "runs").iterdir()
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "train_loss" in r]
    val = [r for r in records if "val_mean_dice_score" in r]
    assert [r["epoch"] for r in train] == [0, 1] and len(val) == 2
    assert all(np.isfinite(r["train_loss"]) and r["train_skipped_nan"] == 0.0 for r in train)
    assert {"train_sax_cross_entropy", "train_sax_mean_dice_loss"} <= set(train[0])
    for key in ("val_mean_dice_score", "val_mean_hausdorff_distance_95", "val_class_1_dice_score",
                "val_class_3_hausdorff_distance_95", "val_sax_mean_iou_score", "val_class_2_true_volume"):
        assert all(np.isfinite(r[key]) for r in val), key
    assert all(0.0 <= r["val_mean_dice_score"] <= 1.0 for r in val)
    # 5 training studies: 10 frames, two batches of 4 an epoch
    assert train[-1]["n_samples"] == 2 * 2 * 4
    (ckpt,) = out_dir.glob("ckpt_*.pt")  # retention keeps one
    meta = json.loads(Path(f"{ckpt}.meta.json").read_text())
    assert meta["best_metric"] == pytest.approx(-max(r["val_mean_dice_score"] for r in val))
    exported = load_safetensors(out_dir / f"model_{meta['epoch']}.safetensors")
    model = factory.get_convunetr_model(config, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()}, strict=True)
