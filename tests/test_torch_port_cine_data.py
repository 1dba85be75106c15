"""The port's cine inputs against the JAX package's (cinema_tpu/data): frame seeks in plain, gzipped,
frame-indexed and scaled 4-D NIfTI; frame-indexed files written byte for byte as the JAX package
writes them; and the items of the per-frame cine, EMIDEC, MyoPS2020 and Kaggle video datasets,
equal to the JAX datasets' at the same (seed, epoch, index) with and without the packaged
transforms. The tables the evaluations write are held to pandas' ``to_csv`` and ``mean``.

``write_rescan_tree``, ``write_volume_tree`` and ``write_kaggle_tree`` write the seeded synthetic
studies of these tests and of tests/test_torch_port_seg_tasks.py in the JAX preprocessing's layouts.
"""

import csv

import numpy as np
import pandas as pd
import pytest

from cinema_tpu_torch.config import PACKAGED, from_dict
from cinema_tpu_torch.data import (
    CineSegmentationDataset,
    EMIDECDataset,
    KaggleVideoDataset,
    MYOPS2020Dataset,
    load_nifti,
    load_nifti_frame,
    read_frame_index,
    read_metadata,
    save_nifti,
)
from cinema_tpu_torch.data import nifti as port_nifti
from cinema_tpu_torch.data.datasets import column_means, write_table
from cinema_tpu_torch.data.transforms import Compose, ScaleIntensityd, SpatialPadd, get_segmentation_transforms
from test_torch_port_nifti_data import assert_items_equal


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def _blob_labels(rng, shape, n_classes):
    """(x, y, z[, t]) uint8 labels: nested boxes of classes 1..n_classes-1 at a seeded centre, shrinking
    over t where there is a time axis."""
    label = np.zeros(shape, np.uint8)
    x, y = shape[:2]
    cx, cy = int(rng.integers(x // 3, 2 * x // 3)), int(rng.integers(y // 3, 2 * y // 3))
    n_frames = shape[3] if len(shape) == 4 else 1
    for t in range(n_frames):
        r = max(3, int(min(x, y) * (0.3 - 0.15 * t / max(n_frames - 1, 1))))
        frame = label[..., t] if len(shape) == 4 else label
        for cls in range(1, n_classes):
            s = max(1, r - 2 * (cls - 1))
            frame[max(cx - s, 0) : cx + s, max(cy - s, 0) : cy + s] = cls
    return label


def _image(rng, label):
    return np.clip(label.astype(np.float32) * 50 + rng.normal(40, 15, label.shape), 0, 255).astype(np.uint8)


def write_rescan_tree(root, n_groups=3, per_group=2, sizes=((32, 32, 4), (36, 34, 5)), n_frames=(5, 3), seed=0,
                      frame_indexed=True, retest_pairs=3):
    """Seeded Rescan studies: ``train/<G0i>/<s_000j>/sax{,_gt}_t.nii.gz`` (uint8 4-D cines, frame-indexed or not)
    with ``train_metadata.csv`` (``pid``, ``n_slices``, ``n_frames``), listed out of pid order; and, with
    ``retest_pairs``, ``test_retest_100/scan_0i_{A,B}/sax_t.nii.gz`` of the first size with ``test_retest_100_metadata.csv``
    (``pid``, ``n_slices``, ``n_frames``, ``ef``, empty for one acquisition)."""
    rng = np.random.default_rng(seed)
    rows = []
    for g in range(n_groups):
        for j in range(per_group):
            pid = f"G{g:02d}/s_{per_group - j:04d}"
            shape = (*sizes[(g + j) % len(sizes)], n_frames[(g + j) % len(n_frames)])
            label = _blob_labels(rng, shape, 4)
            (root / "train" / pid).mkdir(parents=True)
            save_nifti(root / "train" / pid / "sax_t.nii.gz", _image(rng, label), frame_indexed=frame_indexed)
            save_nifti(root / "train" / pid / "sax_gt_t.nii.gz", label, frame_indexed=frame_indexed)
            rows.append({"pid": pid, "n_slices": shape[2], "n_frames": shape[3]})
    _write_csv(root / "train_metadata.csv", rows[::-1])
    rows = []
    for i in range(retest_pairs):
        for acq in "AB":
            pid = f"scan_{i:02d}_{acq}"
            shape = (*sizes[0], n_frames[i % len(n_frames)] + 2)  # one forward a frame: no larger than a patch
            (root / "test_retest_100" / pid).mkdir(parents=True)
            save_nifti(root / "test_retest_100" / pid / "sax_t.nii.gz", _image(rng, _blob_labels(rng, shape, 4)))
            rows.append({"pid": pid, "n_slices": shape[2], "n_frames": shape[3],
                         "ef": "" if (i, acq) == (1, "B") else round(float(rng.uniform(30, 70)), 3)})
    if rows:
        _write_csv(root / "test_retest_100_metadata.csv", rows)


def write_volume_tree(root, name, n_train, n_test=0, sizes=((32, 32, 4), (40, 36, 6), (34, 32, 5)), seed=0):
    """Seeded EMIDEC (``name`` "emidec": ``<pid>/<pid>.nii.gz``, labels 0-4, pids ``Case_N0ii`` and
    ``Case_P0ii``) or MyoPS2020 ("myops2020": ``<pid>/<pid>_{c0,de,t2}.nii.gz``, labels 0-3, integer pids
    written with a leading zero in the table) studies with their ``_gt`` labels and ``<split>_metadata.csv``
    (``pid``, ``n_slices``) for ``train`` and, with ``n_test``, ``test``."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        rows = []
        for i in range(n):
            shape = sizes[i % len(sizes)]
            if name == "emidec":
                pid = table_pid = f"Case_{'NP'[i % 2]}{i:03d}" if i % 3 else f"Case_P{i:03d}"
                label = _blob_labels(rng, shape, 5)
                images = {pid: _image(rng, label)}
            else:
                pid, table_pid = str(101 + i + (100 if split == "test" else 0)), f"0{101 + i}"
                label = _blob_labels(rng, shape, 4)
                images = {f"{pid}_{seq}": _image(rng, label) for seq in ("c0", "de", "t2")}
                if split == "test":
                    table_pid = pid
            (root / split / pid).mkdir(parents=True)
            for stem, image in images.items():
                save_nifti(root / split / pid / f"{stem}.nii.gz", image, spacing=(1.458, 1.458, 10.0))
            save_nifti(root / split / pid / f"{pid}_gt.nii.gz", label)
            rows.append({"pid": table_pid, "n_slices": shape[2]})
        if rows:
            _write_csv(root / f"{split}_metadata.csv", rows)


def write_kaggle_tree(root, n, split="validate", size=(32, 32, 4), n_frames=(30, 33, 12), seed=0):
    """Seeded Kaggle cines: ``<split>/<pid>/<pid>_sax_t.nii.gz`` (uint8 (x, y, z, t), t from ``n_frames`` in
    turn) and ``<split>_metadata.csv`` (``pid``, ``n_slices``, ``n_frames``, ``diastole_volume``,
    ``systole_volume``)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        pid = str(500 + i)
        shape = (*size, n_frames[i % len(n_frames)])
        (root / split / pid).mkdir(parents=True)
        save_nifti(root / split / pid / f"{pid}_sax_t.nii.gz", _image(rng, _blob_labels(rng, shape, 4)))
        edv = round(float(rng.uniform(100, 200)), 2)
        rows.append({"pid": pid, "n_slices": size[2], "n_frames": shape[3], "diastole_volume": edv,
                     "systole_volume": round(edv * float(rng.uniform(0.3, 0.7)), 2)})
    _write_csv(root / f"{split}_metadata.csv", rows)


# --- (a) frame seeks and frame-indexed files --------------------------------------------------

def _cine(dtype, shape=(12, 10, 3, 6), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(0, 50, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("kind", ["nii", "gz", "indexed", "indexed-scaled", "gz-scaled"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32], ids=str)
def test_load_nifti_frame_equals_the_jax_packages(tmp_path, kind, dtype):
    from cinema_tpu.data import nifti as jax_nifti

    array = _cine(dtype)
    path = tmp_path / ("cine.nii" if kind == "nii" else "cine.nii.gz")
    scl = (0.5, -3.0) if kind.endswith("scaled") else (1.0, 0.0)
    save_nifti(path, array, spacing=(1.5, 1.5, 8.0, 1.0), frame_indexed=kind.startswith("indexed"), scl=scl)
    assert (read_frame_index(path) is not None) == kind.startswith("indexed")
    whole, _ = load_nifti(path)
    for t in range(array.shape[-1]):
        got, header = load_nifti_frame(path, t)
        want, want_header = jax_nifti.load_nifti_frame(path, t)
        assert got.dtype == want.dtype and got.shape == array.shape[:3]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, whole[..., t])
        assert header.shape == want_header.shape and header.vox_offset == want_header.vox_offset
    for t in (-1, array.shape[-1]):
        for reader in (load_nifti_frame, jax_nifti.load_nifti_frame):
            with pytest.raises(ValueError, match=rf"Frame {t} out of range \[0, {array.shape[-1]}\)"):
                reader(path, t)


def test_load_nifti_frame_rejects_a_volume_that_is_not_4d(tmp_path):
    save_nifti(tmp_path / "vol.nii.gz", np.zeros((4, 4, 3), np.uint8), frame_indexed=True)
    assert read_frame_index(tmp_path / "vol.nii.gz") is None  # ignored below 4-D
    with pytest.raises(ValueError, match="Expected 4D volume"):
        load_nifti_frame(tmp_path / "vol.nii.gz", 0)


@pytest.mark.parametrize("shape", [(12, 10, 3, 6), (7, 5, 1, 1), (16, 16, 4, 25)], ids=["6-frames", "1-frame",
                                                                                          "25-frames"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=str)
def test_frame_indexed_files_are_the_jax_packages_byte_for_byte(tmp_path, shape, dtype):
    from cinema_tpu.data import nifti as jax_nifti

    array = _cine(dtype, shape, seed=3)
    save_nifti(tmp_path / "port.nii.gz", array, spacing=(1.0, 1.2, 10.0, 1.0), frame_indexed=True)
    jax_nifti.save_nifti(tmp_path / "jax.nii.gz", array, spacing=(1.0, 1.2, 10.0, 1.0), frame_indexed=True)
    assert (tmp_path / "port.nii.gz").read_bytes() == (tmp_path / "jax.nii.gz").read_bytes()
    got, want = read_frame_index(tmp_path / "port.nii.gz"), jax_nifti.read_frame_index(tmp_path / "jax.nii.gz")
    assert got.dtype == want.dtype and len(got) == shape[-1] + 1
    np.testing.assert_array_equal(got, want)
    assert int(got[-1]) == (tmp_path / "port.nii.gz").stat().st_size  # the table ends at the file's end
    # a standard reader decodes the members as one stream
    np.testing.assert_array_equal(jax_nifti.load_nifti(tmp_path / "port.nii.gz")[0], array)
    np.testing.assert_array_equal(load_nifti(tmp_path / "jax.nii.gz")[0], array)


def test_the_frame_index_is_none_for_other_files_and_foreign_extra_fields(tmp_path):
    array = _cine(np.uint8)
    save_nifti(tmp_path / "plain.nii.gz", array)
    save_nifti(tmp_path / "raw.nii", array, frame_indexed=True)  # ignored for a raw file
    head = tmp_path / "foreign.nii.gz"
    head.write_bytes(port_nifti._gzip_member(b"\x00" * 400, extra=b"XY\x04\x00abcd"))
    for path in ("plain.nii.gz", "raw.nii", "foreign.nii.gz", "missing.nii.gz"):
        assert read_frame_index(tmp_path / path) is None, path
    np.testing.assert_array_equal(load_nifti(tmp_path / "raw.nii")[0], array)


# --- (b) the datasets ------------------------------------------------------------------------

def _tiny_config(task, patch=(32, 32, 4)):
    config = from_dict(PACKAGED[task])
    config.data.sax.patch_size = list(patch)
    return config


def _check_items(port, jax_ds, indices):
    assert len(port) == len(jax_ds)
    for index, epoch in indices:
        jax_ds.set_epoch(epoch)
        assert_items_equal(port.load(index, epoch), jax_ds[index])


@pytest.mark.parametrize("augmented", [False, True], ids=["plain", "augmented"])
@pytest.mark.parametrize("frame_indexed", [True, False], ids=["indexed", "single-member"])
def test_cine_dataset_items_equal_the_jax_items(tmp_path, frame_indexed, augmented):
    from cinema_tpu.data.datasets import CineSegmentationDataset as JaxCine
    from cinema_tpu.data.transforms import get_segmentation_transforms as jax_transforms

    write_rescan_tree(tmp_path, frame_indexed=frame_indexed, retest_pairs=0)
    config = _tiny_config("segmentation/rescan")
    transform = get_segmentation_transforms(config)[0] if augmented else None
    jax_transform = jax_transforms(config)[0] if augmented else None
    rows = read_metadata(tmp_path / "train_metadata.csv")
    meta = pd.read_csv(tmp_path / "train_metadata.csv")
    for max_n_frames in (None, 4):
        port = CineSegmentationDataset(tmp_path / "train", rows, "sax", transform=transform,
                                       max_n_frames=max_n_frames, seed=4)
        jax_ds = JaxCine(tmp_path / "train", meta, "sax", transform=jax_transform, max_n_frames=max_n_frames)
        jax_ds.seed = 4
        assert port.index_map == jax_ds.index_map
        _check_items(port, jax_ds, [(0, 0), (4, 1), (len(port) - 1, 3), (7, 2)])
    item = port.load(1, 0)
    assert item["pid"] == rows[0]["pid"] and int(item["frame"]) == 1 and item["sax_label"].dtype == np.int8
    if not augmented:
        assert item["sax_image"].shape == (36, 34, 5, 1) and item["sax_image"].min() == 0.0
        assert item["sax_image"].max() == 1.0


def test_cine_dataset_without_labels_passes_the_volumes_through(tmp_path):
    from cinema_tpu.data.datasets import CineSegmentationDataset as JaxCine

    write_rescan_tree(tmp_path, n_groups=1, per_group=2, retest_pairs=0)
    rows = read_metadata(tmp_path / "train_metadata.csv")
    rows[0].update(edv="120.5", esv="50.0", ef="58.5")
    rows[1].update(edv="100.0", esv=None, ef=None)
    _write_csv(tmp_path / "unlabelled.csv", rows)
    port = CineSegmentationDataset(tmp_path / "train", read_metadata(tmp_path / "unlabelled.csv"), has_labels=False)
    jax_ds = JaxCine(tmp_path / "train", pd.read_csv(tmp_path / "unlabelled.csv"), has_labels=False)
    _check_items(port, jax_ds, [(0, 0), (len(port) - 1, 0)])
    assert float(port.load(0)["ef"]) == 58.5 and np.isnan(port.load(len(port) - 1)["esv"])
    with pytest.raises(ValueError, match="Only the SAX view has labels"):
        CineSegmentationDataset(tmp_path / "train", rows, views=["sax", "lax_4c"])


@pytest.mark.parametrize("augmented", [False, True], ids=["plain", "augmented"])
@pytest.mark.parametrize("name", ["emidec", "myops2020"])
def test_volume_dataset_items_equal_the_jax_items(tmp_path, name, augmented):
    from cinema_tpu.data import datasets as jd
    from cinema_tpu.data.transforms import get_segmentation_transforms as jax_transforms

    write_volume_tree(tmp_path, name, 5)
    config = _tiny_config(f"segmentation/{name}")
    pair = (EMIDECDataset, jd.EMIDECDataset) if name == "emidec" else (MYOPS2020Dataset, jd.MYOPS2020Dataset)
    transform = get_segmentation_transforms(config)[0 if augmented else 1]
    jax_transform = jax_transforms(config)[0 if augmented else 1]
    port = pair[0](tmp_path / "train", read_metadata(tmp_path / "train_metadata.csv"), transform, seed=2)
    jax_ds = pair[1](tmp_path / "train", pd.read_csv(tmp_path / "train_metadata.csv"), transform=jax_transform)
    jax_ds.seed = 2
    _check_items(port, jax_ds, [(0, 0), (1, 0), (3, 5), (4, 1)])
    item = pair[0](tmp_path / "train", read_metadata(tmp_path / "train_metadata.csv")).load(1)
    assert item["sax_image"].shape == (40, 36, 6, 1 if name == "emidec" else 3) and int(item["n_slices"]) == 6
    if name == "myops2020":
        assert read_metadata(tmp_path / "train_metadata.csv")[0]["pid"] == "0101" and port.load(0)["pid"] == "101"


@pytest.mark.parametrize("transformed", [False, True], ids=["raw", "scaled-padded"])
def test_kaggle_video_items_equal_the_jax_items(tmp_path, transformed):
    from cinema_tpu.data import transforms as jt
    from cinema_tpu.data.datasets import KaggleVideoDataset as JaxKaggle

    write_kaggle_tree(tmp_path, 3, size=(30, 28, 3), n_frames=(30, 33, 12))
    key, patch = "sax_image", (32, 32, 4)
    transform = Compose([ScaleIntensityd(key), SpatialPadd(key, patch)]) if transformed else None
    jax_transform = jt.Compose([jt.ScaleIntensityd(key), jt.SpatialPadd(key, patch)]) if transformed else None
    rows = read_metadata(tmp_path / "validate_metadata.csv")
    port = KaggleVideoDataset(tmp_path / "validate", rows, "sax", 30, transform)
    jax_ds = JaxKaggle(tmp_path / "validate", pd.read_csv(tmp_path / "validate_metadata.csv"), "sax", 30,
                       transform=jax_transform)
    _check_items(port, jax_ds, [(0, 0), (1, 0), (2, 0)])
    short = port.load(2)  # 12 frames, zero-padded to 30
    assert short["sax_image"].shape == ((30, *patch, 1) if transformed else (30, 30, 28, 3, 1))
    assert not short["sax_image"][12:].any() and short["sax_image"][:12].any()
    if transformed:  # min-max over all frames together
        assert short["sax_image"][:12].min() == 0.0 and short["sax_image"][:12].max() == 1.0
    with pytest.raises(ValueError, match="Invalid view"):
        KaggleVideoDataset(tmp_path / "validate", rows, "lax_3c", 30)


# --- (c) the tables -----------------------------------------------------------------------------

def test_tables_are_written_and_averaged_as_pandas_does(tmp_path):
    rows = [{"a": 1.5, "pid": "x", "is_ed": True, "b": float("nan"), "n": 3},
            {"a": 0.1 + 0.2, "pid": "y", "is_ed": False, "b": 2.0, "n": 4, "c": 1e-20},
            {"a": np.float64(-7.25), "pid": "z", "is_ed": True, "b": None, "n": 5}]
    write_table(tmp_path / "port.csv", rows)
    frame = pd.DataFrame(rows)
    frame.to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    want = frame.drop(columns=["pid", "is_ed"]).mean(numeric_only=True)
    got = column_means(rows, ("pid", "is_ed"))
    assert list(got) == list(want.index)
    np.testing.assert_array_equal(np.array(list(got.values())), want.to_numpy())
    assert np.isnan(column_means([{"a": None}, {"a": float("nan")}])["a"])
