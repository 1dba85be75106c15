"""The port's processed-NIfTI input path against the JAX package's (cinema_tpu/data): NIfTI files
written by either package read equal through the other; each augmentation transform and the
``get_segmentation_transforms`` pipelines give the JAX package's output bit for bit for the same
generator; the EDES datasets' items equal the JAX datasets' at the same (seed, epoch, index);
and the batch loader gives the same batches with worker threads and with worker processes.

``write_edes_tree`` writes the seeded synthetic studies of these tests and of
tests/test_torch_port_mnms.py in the JAX preprocessing's layout.
"""

import csv
import gzip

import numpy as np
import pandas as pd
import pytest

from cinema_tpu_torch.config import PACKAGED, from_dict
from cinema_tpu_torch.data import (
    BatchLoader,
    EDESClassificationDataset,
    EDESRegressionDataset,
    EDESSegmentationDataset,
    collate,
    load_nifti,
    load_nifti_header,
    read_metadata,
    save_nifti,
)
from cinema_tpu_torch.data import nifti as port_nifti
from cinema_tpu_torch.data import transforms as port_tf

CLASSES = {name: PACKAGED[f"classification/{name}"]["data"]["pathology"] for name in ("acdc", "mnms", "mnms2")}
SAX_SIZES = [(20, 18, 5), (24, 20, 6), (16, 16, 3)]
LAX_SIZE = (22, 20)


def _boxes(rng, shape):
    """LV (1), myocardium (2) and RV (3) as nested boxes at a seeded place, uint8 (x, y, z)."""
    label = np.zeros(shape, np.uint8)
    x, y = shape[:2]
    cx, cy = int(rng.integers(x // 3, 2 * x // 3)), int(rng.integers(y // 3, 2 * y // 3))
    label[max(cx - 6, 0) : cx + 2, max(cy - 5, 0) : cy + 5] = 3
    label[cx - 3 : cx + 5, cy - 4 : cy + 4] = 2
    label[cx - 1 : cx + 3, cy - 2 : cy + 2] = 1
    return label


def write_edes_tree(root, name, n_train, n_val=0, views=("sax",), seed=0, other_class=True):
    """Seeded synthetic studies as the JAX package's preprocessing writes them: per split
    ``<split>/<pid>/<pid>_<view>_{ed,es}[_gt].nii.gz`` (uint8 images with bright nested boxes and
    their uint8 labels; ``lax_*`` views (x, y, 1)) and ``<split>_metadata.csv`` with ``pid``,
    ``n_slices``, ``pathology`` (the dataset's classes in turn; with ``other_class`` two studies
    of a class the config does not list), ``ef`` (empty for every seventh study) and, for M&Ms,
    ``age``. M&Ms2's pids are numbers, ACDC's ``patient<nnn>``, M&Ms' codes with leading zeros."""
    rng = np.random.default_rng(seed)
    classes = CLASSES[name] + (["OTHER"] * 2 if other_class else [])
    for split, n in (("train", n_train), ("val", n_val)):
        if n == 0:
            continue
        rows = []
        for i in range(n):
            pid = {"acdc": f"patient{i:03d}", "mnms": f"0{i:02d}A{split[0].upper()}",
                   "mnms2": str(i + 1 + (0 if split == "train" else 160))}[name]
            size = SAX_SIZES[i % len(SAX_SIZES)]
            (root / split / pid).mkdir(parents=True)
            for view in views:
                shape = size if view == "sax" else (*LAX_SIZE, 1)
                for frame in ("ed", "es"):
                    label = _boxes(rng, shape)
                    image = np.clip(label * 60 + rng.normal(40, 15, shape), 0, 255).astype(np.uint8)
                    save_nifti(root / split / pid / f"{pid}_{view}_{frame}.nii.gz", image)
                    save_nifti(root / split / pid / f"{pid}_{view}_{frame}_gt.nii.gz", label)
            row = {"pid": pid, "n_slices": size[2], "pathology": classes[i % len(classes)],
                   "ef": "" if i % 7 == 3 else round(float(rng.uniform(20, 70)), 3)}
            if name == "mnms":
                row["age"] = int(rng.integers(20, 80))
            rows.append(row)
        with open(root / f"{split}_metadata.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)


def assert_items_equal(got, want):
    """Two dataset items (or batches): the same keys, strings equal, arrays of the same dtype equal bit for bit."""
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, (str, list)):
            assert got[key] == value, key
        else:
            assert got[key].dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


# --- (a) NIfTI --------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", list(port_nifti._DTYPES.values()), ids=str)
def test_nifti_files_read_the_same_through_both_packages(tmp_path, dtype, suffix):
    from cinema_tpu.data import nifti as jax_nifti

    rng = np.random.default_rng(int(dtype.num))
    info = np.iinfo(dtype) if dtype.kind in "iu" else None
    shapes = [(7, 5), (6, 5, 4), (5, 4, 3, 2)]
    for i, shape in enumerate(shapes):
        array = (rng.integers(info.min, info.max, size=shape, endpoint=True) if info else rng.normal(size=shape) * 100)
        array = array.astype(dtype)
        spacing = tuple(float(s) for s in rng.uniform(0.5, 10, len(shape)))
        scl = (1.0, 0.0) if i == 0 else (2.5, -3.0)
        for writer, reader, name in ((jax_nifti.save_nifti, load_nifti, "jax"), (save_nifti, jax_nifti.load_nifti, "port")):
            path = tmp_path / f"{name}{i}{suffix}"
            writer(path, array, spacing=spacing, scl=scl)
            got, header = reader(path)
            want_header = (jax_nifti if reader is load_nifti else port_nifti).load_nifti_header(path)
            want = array.astype(np.float32) * scl[0] + scl[1] if i else array
            assert got.dtype == want.dtype and got.shape == shape
            np.testing.assert_array_equal(got, want)
            assert (header.shape, header.dtype, header.spacing, header.vox_offset, header.scl_slope, header.scl_inter,
                    header.descrip) == (want_header.shape, want_header.dtype, want_header.spacing,
                                        want_header.vox_offset, want_header.scl_slope, want_header.scl_inter,
                                        want_header.descrip)
            np.testing.assert_array_equal(header.affine, want_header.affine)
            raw, _ = reader(path, apply_scaling=False)
            np.testing.assert_array_equal(raw, array)
        # the two writers write the same bytes (gzip's own header aside)
        read = (lambda p: gzip.open(p).read()) if suffix.endswith(".gz") else (lambda p: p.read_bytes())
        assert read(tmp_path / f"jax{i}{suffix}") == read(tmp_path / f"port{i}{suffix}")


def test_nifti_header_and_rejected_files(tmp_path):
    array = np.arange(24, dtype=np.int16).reshape(4, 3, 2)
    save_nifti(tmp_path / "a.nii.gz", array, spacing=(1.5, 2.0, 10.0))
    header = load_nifti_header(tmp_path / "a.nii.gz")
    assert header.shape == (4, 3, 2) and header.dtype == np.int16 and header.spacing == (1.5, 2.0, 10.0)
    np.testing.assert_array_equal(header.affine, np.diag([1.5, 2.0, 10.0, 1.0]))
    assert load_nifti(tmp_path / "a.nii.gz")[0][3, 2, 1] == array[3, 2, 1]  # arr[x, y, z] indexing
    with pytest.raises(ValueError, match="2D-4D"):
        save_nifti(tmp_path / "b.nii", np.zeros(3))
    (tmp_path / "c.nii").write_bytes(b"\x00" * 400)
    with pytest.raises(ValueError, match="little-endian NIfTI-1"):
        load_nifti(tmp_path / "c.nii")


# --- (b) the transforms ----------------------------------------------------------------------

def _inputs(nd, channels, seed):
    rng = np.random.default_rng(seed)
    spatial = (20, 18, 6)[:nd]
    image = (rng.random((*spatial, channels)) * 200).astype(np.float32)
    label = rng.integers(0, 4, size=spatial).astype(np.int8)
    return {"x_image": image, "x_label": label}


def _transform_pairs(nd):
    """(port, JAX) pairs of every transform, each made to fire."""
    import cinema_tpu.data.transforms as jax_tf

    rotate, translate = ([0, 0, 180], [6, 6, 0]) if nd == 3 else ([180], [6, 6])
    keys = ("x_image", "x_label")
    specs = [
        ("ScaleIntensityd", ("x_image",), {}),
        ("SpatialPadd", (keys, (24, 20, 8)[:nd]), {}),
        ("RandAdjustContrastd", ("x_image", 1.0, (0.5, 1.5)), {}),
        ("RandGaussianNoised", ("x_image", 1.0), {}),
        ("RandAffined", (), dict(image_keys="x_image", label_keys="x_label", prob=1.0, rotate_range=rotate,
                                 translate_range=translate, scale_range=0.2)),
        ("RandAffined", (), dict(image_keys="x_image", label_keys="x_label", prob=1.0, rotate_range=rotate)),
        ("RandCoarseDropoutd", ("x_image", 1.0, (5, 4, 2)[:nd]), dict(holes=2)),
        ("RandSpatialCropd", (keys, (12, 24, 4)[:nd]), {}),
    ]
    return [(getattr(port_tf, n)(*a, **k), getattr(jax_tf, n)(*a, **k)) for n, a, k in specs]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("nd", [2, 3])
def test_each_transform_is_bit_identical_to_the_jax_transform(nd, channels):
    for i, (port, jax_t) in enumerate(_transform_pairs(nd)):
        for seed in (0, 1):
            got = port(_inputs(nd, channels, i), np.random.default_rng(seed))
            want = jax_t(_inputs(nd, channels, i), np.random.default_rng(seed))
            assert_items_equal(got, want)
            if type(port).__name__.startswith("Rand") and type(port).__name__ != "RandSpatialCropd":
                assert not np.array_equal(got["x_image"], _inputs(nd, channels, i)["x_image"]), type(port)


def test_transforms_skip_by_their_probability_and_missing_keys():
    data = _inputs(3, 1, 0)
    for cls, args in ((port_tf.RandAdjustContrastd, ("x_image", 0.0, (0.5, 1.5))),
                      (port_tf.RandGaussianNoised, ("x_image", 0.0)),
                      (port_tf.RandCoarseDropoutd, ("x_image", 0.0, (4, 4, 2)))):
        out = cls(*args)(dict(data), np.random.default_rng(0))
        np.testing.assert_array_equal(out["x_image"], data["x_image"])
    assert port_tf.RandAffined("y_image", prob=1.0)(dict(data), np.random.default_rng(0)).keys() == data.keys()
    assert port_tf.ScaleIntensityd("y_image")({}, None) == {}
    np.testing.assert_array_equal(port_tf.scale_intensity(np.full((3, 3), 7.0)), np.zeros((3, 3), np.float32))


@pytest.mark.parametrize("task,views", [("segmentation/mnms", "sax"), ("classification/mnms2", "sax"),
                                        ("segmentation/mnms2", ["sax", "lax_4c"])])
def test_segmentation_pipelines_are_bit_identical_to_the_jax_pipelines(task, views):
    from cinema_tpu.data.transforms import get_segmentation_transforms as jax_transforms

    config = from_dict(PACKAGED[task])
    config.model.views = views
    config.data.sax.patch_size = [16, 16, 4]
    if "lax" in config.data:
        config.data.lax.patch_size = [16, 16]
    rng = np.random.default_rng(3)
    clf = task.startswith("classification")
    for seed in range(4):
        data = {}
        for view in [views] if isinstance(views, str) else views:
            spatial = (20, 18, 6) if view == "sax" else (22, 12)
            data[f"{view}_image"] = (rng.random((*spatial, 2 if clf else 1)) * 255).astype(np.float32)
            if not clf:
                data[f"{view}_label"] = rng.integers(0, 4, size=spatial).astype(np.int8)
        shapes = []
        for port, jax_t in zip(port_tf.get_segmentation_transforms(config), jax_transforms(config)):
            got = port({k: v.copy() for k, v in data.items()}, np.random.default_rng(seed))
            want = jax_t({k: v.copy() for k, v in data.items()}, np.random.default_rng(seed))
            assert_items_equal(got, want)
            shapes.append(got["sax_image"].shape[:3])
        assert shapes == [(16, 16, 4), (20, 18, 6)]  # train: cut to the patch; val: padded only


# --- (c) the EDES datasets ---------------------------------------------------------------------

def _dataset_pairs(root, views):
    """(port, JAX) pairs of the three EDES datasets over ``root/train``, with the packaged M&Ms2
    transforms at patch 16x16x4 (LAX 16x16)."""
    from cinema_tpu.data import datasets as jd
    from cinema_tpu.data.transforms import get_segmentation_transforms as jax_transforms

    config = from_dict(PACKAGED["segmentation/mnms2"])
    config.model.views = views
    config.data.sax.patch_size, config.data.lax.patch_size = [16, 16, 4], [16, 16]
    train_tf, _ = port_tf.get_segmentation_transforms(config)
    jax_train_tf, _ = jax_transforms(config)
    rows = read_metadata(root / "train_metadata.csv")
    meta = pd.read_csv(root / "train_metadata.csv", dtype={"pid": str})
    known = [r for r in rows if r["ef"] is not None]
    classes = CLASSES["mnms2"]
    listed = [r for r in rows if r["pathology"] in classes]
    data_dir = root / "train"
    pairs = [
        (EDESSegmentationDataset(data_dir, rows, views, train_tf, seed=7),
         jd.EDESSegmentationDataset(data_dir, meta, views, transform=jax_train_tf)),
        (EDESClassificationDataset(data_dir, listed, "pathology", classes, views, train_tf, seed=7),
         jd.EDESClassificationDataset(data_dir, meta[meta["pathology"].isin(classes)], "pathology", classes, views,
                                      transform=jax_train_tf)),
        (EDESRegressionDataset(data_dir, known, "ef", 50.0, 15.0, views, train_tf, seed=7),
         jd.EDESRegressionDataset(data_dir, meta.dropna(subset=["ef"]), "ef", 50.0, 15.0, views,
                                  transform=jax_train_tf)),
        (EDESSegmentationDataset(data_dir, rows, views, seed=7), jd.EDESSegmentationDataset(data_dir, meta, views)),
    ]
    for _, jax_ds in pairs:
        jax_ds.seed = 7
    return pairs


@pytest.mark.parametrize("views", ["sax", ["sax", "lax_4c"]], ids=["sax", "sax+lax_4c"])
def test_edes_dataset_items_equal_the_jax_items(tmp_path, views):
    write_edes_tree(tmp_path, "mnms2", 8, views=("sax", "lax_4c"))
    for port, jax_ds in _dataset_pairs(tmp_path, views):
        assert len(port) == len(jax_ds)
        for index, epoch in ((0, 0), (1, 0), (3, 2), (len(port) - 1, 5)):
            jax_ds.set_epoch(epoch)
            assert_items_equal(port.load(index, epoch), jax_ds[index])
    item = _dataset_pairs(tmp_path, views)[3][0].load(1, 0)  # ES of study 0, untransformed
    assert item["pid"] == "1" and not item["is_ed"] and item["sax_label"].dtype == np.int8
    assert item["sax_image"].shape == (*SAX_SIZES[0], 1) and int(item["n_slices"]) == SAX_SIZES[0][2]
    if "lax_4c" in views:
        assert item["lax_4c_image"].shape == (*LAX_SIZE, 1) and item["lax_4c_label"].shape == LAX_SIZE


def test_read_metadata_keeps_pids_as_strings_and_empty_fields_missing(tmp_path):
    write_edes_tree(tmp_path, "mnms", 8, other_class=False)
    rows = read_metadata(tmp_path / "train_metadata.csv")
    meta = pd.read_csv(tmp_path / "train_metadata.csv", dtype={"pid": str})
    assert [r["pid"] for r in rows] == meta["pid"].tolist() and rows[0]["pid"] == "000AT"
    assert [r["ef"] is None for r in rows] == meta["ef"].isna().tolist()
    assert [int(r["n_slices"]) for r in rows] == meta["n_slices"].tolist()
    with pytest.raises(ValueError, match="Column n_slices is required"):
        EDESSegmentationDataset(tmp_path / "train", [{"pid": "x"}], "sax")


# --- (f) the loader's workers ------------------------------------------------------------------

@pytest.mark.parametrize("n_workers,processes", [(3, False), (2, True)], ids=["threads", "processes"])
def test_worker_threads_and_processes_give_the_batches_of_one_loader(tmp_path, n_workers, processes):
    write_edes_tree(tmp_path, "mnms2", 7)
    port, _ = _dataset_pairs(tmp_path, "sax")[0]
    with BatchLoader(port, 3, seed=4) as one, BatchLoader(port, 3, seed=4, n_workers=n_workers,
                                                           processes=processes) as many:
        for epoch in (0, 1):
            order = np.arange(len(port))
            np.random.default_rng(4 + epoch).shuffle(order)  # the JAX loader's order
            want = [collate([port.load(int(i), epoch) for i in order[b : b + 3]]) for b in range(0, 12, 3)]
            for loader in (one, many):
                got = list(loader.epoch(epoch))
                assert len(got) == len(loader) == 4
                for g, w in zip(got, want):
                    assert_items_equal(g, w)
        last = BatchLoader(port, 3, shuffle=False, drop_last=False, n_workers=n_workers, processes=processes)
        with last:
            sizes = [len(b["pid"]) for b in last.epoch(0)]
        assert sizes == [3, 3, 3, 3, 2]


@pytest.mark.parametrize("processes", [False, True], ids=["threads", "processes"])
def test_a_workers_exception_reaches_the_consumer(tmp_path, processes):
    write_edes_tree(tmp_path, "mnms2", 3)
    rows = read_metadata(tmp_path / "train_metadata.csv")
    (tmp_path / "train" / "2" / "2_sax_es.nii.gz").unlink()
    with BatchLoader(EDESSegmentationDataset(tmp_path / "train", rows, "sax"), 2, shuffle=False, n_workers=2,
                     processes=processes) as loader:
        batches = loader.epoch(0)
        assert next(batches)["pid"] == ["1", "1"]
        with pytest.raises(FileNotFoundError, match="2_sax_es"):
            next(batches)
