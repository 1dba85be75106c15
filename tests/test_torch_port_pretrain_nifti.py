"""The port's pretraining input against the JAX package's (cinema_tpu/data, cinema_tpu/tasks/pretrain.py):
``RandZoomd`` and ``get_pretrain_transforms`` bit for bit for the same generator; ``find_view_file``'s
names; ``UKBCineDataset`` items at the same (seed, epoch, index); ``scan_manifest``'s pid lists, its
cache file and each rule that makes the cache stale, with caches written by either package; the first
batch of the pretraining loader against the JAX ``BatchLoader``'s; and ``device_prefetch`` on the CPU.

``write_ukb_tree`` writes the seeded synthetic studies of these tests and of
tests/test_torch_port_pretrain.py as the UKB preprocessing writes them
(cinema_tpu/data/preprocess/ukb_dicom.py): ``<pid>/<pid>_<view>.nii.gz``, uint8, one gzip member per
frame, ``lax_*`` views (x, y, 1, t).
"""

import json

import numpy as np
import pytest
import torch

from cinema_tpu_torch.config import from_dict
from cinema_tpu_torch.data import BatchLoader, UKBCineDataset, device_prefetch, find_view_file, save_nifti
from cinema_tpu_torch.data import transforms as port_tf
from cinema_tpu_torch.tasks.pretrain import scan_manifest
from test_torch_port_nifti_data import assert_items_equal

VIEWS = ("sax", "lax_2c", "lax_3c", "lax_4c")
# sizes around the tests' patch sizes (16, 16, 4) and (32, 32): smaller, equal and larger
SAX_SIZES = [(14, 18, 4), (16, 16, 3), (17, 15, 5)]
LAX_SIZES = [(30, 33), (32, 32), (35, 29)]
# no larger than the patch, as the UKB writer crops its views: after the pad-only pipeline every item
# of a batch has the patch's shape
FIT_SAX, FIT_LAX = [(14, 16, 4), (16, 16, 3), (16, 15, 4)], [(30, 32), (32, 32), (31, 29)]


def write_ukb_tree(root, n, n_frames=5, views=VIEWS, seed=0, sax_sizes=SAX_SIZES, lax_sizes=LAX_SIZES, first=0):
    """``n`` seeded studies ``<root>/<pid>/<pid>_<view>.nii.gz`` (pids ``<1000000 + first + i>_2``, the UKB
    writer's ``{eid}_{instance}``): uint8 noise with a bright disc that moves with the frame, ``sax`` (x, y, z, t)
    and the ``lax_*`` views (x, y, 1, t), written frame-indexed. Returns the pids."""
    rng = np.random.default_rng(seed)
    pids = []
    for i in range(n):
        pid = f"{1000000 + first + i}_2"
        (root / pid).mkdir(parents=True)
        for view in views:
            xy = sax_sizes[i % len(sax_sizes)] if view == "sax" else (*lax_sizes[i % len(lax_sizes)], 1)
            shape = (*xy, n_frames)
            image = rng.normal(50, 20, shape)
            gx, gy = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
            for t in range(n_frames):
                disc = (gx - shape[0] / 2) ** 2 + (gy - shape[1] / 2) ** 2 < (3 + t) ** 2
                image[disc, ..., t] += 120
            save_nifti(root / pid / f"{pid}_{view}.nii.gz", np.clip(image, 0, 255).astype(np.uint8),
                       spacing=(1.0, 1.0, 10.0, 1.0), frame_indexed=True)
        pids.append(pid)
    return pids


def pretrain_config(patch_sax=(16, 16, 4), patch_lax=(32, 32), prob=0.5, scale_range=0.2, views=VIEWS):
    return {
        "model": {"views": list(views)},
        "data": {"sax": {"patch_size": list(patch_sax)}, "lax": {"patch_size": list(patch_lax)}},
        "transform": {"prob": prob, "scale_range": scale_range},
    }


def _jax_config(d):
    from cinema_tpu.config import from_dict as jax_from_dict

    return jax_from_dict(json.loads(json.dumps(d)))


# --- RandZoomd and the pipeline ----------------------------------------------------------------------

@pytest.mark.parametrize("zoom", [(0.8, 0.8), (1.15, 1.15), (0.83, 1.21)], ids=["out", "in", "drawn"])
@pytest.mark.parametrize("shape", [(15, 17, 1), (16, 13, 5, 3), (31, 29, 2)], ids=["2d-odd", "3d-3ch", "2d-2ch"])
def test_rand_zoom_is_bit_identical_to_the_jax_transform(shape, zoom):
    from cinema_tpu.data.transforms import RandZoomd as JaxRandZoomd

    x = np.random.default_rng(3).normal(size=shape).astype(np.float32) * 40
    data = {"a": x, "b": (x[..., :1] * 2).astype(np.float64), "c": x}
    for seed in range(4):
        rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        got = port_tf.RandZoomd(("a", "b", "missing"), 1.0, *zoom)(dict(data), rng_p)
        want = JaxRandZoomd(("a", "b", "missing"), 1.0, *zoom)(dict(data), rng_j)
        assert_items_equal(got, want)
        assert got["a"].shape == shape and got["a"].dtype == np.float32
        assert got["c"] is x  # a key outside the transform is left alone
        assert rng_p.uniform() == rng_j.uniform()  # the same number of draws
    # one zoom factor for every key: the second key is the first's zoom of the same values
    np.testing.assert_array_equal(got["b"][..., 0], 2 * got["a"][..., 0])


def test_rand_zoom_gate_draws_once_and_leaves_the_data():
    from cinema_tpu.data.transforms import RandZoomd as JaxRandZoomd

    x = np.arange(60, dtype=np.float32).reshape(6, 10, 1)
    for prob in (0.0, 0.3, 0.7):
        hits = 0
        for seed in range(20):
            rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
            got = port_tf.RandZoomd("k", prob, 0.7, 0.9)({"k": x}, rng_p)
            want = JaxRandZoomd("k", prob, 0.7, 0.9)({"k": x}, rng_j)
            assert_items_equal(got, want)
            assert rng_p.uniform() == rng_j.uniform()
            hits += got["k"] is not x
        assert (hits == 0) == (prob == 0.0)


@pytest.mark.parametrize("prob,views", [(1.0, VIEWS), (0.5, VIEWS), (0.5, ("sax", "lax_2c"))])
def test_pretrain_pipeline_is_bit_identical_to_the_jax_pipeline(prob, views):
    from cinema_tpu.data.transforms import get_pretrain_transforms as jax_pretrain_transforms

    config = pretrain_config(prob=prob, views=views)
    port, jax_pipeline = port_tf.get_pretrain_transforms(from_dict(config)), jax_pretrain_transforms(_jax_config(config))
    rng = np.random.default_rng(7)
    for seed in range(6):
        item = {"pid": "p"}
        for i, view in enumerate(views):
            size = SAX_SIZES[(seed + i) % 3] if view == "sax" else LAX_SIZES[(seed + i) % 3]
            item[view] = (rng.random((*size, 1)) * 255).round().astype(np.float32)
        got = port({k: v.copy() if hasattr(v, "copy") else v for k, v in item.items()}, np.random.default_rng(seed))
        want = jax_pipeline(dict(item), np.random.default_rng(seed))
        assert_items_equal(got, want)
        for view in views:  # padded up to the patch, never cropped
            patch = config["data"]["sax" if view == "sax" else "lax"]["patch_size"]
            assert all(g >= p for g, p in zip(got[view].shape, patch)) and 0.0 <= got[view].min()


# --- find_view_file and the dataset --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["{pid}_{view}_t.nii.gz", "{pid}_{view}_t.nii", "{pid}_{view}.nii.gz",
                                  "{pid}_{view}.nii", None])
def test_find_view_file_takes_the_jax_packages_names(tmp_path, name):
    from cinema_tpu.data.datasets import find_view_file as jax_find_view_file

    pid_dir = tmp_path / "12_2"
    pid_dir.mkdir()
    (pid_dir / "12_2_lax_2c.nii.gz.bak").write_bytes(b"")
    if name is not None:
        (pid_dir / name.format(pid="12_2", view="sax")).write_bytes(b"")
    got = find_view_file(pid_dir, "12_2", "sax")
    assert got == jax_find_view_file(pid_dir, "12_2", "sax")
    assert (got is None) if name is None else got.name == name.format(pid="12_2", view="sax")


def test_the_first_of_two_names_wins(tmp_path):
    (tmp_path / "7_sax.nii.gz").write_bytes(b"")
    (tmp_path / "7_sax_t.nii").write_bytes(b"")
    assert find_view_file(tmp_path, "7", "sax").name == "7_sax_t.nii"


@pytest.mark.parametrize("views", [VIEWS, ("sax", "lax_4c")])
def test_ukb_items_equal_the_jax_items_over_two_epochs(tmp_path, views):
    from cinema_tpu.data.datasets import UKBCineDataset as JaxUKBCineDataset
    from cinema_tpu.data.transforms import get_pretrain_transforms as jax_pretrain_transforms

    pids = write_ukb_tree(tmp_path, 4, views=views)
    config = pretrain_config(views=views)
    port = UKBCineDataset(tmp_path, pids, views, port_tf.get_pretrain_transforms(from_dict(config)), seed=5)
    jax_ds = JaxUKBCineDataset(tmp_path, pids, views, jax_pretrain_transforms(_jax_config(config)), seed=5)
    raw_port, raw_jax = UKBCineDataset(tmp_path, pids, views, seed=5), JaxUKBCineDataset(tmp_path, pids, views, seed=5)
    frames = set()
    for epoch in (0, 1):
        jax_ds.set_epoch(epoch)
        raw_jax.set_epoch(epoch)
        for i in range(len(pids)):
            assert_items_equal(port.load(i, epoch), jax_ds[i])
            raw = raw_port.load(i, epoch)
            assert_items_equal(raw, raw_jax[i])
            assert raw["sax"].ndim == 4 and raw[views[1]].ndim == 3 and raw["sax"].dtype == np.float32
            frames.add(raw["sax"].tobytes())
    assert len(frames) > 4  # another epoch draws other frames
    assert port.rows == pids and len(port) == 4


def test_ukb_dataset_names_a_missing_view(tmp_path):
    pids = write_ukb_tree(tmp_path, 1, views=("sax",))
    with pytest.raises(FileNotFoundError, match="lax_2c"):
        UKBCineDataset(tmp_path, pids, ("sax", "lax_2c")).load(0)


# --- the manifest ----------------------------------------------------------------------------------------

def _cache(root, views=("sax", "lax_2c")):
    return root / f"manifest_pids_{'_'.join(sorted(views))}.json"


def test_scan_manifest_lists_complete_studies_and_writes_the_jax_cache(tmp_path):
    from cinema_tpu.tasks.pretrain import scan_manifest as jax_scan_manifest

    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    for root in (port_root, jax_root):
        pids = write_ukb_tree(root, 4, views=("lax_2c", "sax"))
        (root / pids[1] / f"{pids[1]}_lax_2c.nii.gz").unlink()  # incomplete: left out
        (root / "notes.txt").write_text("not a study")
    views = ["lax_2c", "sax"]
    got, want = scan_manifest(port_root, views), jax_scan_manifest(jax_root, views)
    assert got == want == [pids[0], pids[2], pids[3]]
    assert _cache(port_root).read_bytes() == _cache(jax_root).read_bytes()
    assert json.loads(_cache(port_root).read_text()) == {"pids": got, "n_dir_entries": 4}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_cache_written_by_either_package_is_read_by_the_other(tmp_path, writer):
    from cinema_tpu.tasks.pretrain import scan_manifest as jax_scan_manifest

    pids = write_ukb_tree(tmp_path, 3, views=("sax", "lax_2c"))
    scans = {"port": scan_manifest, "jax": jax_scan_manifest}
    assert scans[writer](tmp_path, ["sax", "lax_2c"]) == pids
    # a cache that says something the folder does not: only a reader of the cache returns it
    cached = json.loads(_cache(tmp_path).read_text())
    _cache(tmp_path).write_text(json.dumps({**cached, "pids": pids[:2]}))
    reader = scans["jax" if writer == "port" else "port"]
    assert reader(tmp_path, ["lax_2c", "sax"]) == pids[:2]
    assert reader(tmp_path, ["sax", "lax_2c"], rescan=True) == pids


STALE = ["first-pid-gone", "study-added", "legacy-list", "unreadable"]


@pytest.mark.parametrize("rule", STALE)
def test_each_stale_cache_is_rescanned_as_the_jax_package_rescans_it(tmp_path, rule):
    from cinema_tpu.tasks.pretrain import scan_manifest as jax_scan_manifest

    results = []
    for side, scan in (("port", scan_manifest), ("jax", jax_scan_manifest)):
        root = tmp_path / side
        pids = write_ukb_tree(root, 3, views=("sax", "lax_2c"))
        assert scan(root, ["sax", "lax_2c"]) == pids
        if rule == "first-pid-gone":
            for f in (root / pids[0]).iterdir():
                f.rename(root / pids[0] / f"moved_{f.name}")
        elif rule == "study-added":
            write_ukb_tree(root, 1, views=("sax", "lax_2c"), first=5)
        elif rule == "legacy-list":
            _cache(root).write_text(json.dumps(pids[:1]))
        else:
            _cache(root).write_text("{not json")
        results.append((scan(root, ["sax", "lax_2c"]), _cache(root).read_text()))
    assert results[0] == results[1]
    want = {"first-pid-gone": pids[1:], "study-added": pids + ["1000005_2"]}.get(rule, pids)
    assert results[0][0] == want


def test_a_cache_that_cannot_be_written_leaves_the_scan_as_it_is(tmp_path):
    """A cache path that cannot be opened (here a directory stands there, which no user can open as a file)
    is stale and cannot be written: both packages scan and return the same studies."""
    from cinema_tpu.tasks.pretrain import scan_manifest as jax_scan_manifest

    got = []
    for side, scan in (("port", scan_manifest), ("jax", jax_scan_manifest)):
        pids = write_ukb_tree(tmp_path / side, 2, views=("sax",))
        _cache(tmp_path / side, ("sax",)).mkdir()
        got.append(scan(tmp_path / side, ["sax"]))
        assert _cache(tmp_path / side, ("sax",)).is_dir()
    assert got[0] == got[1] == pids


# --- the loader and the device prefetch -------------------------------------------------------------

@pytest.mark.parametrize("processes", [False, True], ids=["threads", "processes"])
def test_the_first_pretraining_batch_equals_the_jax_loaders(tmp_path, processes):
    from cinema_tpu.data.datasets import BatchLoader as JaxBatchLoader
    from cinema_tpu.data.datasets import UKBCineDataset as JaxUKBCineDataset
    from cinema_tpu.data.transforms import get_pretrain_transforms as jax_pretrain_transforms

    pids = write_ukb_tree(tmp_path, 7, sax_sizes=FIT_SAX, lax_sizes=FIT_LAX)
    config = pretrain_config()
    port = UKBCineDataset(tmp_path, pids, VIEWS, port_tf.get_pretrain_transforms(from_dict(config)), seed=3)
    jax_ds = JaxUKBCineDataset(tmp_path, pids, VIEWS, jax_pretrain_transforms(_jax_config(config)), seed=3)
    want = next(iter(JaxBatchLoader(jax_ds, 3, shuffle=True, drop_last=True, n_workers=2, seed=3)))
    with BatchLoader(port, 3, seed=3, shuffle=True, drop_last=True, n_workers=2, processes=processes) as loader:
        batches = list(loader.epoch(0))
    assert len(batches) == 2
    assert_items_equal(batches[0], want)
    assert batches[0]["sax"].shape == (3, 16, 16, 4, 1) and batches[0]["lax_3c"].shape == (3, 32, 32, 1)


def test_device_prefetch_on_the_cpu_yields_the_loaders_arrays_in_order():
    batches = [{"pid": [f"p{i}"], "x": np.full((2, 3), i, np.float32), "y": np.arange(i, i + 2)} for i in range(5)]
    pulled = []

    def source():
        for b in batches:
            pulled.append(b["pid"][0])
            yield b

    got = []
    for n, out in enumerate(device_prefetch(source(), "cpu", depth=2)):
        assert set(out) == {"x", "y"} and all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in out.values())
        got.append(out)
        assert len(pulled) == n + 1  # the CPU takes no batch ahead: nothing is copied
    for out, b in zip(got, batches):
        np.testing.assert_array_equal(out["x"].numpy(), b["x"])
        np.testing.assert_array_equal(out["y"].numpy(), b["y"])
    assert len(got) == 5
