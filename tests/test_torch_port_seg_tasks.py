"""The EMIDEC, MyoPS2020, Rescan and Kaggle tasks and the evaluation of a run folder against the JAX
package's: the packaged configs; the grouped-class metrics on the same logits; every task's
``load_dataset`` pid lists; ``load_run`` on run folders written by either package; the label-free
EF (``video_lv_volumes``, ``evaluate_kaggle``, ``rescan_ef_eval``) and ``evaluate.main`` on the same
safetensors weights; the dispatcher's routes; and a rehearsal of each new entry point on the CPU.

f32 on both sides, the JAX side's Pallas kernels in interpret mode. Logits agree to 2e-4, as in the
other port tests (the JAX package's approximate GELU against torch's exact erf). The argmax tie
rule: a voxel's label may differ between the packages only where its two largest logits lie
within twice the logits' largest difference; the tests check that no voxel of their inputs is
such a tie, and then hold volumes and EFs to the JAX package's exactly (rtol 1e-12 for their
means) and the metric tables to 1e-5.
"""

import functools
import json
import shutil
import warnings
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from cinema_tpu_torch.config import PACKAGED, from_dict
from cinema_tpu_torch.convert import load_safetensors, save_safetensors
from cinema_tpu_torch.factory import get_segmentation_model, init_weights
from cinema_tpu_torch.tasks import evaluate
from cinema_tpu_torch.tasks.classification import get_classification_model
from cinema_tpu_torch.tasks.segmentation import emidec, kaggle, myops2020, rescan, rescan_ef_eval
from cinema_tpu_torch.train.checkpoint import latest_checkpoint
from test_torch_port_cine_data import write_kaggle_tree, write_rescan_tree, write_volume_tree
from test_torch_port_nifti_data import write_edes_tree

REPO = Path(__file__).resolve().parents[1]
ATOL = 2e-4
NEW = ("emidec", "myops2020", "rescan", "kaggle")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: its tiny models run many small ops, which the intra-op
    threads of several test processes sharing the cores slow many times over (the comparisons' tolerances
    do not depend on the thread count)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _tiny(name, data_dir, patch=(32, 32, 4)):
    """The packaged segmentation config of ``name`` at ``patch`` with a tiny ConvUNetR (embed 16, one block),
    narrow stems, one epoch evaluated once, two loader threads."""
    config = from_dict(PACKAGED[f"segmentation/{name}"])
    config.data.dir = str(data_dir)
    config.data.sax.patch_size = list(patch)
    config.model.convunetr.update(size="tiny", enc_conv_chans=[8, 16], enc_conv_n_blocks=1,
                                  dec_chans=[4, 8, 16, 24, 32])
    config.train.update(n_epochs=1, n_warmup_epochs=1, eval_interval=1, batch_size=4, n_workers=2)
    return config


def _jax_config(config):
    from cinema_tpu.config import from_dict as jax_from_dict

    return jax_from_dict(json.loads(json.dumps(config)))


def _jax_run_folder(folder, config):
    """A run folder as the JAX package's ``run_train`` leaves it: ``config.yaml`` and the exported
    ``model_0.safetensors`` of its seeded initial parameters."""
    from cinema_tpu.config import save_config
    from cinema_tpu.factory import get_segmentation_model as jax_segmentation_model
    from cinema_tpu.factory import init_params
    from cinema_tpu.train.checkpoint import save_params_safetensors

    folder.mkdir(parents=True)
    jconfig = _jax_config(config)
    params = init_params(jax_segmentation_model(jconfig))
    save_config(jconfig, folder / "config.yaml")
    save_params_safetensors(params["params"], folder / "model_0.safetensors")
    return folder


def _port_run_folder(folder, config, seed=0, build=get_segmentation_model):
    """A run folder as an older port's ``run_train`` left it, before it wrote ``config.yaml``: a ``run.json``
    with the nested config, and the exported safetensors of a seeded model."""
    folder.mkdir(parents=True)
    (folder / "run.json").write_text(json.dumps({"tags": [], "config": config}))
    model = init_weights(build(config, device="cpu"), seed=seed)
    save_safetensors(folder / "model_0.safetensors", {k: v.numpy() for k, v in model.state_dict().items()})
    return folder


# --- the packaged configs and the grouped-class metrics ----------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_packaged_configs_are_the_jax_packages_yamls(name):
    import yaml

    with open(REPO / "cinema_tpu" / "configs" / "segmentation" / f"{name}.yaml") as f:
        assert yaml.safe_load(f) == PACKAGED[f"segmentation/{name}"]
    assert PACKAGED[f"segmentation/{name}"]["data"]["name"] == name


def _logits_and_labels(n_classes, seed, shape=(2, 20, 18, 5)):
    """Seeded logits and labels: labels of nested boxes, logits that favour the label with noise, so that
    the prediction overlaps the label in part; batch item 1 lacks the last class in both."""
    rng = np.random.default_rng(seed)
    labels = np.zeros(shape, np.int8)
    for cls in range(1, n_classes):
        labels[:, 2 * cls : 18 - 2 * cls, 2 * cls : 16 - cls, 1:] = cls
    labels[1][labels[1] == n_classes - 1] = n_classes - 2
    logits = rng.normal(0, 1, (*shape, n_classes)).astype(np.float32)
    logits += 2.5 * np.eye(n_classes, dtype=np.float32)[labels]
    logits[1, ..., n_classes - 1] -= 10.0
    return logits, labels


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["emidec", "myops2020"])
def test_grouped_class_metrics_match_jax(name, seed):
    import jax.numpy as jnp

    from cinema_tpu.tasks.segmentation import emidec as jax_emidec
    from cinema_tpu.tasks.segmentation import myops2020 as jax_myops

    n_classes, port_fn, jax_fn = {
        "emidec": (5, emidec.emidec_segmentation_metrics, jax_emidec.emidec_segmentation_metrics),
        "myops2020": (4, myops2020.myops2020_segmentation_metrics, jax_myops.myops2020_segmentation_metrics),
    }[name]
    logits, labels = _logits_and_labels(n_classes, seed)
    spacing = (1.458, 1.458, 10.0)
    got = port_fn(torch.from_numpy(logits), torch.from_numpy(labels), spacing)
    want = jax_fn(jnp.asarray(logits), jnp.asarray(labels), spacing)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].shape == (2,), key
        np.testing.assert_allclose(got[key], np.asarray(value), rtol=1e-6, atol=0, err_msg=key)
    last = f"class_{n_classes - 1}_dice_score"
    # the last grouped class is absent from item 1's label and prediction: Dice 1 for EMIDEC, NaN for MyoPS
    assert got[last][1] == 1.0 if name == "emidec" else np.isnan(got[last][1])
    assert np.isfinite(got["class_1_hausdorff_distance_95"]).all()


# --- the splits -------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    write_volume_tree(root / "emidec", "emidec", 14, 3, seed=1)
    write_volume_tree(root / "myops2020", "myops2020", 13, 3, seed=2)
    write_rescan_tree(root / "rescan", n_groups=4, per_group=3, seed=3)
    write_kaggle_tree(root / "kaggle", 3, seed=4)
    write_edes_tree(root / "acdc", "acdc", 10, seed=5)
    (root / "acdc" / "test").symlink_to(root / "acdc" / "train")
    shutil.copy(root / "acdc" / "train_metadata.csv", root / "acdc" / "test_metadata.csv")
    return root


def _pids(dataset):
    if hasattr(dataset, "rows"):
        key = (lambda r: str(int(r["pid"]))) if isinstance(dataset, myops2020.MYOPS2020Dataset) else (
            lambda r: str(r["pid"]))
        return [key(r) for r in dataset.rows]
    return [str(int(p)) if isinstance(dataset.meta_df["pid"][0], (int, np.integer)) else str(p)
            for p in dataset.meta_df["pid"]]


@pytest.mark.parametrize("subset", [{}, {"max_n_samples": 5}, {"proportion": 0.5}], ids=["plain", "cap", "proportion"])
@pytest.mark.parametrize("name", ["emidec", "myops2020", "rescan"])
def test_load_dataset_gives_the_jax_tasks_pid_lists(trees, name, subset):
    import importlib

    config = _tiny(name, trees / name)
    config.data.update(subset)
    config.seed = 3
    port = {"emidec": emidec, "myops2020": myops2020, "rescan": rescan}[name].load_dataset(config)
    want = importlib.import_module(f"cinema_tpu.tasks.segmentation.{name}").load_dataset(_jax_config(config))
    for got, ref in zip(port, want):
        assert _pids(got) == _pids(ref) and len(got) == len(ref) > 0
        assert got.data_dir == ref.data_dir
        if name == "rescan":
            assert got.index_map == ref.index_map
    if not subset:
        assert len(port[1].rows) == {"emidec": 4, "myops2020": 2, "rescan": 4}[name]


# --- the label-free EF and the evaluation of a run folder, on the same weights --------------------------

@functools.cache
def _folders(root):
    """JAX run folders of the tiny Rescan (also used for Kaggle) and EMIDEC configs and of a tiny ACDC one."""
    root = Path(root)
    return {name: _jax_run_folder(root / "jax_runs" / name, _tiny(name, root / name))
            for name in ("rescan", "emidec", "acdc")}


@functools.cache
def _loaded_once(folder):
    from cinema_tpu.tasks import evaluate as jax_evaluate

    return (*evaluate.load_run(folder, device="cpu"), *jax_evaluate.load_run(folder))


def _loaded(folder):
    """(config, model) of the port's ``load_run`` and (config, model, params) of the JAX package's on a run
    folder, each loaded once; the configs are copies, free to change."""
    config, model, jconfig, jmodel, params = _loaded_once(folder)
    return from_dict(config), model, _jax_config(jconfig), jmodel, params


def _tie_free(logits_a, logits_b):
    """The two packages' logits agree to ATOL, no voxel is a near tie (its two largest logits within twice
    their largest difference, in either), and the labels are equal; returns the labels."""
    diff = float(np.abs(logits_a - logits_b).max())
    assert diff <= ATOL
    for x in (logits_a, logits_b):
        top = np.sort(x, axis=-1)
        assert (top[..., -1] - top[..., -2] > 2 * diff).all(), "a near-tie voxel"
    np.testing.assert_array_equal(logits_a.argmax(-1), logits_b.argmax(-1))
    return logits_a.argmax(-1)


def test_load_run_rebuilds_a_jax_run_folder(trees):
    config, model, jconfig, jmodel, params = _loaded(_folders(str(trees))["emidec"])
    assert config.data.name == "emidec" and config.model.out_chans == 5 and not model.training
    image = np.random.default_rng(0).random((2, 32, 32, 4, 1), np.float32)
    with torch.no_grad():
        got = model({"sax": torch.from_numpy(image)})["sax"].numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, {"sax": image})["sax"]), atol=ATOL, rtol=0)


def test_video_lv_volumes_match_jax(trees):
    from cinema_tpu.tasks.segmentation import kaggle as jax_kaggle

    config, model, _, jmodel, params = _loaded(_folders(str(trees))["rescan"])
    rng = np.random.default_rng(1)
    video = rng.random((11, 32, 32, 4, 1), np.float32)  # 11 frames: a chunk of 8 and a tail filled from the start
    forward = jax.jit(lambda p, imgs: jmodel.apply(p, imgs))
    spacing = tuple(config.data.sax.spacing)
    got = kaggle.video_lv_volumes(model, torch.from_numpy(video), spacing, 10)
    want = jax_kaggle.video_lv_volumes(forward, params, video, spacing, 10)
    with torch.no_grad():
        port_logits = model({"sax": torch.from_numpy(video)})["sax"].numpy()
    labels = _tie_free(port_logits, np.asarray(forward(params, {"sax": video})["sax"]))
    assert got.shape == (10,) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (labels == 3).reshape(11, -1).sum(1)[:10] * 0.01)
    assert got.max() > got.min() > 0


def test_evaluate_kaggle_matches_jax(trees):
    from cinema_tpu.tasks.segmentation import kaggle as jax_kaggle

    config, model, jconfig, jmodel, params = _loaded(_folders(str(trees))["rescan"])
    config.data.dir = jconfig.data.dir = str(trees / "kaggle")
    for max_n_samples in (-1, 2):
        got = kaggle.evaluate_kaggle(model, config, "validate", max_n_samples)
        want = jax_kaggle.evaluate_kaggle(jmodel, params, jconfig, "validate", max_n_samples)
        assert list(got) == list(want) and got["n_samples"] == (3 if max_n_samples < 0 else 2)
        np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-12)


def test_rescan_ef_eval_matches_jax(trees, tmp_path):
    from cinema_tpu.tasks.segmentation import rescan_ef_eval as jax_ef_eval

    config, model, jconfig, jmodel, params = _loaded(_folders(str(trees))["rescan"])
    got = rescan_ef_eval.rescan_ef_eval(config, model, "test_retest_100", tmp_path / "port")
    want = jax_ef_eval.rescan_ef_eval(jconfig, jmodel, params, "test_retest_100", tmp_path / "jax")
    assert list(got) == list(want) and got["n_pairs"] == 3
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-12)
    for table in ("ef_metrics.csv", "mean_metrics.csv"):
        g, w = (pd.read_csv(tmp_path / side / table) for side in ("port", "jax"))
        pd.testing.assert_frame_equal(g, w, rtol=1e-12)
    assert np.isnan(pd.read_csv(tmp_path / "port" / "ef_metrics.csv")["label_ef"]).sum() == 1


def test_pair_reproducibility_follows_pandas_pivot():
    from cinema_tpu.tasks.segmentation import rescan_ef_eval as jax_ef_eval

    rows = [{"pid": p, "subject": s, "acq": a, "ef": e, "label_ef": l} for p, s, a, e, l in [
        ("x", "s2", "B", 40.0, np.nan), ("y", "s1", "A", 55.0, 50.0), ("z", "s2", "A", 60.0, np.nan),
        ("w", "s1", "B", 52.0, np.nan), ("v", "s1", "B", 54.0, np.nan), ("u", "s3", "A", 30.0, 31.0),
        ("t", "s4", "A", np.nan, np.nan), ("r", "s4", "B", 70.0, np.nan), ("q", "s0", "C", 20.0, np.nan)]]
    got = rescan_ef_eval.evaluate_pair_reproducibility(rows)
    want = jax_ef_eval.evaluate_pair_reproducibility(pd.DataFrame(rows))
    assert list(got) == list(want) and got["n_pairs"] == 0  # acquisition C has one subject: no full pair
    rows = rows[:-1]
    got = rescan_ef_eval.evaluate_pair_reproducibility(rows)
    want = jax_ef_eval.evaluate_pair_reproducibility(pd.DataFrame(rows))
    assert list(got) == list(want) and got["n_pairs"] == 2
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-12)


@pytest.mark.parametrize("name", ["emidec", "acdc"])
def test_evaluate_main_writes_the_jax_tables(trees, tmp_path, name):
    from cinema_tpu.tasks import evaluate as jax_evaluate

    folder = _folders(str(trees))[name]
    port_folder, jax_folder = (shutil.copytree(folder, tmp_path / side) for side in ("port", "jax"))
    evaluate.main(["--folder_path", str(port_folder), "--device", "cpu"])
    jax_evaluate.main(["--folder_path", str(jax_folder)])
    tables = ["metrics.csv", "mean_metrics.csv"] + (["ef_metrics.csv"] if name == "acdc" else [])
    assert sorted(p.name for p in (port_folder / f"{name}_eval").iterdir()) == sorted(tables)
    for table in tables:
        g, w = (pd.read_csv(f / f"{name}_eval" / table) for f in (port_folder, jax_folder))
        assert list(g.columns) == list(w.columns) and len(g) == len(w) > 0
        pd.testing.assert_frame_equal(g, w, rtol=1e-5, atol=1e-6)


# --- the dispatcher ---------------------------------------------------------------------------------------

ROUTES = [
    ("segmentation", "acdc", "test", "edes_seg_eval"), ("segmentation", "mnms", "test", "edes_seg_eval"),
    ("segmentation", "mnms2", "test", "edes_seg_eval"), ("segmentation", "emidec", "test", "volume_seg_eval"),
    ("segmentation", "myops2020", "test", "volume_seg_eval"), ("segmentation", "kaggle", "validate", "evaluate_kaggle"),
    ("segmentation", "rescan", "test", "rescan_seg_eval"),
    ("segmentation", "rescan", "test_retest_100", "rescan_ef_eval"),
    ("segmentation", "landmark", "test", "landmark_seg_eval"), ("regression", "landmark", "test", "landmark_reg_eval"),
    ("classification", "acdc", "test", "classification_eval_dataloader"),
    ("regression", "mnms", "test", "regression_eval_dataloader"),
]


@pytest.mark.parametrize("task,data,split,route", ROUTES, ids=[f"{t}-{d}-{s}" for t, d, s, _ in ROUTES])
def test_the_dispatcher_routes_every_dataset(monkeypatch, tmp_path, task, data, split, route):
    """The JAX package's routes (tests/test_tasks_misc.py test_eval_dispatcher_routes) and the ED/ES ones."""
    calls = []
    config = from_dict(PACKAGED[f"{task}/acdc"])
    config.data.update(name=data, dir=str(tmp_path))
    monkeypatch.setattr(evaluate, "load_run", lambda folder, device="cuda": (config, None))
    for name in ("edes_seg_eval", "volume_seg_eval", "evaluate_kaggle", "rescan_seg_eval", "rescan_ef_eval",
                 "landmark_seg_eval", "landmark_reg_eval", "classification_eval_dataloader",
                 "regression_eval_dataloader"):
        monkeypatch.setattr(evaluate, name, lambda *a, _n=name, **k: calls.append(_n) or {})
    (tmp_path / f"{split}_metadata.csv").write_text("pid,n_slices,pathology,ef\n")
    evaluate.main(["--folder_path", str(tmp_path), "--split", split])
    assert calls == [route]


@pytest.mark.parametrize("task,data,message", [("segmentation", "ukb", "Unknown dataset"),
                                               ("pretrain", "acdc", "Unknown evaluation task")])
def test_the_dispatcher_rejects_unknown_datasets_and_tasks(monkeypatch, tmp_path, task, data, message):
    config = from_dict({"task": task, "data": {"name": data}})
    monkeypatch.setattr(evaluate, "load_run", lambda folder, device="cuda": (config, None))
    with pytest.raises(ValueError, match=message):
        evaluate.main(["--folder_path", str(tmp_path)])


def test_per_dataset_eval_wrappers_fix_the_data_and_check_the_task(monkeypatch, tmp_path):
    (tmp_path / "run.json").write_text(json.dumps({"config": {"task": "segmentation"}}))
    seen = []
    monkeypatch.setattr(evaluate, "main", lambda argv: seen.append(argv))
    evaluate.main_acdc_seg(["--folder_path", str(tmp_path), "--split", "train"])
    assert seen[-1] == ["--folder_path", str(tmp_path), "--split", "train", "--data", "acdc", "--device", "cuda"]
    evaluate.main_kaggle_seg(["--folder_path", str(tmp_path), "--device", "cpu"])
    assert seen[-1][-4:] == ["--data", "kaggle", "--device", "cpu"]
    with pytest.raises(ValueError, match="classification"):
        evaluate.main_acdc_clf(["--folder_path", str(tmp_path)])
    assert len([n for n in dir(evaluate) if n.startswith("main_")]) == 15


def _rows_of(path):
    return pd.read_csv(path).to_dict("records")


def test_every_route_runs_on_the_cpu(trees, tmp_path):
    """``python -m cinema_tpu_torch.tasks.evaluate`` on port run folders of tiny models, for every dataset
    the dispatcher routes: each route's tables, with finite metrics where the data define them."""
    from test_torch_port_landmark import _tiny_config as landmark_config
    from test_torch_port_landmark import _write_landmark_data

    landmarks = _write_landmark_data(tmp_path / "landmark", {"test": [(32, 32), (32, 32)]}, names=("test",))
    cases = []
    for name, split in (("emidec", "test"), ("myops2020", "test"), ("rescan", "train"), ("rescan", "test_retest_100"),
                        ("kaggle", "validate"), ("acdc", "test")):
        cases.append((name, split, _tiny(name, trees / name), get_segmentation_model))
    for task in ("segmentation", "regression"):
        config = landmark_config(task)
        config.data.dir = str(landmarks)
        cases.append(("landmark", "test", config,
                      get_segmentation_model if task == "segmentation" else get_classification_model))
    for task in ("classification", "regression"):
        config = from_dict(PACKAGED[f"{task}/acdc"])
        config.data.dir = str(trees / "acdc")
        config.data.sax.patch_size = [16, 16, 4]
        config.model.convvit.update(size="tiny", enc_conv_chans=[4, 8], enc_conv_n_blocks=1)
        config.train.n_workers = 2
        cases.append(("acdc", "test", config, get_classification_model))
    for i, (name, split, config, build) in enumerate(cases):
        folder = _port_run_folder(tmp_path / "runs" / str(i), config, build=build)
        evaluate.main(["--folder_path", str(folder), "--split", split, "--device", "cpu"])
        out = folder / f"{name}_eval"
        (means,) = _rows_of(out / "mean_metrics.csv")
        key = {"kaggle": "ef_mae", "landmark": "mean_landmark_distance", "classification": "accuracy",
               "regression": "mae", "test_retest_100": "n_pairs"}.get(name if name in ("kaggle", "landmark") else (
                   config.task if config.task != "segmentation" else split), "mean_dice_score")
        assert np.isfinite(means[key]), (name, split, means)
        per_item = config.task == "segmentation" and name not in ("kaggle", "landmark") and split != "test_retest_100"
        assert (out / "metrics.csv").exists() == per_item
        if per_item:
            assert len(_rows_of(out / "metrics.csv")) > 0


# --- the entry points on the CPU ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["emidec", "myops2020", "rescan"])
def test_new_entry_points_rehearse_on_the_cpu(trees, name, tmp_path):
    """``python -m cinema_tpu_torch.tasks.segmentation.<name> --device cpu --config <tiny>``: one epoch with an
    evaluation, finite metrics, a checkpoint, and ``load_run`` on the run folder rebuilds the saved model."""
    import yaml

    config = _tiny(name, trees / name)
    config.logging.dir = str(tmp_path / "runs")
    config_path = tmp_path / "tiny.yaml"
    config_path.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    {"emidec": emidec, "myops2020": myops2020, "rescan": rescan}[name].main(
        ["--device", "cpu", "--config", str(config_path)])
    (out_dir,) = (tmp_path / "runs").iterdir()
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    train, val = [r for r in records if "train_loss" in r], [r for r in records if "val_mean_dice_score" in r]
    assert len(train) == len(val) == 1 and np.isfinite(train[0]["train_loss"])
    assert np.isfinite(val[0]["val_mean_dice_score"]) and train[0]["train_skipped_nan"] == 0.0
    if name == "emidec":
        assert {f"val_class_{c}_pred_volume" for c in range(1, 5)} <= set(val[0])
    assert latest_checkpoint(out_dir) is not None
    loaded_config, model = evaluate.load_run(out_dir, device="cpu")
    assert loaded_config == json.loads(json.dumps(config))
    saved = load_safetensors(out_dir / "model_0.safetensors")
    assert all(torch.equal(v, torch.from_numpy(saved[k])) for k, v in model.state_dict().items())


def test_rescan_ef_eval_main_writes_its_tables(trees, tmp_path):
    folder = _port_run_folder(tmp_path / "run", _tiny("rescan", trees / "rescan"))
    rescan_ef_eval.main(["--folder_path", str(folder), "--device", "cpu"])
    out = folder / "rescan_test_retest_100_ef_eval"
    assert len(_rows_of(out / "ef_metrics.csv")) == 6 and _rows_of(out / "mean_metrics.csv")[0]["n_pairs"] == 3


def test_ef_from_volumes_is_nan_where_no_frame_holds_lv():
    assert rescan.ef_from_volumes(np.array([10.0, 4.0, 6.0])) == 60.0
    assert np.isnan(rescan.ef_from_volumes(np.zeros(3)))
    got = getattr(rescan, "test_retest_reproducibility")(np.array([50.0, 60.0]), np.array([52.0, 57.0]))
    assert got["ef_mae"] == 2.5 and np.isclose(got["ef_rmse"], np.sqrt(6.5))
