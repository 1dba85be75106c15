"""The nine ED/ES fine-tuning tasks on processed NIfTI (ACDC, M&Ms and M&Ms2; classification,
regression and segmentation) against the JAX package's: the seeded splits and subsets choose
exactly the rows pandas chooses, in pandas' order; every task's ``load_dataset`` gives the JAX
task's pid lists; the first training batch equals the JAX ``BatchLoader``'s bit for bit, and f32
train steps from it agree with the JAX steps; and each new entry point runs on the CPU.

f32 on both sides, the JAX side's Pallas kernels in interpret mode; steps as in
tests/test_torch_port_{finetune,segmentation}.py (losses to 2e-4 relative, parameters to 2e-4).
"""

import importlib
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cinema_tpu_torch.config import PACKAGED, from_dict
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
from cinema_tpu_torch.data import BatchLoader
from cinema_tpu_torch.factory import get_segmentation_model
from cinema_tpu_torch.tasks import segmentation
from cinema_tpu_torch.tasks.classification import get_classification_model
from cinema_tpu_torch.train import loop
from cinema_tpu_torch.train.checkpoint import latest_checkpoint
from cinema_tpu_torch.train.optim import build_optimizer
from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step
from test_torch_port_nifti_data import assert_items_equal, write_edes_tree

TASKS = [f"{family}/{name}" for family in ("classification", "regression", "segmentation")
         for name in ("acdc", "mnms", "mnms2")]
NEW_TASKS = [t for t in TASKS if not t.endswith("acdc")]


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One seeded tree per dataset: ACDC one table of 21 studies (three of every class, six of a class
    the config does not list), M&Ms and M&Ms2 split 16 / 5."""
    root = tmp_path_factory.mktemp("trees")
    write_edes_tree(root / "acdc", "acdc", 21, seed=1)
    write_edes_tree(root / "mnms", "mnms", 16, 5, seed=2)
    write_edes_tree(root / "mnms2", "mnms2", 16, 5, seed=3)
    return root


def _config(task, data_dir, patch=(16, 16, 4), **data):
    config = from_dict(PACKAGED[task])
    config.data.dir = str(data_dir)
    config.data.sax.patch_size = list(patch)
    config.data.update(data)
    return config


# --- the seeded split and subsets, against pandas ---------------------------------------------------

def _cap(cap, proportion=1.0, seed=0):
    return from_dict({"seed": seed, "data": {"max_n_samples": cap, "proportion": proportion}})


@pytest.mark.parametrize("labels", [
    ["b", "a", "c", "a", "b", "c", "c", "a", "b", "c"],
    [3, 1, 1, 2, 3, 2, 0, 0, 3, 1, 2, 2, 3, 0],
    list("DHNMRDHNMRDHNMRDHNMR"),
], ids=["ragged-strings", "ragged-ints", "acdc-like"])
@pytest.mark.parametrize("seed", [0, 5])
def test_split_by_class_holds_out_the_rows_pandas_draws(labels, seed):
    frame = pd.DataFrame({"c": labels})
    want = sorted(frame.groupby("c").sample(n=2, random_state=seed).index.tolist())
    train, val = loop.split_by_class(labels, seed=seed)
    assert val == want and train == [i for i in range(len(labels)) if i not in want]


@pytest.mark.parametrize("cap", [1, 4, 5, 6, 9, 12, 40])
@pytest.mark.parametrize("grouped", [False, True])
def test_the_cap_keeps_pandas_rows_in_pandas_order(cap, grouped):
    """Ragged groups; caps that round a .5 (to even, as Python and pandas do) and caps above the length."""
    train_groups = ["x", "y", "x", "z", "y", "x", "x", "z", "y", "x", "w", "x"]
    val_groups = ["a", "b", "a", "b", "b", "a", "b"]
    config = _cap(cap)
    got = loop.maybe_subset_dataset(config, list(range(12)), list(range(7)),
                                    train_groups if grouped else None, val_groups if grouped else None)
    for items, groups in zip(got, (train_groups, val_groups)):
        frame = pd.DataFrame({"g": groups})
        frac = min(cap / len(groups), 1.0)
        sample = frame.groupby("g").sample(frac=frac, random_state=0) if grouped else frame.sample(
            frac=frac, random_state=0, ignore_index=False)
        assert items == sample.index.tolist()


@pytest.mark.parametrize("seed,proportion", [(0, 0.5), (3, 0.5), (7, 0.25)])
def test_the_proportion_keeps_pandas_rows_in_pandas_order(seed, proportion):
    frame = pd.DataFrame({"x": range(13)})
    capped = frame.sample(frac=min(9 / 13, 1.0), random_state=0, ignore_index=True)
    want = capped.sample(n=int(proportion * len(capped)), random_state=seed).index
    items = list(range(13))
    train, val = loop.maybe_subset_dataset(_cap(9, proportion, seed), items, items[:4])
    assert train == [loop._sample_fraction(items, 9 / 13, None)[i] for i in want]
    assert val == pd.DataFrame({"x": range(4)}).sample(frac=1.0, random_state=0).index.tolist()  # shuffled whole
    assert loop.maybe_subset_dataset(_cap(-1, proportion, seed), items, [])[0] == [
        items[i] for i in frame.sample(n=int(proportion * 13), random_state=seed).index]


# --- (d) load_dataset of the nine tasks ---------------------------------------------------------

def _pids(dataset):
    return [str(r["pid"]) for r in dataset.rows] if hasattr(dataset, "rows") else dataset.meta_df["pid"].astype(
        str).tolist()


@pytest.mark.parametrize("subset", [{}, {"max_n_samples": 5}, {"proportion": 0.5}], ids=["plain", "cap", "proportion"])
@pytest.mark.parametrize("task", TASKS)
def test_load_dataset_gives_the_jax_tasks_pid_lists(trees, task, subset):
    family, name = task.split("/")
    config = _config(task, trees / name, **subset)
    config.seed = 3
    port = importlib.import_module(f"cinema_tpu_torch.tasks.{family}.{name}").load_dataset(config)
    want = importlib.import_module(f"cinema_tpu.tasks.{family}.{name}").load_dataset(config)
    for got, ref in zip(port, want):
        assert _pids(got) == _pids(ref) and len(got) == len(ref)
        assert got.data_dir == ref.data_dir and got.views == ref.views
    assert len(port[0]) > 0 and len(port[1]) > 0
    if name == "acdc" and not subset and family != "regression":  # two of each of the six classes held out
        assert len(port[1].rows) == (10 if family == "classification" else 12)  # the unlisted class left out


# --- (e) the first batch and train steps from it ------------------------------------------------

def _first_batches(task, data_dir, patch, n):
    """The first ``n`` batches of 2 of the port's training loader and of the JAX package's, seed 5."""
    from cinema_tpu.data.datasets import BatchLoader as JaxBatchLoader

    family, name = task.split("/")
    config = _config(task, data_dir, patch)
    config.seed = 5
    port_ds = importlib.import_module(f"cinema_tpu_torch.tasks.{family}.{name}").load_dataset(config)[0]
    jax_ds = importlib.import_module(f"cinema_tpu.tasks.{family}.{name}").load_dataset(config)[0]
    port_ds.seed = jax_ds.seed = 5  # as both packages' run_train sets them
    with BatchLoader(port_ds, 2, seed=5) as loader:
        got = list(loader.epoch(0))[:n]
    want = list(JaxBatchLoader(jax_ds, batch_size=2, shuffle=True, drop_last=True, n_workers=1, seed=5))[:n]
    for g, w in zip(got, want):
        assert_items_equal(g, w)
    return got


def test_first_segmentation_batches_and_steps_match_jax(trees):
    from cinema_tpu.tasks.segmentation import segmentation_loss_fn as jax_loss_fn
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer
    from cinema_tpu.train.state import TrainState as JaxTrainState
    from cinema_tpu.train.state import make_supervised_train_step as jax_make_step
    from test_torch_port_segmentation import ONE_CHANNEL_NORM_WEIGHTS, OPT, PARAM_ATOL, PATCH, _jax_model, _port_model

    batches = [{k: v for k, v in b.items() if k in ("sax_image", "sax_label")}
               for b in _first_batches("segmentation/mnms", trees / "mnms", PATCH, 2)]
    assert batches[0]["sax_image"].shape == (2, *PATCH, 1) and batches[0]["sax_label"].dtype == np.int8
    model, params, _ = _jax_model()
    tx = jax_build_optimizer(params["params"], accum_steps=1, fused=True, **OPT)
    state = JaxTrainState.create(params["params"], tx)
    step = jax_make_step(model, tx, lambda m, p, batch, rng: jax_loss_fn(m, {"params": p}, batch, rng), donate=False)
    port = _port_model(params)
    ptx = build_optimizer(dict(port.named_parameters()), **OPT)
    pstate, step_fn = TrainState.create(port, ptx), make_supervised_train_step(port, ptx,
                                                                               segmentation.segmentation_loss_fn)
    for batch in batches:
        state, want = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        pstate, got = step_fn(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-3)
    ref = state_dict_from_jax(state.params)
    for key, p in port.named_parameters():
        got, want = p.detach().numpy(), ref[key]
        if key.endswith("attn.kv.bias"):  # the k half: zero gradient (tests/test_torch_port_finetune.py)
            got, want = got[got.shape[0] // 2 :], want[want.shape[0] // 2 :]
        if key not in ONE_CHANNEL_NORM_WEIGHTS:
            np.testing.assert_allclose(got, want, atol=PARAM_ATOL, rtol=0, err_msg=key)


def test_first_classification_batches_and_steps_match_jax(trees):
    from test_torch_port_finetune import _assert_params_close, _jax_run, _port_setup

    batches = [{"sax_image": b["sax_image"], "label": b["label"]}
               for b in _first_batches("classification/mnms", trees / "mnms", (16, 16, 4), 3)]
    assert batches[0]["sax_image"].shape == (2, 16, 16, 4, 2)
    records, want = _jax_run("clf", batches, 1)
    model, state, step_fn = _port_setup("clf", 1)
    for batch, (loss, grad_norm) in zip(batches, records):
        state, m = step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=2e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), grad_norm, rtol=1e-3)
    _assert_params_close(model, want)


# --- (g) the new entry points on the CPU ---------------------------------------------------------

def _tiny(task, data_dir):
    family = task.split("/")[0]
    config = _config(task, data_dir, (32, 32, 4) if family == "segmentation" else (16, 16, 4))
    if family == "segmentation":
        config.model.convunetr.update(size="tiny", enc_conv_chans=[8, 16], enc_conv_n_blocks=1,
                                      dec_chans=[4, 8, 16, 24, 32])
    else:
        config.model.convvit.update(size="tiny", enc_conv_chans=[4, 8], enc_conv_n_blocks=1)
    config.train.update(n_epochs=1, n_warmup_epochs=1, eval_interval=1, batch_size=4, n_workers=2)
    return config


@pytest.mark.parametrize("task", NEW_TASKS)
def test_new_entry_points_rehearse_on_the_cpu(trees, task, tmp_path):
    """``python -m cinema_tpu_torch.tasks.<family>.<mnms|mnms2> --device cpu --config <tiny>``: one epoch with
    an evaluation, finite metrics and a checkpoint whose saved weights load into the model."""
    import yaml

    family, name = task.split("/")
    config = _tiny(task, trees / name)
    config_path = tmp_path / "tiny.yaml"
    config_path.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    importlib.import_module(f"cinema_tpu_torch.tasks.{family}.{name}").main(
        ["--device", "cpu", "--config", str(config_path), f"logging.dir={tmp_path / 'runs'}"])
    (out_dir,) = (tmp_path / "runs").iterdir()
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    metric = config.train.early_stopping.metric
    train, val = [r for r in records if "train_loss" in r], [r for r in records if metric in r]
    assert len(train) == len(val) == 1 and np.isfinite(train[0]["train_loss"]) and np.isfinite(val[0][metric])
    assert train[0]["train_skipped_nan"] == 0.0
    ckpt = latest_checkpoint(out_dir)
    assert ckpt is not None and Path(f"{ckpt}.meta.json").exists()
    build = get_segmentation_model if family == "segmentation" else get_classification_model
    model = build(config, device="cpu")
    exported = load_safetensors(out_dir / "model_0.safetensors")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()}, strict=True)


@pytest.mark.parametrize("task", NEW_TASKS)
def test_packaged_configs_name_their_dataset_and_run_on_the_card_by_default(task, tmp_path):
    family, name = task.split("/")
    config = from_dict(PACKAGED[task])
    assert config.data.name == name and config.data.dir.endswith(f"/{name}/processed")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    entry = importlib.import_module(f"cinema_tpu_torch.tasks.{family}.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main([f"data.dir={tmp_path}"])
