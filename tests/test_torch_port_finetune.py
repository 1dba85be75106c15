"""The fine-tuning slice as a whole: losses and metrics against the JAX package's;
supervised train steps of the port against ``cinema_tpu.train.state.make_supervised_train_step``
from identical parameters and batches (classification and regression, with layer
decay, with and without accumulation); and a rehearsal of the task entry points on
the CPU with synthetic processed NIfTI studies: train, evaluate, early-stop, save, resume.

f32 on both sides, drop-path off (the two packages draw different noise). The JAX
side runs its packed Pallas kernels in interpret mode. Losses agree to 2e-4
relative; parameters to 2e-4 absolute after the steps (Adam turns a relative
gradient difference d into a step of about lr * d). The k half of every
``attn.kv.bias`` is left out, as in the pretraining test: softmax does not depend
on a bias of k, its gradient is rounding noise on both sides, and Adam turns noise
of either sign into a full step.
"""

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cinema_tpu_torch import losses, metrics
from cinema_tpu_torch.config import PACKAGED, from_dict, load_config
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
from cinema_tpu_torch.data import save_nifti
from cinema_tpu_torch.factory import from_finetuned, get_convvit_model
from cinema_tpu_torch.models.resnet import ResNet
from cinema_tpu_torch.tasks import classification, regression
from cinema_tpu_torch.tasks.classification import acdc as clf_acdc
from cinema_tpu_torch.tasks.regression import acdc as reg_acdc
from cinema_tpu_torch.train import checkpoint, loop
from cinema_tpu_torch.train.optim import EarlyStopping, build_optimizer
from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step

CKPTS = Path(__file__).parent / "fixtures" / "example_ckpts"
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_steps=1, max_n_steps=10, weight_decay=0.05, clip_grad=5.0, layer_decay=0.75,
           n_blocks=1)
PARAM_ATOL = 2e-4


def _fixture(kind):
    folder = next(CKPTS.glob(f"{kind}-*"))
    return folder / f"{kind}.safetensors", folder / f"{kind}.yaml"


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


# --- losses and metrics --------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_and_classification_loss_match_jax(smoothing):
    from cinema_tpu import losses as jlosses

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 3, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, size=(6, 3))
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), -1, smoothing)
    got = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), -1, smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    all_ignored = losses.cross_entropy(torch.from_numpy(logits), torch.full((6, 3), -1), -1, smoothing)
    assert float(all_ignored) == float(jlosses.cross_entropy(jnp.asarray(logits), jnp.full((6, 3), -1), -1, smoothing)) == 0.0
    want, wmetrics = jlosses.classification_loss(jnp.asarray(logits[:, 0]), jnp.asarray(np.abs(labels[:, 0])), smoothing)
    got, gmetrics = losses.classification_loss(torch.from_numpy(logits[:, 0]), torch.from_numpy(np.abs(labels[:, 0])), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(gmetrics) == set(wmetrics) == {"cross_entropy", "loss"}


def test_regression_loss_matches_jax():
    from cinema_tpu import losses as jlosses

    rng = np.random.default_rng(1)
    preds, targets = rng.normal(size=7).astype(np.float32), rng.normal(size=7).astype(np.float32)
    want, wmetrics = jlosses.regression_loss(jnp.asarray(preds), jnp.asarray(targets))
    got, gmetrics = losses.regression_loss(torch.from_numpy(preds), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(gmetrics) == set(wmetrics)


@pytest.mark.parametrize("n_classes,n,seed", [(2, 40, 0), (2, 7, 1), (5, 60, 2), (5, 12, 3), (3, 30, 4)])
def test_classification_metrics_match_jax(n_classes, n, seed):
    from cinema_tpu.metrics import classification_metrics

    rng = np.random.default_rng(seed)
    true = rng.integers(0, n_classes, size=n)
    probs = rng.random((n, n_classes)).astype(np.float32)
    probs[rng.random(n) < 0.5, :] = np.round(probs[rng.random(n) < 0.5, :][:1], 1)  # tied scores
    probs /= probs.sum(axis=1, keepdims=True)
    pred = probs.argmax(axis=1)
    want = classification_metrics(true, pred, probs)
    got = metrics.classification_metrics(true, pred, probs)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("n_classes", [2, 5])
def test_classification_metrics_with_one_class_present(n_classes):
    from cinema_tpu.metrics import classification_metrics

    true = np.zeros(6, dtype=np.int64)
    probs = np.random.default_rng(5).dirichlet(np.ones(n_classes), size=6)
    want = classification_metrics(true, probs.argmax(1), probs)
    got = metrics.classification_metrics(true, probs.argmax(1), probs)
    assert got["mcc"] == want["mcc"] == 0.0 and got["roc_auc"] == want["roc_auc"] == 0.0
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-9, err_msg=key)


def test_regression_metrics_match_jax():
    from cinema_tpu.metrics import regression_metrics

    rng = np.random.default_rng(6)
    true, pred = rng.normal(size=20), rng.normal(size=20)
    assert metrics.regression_metrics(true, pred, std=10.8, prefix="val_") == regression_metrics(true, pred, std=10.8, prefix="val_")


def test_early_stopping_matches_jax_and_round_trips():
    from cinema_tpu.train.optim import EarlyStopping as JaxEarlyStopping

    a, b = EarlyStopping(0.01, 2), JaxEarlyStopping(0.01, 2)
    for value in (1.0, 0.995, 0.9, 0.95, 0.91):
        a.update(value)
        b.update(value)
        assert (a.has_improved, a.should_stop, a.best_metric, a.patience_count) == (
            b.has_improved, b.should_stop, b.best_metric, b.patience_count)
    assert a.should_stop and a.state_dict() == b.state_dict()
    c = EarlyStopping(0.01, 2)
    c.load_state_dict(json.loads(json.dumps(a.state_dict())))
    assert c.best_metric == a.best_metric and c.should_stop


# --- supervised train steps ------------------------------------------------------

def _batches(kind, n, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = rng.integers(0, 5, size=batch) if kind == "clf" else rng.normal(size=batch).astype(np.float32)
        out.append({"sax_image": rng.random((batch, 16, 16, 4, 2)).astype(np.float32), "label": label})
    return out


def _jax_run(kind, batches, accum_steps):
    """The JAX package's own supervised step from the fixture checkpoint, drop-path off."""
    from cinema_tpu.factory import from_finetuned as jax_from_finetuned
    from cinema_tpu.tasks.classification import classification_loss_fn
    from cinema_tpu.tasks.regression import regression_loss_fn
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer
    from cinema_tpu.train.state import TrainState as JaxTrainState
    from cinema_tpu.train.state import make_supervised_train_step as jax_make_step

    model, params = jax_from_finetuned("convvit", *_fixture(kind))
    model = model.clone(drop_path=0.0, attn_impl="pallas")
    # the state holds the inner tree, so that the layer ids see 'encoder/blocks_0/...' and not
    # 'params/encoder/...': under the 'params' wrapper every parameter but the embeddings
    # falls to the last layer id and the decay does nothing
    params = params["params"]
    task_loss_fn = classification_loss_fn if kind == "clf" else regression_loss_fn
    tx = jax_build_optimizer(params, accum_steps=accum_steps, fused=True, **OPT)
    state = JaxTrainState.create(params, tx)
    step = jax_make_step(model, tx, lambda m, p, batch, rng: task_loss_fn(m, {"params": p}, batch, rng), donate=False)
    records = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        records.append((float(m["loss"]), float(m["grad_norm"])))
    return records, state_dict_from_jax(state.params)


def _port_setup(kind, accum_steps, remat=False):
    config = load_config(_fixture(kind)[1])
    config.model.convvit.drop_path = 0.0
    model = get_convvit_model(config, device="cpu", remat=remat)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in load_safetensors(_fixture(kind)[0]).items()})
    tx = build_optimizer(dict(model.named_parameters()), accum_steps=accum_steps, **OPT)
    loss_fn = classification.classification_loss_fn if kind == "clf" else regression.regression_loss_fn
    return model, TrainState.create(model, tx), make_supervised_train_step(model, tx, loss_fn, seed=0)


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_params_close(model, want):
    for key, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[key]
        if key.endswith("attn.kv.bias"):  # the k half: zero gradient, see the module docstring
            got, ref = got[got.shape[0] // 2 :], ref[ref.shape[0] // 2 :]
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("accum_steps,n_micro", [(1, 3), (2, 4)], ids=["three-steps", "accumulate-2x2"])
@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_supervised_train_steps_match_jax(kind, accum_steps, n_micro):
    batches = _batches(kind, n_micro)
    records, want = _jax_run(kind, batches, accum_steps)
    model, state, step_fn = _port_setup(kind, accum_steps)
    for batch, (loss, gnorm) in zip(batches, records):
        state, m = step_fn(state, _to_torch(batch))
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=2e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), gnorm, rtol=1e-3)
        assert float(m["skipped_nan"]) == 0.0 and model.training
    assert state.step == n_micro and state.n_samples == 2 * n_micro
    assert int(state.opt_state.count) == n_micro // accum_steps
    _assert_params_close(model, want)
    start = load_safetensors(_fixture(kind)[0])
    moved = max(np.abs(p.detach().numpy() - start[k]).max() for k, p in model.named_parameters())
    assert moved > 5 * PARAM_ATOL  # the steps moved the parameters by far more than the tolerance


def test_layer_decay_scales_follow_the_jax_package():
    from cinema_tpu.factory import from_finetuned as jax_from_finetuned
    from cinema_tpu.train.optim import layer_decay_scales as jax_scales
    from cinema_tpu_torch.convert import _flatten, torch_key
    from cinema_tpu_torch.train.optim import layer_decay_scales

    _, params = jax_from_finetuned("convvit", *_fixture("clf"))
    want = {torch_key(path): float(v) for path, v in _flatten(jax_scales(params["params"], 0.75, 1)).items()}
    model = get_convvit_model(load_config(_fixture("clf")[1]), device="cpu")
    got = layer_decay_scales(dict(model.named_parameters()), 0.75, 1)
    assert got == pytest.approx(want) and len(set(got.values())) == 3


def test_supervised_step_skips_a_nan_batch_and_is_seeded():
    model, state, step_fn = _port_setup("clf", 1)
    batches = _batches("clf", 2, seed=1)
    state, _ = step_fn(state, _to_torch(batches[0]))
    before = [t.clone() for t in (*model.parameters(), *state.opt_state.mu, *state.opt_state.nu, state.opt_state.count)]
    bad = _to_torch(batches[1])
    bad["sax_image"] = torch.full_like(bad["sax_image"], float("nan"))
    state, m = step_fn(state, bad)
    assert float(m["skipped_nan"]) == 1.0 and state.step == 2
    now = (*model.parameters(), *state.opt_state.mu, *state.opt_state.nu, state.opt_state.count)
    assert all(torch.equal(a, b) for a, b in zip(before, now))
    other = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="not built over this model"):
        make_supervised_train_step(other, build_optimizer(dict(model.named_parameters()), lr=1e-3), lambda m, b: None)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_drop_path_noise_depends_on_seed_and_step_only(remat):
    """Two runs draw the same drop-path noise, with and without recomputation of the blocks."""
    finals = []
    for _ in range(2):
        config = load_config(_fixture("clf")[1])
        config.model.convvit.drop_path = 0.5
        model = get_convvit_model(config, device="cpu", remat=remat)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in load_safetensors(_fixture("clf")[0]).items()})
        tx = build_optimizer(dict(model.named_parameters()), lr=1e-3)
        state, step_fn = TrainState.create(model, tx), make_supervised_train_step(model, tx, classification.classification_loss_fn, 3)
        for batch in _batches("clf", 2, batch=4, seed=2):
            state, _ = step_fn(state, _to_torch(batch))
        finals.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*finals))


# --- evaluation and the task entry points ------------------------------------------

def test_patched_evaluation_matches_jax():
    """A study deeper than the patch size is evaluated over half-overlapping patches, as the JAX package does."""
    from cinema_tpu.factory import from_finetuned as jax_from_finetuned
    from cinema_tpu.tasks.classification import classification_forward as jax_clf_forward
    from cinema_tpu.tasks.regression import regression_forward as jax_reg_forward

    image = np.random.default_rng(3).random((1, 16, 16, 7, 2)).astype(np.float32)
    for kind, jax_forward, port_forward in (("clf", jax_clf_forward, classification.classification_forward),
                                            ("reg", jax_reg_forward, regression.regression_forward)):
        jmodel, jparams = jax_from_finetuned("convvit", *_fixture(kind))
        want = jax_forward(lambda p, imgs: jmodel.apply(p, imgs), jparams, {"sax": jnp.asarray(image)}, {"sax": (16, 16, 4)})
        model = from_finetuned("convvit", *_fixture(kind), device="cpu")
        with torch.no_grad():
            got = port_forward(model, {"sax": torch.from_numpy(image)}, {"sax": (16, 16, 4)})
            whole = port_forward(model, {"sax": torch.from_numpy(image[:, :, :, :4])}, {"sax": (16, 16, 4)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
        assert got.shape == whole.shape == (1, 5 if kind == "clf" else 1)
    with pytest.raises(ValueError, match="batch size 1"):
        classification.classification_forward(model, {"sax": torch.zeros(2, 16, 16, 7, 2)}, {"sax": (16, 16, 4)})


def _write_studies(data_dir, n=19, seed=0):
    """Synthetic studies in the processed ACDC layout (``train/<pid>/<pid>_sax_{ed,es}.nii.gz``, uint8, and
    ``train_metadata.csv``) whose class shows in the image: class c brightens one z-slab."""
    rng = np.random.default_rng(seed)
    classes = PACKAGED["classification/acdc"]["data"]["pathology"]
    lines = ["pid,n_slices,pathology,ef"]
    for i in range(n):
        label = i % 5
        image = rng.random((18, 16, 5, 2)) * 50
        image[:, :, label % 4] += 60 + 35 * label
        pid = f"patient{i:03d}"
        (data_dir / "train" / pid).mkdir(parents=True)
        for f, frame in enumerate(("ed", "es")):
            save_nifti(data_dir / "train" / pid / f"{pid}_sax_{frame}.nii.gz", image[..., f].astype(np.uint8))
        ef = "" if i == 18 else f"{20.0 + 5.0 * label + rng.normal():.4f}"
        lines.append(f"{pid},5,{classes[label]},{ef}")
    (data_dir / "train_metadata.csv").write_text("\n".join(lines) + "\n")


def _task_config(kind, data_dir, n_epochs=3):
    config = load_config(_fixture(kind)[1])
    config.data.dir = str(data_dir)
    config.grad_ckpt = kind == "reg"
    config.train.update(n_epochs=n_epochs, n_warmup_epochs=1, eval_interval=1, batch_size=4, batch_size_per_device=2,
                        lr=3e-3)
    return config


@pytest.mark.parametrize("kind", ["clf", "reg"])
def test_run_train_rehearsal_trains_evaluates_saves_and_resumes(kind, tmp_path):
    task = clf_acdc if kind == "clf" else reg_acdc
    _write_studies(tmp_path / "studies")
    config = _task_config(kind, tmp_path / "studies")
    train_ds, val_ds = task.load_dataset(config)
    # two studies of each of the 5 classes held out of 19; reg: the study with no target left out as well
    assert len(val_ds) + len(train_ds) == (19 if kind == "clf" else 18) and len(val_ds) >= 9
    item = train_ds.load(0, 0)
    assert item["sax_image"].shape == (16, 16, 4, 2) and 0.0 <= item["sax_image"].min() and item["sax_image"].max() <= 1.0
    assert val_ds.load(0, 0)["sax_image"].shape == (18, 16, 5, 2)  # evaluation pads only: patched forward

    out_dir = task.run(config, device="cpu", out_dir=tmp_path / "run")
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "train_loss" in r]
    val = [r for r in records if "epoch" in r and "train_loss" not in r]
    assert [r["epoch"] for r in train] == [0, 1, 2] and len(val) == 3
    assert all(np.isfinite(r["train_loss"]) and r["train_skipped_nan"] == 0.0 for r in train)
    assert train[-1]["n_samples"] == 3 * 2 * (len(train_ds) // 2)
    metric = "val_accuracy" if kind == "clf" else "val_mae"
    assert all(np.isfinite(r[metric]) for r in val) and (kind == "reg" or "val_roc_auc" in val[0])
    if kind == "reg":
        assert val[0]["val_denormalised_mae"] == pytest.approx(val[0]["val_mae"] * config.data.ef.std)
    # retention keeps one checkpoint; each saved epoch has its sidecar and its export
    ckpts = sorted(out_dir.glob("ckpt_*.pt"))
    assert len(ckpts) == 1 and (out_dir / "ckpt_0.pt.meta.json").exists() and (out_dir / "model_0.safetensors").exists()
    meta = json.loads(Path(f"{ckpts[0]}.meta.json").read_text())
    best = -max(r[metric] for r in val) if kind == "clf" else min(r[metric] for r in val)
    assert meta["best_metric"] == pytest.approx(best)
    exported = load_safetensors(out_dir / f"model_{meta['epoch']}.safetensors")
    model = get_convvit_model(config, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()}, strict=True)
    assert (out_dir / "run.json").exists()

    # resume from the saved checkpoint: starts after its epoch and keeps the best metric
    config.train.resume_path = str(ckpts[0])
    config.train.n_epochs = meta["epoch"] + 2
    resumed = task.run(config, device="cpu", out_dir=tmp_path / "resumed")
    again = [json.loads(line) for line in (resumed / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in again if "train_loss" in r] == [meta["epoch"] + 1]
    for path in resumed.glob("ckpt_*.pt.meta.json"):
        assert json.loads(path.read_text())["best_metric"] <= meta["best_metric"]
    config.train.resume_path = str(tmp_path / "missing.pt")
    with pytest.raises(FileNotFoundError):
        task.run(config, device="cpu", out_dir=tmp_path / "never")


def test_run_train_stops_early_and_loads_pretrained_weights(tmp_path):
    _write_studies(tmp_path / "studies")
    config = _task_config("clf", tmp_path / "studies", n_epochs=6)
    config.train.early_stopping.update(patience=2, min_delta=10.0)  # nothing improves by 10
    config.model.ckpt_path = str(_fixture("mae")[0])
    config.model.freeze_pretrained = True
    out_dir = clf_acdc.run(config, device="cpu", out_dir=tmp_path / "run")
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    # the first evaluation improves on +inf and resets the patience; the next two do not
    assert [r["epoch"] for r in records if "train_loss" in r] == [0, 1, 2]
    exported = load_safetensors(next(out_dir.glob("model_*.safetensors")))
    mae = load_safetensors(_fixture("mae")[0])
    frozen = "encoder.blocks.0.attn.q.weight"
    np.testing.assert_array_equal(exported[frozen], mae[frozen])  # loaded and frozen: never moved
    head = "pred_head_dict.cls.weight"
    assert head not in mae and np.abs(exported[head]).max() > 0


def test_maybe_reduce_batch_size_and_task_model_dispatch():
    config = from_dict(PACKAGED["classification/acdc"])
    assert loop.maybe_reduce_batch_size(config, 100) is config
    small = loop.maybe_reduce_batch_size(config, 3)
    assert (small.train.batch_size, small.train.batch_size_per_device) == (2, 2) and config.train.batch_size == 64
    with pytest.raises(ValueError, match="too small"):
        loop.maybe_reduce_batch_size(config, 0)
    config.model.name = "resnet"
    with torch.device("meta"):  # the full-width baseline, built without memory
        resnet = classification.get_classification_model(config, device="meta")
    assert isinstance(resnet, ResNet) and resnet.fc.out_features == 5 and resnet.conv1.in_channels == 2
    config.model.name = "vgg"
    with pytest.raises(ValueError, match="Invalid model name"):
        regression.get_regression_model(config, device="cpu")


def test_split_by_class_holds_out_two_of_every_class():
    labels = np.array([0, 1, 2] * 5 + [3])
    train, val = loop.split_by_class(labels.tolist())
    assert sorted(train + val) == list(range(16)) and [int((labels[val] == c).sum()) for c in range(4)] == [2, 2, 2, 1]
    assert loop.split_by_class(labels.tolist()) == (train, val)
    # where every class has two studies, the studies pandas draws (the one-study class aside, where it raises)
    want = pd.DataFrame({"c": labels[:15]}).groupby("c").sample(n=2, random_state=0).index
    assert loop.split_by_class(labels[:15].tolist())[1] == sorted(want)
