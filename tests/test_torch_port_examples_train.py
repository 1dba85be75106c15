"""The port's training tutorials against the JAX package's (``examples/train/*.py``, imported by path), in
float32 on the CPU: each one's split equals the pandas draw of the JAX script, one train step from the same
weights and batch equals the JAX script's ``make_train_step`` (loss to 2e-4 relative, parameters to the port's
step tolerances: 2e-5 for CineMA and ConvViT as tests/test_torch_port_pretrain.py, 2e-4 for ConvUNetR as
tests/test_torch_port_segmentation.py), and each ``main`` trains one epoch on synthetic data and writes a
safetensors file that reloads.

Configs have dropout and drop path 0: the two packages' generators draw other noise. The k half of every
``attn.kv.bias`` is left out of the parameter comparison (its gradient is rounding noise, see
tests/test_torch_port_pretrain.py), and so is ConvUNetR's one-channel LayerNorm weight
(tests/test_torch_port_segmentation.py). The segmentation step runs at ``layer_decay`` 1: the JAX tutorial
builds its optimizer over the ``{"params": ...}`` tree, under which the layer ids read ``params/...`` and
its decay reaches only the patch embeddings (ROADMAP.md, known divergences); the port's tutorial decays by
layer as ``run_train`` does.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cinema_tpu_torch.config import PACKAGED, apply_overrides, from_dict
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
from cinema_tpu_torch.data import save_nifti
from cinema_tpu_torch.examples.train import classification, pretrain, regression, segmentation
from cinema_tpu_torch.train.optim import build_optimizer
from test_torch_port_masking import port_mask

REPO = Path(__file__).resolve().parents[1]
JAX_TRAIN = REPO / "examples" / "train"
MAE = next((REPO / "tests" / "fixtures" / "example_ckpts").glob("mae-*"))
PATHOLOGIES = ["DCM", "HCM", "MINF", "NOR", "RV"]
TINY = ["data.sax.patch_size=[16,16,4]", "transform.sax.translate_range=[2,2,0]", "train.batch_size_per_device=2",
        "train.n_warmup_epochs=0", "train.eval_interval=1", "train.early_stopping.patience=2"]
TINY_MODEL = {
    "classification": ["model.convvit.size=tiny", "model.convvit.enc_conv_chans=[4,8]",
                       "model.convvit.enc_conv_n_blocks=1", "model.convvit.drop_path=0.0"],
    "segmentation": ["model.convunetr.size=tiny", "model.convunetr.enc_conv_chans=[4,8]",
                     "model.convunetr.enc_conv_n_blocks=1", "model.convunetr.dec_chans=[4,8,12,16,24]",
                     "model.convunetr.dropout=0.0", "model.convunetr.drop_path=0.0", "data.sax.patch_size=[32,32,4]",
                     "transform.sax.dropout_size=[4,4,1]", "train.layer_decay=1.0"],
}
TINY_MODEL["regression"] = TINY_MODEL["classification"]
TUTORIALS = {"classification": classification, "regression": regression, "segmentation": segmentation}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tutorial(name):
    spec = importlib.util.spec_from_file_location(f"jax_tutorial_{name}", JAX_TRAIN / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def acdc_dir(tmp_path_factory):
    """A processed ACDC-like folder of 17 studies (20x20xz, z 4-5), one of a class no config lists, with ``ef``."""
    root = tmp_path_factory.mktemp("acdc")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(17):
        pid = f"patient{i:03d}"
        (root / "train" / pid).mkdir(parents=True)
        n_slices = int(rng.integers(4, 6))
        for frame in ("ed", "es"):
            image = rng.uniform(0, 255, size=(20, 20, n_slices)).astype(np.float32)
            label = rng.integers(0, 4, size=(20, 20, n_slices)).astype(np.uint8)
            save_nifti(root / "train" / pid / f"{pid}_sax_{frame}.nii.gz", image, spacing=(1, 1, 10))
            save_nifti(root / "train" / pid / f"{pid}_sax_{frame}_gt.nii.gz", label, spacing=(1, 1, 10))
        rows.append({"pid": pid, "n_slices": n_slices, "pathology": (PATHOLOGIES + ["OTHER"])[i % 6],
                     "ef": float(rng.uniform(20, 70))})
    pd.DataFrame(rows).to_csv(root / "train_metadata.csv", index=False)
    return root


def _configs(task, acdc_dir, tmp_path):
    """The port's and the JAX package's config of the tutorial, with the same overrides."""
    from cinema_tpu.config import apply_overrides as jax_apply_overrides
    from cinema_tpu.config import load_config as jax_load_config

    overrides = [f"data.dir={acdc_dir}", *TINY, *TINY_MODEL[task], f"logging.dir={tmp_path}"]
    port = apply_overrides(from_dict(PACKAGED[f"{task}/acdc"]), overrides)
    return port, jax_apply_overrides(jax_load_config(_jax_tutorial(task).CONFIG), overrides)


@pytest.mark.parametrize("task", ["classification", "regression", "segmentation"])
def test_splits_equal_the_jax_tutorials_pandas_draws(task, acdc_dir, tmp_path):
    port_config, jax_config = _configs(task, acdc_dir, tmp_path)
    jax_train, jax_val = _jax_tutorial(task).get_datasets(jax_config)
    train, val = TUTORIALS[task].get_datasets(port_config)
    assert [r["pid"] for r in train.rows] == jax_train.meta_df["pid"].tolist()
    assert [r["pid"] for r in val.rows] == jax_val.meta_df["pid"].tolist()
    # 5 classes of 2 (the sixth class is no config's); 6 pathologies of 2; min(10, 17 // 3)
    assert len(val.rows) == {"classification": 10, "segmentation": 12, "regression": 5}[task]
    jax_train.set_epoch(0)
    for index in (0, len(train) - 1):  # the same items, augmentation included
        want, got = jax_train[index], train.load(index, 0)
        for key in ("sax_image", "label", "sax_label"):
            if key in want:
                np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def _jax_model_and_params(task, jax_config):
    from cinema_tpu.factory import get_segmentation_model, init_params
    from cinema_tpu.tasks.classification import get_classification_model
    from cinema_tpu.tasks.regression import get_regression_model

    if task == "segmentation":
        model = get_segmentation_model(jax_config, dtype=jnp.float32)
        return model, init_params(model)
    model = (get_classification_model if task == "classification" else get_regression_model)(jax_config,
                                                                                           dtype=jnp.float32)
    example = {v: jnp.zeros((1, *model.image_size_dict[v], model.n_frames * model.in_chans_dict[v]), jnp.float32)
               for v in model.views}
    return model, jax.jit(lambda: model.init(jax.random.PRNGKey(0), example))()


def _batch(task, seed=5):
    rng = np.random.default_rng(seed)
    if task == "segmentation":
        return {"sax_image": rng.random((2, 32, 32, 4, 1), np.float32),
                "sax_label": rng.integers(0, 4, size=(2, 32, 32, 4)).astype(np.int32)}
    label = rng.integers(0, 5, size=2).astype(np.int32) if task == "classification" else rng.normal(size=2)
    return {"sax_image": rng.random((2, 16, 16, 4, 2), np.float32),
            "label": label.astype(np.int32 if task == "classification" else np.float32)}


def _opt_args(config, task, n_blocks):
    args = dict(lr=float(config.train.lr), min_lr=float(config.train.min_lr), warmup_steps=0, max_n_steps=10,
                weight_decay=float(config.train.weight_decay), clip_grad=float(config.train.clip_grad))
    if task == "segmentation":
        args.update(layer_decay=float(config.train.layer_decay), n_blocks=n_blocks)
    return args


def _assert_params_close(model, want, atol, skip=()):
    for key, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[key]
        if key.endswith("attn.kv.bias"):  # the k half: zero gradient
            got, ref = got[got.shape[0] // 2 :], ref[ref.shape[0] // 2 :]
        if key not in skip:
            np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize("task", ["classification", "regression", "segmentation"])
def test_one_train_step_matches_the_jax_tutorials(task, acdc_dir, tmp_path):
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer
    from cinema_tpu_torch.factory import get_segmentation_model
    from cinema_tpu_torch.tasks.classification import get_classification_model

    port_config, jax_config = _configs(task, acdc_dir, tmp_path)
    jax_model, params = _jax_model_and_params(task, jax_config)
    start = state_dict_from_jax(params)
    batch = _batch(task)
    jax_tx = jax_build_optimizer(jax.eval_shape(lambda: params),
                                 **_opt_args(jax_config, task, getattr(jax_model, "enc_depth", 0)))
    step = _jax_tutorial(task).make_train_step(jax_model, jax_tx)
    new_params, _, metrics = step(params, jax_tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(0))
    want = state_dict_from_jax(new_params)

    build = get_segmentation_model if task == "segmentation" else get_classification_model
    model = build(port_config, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()}, strict=True)
    tx = build_optimizer(dict(model.named_parameters()), **_opt_args(port_config, task, getattr(model, "enc_depth", 0)))
    port_step = TUTORIALS[task].make_train_step(model, tx, tx.init())
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if task == "segmentation":
        torch_batch["sax_label"] = torch_batch["sax_label"].long()
    got = port_step(torch_batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=2e-4)
    skip = {"dec_image_conv_block_dict.sax.norm1.weight"}
    _assert_params_close(model, want, atol=2e-4 if task == "segmentation" else 2e-5, skip=skip)
    moved = max(np.abs(p.detach().numpy() - start[k]).max() for k, p in model.named_parameters())
    assert moved > 1e-4  # the step did move the parameters


def test_one_pretrain_step_matches_the_jax_tutorial_on_its_masks():
    from cinema_tpu.bridge.torch_loader import load_torch_state_dict
    from cinema_tpu.config import load_config as jax_load_config
    from cinema_tpu.factory import get_mae_model as jax_get_mae_model
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer
    from cinema_tpu_torch.config import load_config
    from cinema_tpu_torch.factory import get_mae_model

    rng = np.random.default_rng(6)
    batch = {"sax": rng.random((2, 16, 16, 4, 1), np.float32), "lax_2c": rng.random((2, 32, 32, 1), np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_model = jax_get_mae_model(jax_load_config(MAE / "mae.yaml"))
    template = jax_model.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, jbatch, 0.75)
    params, _, _ = load_torch_state_dict(template, load_safetensors(MAE / "mae.safetensors"), strict=True)
    opt = dict(lr=1e-3, min_lr=1e-6, warmup_steps=0, max_n_steps=10, weight_decay=0.05, clip_grad=5.0)
    jax_tx = jax_build_optimizer(jax.eval_shape(lambda: params), **opt)
    rng_key = jax.random.PRNGKey(3)
    # the masks that the JAX step draws inside, from rngs={"mask": rng_key}: drawn under jit, as the step draws
    # them (XLA's draw under jit differs from the eager one for the same key)
    masks = jax.jit(lambda p, b, k: jax_model.apply(p, b, 0.75, rngs={"mask": k}, deterministic=False)[2])(
        params, jbatch, rng_key)
    new_params, _, metrics = _jax_tutorial("pretrain").make_train_step(jax_model, jax_tx, 0.75)(
        params, jax_tx.init(params), jbatch, rng_key)  # donates params

    model = get_mae_model(load_config(MAE / "mae.yaml"), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in load_safetensors(MAE / "mae.safetensors").items()})
    tx = build_optimizer(dict(model.named_parameters()), **opt)
    got = pretrain.make_train_step(model, tx, tx.init(), 0.75)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator(), {v: port_mask(m) for v, m in masks.items()})
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=2e-4)
    _assert_params_close(model, state_dict_from_jax(new_params), atol=2e-5)


@pytest.mark.parametrize("task", ["classification", "regression", "segmentation"])
def test_finetune_tutorials_train_an_epoch_and_save_a_checkpoint_that_reloads(task, acdc_dir, tmp_path, capsys):
    TUTORIALS[task].main(["--data_dir", str(acdc_dir), "--n_epochs", "1", "--device", "cpu", *TINY,
                          *TINY_MODEL[task], f"logging.dir={tmp_path}"])
    printed = capsys.readouterr().out
    assert "epoch 0: train loss" in printed and "saved" in printed
    loss = float(printed.split("train loss ")[1].split()[0])
    assert np.isfinite(loss)
    port_config, _ = _configs(task, acdc_dir, tmp_path)
    from cinema_tpu_torch.factory import get_segmentation_model
    from cinema_tpu_torch.tasks.classification import get_classification_model

    model = (get_segmentation_model if task == "segmentation" else get_classification_model)(port_config, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in load_safetensors(tmp_path / "best.safetensors").items()},
                          strict=True)


def test_pretrain_tutorial_trains_an_epoch_and_saves_last(tmp_path, capsys):
    rng = np.random.default_rng(0)
    for i in range(4):
        pid = f"study{i:03d}"
        (tmp_path / "data" / pid).mkdir(parents=True)
        save_nifti(tmp_path / "data" / pid / f"{pid}_sax_t.nii.gz",
                   rng.uniform(0, 255, size=(16, 16, 4, 3)).astype(np.float32), spacing=(1, 1, 10, 1))
    overrides = ["model.views=[sax]", "model.size=tiny", "model.enc_conv_chans=[4,8]", "model.enc_conv_n_blocks=1",
                 "data.sax.patch_size=[16,16,4]", "transform.sax.translate_range=[2,2,0]",
                 "train.batch_size_per_device=2", "train.n_warmup_epochs=0", f"logging.dir={tmp_path / 'runs'}"]
    pretrain.main(["--data_dir", str(tmp_path / "data"), "--n_epochs", "2", "--device", "cpu", *overrides])
    printed = capsys.readouterr().out
    assert "found 4 studies" in printed and printed.count("train loss") == 2
    from cinema_tpu_torch.factory import get_mae_model

    config = apply_overrides(from_dict(PACKAGED["mae"]), overrides)
    model = get_mae_model(config, device="cpu")
    state = load_safetensors(tmp_path / "runs" / "last.safetensors")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    with pytest.raises(ValueError, match="No studies"):
        pretrain.main(["--data_dir", str(tmp_path / "runs"), "--device", "cpu", *overrides])


def test_convunetr_keeps_its_depth_for_the_layer_decay(acdc_dir, tmp_path):
    """``run_train`` and the segmentation tutorial take the layer decay's block count from ``model.enc_depth``,
    as the JAX package does (cinema_tpu/train/loop.py:212); ConvUNetR has it, so its blocks get their own
    scales."""
    from cinema_tpu_torch.factory import get_segmentation_model
    from cinema_tpu_torch.train.optim import layer_decay_scales

    from cinema_tpu.factory import get_segmentation_model as jax_get_segmentation_model

    port_config, jax_config = _configs("segmentation", acdc_dir, tmp_path)
    jax_model = jax_get_segmentation_model(jax_config)
    model = get_segmentation_model(port_config, device="cpu")
    assert model.enc_depth == jax_model.enc_depth == len(model.encoder.blocks)
    scales = layer_decay_scales(dict(model.named_parameters()), 0.75, model.enc_depth)
    first = next(k for k in scales if k.startswith("encoder.blocks.0."))
    assert scales[first] == pytest.approx(0.75 ** model.enc_depth)
