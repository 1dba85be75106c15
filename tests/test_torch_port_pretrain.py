"""The pretraining slice as a whole: MAE train steps of the port against the
JAX package from identical parameters, batches and masks; checkpoint resume;
the safetensors export read back by the JAX bridge; the task entry point on
synthetic studies.

The JAX side of a step is the body of ``cinema_tpu.train.state.make_mae_train_step``
(loss and gradients of ``CineMA.apply``, then ``update_with_guard`` of the fused
AdamW from ``build_optimizer``) with the masks passed in instead of drawn
from its RNG, so that both packages see the same masks.

f32 on both sides. Losses agree to 2e-4 relative (the JAX package's GELU
approximation). Adam divides each gradient by its own magnitude, so a
relative gradient difference d moves a parameter by about lr * d per step:
parameters agree to atol 2e-5 after three steps at lr <= 1e-3. The k half
of every ``attn.kv.bias`` is left out of that comparison: softmax does not
depend on a bias of k, its gradient is rounding noise in both packages, and
Adam turns noise of either sign into a full step.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu.ops.masking import random_patch_mask
from cinema_tpu_torch.config import load_config
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
from cinema_tpu_torch.factory import get_mae_model
from cinema_tpu_torch.tasks import pretrain
from cinema_tpu_torch.train import checkpoint
from cinema_tpu_torch.train.loop import MetricsLogger
from cinema_tpu_torch.train.optim import build_optimizer
from cinema_tpu_torch.train.state import TrainState, make_mae_train_step, mask_generator
from test_torch_port_masking import port_mask

FIXTURE = next((Path(__file__).parent / "fixtures" / "example_ckpts").glob("mae-*"))
OPT = dict(lr=1e-3, min_lr=1e-6, warmup_steps=2, max_n_steps=10, weight_decay=0.05, clip_grad=5.0)
PARAM_ATOL = 2e-5


def _batches(n, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"sax": rng.random((batch, 16, 16, 4, 1)).astype(np.float32), "lax_2c": rng.random((batch, 32, 32, 1)).astype(np.float32)}
        for _ in range(n)
    ]


def _jax_masks(n, batch=2):
    return [{v: random_patch_mask(jax.random.PRNGKey(100 + 10 * i + j), batch, 4, 0.75) for j, v in enumerate(("sax", "lax_2c"))}
            for i in range(n)]


def _port_setup(accum_steps=1, state_dict=None):
    model = get_mae_model(load_config(FIXTURE / "mae.yaml"), device="cpu")
    state_dict = load_safetensors(FIXTURE / "mae.safetensors") if state_dict is None else state_dict
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}, strict=True)
    tx = build_optimizer(dict(model.named_parameters()), accum_steps=accum_steps, **OPT)
    return model, TrainState.create(model, tx), make_mae_train_step(model, tx, 0.75, seed=0)


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX train steps from the fixture checkpoint: per step the loss, grad norm and parameters."""
    from cinema_tpu.bridge.torch_loader import load_torch_state_dict
    from cinema_tpu.config import load_config as jax_load_config
    from cinema_tpu.factory import get_mae_model as jax_get_mae_model
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer

    model = jax_get_mae_model(jax_load_config(FIXTURE / "mae.yaml"))
    batches, masks = _batches(3), _jax_masks(3)
    template = model.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                          {k: jnp.asarray(v) for k, v in batches[0].items()}, 0.75)
    params, _, _ = load_torch_state_dict(template, load_safetensors(FIXTURE / "mae.safetensors"), strict=True)
    tx = jax_build_optimizer(params, fused=True, **OPT)
    opt_state = tx.init(params)
    records = []
    for batch, mask in zip(batches, masks):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.value_and_grad(lambda p: (lambda out: (out[0], out[3]))(model.apply(p, jbatch, 0.75, mask)), has_aux=True)(params)
        params, opt_state, gnorm = tx.update_with_guard(grads, opt_state, params, jnp.isfinite(loss))
        records.append((float(loss), float(gnorm), state_dict_from_jax(params)))
    return model, template, batches, masks, records


def _assert_params_close(model, want):
    for key, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[key]
        if key.endswith("attn.kv.bias"):  # the k half: zero gradient, see the module docstring
            got, ref = got[got.shape[0] // 2 :], ref[ref.shape[0] // 2 :]
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(jax_run, n_steps):
    _, _, batches, masks, records = jax_run
    model, state, step_fn = _port_setup()
    for i in range(n_steps):
        state, metrics = step_fn(state, _to_torch(batches[i]), {v: port_mask(m) for v, m in masks[i].items()})
        np.testing.assert_allclose(float(metrics["loss"]), records[i][0], rtol=2e-4)
        np.testing.assert_allclose(float(metrics["grad_norm"]), records[i][1], rtol=1e-3)
        assert float(metrics["skipped_nan"]) == 0.0
    assert state.step == n_steps and state.n_samples == 2 * n_steps and int(state.opt_state.count) == n_steps
    _assert_params_close(model, records[n_steps - 1][2])
    if n_steps == 3:  # the steps did move the parameters, by far more than the tolerance
        start = load_safetensors(FIXTURE / "mae.safetensors")
        moved = max(np.abs(p.detach().numpy() - start[k]).max() for k, p in model.named_parameters())
        assert moved > 50 * PARAM_ATOL


def test_nan_batch_is_skipped_and_leaves_the_state_bit_identical():
    model, state, step_fn = _port_setup()
    batches = _batches(2)
    state, _ = step_fn(state, _to_torch(batches[0]))
    before = [t.clone() for t in (*model.parameters(), *state.opt_state.mu, *state.opt_state.nu, state.opt_state.count)]
    bad = {k: torch.full_like(v, float("nan")) for k, v in _to_torch(batches[1]).items()}
    state, metrics = step_fn(state, bad)
    assert float(metrics["skipped_nan"]) == 1.0 and torch.isnan(metrics["loss"])
    assert all(torch.equal(a, b) for a, b in zip(before, (*model.parameters(), *state.opt_state.mu, *state.opt_state.nu, state.opt_state.count)))
    assert state.step == 2 and state.n_samples == 4  # counters follow the JAX step: they advance all the same


def test_accumulation_of_two_halves_equals_one_step_on_the_whole_batch():
    whole = _batches(1, batch=4, seed=3)[0]
    masks = {v: port_mask(m) for v, m in _jax_masks(1, batch=4)[0].items()}
    halves = [({k: v[s] for k, v in whole.items()}, {v: type(m)(*(t[s] for t in m)) for v, m in masks.items()})
              for s in (slice(0, 2), slice(2, 4))]
    model_a, state_a, step_a = _port_setup(accum_steps=2)
    model_b, state_b, step_b = _port_setup()
    # move off the warm-up's zero learning rate first
    for _ in range(2):
        for batch, mask in halves:
            state_a, _ = step_a(state_a, _to_torch(batch), mask)
        state_b, _ = step_b(state_b, _to_torch(whole), masks)
    assert int(state_a.opt_state.count) == int(state_b.opt_state.count) == 2 and state_a.step == 4
    for (key, a), b in zip(model_a.named_parameters(), model_b.parameters()):
        if key.endswith("attn.kv.bias"):
            a, b = a[a.shape[0] // 2 :], b[b.shape[0] // 2 :]
        torch.testing.assert_close(a, b, atol=PARAM_ATOL, rtol=0, msg=key)


def test_checkpoint_resume_continues_the_same_trajectory(tmp_path):
    batches = [_to_torch(b) for b in _batches(4)]
    model, state, step_fn = _port_setup()
    for batch in batches:  # masks are drawn from (seed, step)
        state, _ = step_fn(state, batch)

    model_a, state_a, step_a = _port_setup()
    for batch in batches[:2]:
        state_a, _ = step_a(state_a, batch)
    path = checkpoint.save_checkpoint(tmp_path, state_a, epoch=0)
    assert path == checkpoint.latest_checkpoint(tmp_path) and path.name == "ckpt_0.pt"

    model_b, state_b, step_b = _port_setup(state_dict={k: np.zeros_like(v) for k, v in load_safetensors(FIXTURE / "mae.safetensors").items()})
    state_b = checkpoint.load_checkpoint(path, state_b)
    assert state_b.step == 2 and state_b.n_samples == 4 and int(state_b.opt_state.count) == 2
    for batch in batches[2:]:
        state_b, metrics = step_b(state_b, batch)
    for a, b in zip(model.parameters(), model_b.parameters()):
        assert torch.equal(a, b)
    for name in ("mu", "nu"):
        for a, b in zip(getattr(state.opt_state, name), getattr(state_b.opt_state, name)):
            assert torch.equal(a, b)


def test_mask_generator_depends_on_seed_and_step_only():
    draw = lambda seed, step: torch.rand(4, generator=mask_generator(seed, step, torch.device("cpu")))  # noqa: E731
    assert torch.equal(draw(0, 5), draw(0, 5))
    assert not torch.equal(draw(0, 5), draw(0, 6)) and not torch.equal(draw(0, 5), draw(1, 5))


def test_exported_safetensors_load_through_the_jax_bridge_with_the_same_loss(jax_run, tmp_path):
    from safetensors.numpy import load_file

    from cinema_tpu.bridge.torch_loader import load_torch_state_dict

    jmodel, template, batches, masks, _ = jax_run
    model, state, step_fn = _port_setup()
    for batch in batches[:2]:
        state, _ = step_fn(state, _to_torch(batch))
    checkpoint.save_params_safetensors(state.params, tmp_path / "cinema.safetensors")
    exported = load_file(str(tmp_path / "cinema.safetensors"))
    assert len(exported) == 133 and set(exported) == set(load_safetensors(FIXTURE / "mae.safetensors"))
    for key, value in load_safetensors(tmp_path / "cinema.safetensors").items():
        np.testing.assert_array_equal(value, exported[key])
    params, missing, unused = load_torch_state_dict(template, exported, strict=True)
    assert not missing and not unused
    want = jmodel.apply(params, {k: jnp.asarray(v) for k, v in batches[2].items()}, 0.75, masks[2])[0]
    with torch.no_grad():
        got = model(_to_torch(batches[2]), 0.75, {v: port_mask(m) for v, m in masks[2].items()})[0]
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)


def _write_studies(data_dir, n):
    rng = np.random.default_rng(0)
    data_dir.mkdir()
    for i in range(n):
        np.savez(data_dir / f"study_{i}.npz", sax=rng.random((14, 18, 4, 3)).astype(np.float32) * 100,
                 lax_2c=rng.random((32, 30, 3)).astype(np.float32) * 100)


OVERRIDES = ["train.batch_size=4", "train.batch_size_per_device=2", "train.n_warmup_epochs=1", "train.max_n_ckpts=1"]


def test_pretrain_run_takes_its_steps_writes_its_files_and_resumes(tmp_path):
    _write_studies(tmp_path / "studies", 5)
    argv = ["--config", str(FIXTURE / "mae.yaml"), "--device", "cpu", f"data.dir={tmp_path / 'studies'}",
            f"logging.dir={tmp_path / 'runs'}", *OVERRIDES]
    pretrain.main([*argv, "train.n_epochs=2"])
    (run_dir,) = (tmp_path / "runs").iterdir()
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1] and [r["n_samples"] for r in records] == [4, 8]
    assert all(np.isfinite(r["loss"]) and r["skipped_nan"] == 0 for r in records)
    assert sorted(p.name for p in run_dir.glob("ckpt_*")) == ["ckpt_1.pt"]  # max_n_ckpts = 1
    assert json.loads((run_dir / "run.json").read_text())["tags"] == ["ukb_mae_pretrain", "multi_view"]
    exported = load_safetensors(run_dir / "cinema.safetensors")
    start = get_mae_model(load_config(FIXTURE / "mae.yaml"), device="cpu")
    assert set(exported) == set(start.state_dict())

    # resume: one more epoch from the checkpoint, into a second run directory
    pretrain.main([*argv, "train.n_epochs=3", f"train.ckpt_path={run_dir / 'ckpt_1.pt'}", f"logging.dir={tmp_path / 'resumed'}"])
    (resumed,) = (tmp_path / "resumed").iterdir()
    record = [json.loads(line) for line in (resumed / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in record] == [2] and record[0]["n_samples"] == 12
    assert any(not np.array_equal(exported[k], v) for k, v in load_safetensors(resumed / "cinema.safetensors").items())


def test_pretrain_run_needs_data(tmp_path):
    config = load_config(FIXTURE / "mae.yaml")
    with pytest.raises(ValueError, match="data.dir"):
        pretrain.run(config, device="cpu")
    (tmp_path / "empty").mkdir()
    config.data.dir = str(tmp_path / "empty")
    with pytest.raises(ValueError, match="No .npz"):
        pretrain.run(config, device="cpu")


def test_dataset_frames_are_seeded_scaled_and_fitted(tmp_path):
    _write_studies(tmp_path / "studies", 3)
    sizes = {"sax": (16, 16, 4), "lax_2c": (32, 32)}
    data = pretrain.NpzCineDataset(tmp_path / "studies", ["sax", "lax_2c"], sizes, seed=1)
    item = data.load(1, epoch=0)
    assert item["sax"].shape == (16, 16, 4, 1) and item["lax_2c"].shape == (32, 32, 1)
    assert item["sax"].dtype == np.float32 and 0.0 <= item["sax"].min() and 0.9 < item["sax"].max() <= 1.0
    assert not item["sax"][14:].any() and not item["lax_2c"][:, 30:].any()  # end-padded; 18 -> 16 is cropped
    np.testing.assert_array_equal(item["sax"], data.load(1, epoch=0)["sax"])
    frames = {data.load(1, epoch=e)["sax"].tobytes() for e in range(8)}
    assert len(frames) > 1  # another epoch may take another frame
    loader = pretrain.BatchLoader(data, 2, seed=1)
    batches = list(loader.epoch(0))
    assert len(loader) == len(batches) == 1 and batches[0]["sax"].shape == (2, 16, 16, 4, 1)
    np.testing.assert_array_equal(batches[0]["sax"], next(iter(loader.epoch(0)))["sax"])


@pytest.mark.parametrize("shape,size,want", [((5, 7), (4, 9), (4, 9)), ((5, 7, 3), (6, 6), (6, 6, 3))])
def test_fit_to_size(shape, size, want):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    out = pretrain.fit_to_size(x, size)
    assert out.shape == want
    common = tuple(slice(0, min(a, b)) for a, b in zip(shape, size))
    np.testing.assert_array_equal(out[common], x[common])


def test_checkpoint_retention_and_latest(tmp_path):
    retention = checkpoint.CheckpointRetention(max_n_ckpts=2, pin_every=3)
    for epoch in range(5):
        path = tmp_path / f"ckpt_{epoch}.pt"
        path.write_bytes(b"x")
        retention.add(path, epoch)
    # epoch 2 is pinned ((2 + 1) % 3 == 0); of the others the newest two stay
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]
    assert retention.last.name == "ckpt_4.pt"
    (tmp_path / "ckpt_10.pt").write_bytes(b"x")
    (tmp_path / "ckpt_best.pt").write_bytes(b"x")
    assert checkpoint.latest_checkpoint(tmp_path).name == "ckpt_10.pt"
    assert checkpoint.latest_checkpoint(tmp_path / "missing") is None


def test_metrics_logger_appends_json_lines(tmp_path):
    logger = MetricsLogger(tmp_path / "run")
    logger.log({"epoch": 0, "loss": torch.tensor(0.5), "note": "a"})
    logger.log({"epoch": 1, "loss": np.float32(0.25)})
    lines = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert lines == [{"epoch": 0, "loss": 0.5, "note": "a"}, {"epoch": 1, "loss": 0.25}]
