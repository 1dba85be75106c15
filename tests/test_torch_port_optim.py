"""Port parity of the optimizer: LR schedule, layer-decay scales and the fused
AdamW update with its NaN guard against ``cinema_tpu.train``, on the same
numpy parameters and gradients; gradient accumulation against one update on
the mean gradient.

f32 on both sides. The update is elementwise, so the two agree to a few
ulps: atol 1e-6 on parameters of O(1) and 1e-7 on moments.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu.train import optim as jax_optim
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax, torch_key
from cinema_tpu_torch.train import optim
from cinema_tpu_torch.train.fused_optim import FusedAdamW

FIXTURE = next((Path(__file__).parent / "fixtures" / "example_ckpts").glob("mae-*"))


@pytest.mark.parametrize("warmup,max_steps", [(10.0, 100.0), (0.0, 50.0), (4.0, 4.0)])
def test_warmup_cosine_schedule_matches_jax(warmup, max_steps):
    want = jax_optim.warmup_cosine_schedule(1e-3, 1e-6, warmup, max_steps)
    got = optim.warmup_cosine_schedule(1e-3, 1e-6, warmup, max_steps)
    for step in (0, 1, 3, 4, 10, 37, 50, 100, 130):
        np.testing.assert_allclose(float(got(torch.tensor(step, dtype=torch.int32))), float(want(jnp.asarray(step))),
                                   rtol=1e-5, atol=1e-10, err_msg=str(step))
    assert got(7).dtype == torch.float32


@pytest.mark.parametrize("batch,per_device,world,want", [(64, 16, 1, 4), (64, 16, 4, 1), (16, 16, 1, 1)])
def test_n_accum_steps(batch, per_device, world, want):
    assert optim.get_n_accum_steps(batch, per_device, world) == want == jax_optim.get_n_accum_steps(batch, per_device, world)


@pytest.mark.parametrize("batch,per_device", [(8, 16), (24, 16)])
def test_n_accum_steps_errors(batch, per_device):
    with pytest.raises(ValueError):
        optim.get_n_accum_steps(batch, per_device, 1)


@pytest.fixture(scope="module")
def jax_tree():
    """The fixture CineMA's parameters as a flax tree (133 leaves), from the JAX bridge."""
    from cinema_tpu.bridge.torch_loader import load_torch_state_dict
    from cinema_tpu.config import load_config
    from cinema_tpu.factory import get_mae_model

    model = get_mae_model(load_config(FIXTURE / "mae.yaml"))
    images = {"sax": jnp.zeros((1, 16, 16, 4, 1)), "lax_2c": jnp.zeros((1, 32, 32, 1))}
    template = model.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, images, 0.75)
    params, _, _ = load_torch_state_dict(template, load_safetensors(FIXTURE / "mae.safetensors"), strict=True)
    return params["params"]  # the inner tree: the JAX layer ids read paths from its top


def _random_like(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * scale), tree)


def _by_torch_key(tree):
    """A flax tree of per-parameter scalars (scales, flags) by the port's state_dict keys."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {torch_key(tuple(str(getattr(k, "key", k)) for k in path)): value for path, value in flat}


def _torch_named(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in state_dict_from_jax(tree).items()}


def test_layer_decay_scales_match_jax(jax_tree):
    want = _by_torch_key(jax_optim.layer_decay_scales(jax_tree, 0.75, n_blocks=1))
    got = optim.layer_decay_scales(_torch_named(jax_tree), 0.75, n_blocks=1)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(float(want[key])), key
    assert sorted(set(got.values())) == pytest.approx([0.75**2, 0.75, 1.0])


@pytest.mark.parametrize("options", [
    dict(clip_grad=1.0, layer_decay=0.75, freeze=True),
    dict(clip_grad=None, layer_decay=None, freeze=False),
    dict(clip_grad=1e6, layer_decay=0.5, freeze=False),
], ids=["clip-decay-freeze", "plain", "loose-clip-decay"])
def test_fused_update_matches_jax_for_three_steps(jax_tree, options):
    freeze_tree = None
    if options["freeze"]:
        freeze_tree = jax.tree_util.tree_map_with_path(lambda path, _: "decoder" in jax.tree_util.keystr(path), jax_tree)
    common = dict(lr=1e-3, min_lr=1e-6, warmup_steps=2, max_n_steps=10, weight_decay=0.05,
                  clip_grad=options["clip_grad"], layer_decay=options["layer_decay"], n_blocks=1)
    jtx = jax_optim.build_optimizer(jax_tree, freeze_mask=freeze_tree, fused=True, **common)
    jparams, jstate = jax_tree, jtx.init(jax_tree)

    named = _torch_named(jax_tree)
    freeze = None if freeze_tree is None else {k: bool(v) for k, v in _by_torch_key(freeze_tree).items()}
    tx = optim.build_optimizer(named, freeze_mask=freeze, **common)
    state = tx.init()
    keys = list(named)

    for step in range(3):
        grads = _random_like(jax_tree, seed=10 + step, scale=0.3)
        jparams, jstate, jnorm = jtx.update_with_guard(grads, jstate, jparams, jnp.asarray(True))
        tgrads = _torch_named(grads)
        norm = tx.update_with_guard([tgrads[k] for k in keys], state, torch.tensor(True))
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        assert int(state.count) == int(jstate.count) == step + 1
        for name, have, want in (("params", list(named.values()), jparams), ("mu", state.mu, jstate.mu), ("nu", state.nu, jstate.nu)):
            want = state_dict_from_jax(want)
            for key, tensor in zip(keys, have):
                np.testing.assert_allclose(tensor.numpy(), want[key], atol=1e-6 if name == "params" else 1e-7, rtol=1e-6,
                                           err_msg=f"{name} {key} step {step}")
    if options["freeze"]:
        start = _torch_named(jax_tree)
        assert all(torch.equal(named[k], start[k]) for k in keys if freeze[k])
        assert not any(torch.equal(named[k], start[k]) for k in keys if not freeze[k])


def _small_problem(accum_steps=1, **kwargs):
    rng = np.random.default_rng(0)
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in [(4, 3), (3,), (2, 2, 2)]]
    tx = FusedAdamW(params, optim.warmup_cosine_schedule(1e-2, 1e-5, 0, 10), clip_grad=1.0, accum_steps=accum_steps, **kwargs)
    grads = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)) for p in params] for _ in range(4)]
    return params, tx, tx.init(), grads


@pytest.mark.parametrize("bad", ["flag", "nan-grads", "inf-norm"])
def test_guarded_step_is_bit_identical(bad):
    params, tx, state, grads = _small_problem()
    tx.update_with_guard(grads[0], state, torch.tensor(True))
    before = [t.clone() for t in (*params, *state.mu, *state.nu, state.count)]
    g = [x.clone() for x in grads[1]]
    ok = torch.tensor(bad != "flag")
    if bad == "nan-grads":
        g[0][0, 0] = float("nan")
    if bad == "inf-norm":
        g[1][0] = float("inf")
    norm = tx.update_with_guard(g, state, ok)
    assert torch.isfinite(norm) == (bad == "flag")
    for a, b in zip(before, (*params, *state.mu, *state.nu, state.count)):
        assert torch.equal(a, b)
    tx.update_with_guard(grads[1], state, torch.tensor(True))
    assert int(state.count) == 2 and not torch.equal(before[0], params[0])


def test_accumulation_equals_one_update_on_the_mean_gradient():
    params, tx, state, grads = _small_problem(accum_steps=2)
    ref_params, ref_tx, ref_state, _ = _small_problem()
    for pair in (grads[:2], grads[2:]):
        start = [p.clone() for p in params]
        tx.step(pair[0], state, torch.tensor(True))
        assert all(torch.equal(a, b) for a, b in zip(start, params)) and int(state.mini_step) == 1
        norm = tx.step(pair[1], state, torch.tensor(True))
        torch.testing.assert_close(norm, torch.linalg.vector_norm(torch.cat([g.flatten() for g in pair[1]])))
        ref_tx.step([(a + b) / 2 for a, b in zip(*pair)], ref_state, torch.tensor(True))
        assert int(state.mini_step) == 0 and all(float(a.abs().max()) == 0 for a in state.acc)
        for a, b in zip(params, ref_params):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    assert int(state.count) == int(ref_state.count) == 2


def test_accumulation_skips_a_bad_micro_batch_whole():
    params, tx, state, grads = _small_problem(accum_steps=2)
    ref_params, ref_tx, ref_state, _ = _small_problem(accum_steps=2)
    nan = [torch.full_like(g, float("nan")) for g in grads[0]]
    for g, ok in ((grads[0], True), (nan, False), (nan, True), (grads[1], True)):
        tx.step(g, state, torch.tensor(ok))
    for g in grads[:2]:
        ref_tx.step(g, ref_state, torch.tensor(True))
    assert int(state.count) == 1 and int(state.mini_step) == 0
    for a, b in zip(params, ref_params):
        assert torch.equal(a, b)


def test_optimizer_state_round_trips_and_rejects_a_wrong_size():
    params, tx, state, grads = _small_problem(accum_steps=2)
    tx.step(grads[0], state, torch.tensor(True))
    saved = {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone()) for k, v in state.state_dict().items()}
    fresh = FusedAdamW(params, tx.schedule, accum_steps=2).init()
    fresh.load_state_dict(saved)
    assert int(fresh.mini_step) == 1 and all(torch.equal(a, b) for a, b in zip(fresh.acc, state.acc))
    saved["mu"] = saved["mu"][:-1]
    with pytest.raises(ValueError):
        fresh.load_state_dict(saved)
