"""Port parity of the attention options that take the per-head path: rotary
embedding, qk-norm, attention dropout; and of the block options: layer scale
(``init_values``), SwiGLU, projection dropout.

The same numpy inputs and the same weights (through ``state_dict_from_jax``) go
through the JAX module with ``attn_impl="pallas"`` (its per-head Pallas kernel in
interpret mode) and through the port, whose per-head wrapper takes its plain
version on CPU tensors. f32; outputs to 2e-4, parameter gradients to 2e-4 of the
largest entry of each gradient (GELU approximation and summation order).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cinema_tpu_torch.convert import state_dict_from_jax
from cinema_tpu_torch.models import layers as port_layers
from cinema_tpu_torch.models import vit as port_vit
from cinema_tpu_torch import trace
from cinema_tpu_torch.ops import flash_attention as fa
from cinema_tpu_torch.ops import rotary as port_rotary
from cinema_tpu_torch.ops.attention import dot_product_attention

ATOL = 2e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX module says which option forced the per-head kernel
        yield


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=True)
    return module


def _jax_out_and_grads(module, params, x, w, k=None):
    def loss(p):
        return jnp.sum(module.apply(p, jnp.asarray(x), None if k is None else jnp.asarray(k)) * w)

    out = module.apply(params, jnp.asarray(x), None if k is None else jnp.asarray(k))
    return np.asarray(out), state_dict_from_jax(jax.grad(loss)(params))


def _assert_grads_close(module, want):
    for key, p in module.named_parameters():
        scale = max(np.abs(want[key]).max(), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), want[key], atol=ATOL * scale, rtol=0, err_msg=key)


# --- rotary -----------------------------------------------------------------

@pytest.mark.parametrize("n_tokens,dim,scaling", [(7, 8, 1.0), (130, 64, 1.0), (16, 32, 2.0)])
def test_rotary_tables(n_tokens, dim, scaling):
    from cinema_tpu.ops.rotary import rotary_cos_sin

    want = rotary_cos_sin(n_tokens, dim, scaling_factor=scaling)
    got = port_rotary.rotary_cos_sin(n_tokens, dim, scaling_factor=scaling)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("offset", [0, 3])
def test_apply_rotary_matches_jax(offset):
    from cinema_tpu.ops.rotary import apply_rotary, apply_rotary_emb, rotary_cos_sin, rotate_half

    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    np.testing.assert_array_equal(port_rotary.rotate_half(torch.from_numpy(q)).numpy(), np.asarray(rotate_half(jnp.asarray(q))))
    want = apply_rotary(jnp.asarray(q), jnp.asarray(k), offset)
    got = port_rotary.apply_rotary(torch.from_numpy(q), torch.from_numpy(k), offset)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # a rotary dimension smaller than head_dim leaves the tail as it was
    cos, sin = rotary_cos_sin(9, 8)
    want = apply_rotary_emb(jnp.asarray(q), cos, sin)
    got = port_rotary.apply_rotary_emb(torch.from_numpy(q), *(torch.from_numpy(np.asarray(t)) for t in (cos, sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert torch.equal(got[..., 8:], torch.from_numpy(q)[..., 8:])


def test_rotary_raises_like_jax():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="same sequence length"):
        port_rotary.apply_rotary(q, torch.zeros(1, 5, 2, 8))
    with pytest.raises(ValueError, match="larger than the last dimension"):
        port_rotary.apply_rotary_emb(q, torch.zeros(4, 8), torch.zeros(4, 8))
    attn = port_vit.Attention(16, 2, rotary=True)
    with pytest.raises(ValueError, match="different query and key"):
        attn(torch.zeros(1, 4, 16), torch.zeros(1, 5, 16))


# --- Attention and Block through the per-head path ---------------------------

@pytest.mark.parametrize(
    "qk_norm,rotary", [(False, True), (True, False), (True, True)], ids=["rotary", "qk_norm", "qk_norm+rotary"]
)
def test_attention_per_head_path_matches_jax(qk_norm, rotary):
    from cinema_tpu.models.vit import Attention

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, 64)).astype(np.float32)
    w = rng.normal(size=(2, 37, 64)).astype(np.float32)
    jmod = Attention(n_heads=2, qk_norm=qk_norm, rotary=rotary, attn_impl="pallas")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if qk_norm:  # norms initialise to ones and zeros: perturb them so the test sees them
        noise = np.random.default_rng(2)
        params = jax.tree_util.tree_map(lambda p: p + 0.1 * noise.normal(size=p.shape).astype(np.float32), params)
    want_out, want_grads = _jax_out_and_grads(jmod, params, x, w)

    attn = _load(port_vit.Attention(64, 2, qk_norm=qk_norm, rotary=rotary), params)
    assert qk_norm == any("q_norm" in k for k in attn.state_dict())
    launches = trace.counter("attention.heads.launches")
    out = attn(torch.from_numpy(x))
    assert "HeadsAttention" in str(_grad_fn_names(out)) and trace.counter("attention.heads.launches") == launches
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    _assert_grads_close(attn, want_grads)


def _grad_fn_names(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    return sorted({type(f).__name__ for f in seen})


def test_default_attention_keeps_the_packed_path():
    attn = port_vit.Attention(64, 2)
    out = attn(torch.randn(1, 5, 64, generator=torch.Generator().manual_seed(0)))
    names = str(_grad_fn_names(out))
    assert "PackedAttentionFusedKV" in names and "HeadsAttention" not in names


@pytest.mark.parametrize("mlp_type", ["mlp", "swiglu"])
@pytest.mark.parametrize("rotary", [False, True], ids=["packed", "rotary"])
def test_block_with_layer_scale_matches_jax(mlp_type, rotary):
    from cinema_tpu.models.vit import Block

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 21, 64)).astype(np.float32)
    w = rng.normal(size=(2, 21, 64)).astype(np.float32)
    jmod = Block(n_heads=2, init_values=0.3, mlp_type=mlp_type, rotary=rotary, attn_impl="pallas")
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    noise = np.random.default_rng(4)
    params = jax.tree_util.tree_map(lambda p: p + 0.05 * noise.normal(size=p.shape).astype(np.float32), params)
    want_out, want_grads = _jax_out_and_grads(jmod, params, x, w)

    block = _load(port_vit.Block(64, 2, init_values=0.3, mlp_type=mlp_type, rotary=rotary), params)
    keys = set(block.state_dict())
    assert {"ls1_gamma", "ls2_gamma"} <= keys
    assert ({"mlp.fc1_g.weight", "mlp.fc1_x.weight"} <= keys) == (mlp_type == "swiglu")
    if mlp_type == "swiglu":
        assert block.mlp.fc1_g.weight.shape[0] == port_vit.swiglu_hidden_features(64, 4) == 256
    out = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    _assert_grads_close(block, want_grads)


def test_block_without_init_values_has_no_layer_scale():
    block = port_vit.Block(16, 2)
    assert block.ls1_gamma is None and not any("gamma" in k for k in block.state_dict())


def test_swiglu_hidden_features_matches_jax():
    from cinema_tpu.models.vit import swiglu_hidden_features

    for dim, ratio in [(64, 4), (768, 4), (1024, 4), (512, 2.5)]:
        assert port_vit.swiglu_hidden_features(dim, ratio) == swiglu_hidden_features(dim, ratio)


# --- dropout -----------------------------------------------------------------

def _qkv(seed=5, n=12):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(2, n, 2, 16)).astype(np.float32)) for _ in range(3)]


def test_attention_dropout_is_off_in_eval_and_unbiased_in_training():
    q, k, v = _qkv()
    plain = fa.flash_attention_plain(q, k, v)
    assert torch.equal(dot_product_attention(q, k, v, dropout_rate=0.3, training=False), plain)
    assert torch.equal(dot_product_attention(q, k, v, dropout_rate=0.0, training=True), plain)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([dot_product_attention(q, k, v, 0.3, True, gen) for _ in range(4000)])
    assert not torch.equal(draws[0], draws[1])
    # inverted dropout keeps the mean; 4000 draws of a value with std ~0.5 leave ~0.01 of noise
    torch.testing.assert_close(draws.mean(0), plain, atol=0.05, rtol=0)
    gen_a, gen_b = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    assert torch.equal(dot_product_attention(q, k, v, 0.3, True, gen_a), dot_product_attention(q, k, v, 0.3, True, gen_b))


def test_attention_dropout_path_without_noise_is_the_jax_manual_path():
    """With every probability kept (rate -> 0 but active), the manual path equals the JAX package's."""
    from cinema_tpu.ops.attention import dot_product_attention as jax_attention

    q, k, v = _qkv(seed=6)
    want = jax_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), dropout_rate=1e-12, deterministic=False,
                         dropout_rng=jax.random.PRNGKey(0), implementation="xla")
    got = dot_product_attention(q, k, v, dropout_rate=1e-12, training=True, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_attention_module_with_dropout_takes_the_manual_path_in_training_only():
    attn = port_vit.Attention(32, 2, attn_drop=0.5)
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(1))
    attn.eval()
    assert "PackedAttentionFusedKV" in str(_grad_fn_names(attn(x)))
    attn.train()
    with port_layers.sampling_from(torch.Generator().manual_seed(2)):
        a = attn(x)
    with port_layers.sampling_from(torch.Generator().manual_seed(2)):
        b = attn(x)
    with port_layers.sampling_from(torch.Generator().manual_seed(3)):
        c = attn(x)
    names = str(_grad_fn_names(a))
    assert "PackedAttention" not in names and "HeadsAttention" not in names
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("module", ["attention", "mlp", "swiglu"])
def test_proj_drop_is_off_in_eval_and_unbiased_in_training(module):
    make = {"attention": lambda p: port_vit.Attention(32, 2, proj_drop=p), "mlp": lambda p: port_vit.Mlp(32, 64, p),
            "swiglu": lambda p: port_vit.SwiGLU(32, 64, p)}[module]
    torch.manual_seed(0)
    dropped, kept = make(0.25), make(0.0)
    kept.load_state_dict(dropped.state_dict())
    x = torch.randn(2, 7, 32, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = kept(x)
        assert torch.equal(dropped.eval()(x), want)
        dropped.train()
        with port_layers.sampling_from(torch.Generator().manual_seed(5)):
            draws = torch.stack([dropped(x) for _ in range(3000)])
    assert (draws[0] == 0).any() and not torch.equal(draws[0], draws[1])
    torch.testing.assert_close(draws.mean(0), want, atol=0.06, rtol=0)


def test_block_threads_proj_drop_and_attn_drop():
    block = port_vit.Block(32, 2, proj_drop=0.2, attn_drop=0.1, qk_norm=True)
    assert block.attn.proj_drop.rate == 0.2 and block.mlp.drop.rate == 0.2 and block.attn.attn_drop == 0.1
    assert block.attn.qk_norm and block.attn.q_norm.normalized_shape == (16,)


def test_remat_replays_the_same_dropout_noise():
    """A checkpointed block stack draws in its recomputation what it drew in the forward pass."""
    torch.manual_seed(0)
    enc = port_vit.ViTEncoder(32, 2, 2, drop_path=0.5, remat=True).train()
    ref = port_vit.ViTEncoder(32, 2, 2, drop_path=0.5, remat=False).train()
    ref.load_state_dict(enc.state_dict())
    x = torch.randn(4, 6, 32, generator=torch.Generator().manual_seed(1))
    grads = []
    for model in (enc, ref):
        with port_layers.sampling_from(torch.Generator().manual_seed(9)):
            loss = model(x).square().sum()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
