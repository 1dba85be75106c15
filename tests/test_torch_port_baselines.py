"""The UNet and ResNet baselines against the JAX package's (cinema_tpu/models/{layers,unet,resnet}.py): the
instance and group norms in f32 and bf16, the conv blocks with each norm, UNet and ResNet forwards from the
same weights, the ResNet's running statistics, one train step of each task, the NaN guard on the running
statistics, the packaged configs with ``model.name`` overridden, and run folders written by either package
evaluated by the port.

f32 unless named. Outputs, losses and parameters agree to 2e-4 (the JAX package's approximate GELU against
torch's exact erf; XLA's and torch's convolutions sum in other orders), gradient norms to 1e-3. Running
statistics: the variance within 1e-6 relative, the mean within 1e-6 of the feature's running standard
deviation (a mean near zero has no relative error to speak of); the tests run at sizes where torch's
unbiased running variance would be off by n/(n-1) - 1 >= 1e-2. bf16 norms: within one bf16 rounding of
the value (2^-7 relative), both packages taking f32 statistics of the same bf16 input.
"""

import json
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cinema_tpu_torch.config import PACKAGED, from_dict
from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
from cinema_tpu_torch.factory import get_segmentation_model, get_unet_model, init_weights
from cinema_tpu_torch.models import layers as port_layers
from cinema_tpu_torch.models.resnet import BasicBlock, BatchNorm, Bottleneck, ResNet, get_resnet
from cinema_tpu_torch.models.unet import UNet
from cinema_tpu_torch.tasks import classification, evaluate, regression, segmentation
from cinema_tpu_torch.tasks.classification import acdc as clf_acdc
from cinema_tpu_torch.tasks.regression import acdc as reg_acdc
from cinema_tpu_torch.tasks.segmentation import acdc as seg_acdc
from cinema_tpu_torch.train.optim import build_optimizer
from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step
from test_torch_port_nifti_data import write_edes_tree

ATOL = 2e-4
STATS_RTOL = 1e-6
# the UNet's convolutions whose output an instance norm takes next (the stem's, and the first of every
# residual block): the norm removes their bias, whose gradient is zero analytically; both packages leave
# rounding noise there, which Adam turns into a full step of either sign
NORMED_BIASES = ("in_conv.conv.bias", "conv1.bias")
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_steps=0, max_n_steps=10, weight_decay=0.05, clip_grad=5.0)  # the first step moves


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _to_port(model, variables):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables).items()}, strict=True)
    return model


def _channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


def assert_stats_close(model, want):
    """The port model's running statistics against ``want`` (torch-named arrays), as the module docstring says."""
    names = [k for k in model.state_dict() if k.endswith("running_var")]
    assert names
    for key in names:
        var, mean = model.state_dict()[key].numpy(), model.state_dict()[key.replace("var", "mean")].numpy()
        ref_var, ref_mean = want[key], want[key.replace("var", "mean")]
        np.testing.assert_allclose(var, ref_var, rtol=STATS_RTOL, atol=0, err_msg=key)
        assert (np.abs(mean - ref_mean) <= STATS_RTOL * np.sqrt(ref_var)).all(), key


# --- norms and conv blocks -------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["instance", "group", "layer"])
def test_conv_norms_match_jax(norm, dtype):
    from cinema_tpu.models.layers import get_conv_norm as jax_get_conv_norm

    rng = np.random.default_rng(1)
    for shape in [(2, 9, 7, 64), (2, 6, 5, 3, 16)]:
        x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
        module = jax_get_conv_norm(norm, n_chans=shape[-1])
        variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
        variables = jax.tree_util.tree_map(lambda v: jnp.asarray(rng.normal(size=v.shape), jnp.float32), variables)
        want = np.asarray(module.apply(variables, jnp.asarray(x, dtype)).astype(jnp.float32))
        port = port_layers.get_conv_norm(norm, shape[-1])
        if variables:
            _to_port(port, variables)
        torch_dtype = getattr(torch, dtype)
        got = port(_channels_first(x).to(torch_dtype))
        assert got.dtype == torch_dtype
        got = got.float().movedim(1, -1).detach().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6)


def test_conv_norm_dispatch_clamps_the_groups_and_names_a_wrong_norm():
    assert isinstance(port_layers.get_conv_norm("instance", 8), port_layers.InstanceNorm)
    assert not list(port_layers.get_conv_norm("instance", 8).parameters())  # no affine parameters
    assert port_layers.get_conv_norm("group", 8).num_groups == 8 and port_layers.get_conv_norm("group", 64).num_groups == 32
    assert port_layers.get_conv_norm("instance", 8).eps == 1e-6 and port_layers.get_conv_norm("group", 8).eps == 1e-6
    with pytest.raises(ValueError, match="divisible"):
        port_layers.get_conv_norm("group", 48)
    with pytest.raises(ValueError, match="Invalid norm type"):
        port_layers.get_conv_norm("batch", 8)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("norm", ["instance", "group", "layer"])
def test_conv_blocks_take_each_norm_as_the_jax_blocks_do(norm, nd):
    from cinema_tpu.models.layers import ConvNormActBlock as JaxConvNormActBlock
    from cinema_tpu.models.layers import ConvResBlock as JaxConvResBlock

    shape = (2, 10, 9, 8) if nd == 2 else (2, 10, 9, 3, 8)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    for jax_block, port_block in [
        (JaxConvResBlock(out_chans=16, norm=norm), port_layers.ConvResBlock(nd, 8, 16, 3, 0.0, norm)),
        (JaxConvNormActBlock(out_chans=16, norm=norm, padding="SAME"),
         port_layers.ConvNormActBlock(nd, 8, 16, 3, norm=norm, padding="same")),
    ]:
        variables = jax_block.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jax_block.apply(variables, jnp.asarray(x)))
        got = _to_port(port_block, variables)(_channels_first(x)).movedim(1, -1).detach().numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# --- the models -------------------------------------------------------------------------------------------

@pytest.mark.parametrize("nd,size,chans", [(2, (24, 24), (4, 8, 16)), (3, (16, 16, 6), (4, 8, 16)),
                                           (2, (18, 14), (4, 8)), (3, (17, 15, 5), (4, 8, 16))],
                         ids=["2d", "3d", "2d-odd", "3d-odd"])
def test_unet_forward_matches_jax(nd, size, chans):
    """Odd sizes take the decoder's end-padding where an upsampled tensor is smaller than its skip."""
    from cinema_tpu.models.unet import UNet as JaxUNet

    patch = (2, 2, 1) if nd == 3 else 2
    jax_model = JaxUNet(n_dims=nd, in_chans=2, out_chans=4, chans=chans, patch_size=patch)
    image = np.random.default_rng(0).normal(size=(2, *size, 2)).astype(np.float32)
    variables = jax_model.init(jax.random.PRNGKey(0), {"sax": jnp.asarray(image)})
    want = np.asarray(jax_model.apply(variables, {"sax": jnp.asarray(image)})["sax"])
    port = _to_port(UNet(nd, 2, 4, chans, patch_size=patch), variables).eval()
    with torch.no_grad():
        got = port({"sax": torch.from_numpy(image)})
    assert list(got) == ["sax"] and got["sax"].shape == (2, *size, 4)
    np.testing.assert_allclose(got["sax"].numpy(), want, atol=ATOL, rtol=0)


def _jax_resnet(nd, bottleneck=False, seed=0, in_chans=2):
    from cinema_tpu.models.resnet import ResNet as JaxResNet

    size = (32, 32) if nd == 2 else (16, 16, 8)
    jax_model = JaxResNet(out_chans=3, layers=(1, 2), layer_inplanes=(4, 8), bottleneck=bottleneck)
    images = [np.random.default_rng(seed + i).normal(i, 1 + i, size=(2, *size, in_chans)).astype(np.float32)
              for i in range(3)]
    variables = jax_model.init(jax.random.PRNGKey(seed), {"sax": jnp.asarray(images[0])})
    return jax_model, variables, images


@pytest.mark.parametrize("bottleneck", [False, True], ids=["basic", "bottleneck"])
@pytest.mark.parametrize("nd", [2, 3])
def test_resnet_forward_and_running_statistics_match_jax(nd, bottleneck):
    jax_model, variables, images = _jax_resnet(nd, bottleneck)
    port = _to_port(ResNet(nd, 2, 3, layers=(1, 2), layer_inplanes=(4, 8), bottleneck=bottleneck), variables)
    assert isinstance(port.layer2[1], Bottleneck if bottleneck else BasicBlock)
    # eval mode: the running statistics normalise
    want = np.asarray(jax_model.apply(variables, {"sax": jnp.asarray(images[0])}))
    with torch.no_grad():
        got = port.eval()({"sax": torch.from_numpy(images[0])})
    assert got.shape == (2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # train mode: batch statistics normalise, and three batches update the running statistics
    last_bn_inputs = []
    port.layer2[-1].bn2.register_forward_hook(lambda m, args, out: last_bn_inputs.append(args[0].shape))
    port.train()
    for image in images:
        want, updated = jax_model.apply(variables, {"sax": jnp.asarray(image)}, deterministic=False,
                                        mutable=["batch_stats"])
        variables = {"params": variables["params"], **updated}
        with torch.no_grad():
            got = port({"sax": torch.from_numpy(image)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert_stats_close(port, state_dict_from_jax(variables))
    n = np.prod([last_bn_inputs[0][0], *last_bn_inputs[0][2:]])
    assert n / (n - 1) - 1 >= 1e-2  # torch's unbiased running variance would be off by this much


def test_batch_norm_keeps_float32_and_has_no_batch_counter():
    bn = BatchNorm(4)
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean", "running_var"}
    x = torch.randn(3, 4, 5, 6, dtype=torch.bfloat16)
    assert bn.train()(x).dtype == torch.float32 and bn.eval()(x).dtype == torch.float32
    resnet = get_resnet("resnet50", 3, 2, 5)
    assert isinstance(resnet.layer1[0], Bottleneck) and [len(getattr(resnet, f"layer{i}")) for i in (1, 2, 3, 4)] == [3, 4, 6, 3]
    with pytest.raises(ValueError, match="size must be in"):
        get_resnet("resnet101", 3, 2, 5)


# --- train steps ------------------------------------------------------------------------------------------

def _step_case(kind):
    """(JAX model, variables, JAX loss fn, port model, port loss fn, batch) of one tiny task step."""
    from cinema_tpu.models.unet import UNet as JaxUNet
    from cinema_tpu.tasks.classification import classification_loss_fn as jax_clf_loss
    from cinema_tpu.tasks.regression import regression_loss_fn as jax_reg_loss
    from cinema_tpu.tasks.segmentation import segmentation_loss_fn as jax_seg_loss

    rng = np.random.default_rng(4)
    if kind == "unet-seg":
        image = rng.normal(size=(2, 16, 16, 4, 1)).astype(np.float32)
        label = rng.integers(0, 4, size=(2, 16, 16, 4)).astype(np.int8)
        jax_model = JaxUNet(n_dims=3, in_chans=1, out_chans=4, chans=(4, 8), patch_size=(2, 2, 1), scale_factor=(2, 2, 1))
        variables = jax_model.init(jax.random.PRNGKey(0), {"sax": jnp.asarray(image)})
        port = UNet(3, 1, 4, (4, 8), patch_size=(2, 2, 1), scale_factor=(2, 2, 1))
        return (jax_model, variables, jax_seg_loss, port, segmentation.segmentation_loss_fn,
                {"sax_image": image, "sax_label": label})
    jax_model, variables, images = _jax_resnet(3, seed=5)
    label = rng.integers(0, 3, size=2) if kind == "resnet-clf" else rng.normal(size=2).astype(np.float32)
    port = ResNet(3, 2, 3, layers=(1, 2), layer_inplanes=(4, 8))
    jax_loss = jax_clf_loss if kind == "resnet-clf" else jax_reg_loss
    port_loss = classification.classification_loss_fn if kind == "resnet-clf" else regression.regression_loss_fn
    return jax_model, variables, jax_loss, port, port_loss, {"sax_image": images[1], "label": label}


@pytest.mark.parametrize("kind", ["unet-seg", "resnet-clf", "resnet-reg"])
def test_one_train_step_matches_jax(kind):
    """As the JAX package's ``run_train`` steps: the optimizer over the whole variable dict (the BatchNorm
    statistics inert in it and overwritten by the forward's), the fused AdamW with its guard."""
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer
    from cinema_tpu.train.state import TrainState as JaxTrainState
    from cinema_tpu.train.state import make_supervised_train_step as jax_make_step

    jax_model, variables, jax_loss, port, port_loss, batch = _step_case(kind)
    _to_port(port, variables)
    tx = jax_build_optimizer(variables, fused=True, **OPT)
    step = jax_make_step(jax_model, tx, jax_loss, donate=False)
    state, record = step(JaxTrainState.create(variables, tx), {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0))
    want = state_dict_from_jax(state.params)

    ptx = build_optimizer(dict(port.named_parameters()), **OPT)
    pstate, metrics = make_supervised_train_step(port, ptx, port_loss)(
        TrainState.create(port, ptx), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(record["loss"]), rtol=ATOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(record["grad_norm"]), rtol=1e-3)
    assert float(metrics["skipped_nan"]) == 0.0 and pstate.step == 1
    start = state_dict_from_jax(variables)
    moved = 0.0
    for key, p in port.named_parameters():
        moved = max(moved, float(np.abs(p.detach().numpy() - start[key]).max()))
        if key.endswith(NORMED_BIASES):  # zero gradient, see NORMED_BIASES
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[key], atol=ATOL, rtol=0, err_msg=key)
    assert moved > 5 * ATOL
    if kind != "unet-seg":
        assert_stats_close(port, want)
        assert not np.array_equal(port.state_dict()["bn1.running_mean"].numpy(), start["bn1.running_mean"])


def test_a_nan_batch_leaves_the_running_statistics_bit_identical():
    _, variables, _, port, port_loss, batch = _step_case("resnet-clf")
    _to_port(port, variables)
    tx = build_optimizer(dict(port.named_parameters()), **OPT)
    state, step_fn = TrainState.create(port, tx), make_supervised_train_step(port, tx, port_loss)
    good = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state, _ = step_fn(state, good)
    assert all(not torch.equal(before[k], v) for k, v in port.state_dict().items() if "running" in k)
    snapshot = [t.clone() for t in (*port.state_dict().values(), *state.opt_state.mu, *state.opt_state.nu,
                                    state.opt_state.count)]
    state, metrics = step_fn(state, dict(good, sax_image=torch.full_like(good["sax_image"], float("nan"))))
    assert float(metrics["skipped_nan"]) == 1.0 and state.step == 2
    after = [*port.state_dict().values(), *state.opt_state.mu, *state.opt_state.nu, state.opt_state.count]
    assert all(torch.equal(a, b) for a, b in zip(snapshot, after))
    state, metrics = step_fn(state, good)  # and the next good batch updates them again
    assert float(metrics["skipped_nan"]) == 0.0 and not torch.equal(snapshot[2], port.state_dict()["bn1.running_mean"])


# --- the packaged configs ----------------------------------------------------------------------------------

@pytest.mark.parametrize("task,name", [("segmentation/acdc", "unet"), ("classification/acdc", "resnet"),
                                       ("regression/acdc", "resnet"), ("classification/mnms2", "resnet")])
def test_packaged_configs_build_the_baselines_with_the_jax_parameter_count(task, name):
    """The full-width models, built on the meta device (no memory), against the JAX models' abstract
    initialisation (shapes only; the parameter count does not depend on the image size)."""
    from cinema_tpu.config import from_dict as jax_from_dict
    from cinema_tpu.factory import get_segmentation_model as jax_segmentation_model
    from cinema_tpu.tasks.classification import get_classification_model as jax_classification_model

    config = from_dict(PACKAGED[task])
    config.model.name = name
    jax_config = jax_from_dict(json.loads(json.dumps(config)))
    jax_model = (jax_segmentation_model if name == "unet" else jax_classification_model)(jax_config)
    chans = 1 if name == "unet" else config.model.n_frames
    example = {"sax": jnp.zeros((1, 32, 32, 8, chans), jnp.float32)}
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), example))
    count = lambda tree: sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))  # noqa: E731
    build = get_segmentation_model if name == "unet" else classification.get_classification_model
    with torch.device("meta"):
        model = build(config, dtype=torch.bfloat16, device="meta")
    assert isinstance(model, UNet if name == "unet" else ResNet) and not model.training
    assert sum(p.numel() for p in model.parameters()) == count(shapes["params"])
    assert sum(b.numel() for b in model.buffers()) == count(shapes.get("batch_stats", {}))
    if name == "resnet":  # `depth: 50` is not read: basic blocks, as the JAX package builds them
        assert all(isinstance(b, BasicBlock) for i in (1, 2, 3, 4) for b in getattr(model, f"layer{i}"))
        assert model.fc.out_features == len(config.data.get(config.data.get("class_column", ""), [0]))
    else:
        assert model.dtype == torch.bfloat16 and isinstance(model.encoder.in_conv.norm, port_layers.InstanceNorm)
    assert isinstance(get_unet_model(from_dict(PACKAGED["segmentation/acdc"]), device="cpu"), UNet)


# --- run folders ------------------------------------------------------------------------------------------

def _tiny_config(task, data_dir):
    config = from_dict(PACKAGED[f"{task}/acdc"])
    config.model.name = "unet" if task == "segmentation" else "resnet"
    config.data.dir = str(data_dir)
    config.data.sax.patch_size = [16, 16, 4]
    if task == "segmentation":
        config.model.unet.update(chans=[4, 8, 16])
    else:
        config.model.resnet.update(layers=[1, 1], layer_inplanes=[4, 8])
    config.train.update(n_epochs=1, n_warmup_epochs=1, eval_interval=1, batch_size=4, batch_size_per_device=4,
                        n_workers=2)
    return config


@pytest.fixture(scope="module")
def acdc(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc")
    write_edes_tree(root, "acdc", 24, seed=6)
    (root / "test").symlink_to(root / "train")
    shutil.copy(root / "train_metadata.csv", root / "test_metadata.csv")
    return root


def _jax_run_folder(folder, config):
    """A run folder as the JAX package's ``run_train`` leaves it, ``config.yaml`` and ``model_0.safetensors``,
    the variables seeded and, for a ResNet, the running statistics moved by two train-mode batches."""
    from cinema_tpu.config import from_dict as jax_from_dict
    from cinema_tpu.config import save_config
    from cinema_tpu.factory import get_segmentation_model as jax_segmentation_model
    from cinema_tpu.tasks.classification import get_classification_model as jax_classification_model
    from cinema_tpu.train.checkpoint import save_params_safetensors

    folder.mkdir(parents=True)
    jconfig = jax_from_dict(json.loads(json.dumps(config)))
    unet = config.model.name == "unet"
    model = (jax_segmentation_model if unet else jax_classification_model)(jconfig)
    image = jnp.asarray(np.random.default_rng(9).normal(size=(2, 16, 16, 4, 1 if unet else 2)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(3), {"sax": image})
    if not unet:
        for i in range(2):
            _, updated = model.apply(variables, {"sax": image + i}, deterministic=False, mutable=["batch_stats"])
            variables = {"params": variables["params"], **updated}
    save_config(jconfig, folder / "config.yaml")
    save_params_safetensors(variables if not unet else variables["params"], folder / "model_0.safetensors")
    return model, variables


@pytest.mark.parametrize("task", ["segmentation", "classification", "regression"])
def test_a_jax_run_folder_loads_and_evaluates_in_the_port(acdc, tmp_path, task, monkeypatch):
    """The port's ``load_run`` takes the parameters and the running statistics; ``evaluate.main`` writes the
    tables the JAX package's writes for the same weights. The JAX package's own ``load_run`` fills no
    parameter of a ResNet (its bridge matches 'params.conv1.weight' against 'conv1.weight' and, loading
    loosely, keeps the initial values), so its ``load_run`` is given the saved variables here."""
    from cinema_tpu.tasks import evaluate as jax_evaluate

    config = _tiny_config(task, acdc)
    port_folder, jax_folder = tmp_path / "port", tmp_path / "jax"
    model, variables = _jax_run_folder(port_folder, config)
    shutil.copytree(port_folder, jax_folder)
    loaded_config, port = evaluate.load_run(port_folder, device="cpu")
    assert loaded_config.model.name == config.model.name and not port.training
    want = state_dict_from_jax(variables)
    assert set(port.state_dict()) == set(want)
    for key, value in port.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)
    if task != "segmentation":
        loaded = jax_evaluate.load_run
        monkeypatch.setattr(jax_evaluate, "load_run", lambda folder, dtype=None: (*loaded(folder, dtype)[:2], variables))
    evaluate.main(["--folder_path", str(port_folder), "--split", "test", "--device", "cpu"])
    jax_evaluate.main(["--folder_path", str(jax_folder), "--split", "test"])
    tables = sorted(p.name for p in (jax_folder / "acdc_eval").iterdir())
    assert sorted(p.name for p in (port_folder / "acdc_eval").iterdir()) == tables and "mean_metrics.csv" in tables
    for table in tables:
        got, ref = (pd.read_csv(f / "acdc_eval" / table) for f in (port_folder, jax_folder))
        assert list(got.columns) == list(ref.columns) and len(got) == len(ref) > 0
        pd.testing.assert_frame_equal(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("task,module", [("segmentation", seg_acdc), ("classification", clf_acdc),
                                         ("regression", reg_acdc)])
def test_the_acdc_entry_points_train_the_baselines_and_reload(acdc, tmp_path, task, module):
    """One epoch of each ACDC entry point with ``model.name`` overridden, on the CPU: finite metrics, and the
    exported safetensors (running statistics included) rebuild the model that ``load_run`` evaluates."""
    config = _tiny_config(task, acdc)
    out_dir = module.run(config, device="cpu", out_dir=tmp_path / "run")
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(records[0]["train_loss"]) and len(records) == 2
    exported = load_safetensors(out_dir / "model_0.safetensors")
    _, model = evaluate.load_run(out_dir, device="cpu")
    assert set(exported) == set(model.state_dict())
    assert any(k.endswith("running_var") for k in exported) == (task != "segmentation")
    image = torch.from_numpy(np.random.default_rng(1).random((1, 16, 16, 4, 1 if task == "segmentation" else 2),
                                                              np.float32))
    again = init_weights((get_segmentation_model if task == "segmentation" else
                          classification.get_classification_model)(config, device="cpu"), seed=1)
    again.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()})
    with torch.no_grad():
        a, b = model({"sax": image}), again.eval()({"sax": image})
    a, b = (x["sax"] if isinstance(x, dict) else x for x in (a, b))
    assert torch.equal(a, b)
