"""Two processes over gloo on the CPU take one step of the port's distributed train steps
(``cinema_tpu_torch.parallel``): a tiny CineMA MAE and a tiny ConvUNetR, under data parallelism
(``ddp``: one row each), head-aligned tensor parallelism (``tp``: ``mesh.n_model=2``, one head each)
and FSDP (``fsdp``: dim-0 shards), and in four processes FSDP over two data ranks of tensor-parallel pairs
(``fsdp_tp``). Each is held against the port's one-process step on the whole
batch and against the JAX package's one-device step from the same weights, batch and (JAX-drawn)
masks; the checkpoint it writes reloads in one process to the same parameters and outputs, and back
into its own layout.

Tolerances: loss within rtol 1e-5 and parameters after one AdamW step within 2e-4 of the port's
one-process step (the ranks sum in another order); against the JAX package the loss within rtol 2e-4,
the port's tolerance against it everywhere (its approximate GELU against torch's exact one; see
tests/test_torch_port_pretrain.py), parameters within 2e-4. Left out of the parameter comparisons, as in
the one-process tests: the k half of every ``attn.kv.bias`` and the weight of the LayerNorm over the
one-channel image, whose gradients are zero analytically and rounding noise in practice, which Adam
turns into full steps.

The modes of two processes run in turn in one pair of worker processes, the four-process one in its own,
each process under its own ``communicate(timeout=...)``. A worker is this file run as a script,

    python tests/test_torch_port_distributed_2proc.py SPEC.json RANK

SPEC.json: ``world``, ``port`` and ``runs``, taken in turn, each a ``mode`` with its ``cases``, each with
``name``, ``kind`` (``mae`` or ``convunetr``), the model's ``config`` (a YAML path) or ``arch`` (ConvUNetR
arguments), ``weights`` and ``batch`` (``.npz`` files of the whole batch), for the MAE ``masks`` (``.npz``:
``<view>_bool_mask``, ``_keep_ids``, ``_mask_ids`` of the whole batch), ``opt`` (``build_optimizer``
arguments) and ``out`` (a folder). Each rank takes its data rank's rows of the batch and the masks, lays the
model out over the mesh, takes one step, writes the checkpoint (``ckpt_0.pt``) and reads it back into a fresh
model of its layout, and rank 0 writes ``result.json`` (loss, grad norm, local shapes, whether the reloaded
state is the saved one and computes the same outputs), ``params.npz`` (the whole parameters after the step)
and ``outputs.npz`` (the stepped model's output on the whole batch: the MAE's loss and predictions, the
ConvUNetR's logits). The worker imports no jax.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # a worker runs this file as a script

from cinema_tpu_torch.config import load_config  # noqa: E402
from cinema_tpu_torch.factory import get_mae_model  # noqa: E402
from cinema_tpu_torch.models.convunetr import ConvUNetR  # noqa: E402
from cinema_tpu_torch.ops.masking import PatchMask  # noqa: E402
from cinema_tpu_torch.parallel import multihost  # noqa: E402
from cinema_tpu_torch.parallel.mesh import make_mesh, parallelize  # noqa: E402
from cinema_tpu_torch.tasks import segmentation  # noqa: E402
from cinema_tpu_torch.train.checkpoint import checkpoint_state, load_checkpoint, save_checkpoint  # noqa: E402
from cinema_tpu_torch.train.optim import build_optimizer  # noqa: E402
from cinema_tpu_torch.train.state import TrainState, make_mae_train_step, make_supervised_train_step  # noqa: E402

# mode -> processes: and FSDP over two data ranks of tensor-parallel pairs, the two composed
MODES = {"ddp": 2, "tp": 2, "fsdp": 2, "fsdp_tp": 4}
CASES = ["mae", "convunetr"]
# warm-up 0: the one step moves the parameters
OPT = {"mae": dict(lr=1e-3, min_lr=1e-6, warmup_steps=0, max_n_steps=10, weight_decay=0.05, clip_grad=5.0),
       "convunetr": dict(lr=1e-3, min_lr=1e-5, warmup_steps=0, max_n_steps=10, weight_decay=0.05, clip_grad=5.0)}
LOSS_RTOL, JAX_LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-4, 2e-4
TIMEOUT = 240


# --- one rank of a run (this file as a script) ---------------------------------------------------------

def build_model(case: dict) -> torch.nn.Module:
    """The case's model on the CPU with its weights."""
    if case["kind"] == "mae":
        model = get_mae_model(load_config(case["config"]), device="cpu")
    else:
        model = ConvUNetR(**{k: tuple(v) if isinstance(v, list) else v for k, v in case["arch"].items()})
    weights = np.load(case["weights"])
    model.load_state_dict({k: torch.from_numpy(weights[k]) for k in weights.files}, strict=True)
    return model


def masks_of(case: dict, rows: slice = slice(None)) -> dict:
    masks = np.load(case["masks"])
    views = sorted({k.rsplit("_", 2)[0] for k in masks.files})
    return {v: PatchMask(*(torch.from_numpy(masks[f"{v}_{part}"][rows])
                           for part in ("bool_mask", "keep_ids", "mask_ids"))) for v in views}


def outputs_of(case: dict, model: torch.nn.Module, batch: dict) -> dict:
    """The model's output on ``batch``, without gradients."""
    with torch.no_grad():
        if case["kind"] == "mae":
            loss, preds, _, _ = model(batch, 0.75, masks_of(case))
            return {"loss": loss.numpy(), **{f"pred_{v}": p.numpy() for v, p in preds.items()}}
        model.eval()
        return {"logits": model({"sax": batch["sax_image"]})["sax"].numpy()}


def run_case(case: dict, parallel_mode: str, mesh) -> None:
    model = build_model(case)
    par = parallelize(model, mesh, fsdp=parallel_mode.startswith("fsdp"))
    tx = build_optimizer(dict(zip(par.names, par.optimizer_params(model))), global_norm=par.global_norm,
                         **case["opt"])
    state = TrainState.create(model, tx)
    whole = np.load(case["batch"])
    rows = whole[whole.files[0]].shape[0] // par.n_data
    own = slice(par.data_rank * rows, (par.data_rank + 1) * rows)
    batch = {k: torch.from_numpy(whole[k][own]) for k in whole.files}
    if case["kind"] == "mae":
        step_fn = make_mae_train_step(model, tx, 0.75, seed=0, parallel=par)
        state, metrics = step_fn(state, batch, masks_of(case, own))
    else:
        step_fn = make_supervised_train_step(model, tx, segmentation.segmentation_loss_fn, seed=0, parallel=par)
        state, metrics = step_fn(state, batch)
    payload = checkpoint_state(state, par)
    path = save_checkpoint(case["out"], state, 0, par, payload)
    torch.distributed.barrier()
    outputs = outputs_of(case, model, {k: torch.from_numpy(whole[k]) for k in whole.files})
    # the single-process file back into this layout: the same whole tensors
    fresh = build_model(case)
    fresh_par = parallelize(fresh, mesh, fsdp=parallel_mode.startswith("fsdp"))
    fresh_tx = build_optimizer(dict(zip(fresh_par.names, fresh_par.optimizer_params(fresh))),
                               global_norm=fresh_par.global_norm, **case["opt"])
    reloaded = checkpoint_state(load_checkpoint(path, TrainState.create(fresh, fresh_tx), fresh_par), fresh_par)
    same = all(torch.equal(a, reloaded["params"][k]) for k, a in payload["params"].items())
    same &= all(torch.equal(a, b) for key in ("mu", "nu") for a, b in zip(payload["opt_state"][key],
                                                                          reloaded["opt_state"][key]))
    # and the reloaded model computes with them (FSDP re-lays its shards out at the first forward)
    again = outputs_of(case, fresh, {k: torch.from_numpy(whole[k]) for k in whole.files})
    same &= all(np.allclose(again[k], outputs[k], rtol=0, atol=1e-6) for k in outputs)
    if multihost.process_index() == 0:
        out = Path(case["out"])
        np.savez(out / "params.npz", **{k: v.numpy() for k, v in payload["params"].items()})
        np.savez(out / "outputs.npz", **outputs)
        (out / "result.json").write_text(json.dumps({
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "skipped_nan": float(metrics["skipped_nan"]), "n_samples": state.n_samples,
            "local_shapes": {k: list(v.shape) for k, v in model.state_dict().items()}, "reloaded": bool(same),
        }))


def worker_main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(sys.argv[2])
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(spec["port"]), RANK=str(rank),
                      WORLD_SIZE=str(spec["world"]), LOCAL_RANK="0")
    torch.manual_seed(0)
    multihost.maybe_initialize_distributed(True, "cpu")
    for run in spec["runs"]:
        n_model = 2 if run["mode"] in ("tp", "fsdp_tp") else 1
        mesh = make_mesh(spec["world"] // n_model, n_model, "cpu")
        for case in run["cases"]:
            run_case(case, run["mode"], mesh)
    torch.distributed.destroy_process_group()
    print("WORKER DONE", rank, flush=True)



# --- the tests ---------------------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _compared(key: str, value: np.ndarray) -> np.ndarray:
    """The part of a parameter that the comparisons hold (module docstring)."""
    from test_torch_port_segmentation import ONE_CHANNEL_NORM_WEIGHTS

    if key in ONE_CHANNEL_NORM_WEIGHTS:
        return value[:0]
    return value[value.shape[0] // 2 :] if key.endswith("attn.kv.bias") else value


def _mae_inputs(root: Path) -> dict:
    import jax
    import jax.numpy as jnp

    from cinema_tpu_torch.convert import load_safetensors, state_dict_from_jax
    from test_torch_port_masking import port_mask
    from test_torch_port_pretrain import FIXTURE, _batches, _jax_masks

    weights = load_safetensors(FIXTURE / "mae.safetensors")
    batch, masks = _batches(1)[0], _jax_masks(1)[0]
    np.savez(root / "mae_weights.npz", **weights)
    np.savez(root / "mae_batch.npz", **batch)
    np.savez(root / "mae_masks.npz", **{f"{v}_{part}": np.asarray(getattr(m, part)).astype(
        bool if part == "bool_mask" else np.int64) for v, m in masks.items()
        for part in ("bool_mask", "keep_ids", "mask_ids")})

    model = get_mae_model(load_config(FIXTURE / "mae.yaml"), device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in weights.items()}, strict=True)
    tx = build_optimizer(dict(model.named_parameters()), **OPT["mae"])
    state, metrics = make_mae_train_step(model, tx, 0.75, seed=0)(
        TrainState.create(model, tx), {k: torch.from_numpy(v) for k, v in batch.items()},
        {v: port_mask(m) for v, m in masks.items()})
    port = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}

    from cinema_tpu.bridge.torch_loader import load_torch_state_dict
    from cinema_tpu.config import load_config as jax_load_config
    from cinema_tpu.factory import get_mae_model as jax_get_mae_model
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer

    jmodel = jax_get_mae_model(jax_load_config(FIXTURE / "mae.yaml"))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    template = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                                                  jbatch, 0.75))
    params, _, _ = load_torch_state_dict(template, weights, strict=True)
    jtx = jax_build_optimizer(params, fused=True, **OPT["mae"])

    @jax.jit
    def jax_step(params, batch, masks):
        (loss, _), grads = jax.value_and_grad(
            lambda p: (lambda out: (out[0], out[3]))(jmodel.apply(p, batch, 0.75, masks)), has_aux=True)(params)
        params, _, _ = jtx.update_with_guard(grads, jtx.init(params), params, jnp.isfinite(loss))
        return loss, params

    loss, params = jax_step(params, jbatch, masks)
    jax_ref = {"loss": float(loss), "params": state_dict_from_jax(params)}
    return {"spec": {"kind": "mae", "config": str(FIXTURE / "mae.yaml"), "weights": str(root / "mae_weights.npz"),
                     "batch": str(root / "mae_batch.npz"), "masks": str(root / "mae_masks.npz"), "opt": OPT["mae"]},
            "port": port, "jax": jax_ref}


def _convunetr_inputs(root: Path) -> dict:
    import jax
    import jax.numpy as jnp

    from cinema_tpu_torch.convert import state_dict_from_jax
    from test_torch_port_segmentation import ARCH, _train_batches

    from cinema_tpu.tasks.segmentation import segmentation_loss_fn as jax_loss_fn
    from cinema_tpu.train.optim import build_optimizer as jax_build_optimizer
    from cinema_tpu.train.state import TrainState as JaxTrainState
    from cinema_tpu.train.state import make_supervised_train_step as jax_make_step

    from cinema_tpu.models.convunetr import ConvUNetR as JaxConvUNetR

    from cinema_tpu.bridge.torch_loader import load_torch_state_dict
    from cinema_tpu_torch.factory import init_weights

    # seeded port weights, loaded into the JAX model by its bridge; the JAX package's plain attention ("auto"
    # on the CPU): its Pallas kernels are held to the port's in tests/test_torch_port_segmentation.py, and in
    # interpret mode they would double this fixture's time
    model = init_weights(ConvUNetR(**ARCH), seed=0)
    weights = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    batch = _train_batches(1)[0]
    np.savez(root / "convunetr_weights.npz", **weights)
    np.savez(root / "convunetr_batch.npz", **batch)
    jmodel = JaxConvUNetR(**ARCH)
    template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                  {"sax": jnp.zeros((1, *ARCH["image_size_dict"]["sax"], 1))}))
    params, _, _ = load_torch_state_dict(template, weights, strict=True)
    tx = build_optimizer(dict(model.named_parameters()), **OPT["convunetr"])
    state, metrics = make_supervised_train_step(model, tx, segmentation.segmentation_loss_fn)(
        TrainState.create(model, tx), {k: torch.from_numpy(v) for k, v in batch.items()})
    port = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}

    jtx = jax_build_optimizer(params["params"], accum_steps=1, fused=True, **OPT["convunetr"])
    step = jax_make_step(jmodel, jtx, lambda m, p, b, rng: jax_loss_fn(m, {"params": p}, b, rng), donate=False)
    jstate, jmetrics = step(JaxTrainState.create(params["params"], jtx),
                            {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    jax_ref = {"loss": float(jmetrics["loss"]), "params": state_dict_from_jax(jstate.params)}
    return {"spec": {"kind": "convunetr", "arch": ARCH, "weights": str(root / "convunetr_weights.npz"),
                     "batch": str(root / "convunetr_batch.npz"), "opt": OPT["convunetr"]},
            "port": port, "jax": jax_ref}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Per case: the worker's spec, the port's one-process step and the JAX package's one-device step."""
    root = tmp_path_factory.mktemp("inputs")
    return {"mae": _mae_inputs(root), "convunetr": _convunetr_inputs(root)}


_RUNS: dict = {}


def _run(mode: str, inputs: dict, root: Path) -> dict:
    """Each case's folder of ``mode``: the modes of one process count run in turn in one set of processes,
    once per module."""
    if mode not in _RUNS:
        world = MODES[mode]
        out = root / f"world{world}"
        runs = []
        for run_mode in (m for m, w in MODES.items() if w == world):
            cases = []
            for name in CASES:
                (out / run_mode / name).mkdir(parents=True)
                cases.append({**inputs[name]["spec"], "name": name, "out": str(out / run_mode / name)})
            runs.append({"mode": run_mode, "cases": cases})
        spec_path = out / "spec.json"
        spec_path.write_text(json.dumps({"world": world, "port": _free_port(), "runs": runs}))
        # two threads a process: the ranks share the host with the other test workers
        env = {**os.environ, "OMP_NUM_THREADS": "2"}
        procs = [subprocess.Popen([sys.executable, __file__, str(spec_path), str(rank)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env) for rank in range(world)]
        for proc in procs:
            try:
                log, _ = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                raise
            assert proc.returncode == 0 and "WORKER DONE" in log, log[-4000:]
        for run in runs:
            _RUNS[run["mode"]] = {name: out / run["mode"] / name for name in CASES}
    return _RUNS[mode]


@pytest.fixture(scope="module")
def runs_root(tmp_path_factory):
    return tmp_path_factory.mktemp("runs")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_step_as_one_process_and_as_jax(inputs, runs_root, mode, case):
    from test_torch_port_segmentation import ARCH

    folder = _run(mode, inputs, runs_root)[case]
    result = json.loads((folder / "result.json").read_text())
    port, jax_ref = inputs[case]["port"], inputs[case]["jax"]
    assert result["skipped_nan"] == 0.0 and result["n_samples"] == 2
    np.testing.assert_allclose(result["loss"], port["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(result["grad_norm"], port["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(result["loss"], jax_ref["loss"], rtol=JAX_LOSS_RTOL)
    params = np.load(folder / "params.npz")
    assert set(params.files) == set(port["params"])
    moved = 0.0
    start = np.load(inputs[case]["spec"]["weights"])
    for key in params.files:
        got = params[key]
        assert got.shape == port["params"][key].shape, key
        moved = max(moved, float(np.abs(got - start[key]).max()))
        np.testing.assert_allclose(_compared(key, got), _compared(key, port["params"][key]), atol=PARAM_ATOL, rtol=0,
                                   err_msg=key)
        if key in jax_ref["params"]:
            np.testing.assert_allclose(_compared(key, got), _compared(key, jax_ref["params"][key]), atol=PARAM_ATOL,
                                       rtol=0, err_msg=key)
    assert moved > 5 * PARAM_ATOL  # the step moved the parameters by far more than the tolerance
    shapes = result["local_shapes"]
    embed = 16 if case == "mae" else ARCH["enc_embed_dim"]
    q = next(k for k in shapes if k.endswith("blocks.0.attn.q.weight"))
    kv = q.replace(".q.", ".kv.")
    if mode == "tp":  # rank 0 holds its head's rows of q and kv (FSDP's shapes are the whole tensor's)
        assert shapes[q] == [embed // 2, embed] and shapes[kv] == [embed, embed]
    elif mode == "ddp":
        assert shapes[q] == [embed, embed] and shapes[kv] == [2 * embed, embed]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["tp", "fsdp", "fsdp_tp"])
def test_a_checkpoint_of_two_ranks_reloads_in_one_process(inputs, runs_root, mode, case):
    folder = _run(mode, inputs, runs_root)[case]
    spec = inputs[case]["spec"]
    model = build_model(spec)
    tx = build_optimizer(dict(model.named_parameters()), **spec["opt"])
    state = load_checkpoint(folder / "ckpt_0.pt", TrainState.create(model, tx))
    assert state.step == 1 and state.n_samples == 2 and int(state.opt_state.count) == 1
    params = np.load(folder / "params.npz")
    for key, value in model.state_dict().items():
        assert np.array_equal(value.numpy(), params[key]), key
    whole = np.load(spec["batch"])
    got = outputs_of(spec, model, {k: torch.from_numpy(whole[k]) for k in whole.files})
    want = np.load(folder / "outputs.npz")
    assert set(got) == set(want.files)
    for key in want.files:
        scale = max(float(np.abs(want[key]).max()), 1.0)
        np.testing.assert_allclose(got[key], want[key], atol=1e-5 * scale, rtol=0, err_msg=key)
    assert json.loads((folder / "result.json").read_text())["reloaded"] is True


if __name__ == "__main__":
    worker_main()
