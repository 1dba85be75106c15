"""The port's distribution (``cinema_tpu_torch.parallel``) against the JAX package's
(``cinema_tpu.parallel``, ``cinema_tpu.train.loop.pick_n_data``) in one process: the manifest shards,
the data-parallel width, the tensor-parallel class of every parameter of a tiny CineMA (with and
without SwiGLU, at ``n_model`` 2 and 8), the head order of a sharded fused kv projection, and the
loader's shard. The last test runs the pretraining and the ACDC classification entry points in a subprocess
without a process group and in a one-rank gloo group (``mesh.multiprocess=true``): the same bits.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cinema_tpu_torch.config import load_config
from cinema_tpu_torch.convert import _flatten, torch_key
from cinema_tpu_torch.data import BatchLoader
from cinema_tpu_torch.factory import get_mae_model
from cinema_tpu_torch.models.vit import Attention
from cinema_tpu_torch.parallel import multihost
from cinema_tpu_torch.parallel.mesh import COLUMN, REPLICATED, ROW, _rows, param_spec
from cinema_tpu_torch.train.loop import pick_n_data

REPO = Path(__file__).resolve().parents[1]
FIXTURE = next((REPO / "tests" / "fixtures" / "example_ckpts").glob("mae-*"))


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_shard_manifest_is_the_jax_packages(seed):
    from cinema_tpu.parallel.multihost import shard_manifest as jax_shard

    for n in (0, 1, 5, 8, 13):
        items = [f"pid{i}" for i in range(n)]
        for world in (1, 2, 3, 4, 8):
            shards = []
            for rank in range(world):
                got = multihost.shard_manifest(items, rank, world, shuffle_seed=seed)
                assert got == jax_shard(items, rank, world, shuffle_seed=seed), (n, world, rank, seed)
                shards.append(got)
            if n:
                assert len({len(s) for s in shards}) == 1 and set(sum(shards, [])) == set(items)


def test_shard_manifest_defaults_to_the_data_shard_of_the_mesh():
    items = list(range(10))
    # without a process group the defaults are rank 0 of 1; without a mesh the data shard is too
    assert multihost.data_shard(None) == (0, 1) and multihost.shard_manifest(items, shuffle_seed=3) == items

    class Mesh:  # a 2x2 mesh seen from rank 3: data coordinate 1 of 2
        def get_local_rank(self, axis):
            assert axis == "data"
            return 1

        def size(self, axis):
            return 2

    assert multihost.data_shard(Mesh()) == (1, 2)
    got = multihost.shard_manifest(items, *multihost.data_shard(Mesh()), shuffle_seed=3)
    assert got == multihost.shard_manifest(items, 1, 2, shuffle_seed=3) and len(got) == 5


def test_pick_n_data_is_the_jax_packages():
    from cinema_tpu.train.loop import pick_n_data as jax_pick

    for n_devices in (1, 2, 3, 4, 8):
        for batch_size in (1, 2, 4, 6, 8, 16, 64):
            for per_device in (1, 2, 4, 16):
                for n_samples in (1, 3, 8, 100):
                    args = (n_devices, batch_size, per_device, n_samples)
                    assert pick_n_data(*args) == jax_pick(*args), args


def _jax_class(spec) -> str:
    spec = tuple(spec)
    if spec == (None, "model"):
        return COLUMN
    if spec == ("model",):
        return COLUMN
    if spec == ("model", None):
        return ROW
    assert all(s is None for s in spec), spec
    return REPLICATED


@pytest.mark.parametrize("n_model", [2, 8])
@pytest.mark.parametrize("mlp_type", ["mlp", "swiglu"])
def test_param_spec_gives_the_jax_class_of_every_parameter(n_model, mlp_type):
    from cinema_tpu.config import load_config as jax_load_config
    from cinema_tpu.factory import get_mae_model as jax_get_mae_model
    from cinema_tpu.parallel.mesh import make_mesh, param_shardings

    config = load_config(FIXTURE / "mae.yaml")
    port = get_mae_model(config, device="cpu", mlp_type=mlp_type)
    jmodel = jax_get_mae_model(jax_load_config(FIXTURE / "mae.yaml")).clone(mlp_type=mlp_type)
    example = {v: jax.numpy.zeros((1, *jmodel.image_size_dict[v], 1)) for v in jmodel.image_size_dict}
    params = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                                                example, 0.75))["params"]
    shardings = param_shardings(params, make_mesh(n_data=1, n_model=n_model))
    want = {torch_key(path): _jax_class(s.spec) for path, s in _flatten(shardings).items()}
    got = {name: param_spec(name, p, n_model) for name, p in port.named_parameters()}
    assert set(got) == set(want)
    assert got == want
    classes = set(got.values())
    assert classes == {COLUMN, ROW, REPLICATED}
    # the attention and MLP layers of the ViT blocks, the only ones parallelize shards
    for name, p in port.named_parameters():
        if ".blocks." in name and name.endswith(("attn.q.weight", "attn.kv.weight", "mlp.fc1.weight",
                                                 "mlp.fc1_g.weight", "mlp.fc1_x.weight")):
            assert got[name] == COLUMN, name
        if ".blocks." in name and name.endswith(("attn.proj.weight", "mlp.fc2.weight")):
            assert got[name] == ROW, name


@pytest.mark.parametrize("n_heads,n_model", [(2, 2), (6, 2), (6, 3), (12, 4)])
def test_a_sharded_kv_keeps_the_k_and_v_rows_of_its_heads(n_heads, n_model):
    embed, head_dim = n_heads * 8, 8
    attn = Attention(embed, n_heads)
    x = torch.randn(3, 5, embed, generator=torch.Generator().manual_seed(0))
    kv_out = attn.kv(x).view(3, 5, 2, n_heads, head_dim)
    parts = [_rows(2 * embed, r, n_model, kv=True) for r in range(n_model)]
    # the shards together are every row once, and gathered in rank order they give kv back
    weight = attn.kv.weight.detach()
    full = torch.empty_like(weight)
    for idx in parts:
        full.index_copy_(0, idx, weight.index_select(0, idx))
    assert torch.equal(full, weight) and torch.equal(torch.sort(torch.cat(parts)).values, torch.arange(2 * embed))
    per = n_heads // n_model
    for r, idx in enumerate(parts):
        local = torch.nn.functional.linear(x, weight[idx], attn.kv.bias.detach()[idx]).view(3, 5, 2, per, head_dim)
        # the local kv is (2, heads of rank r, head_dim): rank r's k and v heads, as the packed kernel reads them
        torch.testing.assert_close(local, kv_out[:, :, :, r * per : (r + 1) * per], rtol=0, atol=1e-6)
    # a plain split of the output dimension would give one rank the k half and the other the v half
    assert not torch.equal(parts[0], torch.arange(2 * embed // n_model))


def test_a_column_and_a_row_split_give_the_dense_output():
    from cinema_tpu_torch.models.vit import Mlp

    mlp = Mlp(16, 64)
    x = torch.randn(2, 3, 16, generator=torch.Generator().manual_seed(1))
    want = mlp(x)
    got = 0
    for r in range(4):
        rows = _rows(64, r, 4, kv=False)
        h = torch.nn.functional.gelu(torch.nn.functional.linear(x, mlp.fc1.weight[rows], mlp.fc1.bias[rows]))
        got = got + torch.nn.functional.linear(h, mlp.fc2.weight[:, rows])
    torch.testing.assert_close(got + mlp.fc2.bias, want, rtol=1e-5, atol=1e-6)


def test_the_loaders_shard_is_the_jax_loaders():
    from cinema_tpu.data.datasets import BatchLoader as JaxLoader

    class Items:
        def __len__(self):
            return 11

        def load(self, index, epoch=0):
            return {"x": np.array([index])}

        def __getitem__(self, index):
            return self.load(index)

    for rank in range(3):
        loader = BatchLoader(Items(), 2, seed=5, process_shard=(rank, 3))
        jax_loader = JaxLoader(Items(), 2, shuffle=True, drop_last=True, n_workers=1, seed=5, process_shard=True)
        jax_loader._shard_info = lambda rank=rank: (rank, 3)
        for epoch in range(2):
            jax_batches = [b["x"].tolist() for b in jax_loader]
            assert [b["x"].tolist() for b in loader.epoch(epoch)] == jax_batches
        assert len(loader) == len(jax_loader) == 2


_ONE_RANK = """
import os, sys
from cinema_tpu_torch.tasks import pretrain
from cinema_tpu_torch.tasks.classification import acdc
args = sys.argv[1:]
name, multiprocess = args[0], args[1]
if multiprocess == "true":
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=args[2], RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
main = pretrain.main if name == "pretrain" else acdc.main
main(["--device", "cpu", *args[3:], f"mesh.multiprocess={multiprocess}"])
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_one_rank_group_takes_the_single_process_steps_bit_for_bit(tmp_path):
    from test_torch_port_finetune import _fixture, _write_studies
    from test_torch_port_pretrain import OVERRIDES
    from test_torch_port_pretrain_nifti import FIT_LAX, FIT_SAX, write_ukb_tree

    write_ukb_tree(tmp_path / "ukb", 4, views=("sax", "lax_2c"), sax_sizes=FIT_SAX, lax_sizes=FIT_LAX)
    _write_studies(tmp_path / "acdc")
    jobs = {"pretrain": ["--config", str(FIXTURE / "mae.yaml"), f"data.dir={tmp_path / 'ukb'}", *OVERRIDES,
                         "train.n_epochs=1", "train.n_warmup_epochs=0"],
            "classification": ["--config", str(_fixture("clf")[1]), f"data.dir={tmp_path / 'acdc'}", "train.n_epochs=2",
                               "train.n_warmup_epochs=1", "train.eval_interval=1", "train.batch_size=4",
                               "train.batch_size_per_device=2", "train.lr=3e-3"]}
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}  # four processes beside the other tests
    procs = {}
    for name, argv in jobs.items():
        for multiprocess in ("false", "true"):
            runs = tmp_path / f"runs_{name}_{multiprocess}"
            procs[name, multiprocess] = subprocess.Popen(
                [sys.executable, "-c", _ONE_RANK, name, multiprocess, str(_free_port()), *argv, f"logging.dir={runs}"],
                env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        out, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, (key, out[-3000:])
        assert ("distributed: rank 0/1 (gloo)" in out) == (key[1] == "true"), out[-3000:]
    from cinema_tpu_torch.convert import load_safetensors

    for name in jobs:
        (single,), (grouped,) = ((tmp_path / f"runs_{name}_{m}").iterdir() for m in ("false", "true"))
        records = [[json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
                   for run in (single, grouped)]
        timed = "clips_per_sec_per_chip"  # the epoch's rate: a clock's reading
        assert [{k: v for k, v in r.items() if k != timed} for r in records[0]] == \
            [{k: v for k, v in r.items() if k != timed} for r in records[1]] and records[0]
        exports = [sorted(run.glob("*.safetensors")) for run in (single, grouped)]
        assert [p.name for p in exports[0]] == [p.name for p in exports[1]] and exports[0]
        for a, b in zip(*exports):
            want, got = load_safetensors(a), load_safetensors(b)
            assert set(want) == set(got) and all(np.array_equal(want[k], got[k]) for k in want), name
        ckpts = [torch.load(next(run.glob("ckpt_*.pt")), weights_only=True) for run in (single, grouped)]
        assert ckpts[0]["step"] == ckpts[1]["step"] > 0
        for key in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(ckpts[0]["opt_state"][key], ckpts[1]["opt_state"][key]))
