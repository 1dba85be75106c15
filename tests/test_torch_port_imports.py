"""The port stands alone: importing every module of ``cinema_tpu_torch`` pulls
in neither jax nor the JAX package, and its entry points run on the card
unless the caller asks for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cinema_tpu_torch import factory
from cinema_tpu_torch.config import PACKAGED, from_dict

REPO = Path(__file__).resolve().parents[1]
SEG_SAX = next((REPO / "tests" / "fixtures" / "example_ckpts").glob("seg_sax-*"))

_PROBE = """
import importlib, pkgutil, sys
import cinema_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cinema_tpu_torch.__path__, "cinema_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cinema_tpu"))
print(len(names), bad)
print(" ".join(names))
"""

# every module that the pretraining slice added must be among those imported
PRETRAIN_MODULES = {
    "cinema_tpu_torch.models.mae", "cinema_tpu_torch.ops.masking", "cinema_tpu_torch.ops.sparse_cells",
    "cinema_tpu_torch.tasks.pretrain", "cinema_tpu_torch.train.checkpoint", "cinema_tpu_torch.train.fused_optim",
    "cinema_tpu_torch.train.loop", "cinema_tpu_torch.train.optim", "cinema_tpu_torch.train.state",
}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300, check=True
    )
    first, names = proc.stdout.splitlines()
    n_modules, bad = first.split(" ", 1)
    assert int(n_modules) >= 28, proc.stdout
    assert bad.strip() == "[]", proc.stdout
    assert PRETRAIN_MODULES <= set(names.split()), proc.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")


def test_model_factory_defaults_to_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.get_convunetr_model(from_dict(PACKAGED["segmentation/acdc"]))


def test_mae_factory_and_pretraining_default_to_the_card(tmp_path):
    _no_card()
    from cinema_tpu_torch.tasks import pretrain

    config = from_dict(PACKAGED["mae"])
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.get_mae_model(config)
    config.data.dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.run(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.main([f"data.dir={tmp_path}"])


def test_packaged_mae_config_is_the_jax_packages_yaml():
    import yaml

    with open(REPO / "cinema_tpu" / "configs" / "mae.yaml") as f:
        assert yaml.safe_load(f) == PACKAGED["mae"]


def test_from_finetuned_defaults_to_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.from_finetuned("convunetr", SEG_SAX / "seg_sax.safetensors", SEG_SAX / "seg_sax.yaml")


def test_init_weights_is_seeded_and_device_independent():
    config = from_dict(PACKAGED["segmentation/acdc"])
    config.model.convunetr.size = "tiny"
    config.data.sax.patch_size = [16, 16, 4]
    a = factory.init_weights(factory.get_convunetr_model(config, device="cpu"), seed=3)
    b = factory.init_weights(factory.get_convunetr_model(config, device="cpu"), seed=3)
    c = factory.init_weights(factory.get_convunetr_model(config, device="cpu"), seed=4)
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
        if p.ndim > 1:
            assert not torch.equal(p, r), name


def test_chip_smoke_imports_only_the_port():
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    modules = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    modules |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    roots = {m.split(".")[0] for m in modules}
    assert "cinema_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "cinema_tpu"}, roots


def test_chip_smoke_fails_without_a_card():
    _no_card()
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
