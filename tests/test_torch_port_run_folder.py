"""Run folders the JAX package can read: ``log.flatten_dict`` and ``log.get_run_tags`` against the JAX ones,
``train.loop.init_run_dir`` against ``cinema_tpu.log.init_run_dir`` (the folder's name, ``run.json``), what a
port ``run_train`` leaves (``config.yaml`` with the JAX ``save_config``'s bytes, a flat ``run.json``, checked
by ``chip_smoke.check_run_folder`` as on the card), ``tasks.evaluate.run_config`` on the three kinds of
folders, and ``data.nifti.save_nifti_like`` against the JAX function. The JAX package's ``load_run`` and
evaluation of a port-written folder are in ``test_torch_port_run_folder_jax.py``."""

from __future__ import annotations

import importlib.util
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest

from cinema_tpu.config import from_dict as jax_from_dict
from cinema_tpu.config import save_config as jax_save_config
from cinema_tpu.log import flatten_dict as jax_flatten_dict
from cinema_tpu.log import get_run_tags as jax_get_run_tags
from cinema_tpu.log import init_run_dir as jax_init_run_dir
from cinema_tpu_torch.config import PACKAGED, from_dict, load_config
from cinema_tpu_torch.log import flatten_dict, get_run_tags
from cinema_tpu_torch.tasks import evaluate
from cinema_tpu_torch.tasks.regression import acdc as reg_acdc
from cinema_tpu_torch.train.loop import init_run_dir

REPO = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


def _variants():
    """The packaged configs as they are, with a pretrained ``ckpt_path``, with a class column and with a
    regression column, and with a views list and another seed and label proportion."""
    for name in sorted(PACKAGED):
        if "model" not in PACKAGED[name] or "name" not in PACKAGED[name].get("data", {}):
            continue  # the MAE config has no data name: get_run_tags raises, init_run_dir takes no tags
        config = json.loads(json.dumps(PACKAGED[name]))
        yield name, config
        changed = json.loads(json.dumps(config))
        changed["model"]["ckpt_path"] = "/weights/cinema.safetensors"
        changed["data"]["class_column"] = "pathology"
        changed["data"]["regression_column"] = "ef"
        yield f"{name}+pretrained+columns", changed
        other = json.loads(json.dumps(config))
        other["model"]["views"] = ["sax", "lax_4c"]
        other.update(seed=7)
        other["data"]["proportion"] = 0.25
        yield f"{name}+views+seed+proportion", other


VARIANTS = dict(_variants())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_flatten_dict_and_get_run_tags_are_the_jax_ones(name):
    config = VARIANTS[name]
    assert flatten_dict(config) == jax_flatten_dict(config)
    assert list(flatten_dict(config)) == list(jax_flatten_dict(config))
    assert flatten_dict(config, sep=".") == jax_flatten_dict(config, sep=".")
    assert get_run_tags(from_dict(config)) == jax_get_run_tags(jax_from_dict(config))


@pytest.mark.parametrize("name", ["segmentation/acdc", "regression/landmark", "mae"])
def test_init_run_dir_writes_the_jax_record(tmp_path, name):
    """The folder's name and ``run.json`` (tags, flattened config) as ``cinema_tpu.log.init_run_dir`` makes them;
    a config without the tags' keys (the MAE's) takes no tags."""
    config = json.loads(json.dumps(PACKAGED[name]))
    config["logging"]["dir"] = str(tmp_path / "port")
    port = init_run_dir(from_dict(config))
    config["logging"]["dir"] = str(tmp_path / "jax")
    jax = jax_init_run_dir(jax_from_dict(config))
    stamp = r"\d{8}_\d{6}"
    assert re.fullmatch(stamp + re.escape(jax.name[15:]), port.name), (port.name, jax.name)
    assert re.fullmatch(stamp + r"(-[^-]+){0,3}", port.name)
    got, want = (json.loads((d / "run.json").read_text()) for d in (port, jax))
    assert got["tags"] == want["tags"] and got["config"]["logging_dir"] == str(tmp_path / "port")
    want["config"]["logging_dir"] = str(tmp_path / "port")
    assert got["config"] == want["config"] and not any(isinstance(v, dict) for v in got["config"].values())
    time.strptime(got["created"], "%Y-%m-%dT%H:%M:%S")
    # tags given and a folder named
    named = init_run_dir(from_dict(config), tags=["a", "b"], out_dir=tmp_path / "named")
    assert named == tmp_path / "named" and json.loads((named / "run.json").read_text())["tags"] == ["a", "b"]


def _write_studies(data_dir, n=24, seed=0):
    """Synthetic ACDC studies in the processed layout (``train/<pid>/<pid>_sax_{ed,es}.nii.gz``, uint8) and
    ``train_metadata.csv`` with an EF of each study."""
    from cinema_tpu_torch.data import save_nifti

    rng = np.random.default_rng(seed)
    classes = PACKAGED["classification/acdc"]["data"]["pathology"]
    lines = ["pid,n_slices,pathology,ef"]
    for i in range(n):
        image = rng.random((18, 16, 5, 2)) * 50
        image[:, :, i % 4] += 60 + 35 * (i % 5)
        pid = f"patient{i:03d}"
        (data_dir / "train" / pid).mkdir(parents=True)
        for f, frame in enumerate(("ed", "es")):
            save_nifti(data_dir / "train" / pid / f"{pid}_sax_{frame}.nii.gz", image[..., f].astype(np.uint8))
        lines.append(f"{pid},5,{classes[i % 5]},{20.0 + 5.0 * (i % 5) + rng.normal():.4f}")
    (data_dir / "train_metadata.csv").write_text("\n".join(lines) + "\n")


def tiny_regression_run(root: Path) -> tuple:
    """(config, run folder) of one CPU epoch of the port's ACDC regression ``run_train`` with the tiny ConvViT
    of the regression example checkpoint, written under ``root``."""
    config = load_config(next((REPO / "tests" / "fixtures" / "example_ckpts").glob("reg-*/reg.yaml")))
    _write_studies(root / "studies")
    config.data.dir = str(root / "studies")
    config.logging.dir = str(root / "runs")
    config.train.update(n_epochs=1, n_warmup_epochs=1, eval_interval=1, batch_size=4, batch_size_per_device=2,
                        n_workers=2)
    return config, reg_acdc.run(config, device="cpu")


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return tiny_regression_run(tmp_path_factory.mktemp("port_run"))


def test_run_train_writes_a_folder_the_jax_package_reads(port_run, tmp_path):
    config, folder = port_run
    assert folder.parent == Path(config.logging.dir)
    assert {"config.yaml", "run.json", "metrics.jsonl", "model_0.safetensors"} <= {p.name for p in folder.iterdir()}
    jax_save_config(jax_from_dict(json.loads(json.dumps(config))), tmp_path / "jax.yaml")
    assert (folder / "config.yaml").read_bytes() == (tmp_path / "jax.yaml").read_bytes()
    chip_smoke.check_run_folder("regression", config, folder)  # the check of the card's run
    assert chip_smoke.RUN_FOLDERS["regression"]["name"] == folder.name
    assert evaluate.run_config(folder) == config


def test_run_config_reads_an_older_nested_run_json_and_refuses_a_flat_one(port_run, tmp_path):
    config, folder = port_run
    older = tmp_path / "older"
    older.mkdir()
    (older / "run.json").write_text(json.dumps({"tags": ["regression", "acdc"], "config": config}))
    assert evaluate.run_config(older) == config
    flat = tmp_path / "flat"
    flat.mkdir()
    (flat / "run.json").write_bytes((folder / "run.json").read_bytes())
    with pytest.raises(FileNotFoundError, match="flattened"):
        evaluate.run_config(flat)
    with pytest.raises(FileNotFoundError, match="neither"):
        evaluate.run_config(tmp_path / "nothing")


def test_check_run_folder_fails_on_a_folder_of_another_format(port_run, tmp_path):
    import shutil

    config, folder = port_run
    other = shutil.copytree(folder, tmp_path / "20260101-000000-regression-acdc")
    with pytest.raises(SystemExit):
        chip_smoke.check_run_folder("renamed", config, other)
    (folder_copy := shutil.copytree(folder, tmp_path / folder.name)).joinpath("config.yaml").unlink()
    with pytest.raises(SystemExit):
        chip_smoke.check_run_folder("no yaml", config, folder_copy)


def _jax_and_port(tmp_path, array, reference, name):
    """The file that each package's ``save_nifti_like`` writes, or the error type it raises."""
    from cinema_tpu.data.nifti import save_nifti_like as jax_save_nifti_like
    from cinema_tpu_torch.data import save_nifti_like

    from tests.test_torch_port_preprocess import gzip_clock_at_zero

    out = []
    for side, fn in (("jax", jax_save_nifti_like), ("port", save_nifti_like)):
        path = tmp_path / side / name
        try:
            with gzip_clock_at_zero():
                fn(array, reference, path)
            out.append(path.read_bytes())
        except ValueError as e:
            out.append(type(e))
    return out


@pytest.mark.parametrize("case", ["same-4d", "3d-of-4d", "clamped-frames", "other-size", "no-reference"])
def test_save_nifti_like_is_the_jax_function(tmp_path, case):
    """The cases of tests/test_data.py test_save_nifti_like, in file bytes where both write."""
    from cinema_tpu_torch.data import load_nifti, save_nifti

    rng = np.random.default_rng(3)
    ref = rng.normal(size=(6, 5, 4, 9)).astype(np.float32)
    ref_path = tmp_path / "ref.nii.gz"
    affine = np.eye(4)
    affine[:3, :3] = np.diag([1.0, 1.25, 10.0]) @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    affine[:3, 3] = (-3.0, 4.5, 20.0)
    save_nifti(ref_path, ref, spacing=(1.0, 1.25, 10.0, 1.0), affine=affine)
    array, reference, shape = {
        "same-4d": (np.ones_like(ref), ref_path, (6, 5, 4, 9)),
        "3d-of-4d": (np.ones((6, 5, 4), np.float32), ref_path, (6, 5, 4)),
        "clamped-frames": (np.ones((6, 5, 4, 12), np.float32), ref_path, (6, 5, 4, 9)),
        "other-size": (np.ones((7, 5, 4, 9), np.float32), ref_path, None),
        "no-reference": (np.ones((6, 5, 4), np.float32), None, (6, 5, 4)),
    }[case]
    jax_out, port_out = _jax_and_port(tmp_path, array, reference, "out.nii.gz")
    assert jax_out == port_out
    if shape is None:
        assert port_out is ValueError
        return
    back, header = load_nifti(tmp_path / "port" / "out.nii.gz")
    assert back.shape == shape
    if reference is not None:
        np.testing.assert_allclose(header.spacing[:3], (1.0, 1.25, 10.0), rtol=1e-6)
        np.testing.assert_allclose(header.affine, affine, rtol=1e-6, atol=1e-6)
