"""The port stands alone: importing every module of ``cinema_tpu_torch`` pulls
in neither jax nor the JAX package, nor PIL, matplotlib, pandas or PyYAML, which
the card's machine does not have; and its entry points, the example scripts
among them, run on the card unless the caller asks for the CPU. (The
preprocessing CLIs do no device work, as in the JAX package, and take no
device.)"""

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
# the names of the last slice, which the port imports from modules of earlier slices
from cinema_tpu_torch.config import merge, save_config
from cinema_tpu_torch.data import read_png_gray, save_nifti_like
from cinema_tpu_torch.log import flatten_dict, get_run_tags
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cinema_tpu", "PIL", "matplotlib", "pandas",
                                    "yaml"))
print(len(names), bad)
print(" ".join(names))
"""

# every module that the pretraining slice added must be among those imported
PRETRAIN_MODULES = {
    "cinema_tpu_torch.models.mae", "cinema_tpu_torch.ops.masking", "cinema_tpu_torch.ops.sparse_cells",
    "cinema_tpu_torch.tasks.pretrain", "cinema_tpu_torch.train.checkpoint", "cinema_tpu_torch.train.fused_optim",
    "cinema_tpu_torch.train.loop", "cinema_tpu_torch.train.optim", "cinema_tpu_torch.train.state",
}

# and every module that the fine-tuning slice added
FINETUNE_MODULES = {
    "cinema_tpu_torch.data", "cinema_tpu_torch.losses", "cinema_tpu_torch.metrics", "cinema_tpu_torch.ops.rotary",
    "cinema_tpu_torch.tasks.classification", "cinema_tpu_torch.tasks.classification.acdc",
    "cinema_tpu_torch.tasks.regression", "cinema_tpu_torch.tasks.regression.acdc",
}

# and every module that the segmentation fine-tuning slice added
SEGMENTATION_MODULES = {
    "cinema_tpu_torch.tasks.cli", "cinema_tpu_torch.tasks.segmentation", "cinema_tpu_torch.tasks.segmentation.acdc",
}

# and every module that the landmark slice added
LANDMARK_MODULES = {"cinema_tpu_torch.tasks.segmentation.landmark", "cinema_tpu_torch.tasks.regression.landmark"}

# and every module of the processed-NIfTI slice: the data package and the M&Ms and M&Ms2 tasks
NIFTI_MODULES = {
    "cinema_tpu_torch.data.datasets", "cinema_tpu_torch.data.nifti", "cinema_tpu_torch.data.transforms",
    "cinema_tpu_torch.tasks.edes",
    *(f"cinema_tpu_torch.tasks.{family}.{name}" for family in ("classification", "regression", "segmentation")
      for name in ("mnms", "mnms2")),
}

# and every module of the cine slice: the EMIDEC, MyoPS2020, Rescan and Kaggle tasks and the evaluation
CINE_MODULES = {"cinema_tpu_torch.tasks.evaluate",
                *(f"cinema_tpu_torch.tasks.segmentation.{name}"
                  for name in ("emidec", "myops2020", "rescan", "kaggle", "rescan_ef_eval"))}

# and every module of the baselines slice: the UNet and the ResNet
BASELINE_MODULES = {"cinema_tpu_torch.models.unet", "cinema_tpu_torch.models.resnet"}

# and every module of the examples slice: the example scripts, their shared helpers, viz and the constants
INFERENCE_EXAMPLES = ["segmentation_sax", "segmentation_lax_4c", "classification_cvd", "classification_sex",
                      "classification_vendor", "regression_age", "regression_bmi", "regression_ef",
                      "landmark_heatmap", "landmark_coordinate", "mae", "mae_feature_extraction"]
TRAIN_EXAMPLES = ["classification", "regression", "segmentation", "pretrain"]
EXAMPLE_MODULES = {
    "cinema_tpu_torch.viz", "cinema_tpu_torch.constants", "cinema_tpu_torch.examples",
    "cinema_tpu_torch.examples.common", "cinema_tpu_torch.examples.inference", "cinema_tpu_torch.examples.train",
    "cinema_tpu_torch.examples.inference.edes",
    *(f"cinema_tpu_torch.examples.inference.{name}" for name in INFERENCE_EXAMPLES),
    *(f"cinema_tpu_torch.examples.train.{name}" for name in TRAIN_EXAMPLES),
}

# and every module of the preprocessing slice: the logger, the DICOM reader, the geometry, Volume and the CLIs
PREPROCESS_CLI_MODULES = ["acdc", "mnms", "mnms2", "emidec", "myops2020", "landmark", "reindex", "kaggle", "rescan",
                          "ukb_dicom", "dicom_based"]
PREPROCESS_MODULES = {
    "cinema_tpu_torch.log", "cinema_tpu_torch.data.dicom", "cinema_tpu_torch.data.geometry",
    "cinema_tpu_torch.data.volume", "cinema_tpu_torch.data.preprocess",
    *(f"cinema_tpu_torch.data.preprocess.{name}" for name in PREPROCESS_CLI_MODULES),
}

# and every module of the native-reader and distribution slice
DISTRIBUTION_MODULES = {"cinema_tpu_torch.native", "cinema_tpu_torch.parallel", "cinema_tpu_torch.parallel.mesh",
                        "cinema_tpu_torch.parallel.multihost"}

# and every module of the last slice: the PNG reader, the YAML writer and the cine_cmr example
LAST_SLICE_MODULES = {"cinema_tpu_torch.data.png", "cinema_tpu_torch.yaml_writer", "cinema_tpu_torch.examples.cine_cmr"}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300, check=True
    )
    first, names = proc.stdout.splitlines()
    n_modules, bad = first.split(" ", 1)
    assert int(n_modules) >= 54 + len(PREPROCESS_MODULES) + len(DISTRIBUTION_MODULES), proc.stdout
    assert bad.strip() == "[]", proc.stdout
    assert len(PREPROCESS_MODULES) == 16
    wanted = (PRETRAIN_MODULES | FINETUNE_MODULES | SEGMENTATION_MODULES | LANDMARK_MODULES | NIFTI_MODULES
              | CINE_MODULES | BASELINE_MODULES | EXAMPLE_MODULES | PREPROCESS_MODULES | DISTRIBUTION_MODULES
              | LAST_SLICE_MODULES)
    assert wanted <= set(names.split()), proc.stdout


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


@pytest.mark.parametrize("task", ["classification", "regression", "segmentation", "segmentation/landmark",
                                  "regression/landmark", *(f"{family}/{name}" for name in ("mnms", "mnms2")
                                                           for family in ("classification", "regression",
                                                                          "segmentation"))])
def test_packaged_finetune_configs_are_the_jax_packages_yamls(task):
    import yaml

    name = task if "/" in task else f"{task}/acdc"
    with open(REPO / "cinema_tpu" / "configs" / f"{name}.yaml") as f:
        assert yaml.safe_load(f) == PACKAGED[name]


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_finetune_factory_and_entry_points_default_to_the_card(task, tmp_path):
    _no_card()
    import importlib

    acdc = importlib.import_module(f"cinema_tpu_torch.tasks.{task}.acdc")
    config = from_dict(PACKAGED[f"{task}/acdc"])
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.get_convvit_model(config)
    config.data.dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        acdc.run(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        acdc.main([f"data.dir={tmp_path}"])
    clf = next((REPO / "tests" / "fixtures" / "example_ckpts").glob("clf-*"))
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.from_finetuned("convvit", clf / "clf.safetensors", clf / "clf.yaml")


def test_segmentation_factory_and_entry_point_default_to_the_card(tmp_path):
    _no_card()
    from cinema_tpu_torch.tasks.segmentation import acdc

    config = from_dict(PACKAGED["segmentation/acdc"])
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.get_segmentation_model(config)
    config.data.dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        acdc.run(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        acdc.main([f"data.dir={tmp_path}"])


@pytest.mark.parametrize("task", ["segmentation", "regression"])
def test_landmark_factory_and_entry_point_default_to_the_card(task, tmp_path):
    _no_card()
    import importlib

    landmark = importlib.import_module(f"cinema_tpu_torch.tasks.{task}.landmark")
    config = from_dict(PACKAGED[f"{task}/landmark"])
    build = factory.get_segmentation_model if task == "segmentation" else factory.get_convvit_model
    with pytest.raises(RuntimeError, match="CUDA"):
        build(config)
    config.data.dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        landmark.run(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        landmark.main([f"data.dir={tmp_path}"])


@pytest.mark.parametrize("name", ["emidec", "myops2020", "rescan"])
def test_cine_slice_entry_points_default_to_the_card(name, tmp_path):
    _no_card()
    import importlib

    entry = importlib.import_module(f"cinema_tpu_torch.tasks.segmentation.{name}")
    config = from_dict(PACKAGED[f"segmentation/{name}"])
    config.data.dir = str(tmp_path)
    (tmp_path / "train_metadata.csv").write_text("pid,n_slices,n_frames\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.run(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main([f"data.dir={tmp_path}"])


def test_evaluation_entry_points_default_to_the_card(tmp_path):
    _no_card()
    import json

    from cinema_tpu_torch.tasks import evaluate
    from cinema_tpu_torch.tasks.segmentation import rescan_ef_eval

    (tmp_path / "run.json").write_text(json.dumps({"config": PACKAGED["segmentation/rescan"]}))
    (tmp_path / "model_0.safetensors").write_bytes(b"")
    for entry in (evaluate.main, rescan_ef_eval.main, evaluate.main_rescan_seg):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(["--folder_path", str(tmp_path)])


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


@pytest.mark.parametrize("task,name", [("segmentation/acdc", "unet"), ("classification/acdc", "resnet"),
                                       ("regression/acdc", "resnet")])
def test_baseline_factories_default_to_the_card(task, name):
    _no_card()
    from cinema_tpu_torch.tasks.classification import get_classification_model

    config = from_dict(PACKAGED[task])
    config.model.name = name
    build = factory.get_segmentation_model if name == "unet" else get_classification_model
    with pytest.raises(RuntimeError, match="CUDA"):
        build(config)


def _fixture(name):
    folder = next((REPO / "tests" / "fixtures" / "example_ckpts").glob(f"{name}-*"))
    return ["--model", str(folder / f"{name}.safetensors"), "--config", str(folder / f"{name}.yaml")]


_EXAMPLE_ARGS = {
    "segmentation_sax": [*_fixture("seg_sax"), "--image", "cine.nii.gz"],
    "segmentation_lax_4c": [*_fixture("seg_lax"), "--image", "cine.nii.gz"],
    "landmark_heatmap": [*_fixture("lmk_heat"), "--image", "image.png"],
    "landmark_coordinate": [*_fixture("lmk_coord"), "--image", "image.png"],
    "mae": [*_fixture("mae"), "--study_dir", "study"],
    "mae_feature_extraction": [*_fixture("mae"), "--study_dir", "study"],
}


@pytest.mark.parametrize("name", INFERENCE_EXAMPLES)
def test_inference_examples_default_to_the_card(name):
    """Without ``--device`` the script asks for the card before it loads a model or reads an input."""
    _no_card()
    import importlib

    module = importlib.import_module(f"cinema_tpu_torch.examples.inference.{name}")
    model = "clf" if name.startswith("classification") else "reg"
    argv = _EXAMPLE_ARGS.get(name, [*_fixture(model), "--ed", "ed.nii.gz", "--es", "es.nii.gz"])
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(argv)


@pytest.mark.parametrize("name", TRAIN_EXAMPLES)
def test_train_examples_default_to_the_card(name, tmp_path):
    """Without ``--device`` the tutorial asks for the card before it reads the data."""
    _no_card()
    import importlib

    module = importlib.import_module(f"cinema_tpu_torch.examples.train.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(["--data_dir", str(tmp_path / "missing")])


def test_mae_from_pretrained_defaults_to_the_card():
    _no_card()
    mae = _fixture("mae")
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.mae_from_pretrained(mae[1], mae[3])
