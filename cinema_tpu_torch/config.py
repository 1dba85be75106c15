"""Hierarchical config with attribute access (port of cinema_tpu/config.py).

Same YAML schema as the JAX package, so the published config.yaml files
rebuild the same models. YAML is read and written by the port's own reader
and writer (:mod:`cinema_tpu_torch.yaml_reader`, :mod:`cinema_tpu_torch.yaml_writer`):
the machine with the card has no PyYAML. :func:`save_config` writes the bytes
the JAX package's ``save_config`` writes. :data:`PACKAGED` holds the configs
the entry points default to.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, Union

from cinema_tpu_torch import yaml_reader, yaml_writer


class Config(dict):
    """Dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)


def _wrap(value: Any) -> Any:
    if isinstance(value, dict):
        return Config({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def from_dict(d: Dict[str, Any]) -> Config:
    """Wrap a nested dict into a Config (a deep copy)."""
    return _wrap(dict(d))


def load_config(path: Union[str, Path]) -> Config:
    """Load a YAML config file."""
    return from_dict(yaml_reader.load(path) or {})


def save_config(config: Dict[str, Any], path: Union[str, Path]) -> None:
    """Write a config as YAML, the bytes of the JAX package's ``save_config``
    (``yaml.safe_dump(config.to_dict(), f, sort_keys=False)``); the Configs in it are written as the plain
    mappings they are."""
    yaml_writer.dump(_unwrap(config), path)


def merge(base: Dict[str, Any], override: Dict[str, Any]) -> Config:
    """Deep-merge ``override`` into ``base``, the override winning, as a new Config (cinema_tpu/config.py:74-82):
    a mapping that meets a mapping is merged key by key, anything else replaces."""
    out = from_dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = _wrap(v)
    return out


def apply_overrides(config: Config, overrides: List[str]) -> Config:
    """Apply dotted ``key.sub=value`` overrides, each value read as a YAML document (as the JAX package's
    ``yaml.safe_load``); a parent key that holds no mapping is replaced by one."""
    config = from_dict(config)
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"Override {item!r} is not of the form key=value.")
        value = yaml_reader.loads(raw)
        *parents, leaf = key.split(".")
        node = config
        for part in parents:
            if not isinstance(node.get(part), dict):
                node[part] = Config()
            node = node[part]
        node[leaf] = _wrap(value)
    return config


# cinema_tpu/configs/segmentation/acdc.yaml: ConvUNetR (ViT-base) on the ED and ES
# frames of ACDC SAX, fine-tuned for segmentation; serving reads its model section
ACDC_SEGMENTATION = {
    "task": "segmentation",
    "seed": 0,
    "grad_ckpt": True,
    "logging": {"dir": "runs"},
    "data": {
        "name": "acdc",
        "dir": "~/.cache/cinema_datasets/acdc/processed",
        "sax": {"spacing": [1.0, 1.0, 10.0], "patch_size": [192, 192, 16], "in_chans": 1},
        "max_n_samples": -1,
        "proportion": 1.0,
    },
    "transform": {
        "prob": 0.5,
        "gamma": [0.5, 1.5],
        "scale_range": 0.2,
        "sax": {"rotate_range": [0, 0, 180], "translate_range": [60, 60, 0], "dropout_size": [40, 40, 2]},
    },
    "train": {
        "n_workers": 4,
        "clip_grad": 5.0,
        "weight_decay": 0.05,
        "layer_decay": 0.75,
        "betas": [0.9, 0.95],
        "lr": 1.0e-3,
        "min_lr": 1.0e-5,
        "n_warmup_epochs": 50,
        "n_epochs": 4000,
        "max_n_ckpts": 1,
        "batch_size": 64,
        "batch_size_per_device": 4,
        "eval_interval": 100,
        "early_stopping": {"metric": "val_mean_dice_score", "mode": "max", "patience": 5, "min_delta": 1.0e-4},
    },
    "model": {
        "name": "convunetr",
        "ckpt_path": None,
        "freeze_pretrained": False,
        "views": "sax",
        "out_chans": 4,
        "convunetr": {
            "size": "base",
            "enc_patch_size": [4, 4, 1],
            "enc_scale_factor": [2, 2, 1],
            "enc_conv_chans": [64, 128],
            "enc_conv_n_blocks": 2,
            "dec_chans": [32, 64, 128, 256, 512],
            "dec_patch_size": [2, 2, 1],
            "dec_scale_factor": [2, 2, 1],
            "dropout": 0.1,
            "drop_path": 0.1,
        },
        "unet": {"chans": [32, 64, 128, 256, 512], "dropout": 0.1, "patch_size": [2, 2, 1], "scale_factor": [2, 2, 1]},
    },
}

# cinema_tpu/configs/mae.yaml: CineMA (ViT-base) MAE pretraining on four views
MAE_PRETRAIN = {
    "seed": 0,
    "grad_ckpt": True,
    "logging": {"dir": "runs"},
    "data": {
        "dir": None,
        "max_n_samples": -1,
        "sax": {"spacing": [1.0, 1.0, 10.0], "patch_size": [192, 192, 16], "in_chans": 1},
        "lax": {"spacing": [1.0, 1.0], "patch_size": [256, 256], "in_chans": 1},
    },
    "transform": {
        "prob": 0.5,
        "scale_range": 0.2,
        "sax": {"rotate_range": [0, 0, 180], "translate_range": [48, 48, 0]},
        "lax": {"rotate_range": [180], "translate_range": [64, 64]},
    },
    "train": {
        "ckpt_path": None,
        "n_workers_per_device": 16,
        "clip_grad": 5.0,
        "weight_decay": 0.05,
        "betas": [0.9, 0.95],
        "lr": 1.0e-3,
        "min_lr": 1.0e-6,
        "n_warmup_epochs": 10,
        "n_epochs": 800,
        "max_n_ckpts": 1,
        "batch_size": 64,
        "batch_size_per_device": 16,
        "enc_mask_ratio": 0.75,
    },
    "mesh": {"n_model": 1, "fsdp": False},
    "model": {
        "size": "base",
        "views": ["sax", "lax_2c", "lax_3c", "lax_4c"],
        "ckpt_path": None,
        "patch_size": [4, 4, 1],
        "scale_factor": [2, 2, 1],
        "enc_conv_chans": [64, 128],
        "enc_conv_n_blocks": 2,
    },
}



def _acdc_finetune(task: str, data: Dict[str, Any], early_stopping: Dict[str, Any]) -> Dict[str, Any]:
    """cinema_tpu/configs/{classification,regression}/acdc.yaml: ConvViT (ViT-base) on the
    ED + ES frames of ACDC; the two files differ in the data columns and the early-stopping metric."""
    return {
        "task": task,
        "seed": 0,
        "grad_ckpt": True,
        "logging": {"dir": "runs"},
        "data": {
            "name": "acdc",
            "dir": "~/.cache/cinema_datasets/acdc/processed",
            "sax": {"spacing": [1.0, 1.0, 10.0], "patch_size": [192, 192, 16], "in_chans": 1},
            "lax": {"spacing": [1.0, 1.0], "patch_size": [256, 256], "in_chans": 1},
            "max_n_samples": -1,
            "proportion": 1.0,
            **data,
        },
        "transform": {
            "prob": 0.5,
            "gamma": [0.5, 1.5],
            "scale_range": 0.2,
            "sax": {"rotate_range": [0, 0, 180], "translate_range": [60, 60, 0]},
            "lax": {"rotate_range": [180], "translate_range": [64, 64]},
        },
        "train": {
            "n_workers": 4,
            "clip_grad": 5.0,
            "weight_decay": 0.05,
            "layer_decay": 0.75,
            "betas": [0.9, 0.95],
            "label_smoothing": 0.1,
            "lr": 1.0e-3,
            "min_lr": 1.0e-5,
            "n_warmup_epochs": 10,
            "n_epochs": 800,
            "max_n_ckpts": 1,
            "batch_size": 64,
            "batch_size_per_device": 4,
            "eval_interval": 20,
            "early_stopping": {**early_stopping, "patience": 5, "min_delta": 1.0e-4},
        },
        "model": {
            "name": "convvit",
            "ckpt_path": None,
            "freeze_pretrained": False,
            "views": "sax",
            "n_frames": 2,
            "out_chans": 1,
            "convvit": {
                "size": "base",
                "enc_patch_size": [4, 4, 1],
                "enc_scale_factor": [2, 2, 1],
                "enc_conv_chans": [64, 128],
                "enc_conv_n_blocks": 2,
                "dropout": 0.1,
                "drop_path": 0.1,
            },
            "resnet": {"depth": 50, "layers": [3, 4, 6, 3], "layer_inplanes": [64, 128, 256, 512]},
        },
    }


ACDC_CLASSIFICATION = _acdc_finetune(
    "classification",
    {"class_column": "pathology", "pathology": ["DCM", "HCM", "MINF", "NOR", "RV"]},
    {"metric": "val_accuracy", "mode": "max"},
)
ACDC_REGRESSION = _acdc_finetune(
    "regression",
    {
        "regression_column": "ef",
        "ef": {"mean": 27.698811590282546, "std": 10.848138374627386},
        "bmi": {"mean": 25.561040294207242, "std": 4.732639548868183},
    },
    {"metric": "val_mae", "mode": "min"},
)


def _landmark(base: Dict[str, Any], model: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` for the landmark dataset on the 2-D ``lax_2c`` view (256x256): its data name and
    directory, the ``lax`` transform ranges, early stopping on the mean landmark distance, and the
    model fields ``model``."""
    config = copy.deepcopy(base)
    config["data"].update(name="landmark", dir="~/.cache/cinema_datasets/landmark/processed",
                          lax={"spacing": [1.0, 1.0], "patch_size": [256, 256], "in_chans": 1})
    config["transform"]["lax"] = {"rotate_range": [180], "translate_range": [64, 64]}
    config["train"]["early_stopping"].update(metric="val_mean_landmark_distance", mode="min")
    config["model"].update(views="lax_2c", **model)
    return config


# cinema_tpu/configs/segmentation/landmark.yaml: ConvUNetR (ViT-base) heatmaps of three landmarks
LANDMARK_SEGMENTATION = _landmark(ACDC_SEGMENTATION, {"out_chans": 3})
LANDMARK_SEGMENTATION["model"]["convunetr"]["enc_patch_size"] = [4, 4]
# cinema_tpu/configs/regression/landmark.yaml: ConvViT (ViT-base) regression of the six coordinates
LANDMARK_REGRESSION = _landmark(_acdc_finetune("regression", {}, {}), {"n_frames": 1, "out_chans": 6})

def _on(base: Dict[str, Any], name: str, **data: Any) -> Dict[str, Any]:
    """``base`` on the dataset ``name``: its data name and directory, and the data fields ``data`` in place
    of the ACDC ones of the same purpose (the class names, the regression columns)."""
    config = copy.deepcopy(base)
    for key in ("pathology", "ef", "bmi"):
        config["data"].pop(key, None)
    config["data"].update(name=name, dir=f"~/.cache/cinema_datasets/{name}/processed", **data)
    return config


_MNMS_EF = {"mean": 50.0, "std": 15.0}
# cinema_tpu/configs/{classification,regression,segmentation}/{mnms,mnms2}.yaml: the ACDC tasks'
# models and training on M&Ms and M&Ms2 (processed as cinema_tpu/data/preprocess/mnms{,2}.py writes them)
MNMS_CLASSIFICATION = _on(ACDC_CLASSIFICATION, "mnms", pathology=["DCM", "HCM", "NOR", "ARV", "HHD"])
MNMS2_CLASSIFICATION = _on(ACDC_CLASSIFICATION, "mnms2", pathology=["ARR", "CIA", "FALL", "HCM", "LV", "NOR"])
MNMS_REGRESSION = _on(ACDC_REGRESSION, "mnms", ef=_MNMS_EF, age={"mean": 60.0, "std": 15.0})
MNMS2_REGRESSION = _on(ACDC_REGRESSION, "mnms2", ef=_MNMS_EF)
MNMS_SEGMENTATION = _on(ACDC_SEGMENTATION, "mnms")
MNMS2_SEGMENTATION = _on(ACDC_SEGMENTATION, "mnms2", lax={"spacing": [1.0, 1.0], "patch_size": [256, 256],
                                                           "in_chans": 1})
MNMS2_SEGMENTATION["transform"]["lax"] = {"rotate_range": [180], "translate_range": [64, 64], "dropout_size": [50, 50]}


def _segmentation_on(name: str, sax: Dict[str, Any], out_chans: int = 4, **train: Any) -> Dict[str, Any]:
    """cinema_tpu/configs/segmentation/{emidec,myops2020,rescan,kaggle}.yaml: the ACDC segmentation config on
    the dataset ``name``, with the ``sax`` data fields, the number of output classes and the ``train`` fields
    given."""
    config = _on(ACDC_SEGMENTATION, name)
    config["data"]["sax"].update(sax)
    config["model"]["out_chans"] = out_chans
    config["train"].update(train)
    return config


# EMIDEC delayed enhancement: 96x96x8 patches at its 1.458 mm in-plane spacing, five classes
EMIDEC_SEGMENTATION = _segmentation_on("emidec", {"spacing": [1.458, 1.458, 10.0], "patch_size": [96, 96, 8]}, 5)
# MyoPS2020: bSSFP, LGE and T2 as three input channels, 192x192x4 patches
MYOPS2020_SEGMENTATION = _segmentation_on("myops2020", {"patch_size": [192, 192, 4], "in_chans": 3})
# Rescan cines, every frame an item: fewer epochs, evaluated more often
RESCAN_SEGMENTATION = _segmentation_on("rescan", {}, n_epochs=400, eval_interval=10)
# Kaggle Data Science Bowl cines: evaluation only (cinema_tpu_torch/tasks/segmentation/kaggle.py)
KAGGLE_SEGMENTATION = _segmentation_on("kaggle", {})

PACKAGED = {
    "segmentation/acdc": ACDC_SEGMENTATION,
    "mae": MAE_PRETRAIN,
    "classification/acdc": ACDC_CLASSIFICATION,
    "regression/acdc": ACDC_REGRESSION,
    "segmentation/landmark": LANDMARK_SEGMENTATION,
    "regression/landmark": LANDMARK_REGRESSION,
    "classification/mnms": MNMS_CLASSIFICATION,
    "classification/mnms2": MNMS2_CLASSIFICATION,
    "regression/mnms": MNMS_REGRESSION,
    "regression/mnms2": MNMS2_REGRESSION,
    "segmentation/mnms": MNMS_SEGMENTATION,
    "segmentation/mnms2": MNMS2_SEGMENTATION,
    "segmentation/emidec": EMIDEC_SEGMENTATION,
    "segmentation/myops2020": MYOPS2020_SEGMENTATION,
    "segmentation/rescan": RESCAN_SEGMENTATION,
    "segmentation/kaggle": KAGGLE_SEGMENTATION,
}
