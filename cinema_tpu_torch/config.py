"""Hierarchical config with attribute access (port of cinema_tpu/config.py).

Same YAML schema as the JAX package, so the published config.yaml files
rebuild the same models. PyYAML is imported only inside :func:`load_config`:
the machine with the card has no PyYAML, and there the packaged configs
(:data:`PACKAGED`) go through :func:`from_dict`.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Any, Dict, List, Union


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


def from_dict(d: Dict[str, Any]) -> Config:
    """Wrap a nested dict into a Config (a deep copy)."""
    return _wrap(dict(d))


def load_config(path: Union[str, Path]) -> Config:
    """Load a YAML config file."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return from_dict(data or {})


def apply_overrides(config: Config, overrides: List[str]) -> Config:
    """Apply dotted ``key.sub=value`` overrides; values are Python literals where they parse as one."""
    config = from_dict(config)
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"Override {item!r} is not of the form key=value.")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = {"null": None, "true": True, "false": False}.get(raw, raw)
        *parents, leaf = key.split(".")
        node = config
        for part in parents:
            if part not in node:
                node[part] = Config()
            node = node[part]
        node[leaf] = _wrap(value)
    return config


# cinema_tpu/configs/segmentation/acdc.yaml, the model and data sections
# that rebuild ConvUNetR (ViT-base) for ACDC SAX segmentation
ACDC_SEGMENTATION = {
    "task": "segmentation",
    "seed": 0,
    "data": {
        "name": "acdc",
        "sax": {"spacing": [1.0, 1.0, 10.0], "patch_size": [192, 192, 16], "in_chans": 1},
    },
    "model": {
        "name": "convunetr",
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

PACKAGED = {"segmentation/acdc": ACDC_SEGMENTATION, "mae": MAE_PRETRAIN}
