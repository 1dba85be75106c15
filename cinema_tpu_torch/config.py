"""Hierarchical config with attribute access (port of cinema_tpu/config.py).

Same YAML schema as the JAX package, so the published config.yaml files
rebuild the same models. PyYAML is imported only inside :func:`load_config`:
the machine with the card has no PyYAML, and there the packaged configs
(:data:`PACKAGED`) go through :func:`from_dict`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union


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

PACKAGED = {"segmentation/acdc": ACDC_SEGMENTATION}
