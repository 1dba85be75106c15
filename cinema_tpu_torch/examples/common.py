"""What the example scripts share: their arguments, the local-file rule, the compute dtype and the
preprocessing of one image.

The JAX package's scripts also take HuggingFace ``repo::file`` references and download them. The port runs
where there is no network, so weights and configs are local files: a ``::`` reference raises ``ValueError``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from cinema_tpu_torch.data.transforms import scale_intensity, spatial_pad

LOCAL_FILES = ("Weights (--model, safetensors) and config (--config, config.yaml) are local files: HuggingFace "
               "'repo::file' references are not downloaded.")


def check_local(*paths: Optional[str]) -> None:
    """Raise ``ValueError`` for a HuggingFace ``repo::file`` reference."""
    for path in paths:
        if path is not None and "::" in str(path):
            raise ValueError(f"{path!r} is a HuggingFace reference; {LOCAL_FILES}")


def example_parser(doc: str) -> argparse.ArgumentParser:
    """The parser of an inference script: ``--model``, ``--config`` and ``--device`` (the card by default)."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0], epilog=LOCAL_FILES)
    parser.add_argument("--model", required=True, help="local safetensors weights")
    parser.add_argument("--config", required=True, help="local config.yaml of the model")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def compute_dtype(device: str) -> torch.dtype:
    """The activations' dtype: bfloat16 on the card, as the JAX scripts run, float32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def preprocess(image: np.ndarray, patch_size: Sequence[int]) -> np.ndarray:
    """A channels-last image min-max scaled to [0, 1] and end-padded to the patch size (the JAX scripts'
    ``ScaleIntensityd`` then ``SpatialPadd``), float32."""
    return spatial_pad(scale_intensity(image), patch_size)
