"""Weights in and out of the port's modules (port of cinema_tpu/bridge/torch_loader.py).

The port's module names are the reference checkpoint's, so a reference
safetensors file loads with no renaming. This module holds:

- :func:`load_safetensors` / :func:`save_safetensors`: a small numpy reader
  and writer of the safetensors format (the machine with the card need not
  have the ``safetensors`` package);
- :func:`state_dict_from_jax`: a flax param tree (nested dicts of arrays)
  to the port's ``state_dict``, the inverse of the JAX bridge's
  ``flax_path_to_torch_key`` / ``_convert_tensor``;
- :func:`drop_frozen_pos_embeds`: the checkpoint's frozen sincos tables are
  checked against the recomputed ones and dropped (the port recomputes them);
- :func:`load_pretrain_weights`: the MAE -> downstream transfer (reference
  convvit.py:616-704): key drops per target model, patch-embed channel
  inflation for stacked frames, and the loaded keys for the freeze mask.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
    "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Read a safetensors file: 8-byte little-endian header length, JSON header, raw buffer."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    buf = memoryview(data)[8 + n :]
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"Unsupported safetensors dtype {info['dtype']} for {key}.")
        start, end = info["data_offsets"]
        arr = np.frombuffer(buf[start:end], dtype=np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        out[key] = arr.reshape(info["shape"]).copy()
    return out


def save_safetensors(path: Union[str, Path], tensors: Mapping[str, np.ndarray]) -> None:
    """Write arrays as a safetensors file, keys sorted, header padded to 8 bytes as the format's
    own writer does."""
    codes = {np.dtype(v): k for k, v in _ST_DTYPES.items()}
    header, chunks, offset = {}, [], 0
    for key in sorted(tensors):
        arr = np.ascontiguousarray(tensors[key])
        if arr.dtype not in codes:
            raise ValueError(f"Unsupported dtype {arr.dtype} for {key}.")
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[key] = {
            "dtype": codes[arr.dtype], "shape": list(arr.shape), "data_offsets": [offset, offset + len(data)],
        }
        chunks.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in chunks:
            f.write(data)


# the models' flax dict attributes, whose next path component is a view name
_DICT_PREFIXES = (
    "enc_down_dict", "enc_fusion_dict", "dec_embed_dict", "pred_head_dict", "dec_image_conv_block_dict",
    "dec_down_blocks_dict", "dec_conv_blocks_dict", "decoder_dict",
)
_DICT_KEYS = ("sax", "lax_2c", "lax_3c", "lax_4c", "cls")


def _torch_part(part: str) -> str:
    """One flax path component -> dotted torch key part:
    'decoder_dict_sax' -> 'decoder_dict.sax', 'dec_down_blocks_dict_sax_0' ->
    'dec_down_blocks_dict.sax.0', 'blocks_0_conv_1' -> 'blocks.0.conv.1'."""
    for prefix in _DICT_PREFIXES:
        if part.startswith(prefix + "_"):
            rest = part[len(prefix) + 1 :]
            for key in _DICT_KEYS:
                if rest == key:
                    return f"{prefix}.{key}"
                if rest.startswith(key + "_"):
                    return f"{prefix}.{key}." + rest[len(key) + 1 :].replace("_", ".")
    part = re.sub(r"_(\d+)(?=_|$)", r".\1", part)
    return re.sub(r"(\.\d+)_", r"\1.", part)


def torch_key(path: Tuple[str, ...]) -> Optional[str]:
    """Flax param path -> torch state_dict key; None for params the port lacks.

    The JAX Dense/Conv wrappers add one module level ('linear'/'conv') right
    above the leaf; torch keeps the params on the named module itself.
    """
    *parts, leaf = path
    if leaf in ("kernel", "scale"):
        name = "weight"
    elif leaf in ("bias", "cls_token", "mask_token", "ls1_gamma", "ls2_gamma"):
        name = leaf
    else:
        return None
    if leaf in ("kernel", "bias") and parts and parts[-1] in ("linear", "conv"):
        parts = parts[:-1]
    return ".".join([*(_torch_part(p) for p in parts), name])


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, (*prefix, str(key))))
        else:
            out[(*prefix, str(key))] = value
    return out


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax variables ({'params': ...} with or without 'batch_stats', or the param tree alone) ->
    torch-named, torch-laid-out arrays.

    Dense kernels (in, out) are transposed; Conv kernels (*k, in, out) and
    ConvTranspose kernels (*k, out, in) (flax ``transpose_kernel=True``) both
    go to torch's layout by one permutation, (o, i, *k) and (i, o, *k).
    A BatchNorm's ``batch_stats`` ``mean`` and ``var`` become its ``running_mean``
    and ``running_var``, under its parameters' key (``layer1_0/bn1`` ->
    ``layer1.0.bn1``), as the JAX bridge exports them.
    """
    stats: Mapping[str, Any] = {}
    if "params" in params and set(params) <= {"params", "batch_stats"}:
        stats = params.get("batch_stats", {})
        params = params["params"]
    out = {}
    for path, value in _flatten(stats).items():
        if path[-1] not in ("mean", "var"):
            raise ValueError(f"No torch key for flax batch statistic {'/'.join(path)}.")
        module = torch_key((*path[:-1], "bias"))[: -len("bias")]
        out[f"{module}running_{path[-1]}"] = np.ascontiguousarray(np.array(value))
    for path, value in _flatten(params).items():
        key = torch_key(path)
        if key is None:
            raise ValueError(f"No torch key for flax param {'/'.join(path)}.")
        v = np.array(value)
        if path[-1] == "kernel":
            nd = v.ndim - 2
            v = v.T if v.ndim == 2 else np.transpose(v, (nd + 1, nd, *range(nd)))
        out[key] = np.ascontiguousarray(v)
    return out


def drop_frozen_pos_embeds(
    state: Dict[str, np.ndarray], expected: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Check the checkpoint's frozen ``*.pos_embed`` tables against the
    recomputed ones (``expected``: key -> array) and return the state without them."""
    out = {}
    for key, value in state.items():
        if key.endswith(".pos_embed") or key == "pos_embed":
            want = expected.get(key)
            if want is not None and (
                want.shape != value.shape or not np.allclose(want, value.astype(np.float64), atol=1e-5)
            ):
                raise ValueError(f"Frozen constant {key} in the checkpoint does not match the recomputed "
                                 f"sincos table (shape {value.shape} vs {want.shape}).")
            continue
        out[key] = value
    return out


# keys dropped when MAE weights go into a downstream model (reference convvit.py:640-651)
_TRANSFER_DROP_SUBSTRINGS = (
    "mask", "decoder", "_head", "sax", "lax_2c", "lax_3c", "lax_4c", "fusion", "dec_linear", "pos_embed",
)


@torch.no_grad()
def load_pretrain_weights(
    model: nn.Module, views: Union[str, Sequence[str]], state_dict: Mapping[str, np.ndarray],
    keep_fusion: bool = False,
) -> List[str]:
    """Copy pretrained MAE weights into a downstream model, in place.

    Keys holding a dropped substring are left out (the stems of the views
    the target lacks, the decoder, the heads, mask tokens, the frozen
    pos-embeds and, unless ``keep_fusion``, the fusion). A first conv whose
    input channels are a multiple of the checkpoint's (``n_frames`` stacked as
    channels) gets the weight repeated along the input axis. A kept key the
    model lacks raises.

    Returns:
        the loaded keys, sorted: they feed :func:`loaded_freeze_mask`.
    """
    views = [views] if isinstance(views, str) else list(views)
    drops = [d for d in _TRANSFER_DROP_SUBSTRINGS if d not in views and not (keep_fusion and d == "fusion")]
    filtered = {k: np.asarray(v) for k, v in state_dict.items() if not any(d in k for d in drops)}
    target = model.state_dict()
    unused = sorted(set(filtered) - set(target))
    if unused:
        raise ValueError(f"Unexpected keys in checkpoint after filtering: {unused}")
    for key, value in filtered.items():
        want = target[key]
        if "patch_embed" in key and key.endswith("conv.weight") and value.ndim > 2 and value.shape[1] != want.shape[1]:
            if want.shape[1] % value.shape[1] != 0:
                raise ValueError(f"Cannot inflate {key}: {value.shape[1]} -> {want.shape[1]}.")
            value = np.tile(value, [1, want.shape[1] // value.shape[1]] + [1] * (value.ndim - 2))
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"Shape mismatch at {key}: checkpoint {value.shape} vs model {tuple(want.shape)}.")
        want.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return sorted(filtered)


def loaded_freeze_mask(model: nn.Module, loaded_keys: Sequence[str]) -> Dict[str, bool]:
    """Parameter name -> True where the parameter was loaded (to be frozen)."""
    loaded = set(loaded_keys)
    return {name: name in loaded for name, _ in model.named_parameters()}


def load_pretrained(model: nn.Module, config: Mapping[str, Any]) -> Dict[str, bool]:
    """MAE -> fine-tuned model transfer from the safetensors checkpoint ``config.model.ckpt_path``
    for the views of ``config.model.views``, the fusion left out; returns the freeze mask."""
    state_dict = load_safetensors(Path(config.model.ckpt_path).expanduser())
    return loaded_freeze_mask(model, load_pretrain_weights(model, config.model.views, state_dict, keep_fusion=False))
