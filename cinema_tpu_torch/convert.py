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
  checked against the recomputed ones and dropped (the port recomputes them).
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np

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
_DICT_KEYS = ("sax", "lax_2c", "lax_3c", "lax_4c")


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
    elif leaf in ("bias", "cls_token", "mask_token"):
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
    """Flax param tree ({'params': ...} or the inner tree) -> torch-named, torch-laid-out arrays.

    Dense kernels (in, out) are transposed; Conv kernels (*k, in, out) and
    ConvTranspose kernels (*k, out, in) (flax ``transpose_kernel=True``) both
    go to torch's layout by one permutation, (o, i, *k) and (i, o, *k).
    """
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
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
