"""The port's YAML writer (``cinema_tpu_torch.yaml_writer``, ``config.save_config``) against PyYAML's
``safe_dump(..., sort_keys=False)``, which the JAX package's ``save_config`` calls, byte for byte: on the 16
packaged configs, the 7 configs of the example checkpoints, the port's own packaged configs, hand-picked values
(quoting, floats, folding at 80 columns, empty collections) and hypothesis-drawn configs; each output read back
by the port's reader (``yaml_reader.loads``) as the same dict. And ``config.merge`` against the JAX ``merge``."""

from __future__ import annotations

import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cinema_tpu.config import from_dict as jax_from_dict
from cinema_tpu.config import merge as jax_merge
from cinema_tpu.config import save_config as jax_save_config
from cinema_tpu_torch import yaml_reader, yaml_writer
from cinema_tpu_torch.config import PACKAGED, Config, from_dict, load_config, merge, save_config

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted((REPO / "cinema_tpu" / "configs").rglob("*.yaml")) + sorted(
    (REPO / "tests" / "fixtures" / "example_ckpts").glob("*/*.yaml"))


def _same(a, b) -> bool:
    """Equal values of equal types, keys in the same order; NaN equals NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def test_there_are_the_23_yamls():
    assert len(YAMLS) == 23


@pytest.mark.parametrize("path", YAMLS, ids=[str(p.relative_to(REPO)) for p in YAMLS])
def test_save_config_writes_the_jax_save_configs_bytes(tmp_path, path):
    with open(path) as f:
        data = yaml.safe_load(f)
    jax_save_config(jax_from_dict(data), tmp_path / "jax.yaml")
    save_config(load_config(path), tmp_path / "port.yaml")
    written = (tmp_path / "port.yaml").read_bytes()
    assert written == (tmp_path / "jax.yaml").read_bytes()
    assert _same(yaml_reader.loads(written.decode()), data)


@pytest.mark.parametrize("name", sorted(PACKAGED))
def test_save_config_of_the_ports_packaged_configs_is_pyyamls(tmp_path, name):
    save_config(from_dict(PACKAGED[name]), tmp_path / "c.yaml")
    assert (tmp_path / "c.yaml").read_text() == yaml.safe_dump(PACKAGED[name], sort_keys=False)
    assert load_config(tmp_path / "c.yaml") == PACKAGED[name]


HAND_PICKED = {
    "lists at the key's column": {"a": [1, [2, []], {"b": [3]}], "c": {"d": [{"e": 1, "f": [None]}]}},
    "floats": {"lr": 1e-05, "big": 1e17, "neg": -2.5e-300, "inf": math.inf, "ninf": -math.inf, "nan": math.nan,
               "zero": -0.0, "x": 0.1},
    "scalars": {"n": None, "t": True, "f": False, "i": -12, "big": 2**70},
    "strings read as other types": {"a": "1.0", "b": "yes", "c": "null", "d": "", "e": "~", "f": "0x1F",
                                    "g": "2001-12-14", "h": "<<", "i": "=", "j": "1_000", "k": "1:20", "l": "Off"},
    "indicators and separators": {"a": "-x", "b": "- x", "c": "a: b", "d": "a #b", "e": "a#b", "f": "#a", "g": "&a",
                                  "h": "?x", "i": ": x", "j": "'q'", "k": '"q"', "l": "it's", "m": " lead", "n": "trail ",
                                  "o": "---", "p": "...x", "q": "[a]", "r": "a,b", "s": "%x", "t": "@x", "u": "a:"},
    "long strings fold": {"plain": " ".join(["word"] * 40), "quoted": "yes " + "x " * 60 + "end",
                          "path": "/" + "p" * 120, "deep": {"deeper": {"s": "ab cd " * 30}},
                          "list": ["item with spaces " * 8]},
    "breaks and escapes": {"a": "line\nnext", "b": "two\n\nbreaks", "c": "tab\there", "d": "é", "e": "\x85",
                           "f": "space \nbreak", "g": "\\ back", "h": "x y"},
    "empty collections": {"l": [], "d": {}, "ll": [[]], "dd": [{}]},
    "keys": {"yes": 1, "1": 2, "a b": 3, "key: x": 4, "#k": 5, "null": {"x": 1}},
}


@pytest.mark.parametrize("name", list(HAND_PICKED))
def test_save_config_on_hand_picked_values_is_pyyamls(tmp_path, name):
    config = HAND_PICKED[name]
    save_config(from_dict(config), tmp_path / "c.yaml")
    text = (tmp_path / "c.yaml").read_text()
    assert text == yaml.safe_dump(config, sort_keys=False)
    assert _same(yaml_reader.loads(text), config)


def test_save_config_refuses_what_a_config_does_not_hold(tmp_path):
    with pytest.raises(ValueError, match="represent"):
        save_config(from_dict({"a": {1, 2}}), tmp_path / "c.yaml")
    with pytest.raises(ValueError, match="mapping"):
        yaml_writer.dumps([1, 2])
    for key in ("", "a\nb", "k" * 128):
        with pytest.raises(ValueError, match="complex key"):
            yaml_writer.dumps({key: 1})
    assert yaml_writer.dumps({}) == yaml.safe_dump({}) == "{}\n"


_TEXT = st.one_of(
    st.text(max_size=100),
    st.lists(st.sampled_from(list(" ab01:#-'\"?.,[]{}&*!|>%@`~=<\\\n\t") + ["yes", "null", "1.0", "  ", "- ", ": "]),
             max_size=50).map("".join),
    st.lists(st.sampled_from(["word", "x y", "a b c d e", "#x", "'q'", "-", ":"]), max_size=40).map(" ".join),
)
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(), st.floats(), _TEXT)
_KEYS = st.one_of(st.text(st.sampled_from(list("abc_:# -'1.y")), min_size=1, max_size=12),
                  st.sampled_from(["yes", "null", "1", "seed", "lr"]))
_CONFIGS = st.dictionaries(_KEYS, st.recursive(
    _SCALARS, lambda inner: st.one_of(st.lists(inner, max_size=4), st.dictionaries(_KEYS, inner, max_size=4)),
    max_leaves=20), max_size=6)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_CONFIGS)
def test_save_config_on_drawn_configs_is_pyyamls_and_reads_back(config):
    text = yaml_writer.dumps(config)
    assert text == yaml.safe_dump(config, sort_keys=False)
    assert _same(yaml_reader.loads(text), config)


MERGES = [
    ({"a": 1, "b": {"c": 2, "d": [1, 2]}}, {"b": {"c": 3}}),
    ({"a": 1, "b": {"c": 2}}, {"b": 5, "e": {"f": None}}),
    ({"a": {"b": {"c": {"d": 1}}}}, {"a": {"b": {"c": {"e": 2}, "x": [3]}}}),
    ({"a": [1, {"b": 2}]}, {"a": [{"c": 3}]}),
    ({"a": 1}, {}),
    ({}, {"a": {"b": 1}}),
]


@pytest.mark.parametrize("base,override", MERGES)
def test_merge_is_the_jax_merge(base, override):
    got = merge(from_dict(base), override)
    want = jax_merge(jax_from_dict(base), override)
    assert isinstance(got, Config) and got == want.to_dict()
    assert all(isinstance(v, Config) for v in got.values() if isinstance(v, dict))
    got_override = next((k for k in override if isinstance(override[k], dict)), None)
    if got_override is not None:  # a new Config: nothing of the override aliased
        assert got[got_override] is not override[got_override]


def test_merge_leaves_its_arguments_as_they_were():
    base, override = from_dict({"a": {"b": 1, "c": [1]}}), {"a": {"b": 2}}
    got = merge(base, override)
    got.a.c.append(2)
    assert base == {"a": {"b": 1, "c": [1]}} and override == {"a": {"b": 2}} and got.a.b == 2
