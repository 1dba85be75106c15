"""The port's YAML reader and config repairs against the JAX package's PyYAML, on the CPU.

``cinema_tpu_torch.config.load_config`` reads every config of the JAX package, the example checkpoints'
config files and a ``config.yaml`` the JAX package's ``save_config`` wrote to what ``yaml.safe_load``
gives; ``yaml.safe_dump`` of config-like dicts reads back to the dict (hypothesis); what the reader
does not read raises with the line number; dotted overrides give what the JAX package's
``apply_overrides`` gives; the entry points that read YAML run where PyYAML cannot be imported; and
the float32 evaluation turns TF32 off inside and restores the caller's flags.
"""

import json
import math
import string
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cinema_tpu.config import apply_overrides as jax_apply_overrides
from cinema_tpu.config import from_dict as jax_from_dict
from cinema_tpu.config import load_config as jax_load_config
from cinema_tpu.config import save_config as jax_save_config
from cinema_tpu_torch import yaml_reader
from cinema_tpu_torch.config import PACKAGED, apply_overrides, from_dict, load_config
from cinema_tpu_torch.factory import from_finetuned
from cinema_tpu_torch.tasks import evaluate
from cinema_tpu_torch.tasks.evaluate import float32_precision

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "cinema_tpu" / "configs").rglob("*.yaml"))
FIXTURES = sorted((REPO / "tests" / "fixtures" / "example_ckpts").glob("*/*.yaml"))
SEG_SAX = next((REPO / "tests" / "fixtures" / "example_ckpts").glob("seg_sax-*"))


def _same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN (bool is not int, int is not float)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def test_every_config_and_fixture_is_found():
    assert len(CONFIGS) == 16 and len(FIXTURES) == 7


@pytest.mark.parametrize("path", CONFIGS + FIXTURES, ids=lambda p: str(p.relative_to(REPO)))
def test_load_config_reads_what_pyyaml_reads(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert _same(load_config(path), want)


@pytest.mark.parametrize("name", ["segmentation/acdc", "classification/mnms2", "mae"])
def test_load_config_reads_a_config_yaml_the_jax_package_wrote(tmp_path, name):
    """``save_config`` writes block sequences at their key's column and its own float forms (1.0e-05)."""
    config = jax_load_config(REPO / "cinema_tpu" / "configs" / f"{name}.yaml")
    config.model.views = ["sax", "lax_4c"]
    config.train.lr = 1e-5
    config.extra = {"empty_list": [], "empty_map": {}, "nested": [{"a": [1, 2]}, [3, [4]]], "none": None,
                    "quoted": ["yes", "1e-3", "~", "a: b", "# c", "it's"], "inf": float("inf")}
    jax_save_config(config, tmp_path / "config.yaml")
    with open(tmp_path / "config.yaml") as f:
        want = yaml.safe_load(f)
    assert _same(load_config(tmp_path / "config.yaml"), want)
    assert load_config(tmp_path / "config.yaml") == config.to_dict()


_TEXT = st.text(alphabet=string.ascii_letters + string.digits + " _-.:/#'\"~[]{},!&*?|>%@`", max_size=16)
_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(), st.floats(allow_nan=True), _TEXT,
    st.sampled_from(["yes", "No", "ON", "null", "~", "", "1e-3", "1.0e5", "010", "0x1F", "1:20", "2001-12-14",
                     ".inf", "-.5", " a", "a ", "- a", "[x]", "a #b", "<<", "="]),
)
_KEYS = st.one_of(st.from_regex(r"[a-z_][a-z0-9_]{0,8}", fullmatch=True), st.sampled_from(["yes", "null", "1", "on"]))
_CONFIGS = st.recursive(_SCALARS, lambda inner: st.one_of(st.lists(inner, max_size=4),
                                                          st.dictionaries(_KEYS, inner, max_size=4)), max_leaves=24)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.dictionaries(_KEYS, _CONFIGS, max_size=6))
def test_safe_dump_of_config_like_dicts_reads_back(config):
    text = yaml.safe_dump(config, sort_keys=False)
    assert _same(yaml_reader.loads(text), yaml.safe_load(text))
    assert _same(yaml_reader.loads(text), config)


@pytest.mark.parametrize("text,line,what", [
    ("a: 1\nb: &x 2\n", 2, "anchors"),
    ("a: [1]\nb: *x\n", 2, "aliases"),
    ("a: !!str 1\n", 1, "tags"),
    ("a: |\n  text\n", 1, "block scalars"),
    ("a: >\n  text\n", 1, "block scalars"),
    ("a: 1\n---\nb: 2\n", 2, "several documents"),
    ("a:\n\tb: 1\n", 2, "tab"),
    ("a: 1\nb: 2\na: 3\n", 3, "duplicate key 'a'"),
    ("a: {b: 1, b: 2}\n", 1, "duplicate key 'b'"),
])
def test_what_the_reader_does_not_read_raises_with_its_line(text, line, what):
    with pytest.raises(ValueError, match=f"line {line}: .*{what}"):
        yaml_reader.loads(text)


OVERRIDES = ["[sax,lax_4c]", "1e-3", "1.0e5", "1.0e-05", "yes", "off", "~", "null", "", "true", "0x10", "010",
             "4000", "-1", ".inf", "sax", "{a: 1, b: [x]}", "'quoted'", "a b #comment"]


@pytest.mark.parametrize("raw", OVERRIDES)
def test_an_override_value_reads_as_the_jax_package_reads_it(raw):
    config = PACKAGED["segmentation/mnms2"]
    got = apply_overrides(from_dict(config), [f"model.views={raw}", f"train.new.key={raw}"])
    want = jax_apply_overrides(jax_from_dict(config), [f"model.views={raw}", f"train.new.key={raw}"]).to_dict()
    assert _same(json.loads(json.dumps(got, allow_nan=True)), json.loads(json.dumps(want, allow_nan=True)))
    assert _same(got["model"]["views"], yaml.safe_load(raw))


def test_an_override_below_a_scalar_replaces_it_with_a_mapping():
    config = PACKAGED["segmentation/acdc"]
    overrides = ["model.views.sax=1", "seed.offset=2", "train.lr=1.0e-4"]
    got = apply_overrides(from_dict(config), overrides)
    assert got == jax_apply_overrides(jax_from_dict(config), overrides).to_dict()
    assert got["model"]["views"] == {"sax": 1} and got["seed"] == {"offset": 2} and got["train"]["lr"] == 1e-4


_NO_YAML = "import sys\nsys.modules['yaml'] = None\n"
_ENTRY_POINTS = {
    "from_finetuned": """
from cinema_tpu_torch.factory import from_finetuned
model = from_finetuned("convunetr", sys.argv[1] + "/seg_sax.safetensors", sys.argv[1] + "/seg_sax.yaml", device="cpu")
print(json.dumps({"n": sum(p.numel() for p in model.parameters()), "sum": float(sum(p.detach().double().sum() for p in model.parameters()))}))
""",
    "load_run": """
from cinema_tpu_torch.tasks import evaluate
config, model = evaluate.load_run(sys.argv[2], device="cpu")
print(json.dumps({"config": config, "n": sum(p.numel() for p in model.parameters()), "sum": float(sum(p.detach().double().sum() for p in model.parameters()))}))
""",
    "cli": """
from cinema_tpu_torch.tasks import cli
cli.task_main("segmentation/acdc", lambda config, device: print(json.dumps({"config": config, "device": device})), "doc",
              ["--config", sys.argv[2] + "/config.yaml", "--device", "cpu", "model.views=[sax,lax_4c]", "train.lr=1e-3"])
""",
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_read_yaml_where_pyyaml_cannot_be_imported(tmp_path, entry):
    """``from_finetuned`` on the seg_sax example checkpoint, ``load_run`` of a run folder the JAX package wrote
    (its ``save_config``) and ``tasks.cli`` with ``--config`` and overrides, in a process where ``import yaml``
    fails, as on the card's machine."""
    jconfig = jax_load_config(next(SEG_SAX.glob("*.yaml")))
    jax_save_config(jconfig, tmp_path / "config.yaml")
    (tmp_path / "model_0.safetensors").write_bytes(next(SEG_SAX.glob("*.safetensors")).read_bytes())
    code = _NO_YAML + "import json\n" + _ENTRY_POINTS[entry]
    proc = subprocess.run([sys.executable, "-c", code, str(SEG_SAX), str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if entry == "cli":
        want = jax_apply_overrides(jconfig, ["model.views=[sax,lax_4c]", "train.lr=1e-3"]).to_dict()
        assert got == {"config": want, "device": "cpu"} and got["config"]["train"]["lr"] == "1e-3"
        return
    if entry == "load_run":
        assert got.pop("config") == jconfig.to_dict()
        _, model = evaluate.load_run(tmp_path, device="cpu")
    else:
        model = from_finetuned("convunetr", next(SEG_SAX.glob("*.safetensors")), next(SEG_SAX.glob("*.yaml")),
                               device="cpu")
    assert got == {"n": sum(p.numel() for p in model.parameters()),
                   "sum": float(sum(p.detach().double().sum() for p in model.parameters()))}


@pytest.mark.parametrize("caller", [("highest", True), ("high", False), ("medium", True)])
def test_the_float32_evaluation_turns_tf32_off_and_restores_the_callers_flags(caller):
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision(caller[0])
        torch.backends.cudnn.allow_tf32 = caller[1]
        with float32_precision():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == caller
        with pytest.raises(RuntimeError), float32_precision():
            raise RuntimeError("the evaluation failed")
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == caller
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
