"""CPU tests of the benchmark: its files and their contract, the frozen arithmetic, the result line,
the imports, and ``correct`` at a size the CPU holds (sound runs pass; the control and every planted
fault fail; the data-parallel cell on two gloo ranks). Run with ``python -m pytest perfbench/tests
-q``; the test marked ``gpu`` runs the cells on the card and skips elsewhere."""

from __future__ import annotations

import ast
import copy
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench.harness import faults, registry, trace, weights, yardstick
from perfbench.reference import models as ref
from perfbench.reference import train as ref_train
from perfbench.run import FORBIDDEN
from perfbench.tests.tiny import tiny_cell

ROOT = registry.PERFBENCH
CHECKOUT = registry.CHECKOUT
BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = registry.workload_names()
# mae-pretrain-b16 on cinema-mae-base at the ViT-H/14 preset, which no cell runs yet: files that a later cell can drop in
HUGE = "mae-pretrain-huge-b16"


def _huge_config() -> dict:
    cfg = copy.deepcopy(registry.config("cinema-mae-base"))
    cfg["name"] = "cinema-mae-huge"
    cfg["model"]["size"] = "huge"
    return cfg


def _huge_workload() -> dict:
    return dict(registry.workload("mae-pretrain-b16"), config="cinema-mae-huge")


# ---------------------------------------------------------------- files and contract


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_workload_resolves_to_a_config_a_driver_and_metrics(name):
    w = registry.workload(name)
    cfg = registry.config(w["config"])
    assert cfg["name"] == w["config"]
    assert callable(registry.driver(w["kind"]).run)
    entry = next(e for e in BENCH["workloads"] if e["name"] == name)
    assert entry["config"] == w["config"]
    e2e = [m["name"] for m in registry.cell_metrics(name, "end_to_end", BENCH)]
    assert w["rate_metric"] in e2e and "setup_s" in e2e
    per_layer = registry.cell_metrics(name, "per_layer", BENCH)
    assert per_layer
    for m in per_layer:
        assert callable(registry.metric_reader(m["name"]).read)
    assert w["correct"]["limits"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (CHECKOUT / p).is_dir() and re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (CHECKOUT / c["file"]).is_file() and any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells) and sorted(cells) == WORKLOADS
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
        # a cell takes the chips its configuration's ranks run on
        assert w["chips"] == registry.config(w["config"]).get("n_devices", 1)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_dropped_in_cell_metric_and_kernel_class_are_found_without_an_edit(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    extra = dict(registry.workload("mae-pretrain-b16"), traffic=dict(registry.workload("mae-pretrain-b16")["traffic"],
                                                                     n_batches=4))
    (root / "workloads" / "mae-pretrain-b16-small.json").write_text(json.dumps(extra))
    (root / "metrics" / "softmax_ms.py").write_text("def read(result, span):\n    return span.busy_s('softmax') * 1e3\n")
    (root / "kernel_classes" / "softmax.json").write_text(json.dumps({"rank": 5, "include": ["(?i)softmax"]}))
    assert "mae-pretrain-b16-small" in registry.workload_names(root)
    assert registry.workload("mae-pretrain-b16-small", root)["traffic"]["n_batches"] == 4
    assert registry.metric_reader("softmax_ms.pretrain", root).read is not None
    classes = registry.kernel_classes(root)
    assert registry.classify("cunn_SoftMaxForward<4, float>", classes) == "softmax"
    assert registry.classify("flash_fwd_bf16<128>", classes) == "attention"
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_dropped_in_configuration_at_another_vit_preset_needs_no_edit(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "cinema-mae-huge.json").write_text(json.dumps(_huge_config()))
    (root / "workloads" / f"{HUGE}.json").write_text(json.dumps(_huge_workload()))
    assert HUGE in registry.workload_names(root)
    w = registry.workload(HUGE, root)
    cfg = registry.config(w["config"], root)
    assert cfg["name"] == w["config"] and cfg["model"]["size"] == "huge"
    batch, n_batches = w["traffic"]["batch"], w["traffic"]["n_batches"]
    scheme = weights._scheme(weights.on_meta(w["step"], cfg))
    assert ("encoder.blocks.31.mlp.fc1.weight", torch.Size([5120, 1280]), "uniform", math.sqrt(6.0 / 6400)) in scheme
    assert yardstick.attention_calls(cfg, w["step"], batch, train=True) == (
        [(16, 769, 769, 1280, True)] * 32 + [(16, 2305, 768, 512, True)] * 8)
    assert yardstick.model_flop(cfg, w["step"], batch, train=True) > yardstick.model_flop(
        registry.config("cinema-mae-base"), w["step"], batch, train=True)
    assert ref_train.optimizer_settings(cfg, w["step"], n_batches, batch) == ref_train.optimizer_settings(
        registry.config("cinema-mae-base"), w["step"], n_batches, batch)
    after = {p for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert after - set(before) == {root / "configs" / "cinema-mae-huge.json", root / "workloads" / f"{HUGE}.json"}
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("size", ["tiny", "base", "large", "huge"])
def test_the_reference_s_vit_presets_are_the_program_s(size):
    from cinema_tpu_torch.models.vit import get_vit_config

    assert list(ref.VIT) == ["tiny", "base", "large", "huge"]
    assert ref.vit_widths({"size": size}) == get_vit_config(size)


def test_an_unknown_vit_size_is_refused_with_the_presets():
    with pytest.raises(ValueError, match=r"\['tiny', 'base', 'large', 'huge'\], got 'giant'"):
        ref.vit_widths({"size": "giant"})


# ---------------------------------------------------------------- frozen arithmetic


def _readings(name: str) -> dict:
    """What a cell reads from the reference and the yardstick, as its driver asks for it: the weight scheme,
    the attention calls of a unit and, in training, the update's settings."""
    w = registry.workload(name)
    cfg = registry.config(w["config"])
    step = w.get("step", "segmentation")
    if w["kind"] == "serve_cine":
        rows, train, settings = 8, False, None
    else:
        rows, train = w["traffic"]["batch"] // cfg.get("n_devices", 1), True
        settings = ref_train.optimizer_settings(cfg, step, w["traffic"]["n_batches"], w["traffic"]["batch"])
    scheme = [(n, list(shape), kind, repr(float(scale))) for n, shape, kind, scale in weights._scheme(
        weights.on_meta(step, cfg))]
    return {"scheme": scheme, "calls": yardstick.attention_calls(cfg, step, rows, train), "settings": settings}


# taken on the tree before the reference's table of presets held more than tiny and base
FROZEN = {
    "mae-pretrain-b16": "b161cb3edeeec476bec951479dfb1f8367f05f38962d430f0a441083b0c9fbf1",
    "mae-pretrain-ddp4": "01d04b7aaece6e8217463adc9f28d3eb0f43fed7877711b1353e8a0bf0b0034d",
    "seg-finetune-b4": "7562f98e5341fd76cac76f46b6f42baabd1a550dbb549df9d7ea7e4da309c644",
    "seg-serve-cine": "5d7dfabd37e360078bd6760b14ca805e039b5856384d69d19eee494689991e72",
}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_the_cells_readings_of_the_reference_are_frozen(name):
    digest = hashlib.sha256(json.dumps(_readings(name)).encode("utf-8")).hexdigest()
    assert digest == FROZEN[name]


def test_the_huge_reference_s_encoder_blocks_hold_vit_h_s_parameters():
    model = weights.on_meta("mae", _huge_config())
    blocks = [sum(p.numel() for p in b.parameters()) for b in model.encoder.blocks]
    assert blocks == [12 * 1280**2 + 13 * 1280] * 32
    assert sum(blocks) == 629_678_080


def _hand_attention_min_s(b, tq, tk, e, train):
    flop = 4 * b * tq * tk * e + (10 * b * tq * tk * e if train else 0)
    nbytes = 2 * (b * tq * e * 2 + b * tk * e * 2) + (2 * (4 * b * tq * e + 4 * b * tk * e) if train else 0)
    return max(flop / 989e12, nbytes / 3.35e12)


@pytest.mark.parametrize("name", WORKLOADS + [HUGE])
def test_attention_work_agrees_with_a_hand_count(name):
    w = _huge_workload() if name == HUGE else registry.workload(name)
    cfg = _huge_config() if name == HUGE else registry.config(w["config"])
    if w["kind"] == "train_pool":
        calls = yardstick.attention_calls(cfg, w["step"], w["traffic"]["batch"], train=True)
    elif w["kind"] == "train_ddp":  # one rank's rows
        calls = yardstick.attention_calls(cfg, w["step"], w["traffic"]["batch"] // cfg["n_devices"], train=True)
    else:
        calls = yardstick.attention_calls(cfg, "segmentation", 8, train=False)
    if name == HUGE:
        # as below, through 32 encoder blocks 1280 wide (16 heads of 80)
        assert calls == [(16, 769, 769, 1280, True)] * 32 + [(16, 2305, 768, 512, True)] * 8
        hand = 32 * _hand_attention_min_s(16, 769, 769, 1280, True) + 8 * _hand_attention_min_s(16, 2305, 768, 512, True)
    elif name.startswith("mae"):
        # 2304 SAX tokens and 3 x 256 LAX tokens at mask ratio 0.75: 576 + 3 x 64 kept, 1728 + 3 x 192 masked
        hand = 12 * _hand_attention_min_s(16, 769, 769, 768, True) + 8 * _hand_attention_min_s(16, 2305, 768, 512, True)
    elif w["kind"].startswith("train"):
        hand = 12 * _hand_attention_min_s(4, 2305, 2305, 768, True)
    else:
        hand = 12 * _hand_attention_min_s(8, 2305, 2305, 768, False)
    assert math.isclose(yardstick.attention_min_s(calls), hand, rel_tol=1e-12)


def _convunetr_forward_flop_by_hand() -> float:
    """ConvUNetR-base on one 192x192x16 frame, forward: 2 x multiply-adds of every conv and linear layer
    and of the two attention products."""
    def conv(cin, cout, k, positions):
        return 2 * cin * cout * k * positions
    f = 0
    p1, p2 = 48 * 48 * 16, 24 * 24 * 16
    f += conv(1, 64, 16, p1)  # stem level 1, kernel 4x4x1
    f += 2 * (conv(64, 64, 1, p1) * 2 + 2 * 64 * 125 * p1 + conv(64, 256, 1, p1) * 2)  # two masked conv blocks
    f += conv(64, 128, 4, p2)
    f += 2 * (conv(128, 128, 1, p2) * 2 + 2 * 128 * 125 * p2 + conv(128, 512, 1, p2) * 2)
    t, e = 2304, 768
    f += 2 * t * 512 * e + 2 * t * e * e  # patch embed, linear
    t += 1
    f += 12 * (24 * t * e * e + 4 * t * t * e)  # ViT blocks
    g = 12 * 12 * 16
    f += conv(768, 768, 4, g // 4)  # one strided downsample below the ViT grid

    def res(cin, cout, positions):
        return conv(cin, cout, 27, positions) + conv(cout, cout, 27, positions) + (
            conv(cin, cout, 1, positions) if cin != cout else 0)
    full = 192 * 192 * 16
    dec = [32, 64, 128, 256, 512]
    f += res(1, 32, full)
    sizes = [full // 16, full // 64, g, g // 4]  # the skips' positions, finest first
    for ch_in, ch_out, pos in zip([64, 128, 768, 768], dec[1:], sizes):
        f += res(ch_in, ch_out, pos)
    levels = [(512, 256, g), (256, 128, full // 64), (128, 64, full // 16), (64, 32, full // 4), (32, 32, full)]
    for cin, cout, pos in levels:
        f += 2 * cin * cout * 4 * (pos // 4) + 2 * res(cout, cout, pos)  # transposed conv 2x2x1, two blocks
    f += conv(32, 4, 1, full)
    return float(f)


def test_model_flop_agrees_with_a_hand_count_at_the_cells_shapes():
    cfg = registry.config("convunetr-base-sax")
    forward = yardstick.model_flop(cfg, "segmentation", 1, train=False)
    assert math.isclose(forward, _convunetr_forward_flop_by_hand(), rel_tol=1e-9)
    train = yardstick.model_flop(cfg, "segmentation", 4, train=True)
    # the backward is two forwards, less the input gradient of the first layers, which nothing needs
    assert 2.9 * 4 * forward < train <= 3 * 4 * forward


def test_the_huge_step_s_extra_work_agrees_with_a_hand_count():
    """model_flop(huge) - model_flop(base) for a training micro-batch of 16: only the layers of the encoder's
    width differ, each training pass three forwards."""
    def forward(e, depth):
        t, n = 769, 2304 + 3 * 256  # tokens through the encoder; patches of the four views, dense in the stems
        blocks = depth * (24 * t * e * e + 4 * t * t * e)
        # per view: the patch embed (512 in), the stem's linear layer and the fusion's two strided convolutions
        # (64 channels by 4x4, 128 by 2x2); then the decoder's linear layer on the encoder's tokens
        projections = n * (2 * 512 * e + 2 * e * e + 2 * (64 * 16 + 128 * 4) * e) + 2 * t * e * 512
        return blocks + projections
    base = yardstick.model_flop(registry.config("cinema-mae-base"), "mae", 16, train=True)
    huge = yardstick.model_flop(_huge_config(), "mae", 16, train=True)
    assert math.isclose(huge - base, 3 * 16 * (forward(1280, 32) - forward(768, 12)), rel_tol=1e-9)


def test_busy_time_is_the_union_of_intervals_and_gaps_are_named_by_the_host():
    assert trace.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    span = trace.Span(device=[("flash_fwd_bf16", 0, 10), ("sm90_xmma_gemm", 5, 15), ("cudnn_conv", 40, 50)],
                      host=[("aten::mm", 14, 35), ("aten::linear", 12, 38), ("cudaLaunchKernel", 15, 45),
                            (trace.SPAN, -5, 60)],
                      wall_s=65e-6, units=2)
    span.classify(registry.kernel_classes())
    assert span.busy_s() == 25e-6 and span.busy_s("attention") == 10e-6 and span.busy_s("conv") == 10e-6
    gaps = span.idle_gaps()
    assert [name for name, _ in gaps] == ["aten::mm", "host work outside torch operations"]
    assert [round(s * 1e6, 6) for _, s in gaps] == [25, 15]
    assert span.device_ops()[0][0] in ("flash_fwd_bf16", "sm90_xmma_gemm", "cudnn_conv")


# ---------------------------------------------------------------- result line and correct, on the CPU


def test_the_result_line_has_the_keys_of_the_contract():
    out = tiny_cell("mae-pretrain-b16").run(BENCH)
    lines = out.pop("_lines")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"clips_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} and out["device"]["count"] == 1
    limits = registry.workload("mae-pretrain-b16")["correct"]["limits"]
    assert set(out["checks"]) == set(limits) == {line.split()[0] for line in lines}
    json.dumps(out)


@pytest.mark.parametrize("name", WORKLOADS)
def test_a_sound_run_is_correct(name):
    assert tiny_cell(name).run(BENCH)["correct"] is True


@pytest.mark.parametrize("name,fault", [(n, f) for n in WORKLOADS for f in faults.BY_KIND[registry.workload(n)["kind"]]])
def test_every_planted_fault_makes_correct_false(name, fault):
    assert tiny_cell(name, fault=fault).run(BENCH)["correct"] is False


@pytest.mark.parametrize("name", WORKLOADS)
def test_the_control_fails_a_limit(name):
    cell = tiny_cell(name, fault=faults.CONTROL)
    result = cell.drive()
    correct, judged = cell.judge(result)
    assert not correct and result["failed"] == 0
    assert not all(v["ok"] for v in judged.values())


# ---------------------------------------------------------------- imports


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "cinema_tpu_torch", f"{path} imports {name}"


def test_a_run_loads_no_jax_into_its_process():
    code = ("import sys; sys.argv = ['x']\n"
            "from perfbench.run import forbidden_modules\n"
            "from perfbench.tests.tiny import tiny_cell\n"
            "from perfbench.harness import registry\n"
            "tiny_cell('seg-serve-cine').run(registry.benchmark())\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the program's CUDA kernels")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_each_cell_runs_correct_on_the_card(card, name):
    chips = next(w["chips"] for w in BENCH["workloads"] if w["name"] == name)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"the cell needs {chips} CUDA devices")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", name, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "1"], cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_a_depthwise_convolution_s_backward_counts_twice_its_forward():
    from torch.nn import functional as F
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty(2, 8, 6, 6, 6, device="meta", requires_grad=True)
    w = torch.empty(8, 1, 5, 5, 5, device="meta", requires_grad=True)
    counter = FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward:
                                                             yardstick.conv_backward_flop})
    with counter:
        F.conv3d(x, w, padding=2, groups=8).sum().backward()
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert counts["aten.convolution"] == 2 * 2 * 8 * 125 * 216
    assert counts["aten.convolution_backward"] == 2 * counts["aten.convolution"]
