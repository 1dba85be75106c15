"""The port's preprocessing CLIs (``cinema_tpu_torch.data.preprocess``) against the JAX package's.

Each of the ten CLIs (the JAX package's console scripts, ``pyproject.toml``) runs on one seeded raw tree, written
by the writers of ``chip_smoke.py``, once as the JAX CLI and once as the port's, into two folders: the same
file list, NIfTI and CSV files equal byte for byte as whole files, PNGs equal as decoded pixels. The JAX CLIs
run with gzip's clock at 0, the time stamp that the port writes into every gzip stream, so that their outputs are
reproducible: ``tests/fixtures/preprocess_jax/`` is the JAX CLIs' output, which ``chip_smoke.py`` holds the port's
CLIs to on the card's machine, and it must equal the output regenerated here. Also: the Pillow-equal bicubic
resize of the landmark CLI against ``Image.resize``, and the port's tables (``read_table``, ``write_table``,
``iterrows``) against pandas."""

from __future__ import annotations

import contextlib
import gzip
import importlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cinema_tpu_torch.data import read_png_gray
from cinema_tpu_torch.data.datasets import iterrows, read_table, write_table
from cinema_tpu_torch.data.preprocess.landmark import resize_bicubic

_ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
CLIS = list(chip_smoke.PREPROCESS_CLIS)


@contextlib.contextmanager
def gzip_clock_at_zero():
    """``gzip.open`` writes the time stamp 0 in place of the clock's inside the block."""
    real_open = gzip.open

    def pinned(filename, mode="rb", *args, **kwargs):
        if "w" in mode:
            return gzip.GzipFile(filename, mode, mtime=0)
        return real_open(filename, mode, *args, **kwargs)

    gzip.open = pinned
    try:
        yield
    finally:
        gzip.open = real_open


def run_jax_cli(name: str, raw: Path, out: Path) -> None:
    """Write CLI ``name``'s seeded raw tree under ``raw`` (the seed of ``chip_smoke.run_port_cli``) and run the JAX
    package's CLI on it into ``out``, as its console script runs (``sys.argv``); Kaggle's studies in this process
    (``--max_n_cpus 1``: the same rows, no worker processes forked from the test's)."""
    module, function, writer, argv = chip_smoke.PREPROCESS_CLIS[name]
    writer(raw, seed=13)
    entry = getattr(importlib.import_module(f"cinema_tpu.data.preprocess.{module}"), function)
    saved = sys.argv
    try:
        with gzip_clock_at_zero():
            for args in argv(raw, out):
                if name == "kaggle_preprocess":
                    args = [*args[:-1], "1"]
                sys.argv = [name, *args]
                entry()
    finally:
        sys.argv = saved


def write_jax_fixtures(dest: Path) -> None:
    """Regenerate ``tests/fixtures/preprocess_jax`` into ``dest``: ``python -c "from pathlib import Path; from
    tests.test_torch_port_preprocess import write_jax_fixtures as w; w(Path('tests/fixtures/preprocess_jax'))"``
    (into an empty folder; the raw trees go to a temporary one)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for name in CLIS:
            run_jax_cli(name, Path(tmp) / name, dest / name)


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_outputs")
    for name in CLIS:
        run_jax_cli(name, root / "raw" / name, root / "out" / name)
    return root / "out"


@pytest.mark.parametrize("name", CLIS)
def test_port_cli_writes_what_the_jax_cli_writes(name, jax_outputs, tmp_path):
    seconds = chip_smoke.run_port_cli(name, tmp_path / "raw", tmp_path / "out")
    assert chip_smoke.compare_trees(tmp_path / "out", jax_outputs / name) == {}
    files = [p for p in (tmp_path / "out").rglob("*") if p.is_file()]
    assert files and seconds >= 0
    if name == "landmark_preprocess":  # the JAX CLI's PNGs decoded by Pillow, the port's by the port's reader
        from PIL import Image

        pngs = sorted(p.relative_to(tmp_path / "out") for p in files if p.suffix == ".png")
        assert len(pngs) == 16
        for png in pngs:
            want = np.asarray(Image.open(jax_outputs / name / png).convert("L"), np.float32).T
            np.testing.assert_array_equal(read_png_gray(tmp_path / "out" / png), want)


@pytest.mark.parametrize("name", CLIS)
def test_committed_fixture_is_the_jax_clis_output(name, jax_outputs):
    fixture = chip_smoke.PREPROCESS_FIXTURES / name
    assert chip_smoke.compare_trees(jax_outputs / name, fixture) == {}


def test_committed_fixtures_stay_small():
    sizes = [p.stat().st_size for p in chip_smoke.PREPROCESS_FIXTURES.rglob("*") if p.is_file()]
    assert 0 < sum(sizes) <= 1_000_000, sum(sizes)


def test_compare_trees_reports_each_kind_of_difference(tmp_path):
    from cinema_tpu_torch.data import save_nifti
    from cinema_tpu_torch.viz import write_png

    for side, value in (("a", 1), ("b", 2)):
        (tmp_path / side).mkdir()
        save_nifti(tmp_path / side / "x.nii.gz", np.full((3, 2, 2), value, np.uint8))
        write_png(tmp_path / side / "same.png", np.arange(6, dtype=np.uint8).reshape(2, 3))
        (tmp_path / side / "t.csv").write_text(f"a\n{value}\n")
        (tmp_path / side / f"only_{side}.csv").write_text("a\n")
    problems = chip_smoke.compare_trees(tmp_path / "a", tmp_path / "b")
    assert problems["x.nii.gz"]["voxels_differ"] == 12 and problems["x.nii.gz"]["max_abs_diff"] == 1.0
    assert problems["t.csv"] == "bytes differ" and "same.png" not in problems
    assert problems["only_a.csv"] == "only in the port's output"
    assert problems["only_b.csv"] == "missing from the port's output"


# --- the Pillow-equal resize of the landmark CLI ------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(height=st.integers(1, 80), width=st.integers(1, 80), out_height=st.integers(1, 90),
       out_width=st.integers(1, 90), seed=st.integers(0, 2**16), smooth=st.booleans())
def test_resize_is_pillows_bicubic_resize(height, width, out_height, out_width, seed, smooth):
    from PIL import Image

    rng = np.random.default_rng(seed)
    if smooth:
        image = ((np.add.outer(np.arange(height), 2 * np.arange(width)) * 5 + seed) % 256).astype(np.uint8)
    else:
        image = rng.integers(0, 256, (height, width)).astype(np.uint8)
    want = np.asarray(Image.fromarray(image, "L").resize((out_width, out_height)))
    np.testing.assert_array_equal(resize_bicubic(image, (out_width, out_height)), want)


@pytest.mark.parametrize("scale", [0.25, 0.5, 0.3, 1.0, 1.7])
@pytest.mark.parametrize("size", [(256, 256), (1024, 880), (97, 131)])
def test_resize_at_the_cli_scales_is_pillows(size, scale):
    from PIL import Image

    image = np.random.default_rng(size[0]).integers(0, 256, size[::-1]).astype(np.uint8)
    new_size = (int(size[0] * scale), int(size[1] * scale))
    want = np.asarray(Image.fromarray(image, "L").resize(new_size))
    np.testing.assert_array_equal(resize_bicubic(image, new_size), want)


# --- the tables as pandas reads and writes them --------------------------------------------------------------

TABLE_CASES = {
    "int-with-missing": [{"a": 1, "b": 70}, {"a": 2, "b": None}, {"a": 3, "b": float("nan")}],
    "bools": [{"flag": True, "maybe": np.bool_(False)}, {"flag": False, "maybe": None}],
    "numpy-scalars": [{"i": np.int64(3), "j": np.int32(-4), "f": np.float64(0.1), "g": np.float32(0.1),
                       "u": np.uint8(7)}, {"i": np.int64(5), "j": np.int32(2), "f": np.float64(1e-20),
                                           "g": np.float32(2.5), "u": np.uint8(0)}],
    "float32-with-python-float": [{"g": np.float32(0.1)}, {"g": 1.0}],
    "column-union": [{"pid": "a", "x": 1}, {"y": 2.5, "pid": "b"}, {"z": "q,\"r\"", "x": 4}],
    "mixed-object": [{"m": 1}, {"m": "one"}, {"m": True}, {"m": 1.5}],
    "floats": [{"f": 0.1 + 0.2, "g": 1e16, "h": -0.0, "k": float("inf")}, {"f": 5.0, "g": 123456789.0, "h": 1e-5,
                                                                           "k": -2.0}],
    "single-column-missing": [{"a": None}, {"a": None}],
    "empty": [],
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_write_table_is_pandas_to_csv(case, tmp_path):
    rows = TABLE_CASES[case]
    write_table(tmp_path / "port.csv", rows)
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_write_table_leading_columns_are_concats_and_an_empty_frames(tmp_path):
    old = pd.DataFrame({"uid": [1, 2], "view": ["lax_2c", "lax_2c"], "x1": [3, 4]})
    new = pd.DataFrame({"uid": ["U1"], "view": ["lax_4c"], "x1": [5], "extra": [0.5]})
    pd.concat([old, new], ignore_index=True).to_csv(tmp_path / "pandas.csv", index=False)
    write_table(tmp_path / "port.csv", [*old.to_dict("records"), *new.to_dict("records")],
                columns=list(old.columns))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    old.iloc[2:].to_csv(tmp_path / "pandas.csv", index=False)
    write_table(tmp_path / "port.csv", [], columns=list(old.columns))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


CSV_TEXT = ("i,f,im,b,s,sm,na,empty,dates,big\n"
            "1,1.5,7,True,x,a,NA,,\"30-Aug-2015\",1e3\n"
            "-2,2,,False,\"y,z\",,n/a,,31-Aug-2015,inf\n"
            "3,.5,9,TRUE,w,c,None,,1-Sep-2015,-1.25E-2\n")


def _same_value(got, want) -> bool:
    if isinstance(want, float) and np.isnan(want):
        return isinstance(got, float) and np.isnan(got)
    return got == want and isinstance(got, bool) == isinstance(want, (bool, np.bool_))


@pytest.mark.parametrize("names", [None, ["c1", "c2", "c3", "c4", "c5", "c6", "c7", "c8", "c9", "c10"]])
def test_read_table_types_columns_as_pandas_read_csv(names, tmp_path):
    text = CSV_TEXT if names is None else CSV_TEXT.split("\n", 1)[1]
    (tmp_path / "t.csv").write_text(text)
    columns, rows = read_table(tmp_path / "t.csv", names=names)
    frame = pd.read_csv(tmp_path / "t.csv", **({} if names is None else {"header": None, "names": names}))
    assert columns == list(frame.columns)
    for row, (_, want) in zip(rows, frame.astype(object).iterrows()):
        for c in columns:
            assert _same_value(row[c], want[c]), (c, row[c], want[c])
    kinds = {c: {type(row[c]) for row in rows} for c in columns}
    for c, dtype in frame.dtypes.items():
        if dtype.kind == "i":
            assert kinds[c] == {int}, c
        elif dtype.kind == "f":
            assert kinds[c] == {float}, c
    # and back: pandas' to_csv of what it read, byte for byte
    write_table(tmp_path / "port.csv", rows, columns=columns)
    frame.to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


@pytest.mark.parametrize("text", ["a,b\n1,2\n3,4\n", "a,b\n1,2.5\n3,4\n", "a,b\n1,\n3,4\n", "a,b\n1,x\n3,y\n"],
                         ids=["ints", "floats", "missing", "strings"])
def test_iterrows_is_pandas_iterrows(text, tmp_path):
    (tmp_path / "t.csv").write_text(text)
    got = list(iterrows(read_table(tmp_path / "t.csv")[1]))
    want = [dict(row) for _, row in pd.read_csv(io.StringIO(text)).iterrows()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            floats = (float, np.floating)
            assert _same_value(g[k], w[k]) and isinstance(g[k], floats) == isinstance(w[k], floats)
