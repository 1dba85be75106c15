"""The JAX package reads and evaluates a run folder that the port's ``run_train`` wrote: one CPU epoch of the
ACDC regression task with a tiny ConvViT (``test_torch_port_run_folder.tiny_regression_run``), then the JAX
``load_run`` (its ``config.yaml`` and newest safetensors) and ``cinema_tpu.tasks.evaluate.main`` on one copy
of the folder, the port's ``tasks.evaluate.main`` on another: the same config, the same model outputs and the
same metric tables, f32 on both sides (the JAX side's Pallas kernels in interpret mode) within 2e-4. A file of
its own: pytest-xdist's ``--dist loadfile`` runs a file on one worker."""

from __future__ import annotations

import json
import shutil
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from cinema_tpu_torch.tasks import evaluate
from tests.test_torch_port_run_folder import tiny_regression_run

ATOL = 2e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def test_the_jax_package_loads_and_evaluates_a_port_run_folder(tmp_path):
    from cinema_tpu.tasks import evaluate as jax_evaluate

    config, folder = tiny_regression_run(tmp_path / "run")
    jconfig, jmodel, params = jax_evaluate.load_run(folder)
    assert json.loads(json.dumps(jconfig)) == json.loads(json.dumps(config))
    port_config, model = evaluate.load_run(folder, device="cpu")
    image = np.random.default_rng(0).random((3, *config.data.sax.patch_size, 2), np.float32)
    with torch.no_grad():
        got = model({"sax": torch.from_numpy(image)}).numpy()
    want = np.asarray(jmodel.apply(params, {"sax": image}))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    port_folder, jax_folder = (shutil.copytree(folder, tmp_path / side) for side in ("port", "jax"))
    evaluate.main(["--folder_path", str(port_folder), "--split", "train", "--device", "cpu"])
    jax_evaluate.main(["--folder_path", str(jax_folder), "--split", "train"])
    port_tables = sorted(p.name for p in (port_folder / "acdc_eval").iterdir())
    assert port_tables == sorted(p.name for p in (jax_folder / "acdc_eval").iterdir()) and port_tables
    for table in port_tables:
        g, w = (pd.read_csv(f / "acdc_eval" / table) for f in (port_folder, jax_folder))
        assert list(g.columns) == list(w.columns) and len(g) == len(w) > 0
        pd.testing.assert_frame_equal(g, w, rtol=0, atol=ATOL)
