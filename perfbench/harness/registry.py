"""Where the benchmark finds its parts, by the names that BENCHMARK.json and the workload files use.

- ``workloads/<cell>.json``: the configuration, the driver (``kind``), the traffic's parameters and
  what decides ``correct``;
- ``configs/<config>.json``: the configuration as it is run, with its source and its cuts;
- ``drivers/<kind>.py``: one module per kind of traffic, with ``run(ctx)``;
- ``metrics/<family>.py``: one reader per per-layer metric family (the name before the first dot),
  with ``read(ctx)``;
- ``kernel_classes/*.json``: name patterns of the device kernels of one class.

A part is added by adding its file; nothing here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PERFBENCH = Path(__file__).resolve().parents[1]
CHECKOUT = PERFBENCH.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(CHECKOUT)} does not exist.")
    return json.loads(path.read_text(encoding="utf-8"))


def benchmark() -> dict:
    return _json(CHECKOUT / "BENCHMARK.json")


def workload(name: str, root: Path = PERFBENCH) -> dict:
    return _json(root / "workloads" / f"{name}.json")


def config(name: str, root: Path = PERFBENCH) -> dict:
    return _json(root / "configs" / f"{name}.json")


def workload_names(root: Path = PERFBENCH) -> List[str]:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{kind}")


def metric_family(metric: str) -> str:
    return metric.split(".", 1)[0]


def metric_reader(metric: str, root: Path = PERFBENCH) -> ModuleType:
    """The reader module of ``metric``'s family, loaded from ``metrics/<family>.py``."""
    family = metric_family(metric)
    path = root / "metrics" / f"{family}.py"
    if not path.is_file():
        raise FileNotFoundError(f"No reader metrics/{family}.py for the metric {metric}.")
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{family}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class KernelClass:
    """A named class of device kernels: a kernel belongs to the class of the lowest ``rank`` one of
    whose ``include`` patterns it matches."""

    def __init__(self, name: str, spec: dict) -> None:
        self.name = name
        self.rank = int(spec["rank"])
        self.include = [re.compile(p) for p in spec["include"]]

    def matches(self, kernel: str) -> bool:
        return any(p.search(kernel) for p in self.include)


def kernel_classes(root: Path = PERFBENCH) -> List[KernelClass]:
    classes = [KernelClass(p.stem, _json(p)) for p in sorted((root / "kernel_classes").glob("*.json"))]
    return sorted(classes, key=lambda c: (c.rank, c.name))


def classify(kernel: str, classes: List[KernelClass]) -> str:
    for c in classes:
        if c.matches(kernel):
            return c.name
    return "other"


def cell_metrics(cell: str, section: str, bench: Dict) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that ``cell`` reports: those that
    list it, and those without a ``workloads`` key that move an end-to-end metric the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e]
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
