"""One run of one cell: its files resolved, its driver run, its metrics read and its result assembled."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from perfbench.harness import checks, registry


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float = field(default_factory=time.time)
    fault: Optional[str] = None
    setup_s: Optional[float] = None

    @classmethod
    def load(cls, name: str, seed: int, seconds: float, trace: bool, device: torch.device, started: float,
             fault: Optional[str] = None) -> "Cell":
        workload = registry.workload(name)
        return cls(name, workload, registry.config(workload["config"]), seed, seconds, trace, device, started, fault)

    def mark_setup_done(self) -> None:
        """Called by the cell's traffic module just before its first timed step."""
        self.setup_s = time.time() - self.started

    def drive(self) -> dict:
        """The cell's driver run: its window, its profiled span, and the numbers compared."""
        return registry.driver(self.workload["kind"]).run(self)

    def judge(self, result: dict) -> tuple:
        """(``correct``, each number with a limit beside its limit) of a driver run."""
        judged = checks.judge(result["numbers"], self.workload["correct"]["limits"])
        return all(v["ok"] for v in judged.values()) and result["failed"] == 0, judged

    def run(self, bench: dict) -> dict:
        result = self.drive()
        span = result["span"]
        if span is not None:
            span.classify(registry.kernel_classes())
        metrics = {}
        if self.trace:
            for m in registry.cell_metrics(self.name, "per_layer", bench):
                value = registry.metric_reader(m["name"]).read(result, span)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            rates = {self.workload["rate_metric"]: result["units"] / result["window_s"], "setup_s": self.setup_s}
            for m in registry.cell_metrics(self.name, "end_to_end", bench):
                metrics[m["name"]] = {"value": rates[m["name"]], "unit": m["unit"]}
        correct, judged = self.judge(result)
        device = {
            "platform": "gpu" if self.device.type == "cuda" else self.device.type,
            "kind": torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu",
            "count": int(result.get("chips", 1)),
            "memory_peak_bytes": int(result["memory_peak_bytes"]),
        }
        out = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"], "metrics": metrics, "device": device}
        if span is not None:
            device["busy_s"] = span.busy_s()
            device["window_s"] = span.wall_s
            out["breakdown"] = {"device_ops": span.device_ops(), "idle_gaps": result["gaps"].idle_gaps()}
        out["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in judged.items()}
        out["_lines"] = checks.lines(judged)
        return out
