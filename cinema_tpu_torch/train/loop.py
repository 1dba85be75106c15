"""Training-loop helpers (port of cinema_tpu/train/loop.py: the metrics log)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict


class MetricsLogger:
    """Append-only JSONL metrics log."""

    def __init__(self, out_dir: Path) -> None:
        self.path = Path(out_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, metrics: Dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in metrics.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
