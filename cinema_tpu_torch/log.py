"""Logging and run records (port of cinema_tpu/log.py:15-66): the logger of the preprocessing CLIs, and the
flattened config and the tags that a run folder's ``run.json`` holds, as the JAX package writes them."""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict, List

_FORMAT = "%(asctime)s | %(levelname)s | %(process)d | %(name)s | %(message)s"


def get_logger(name: str) -> logging.Logger:
    """A logger named ``name`` that writes to stdout at INFO, with one stream handler and no propagation."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def flatten_dict(d: Dict[str, Any], parent_key: str = "", sep: str = "_") -> Dict[str, Any]:
    """A nested dict flattened, the keys of each level joined by ``sep`` (cinema_tpu/log.py:34-43)."""
    items: Dict[str, Any] = {}
    for k, v in d.items():
        new_key = parent_key + sep + str(k) if parent_key else str(k)
        if isinstance(v, dict):
            items.update(flatten_dict(v, parent_key=new_key, sep=sep))
        else:
            items[new_key] = v
    return items


def get_run_tags(config) -> List[str]:
    """A run's tags, sorted and unique (cinema_tpu/log.py:46-66; the reference's wandb tags): the dataset,
    the model, the views, the task, ``seed{n}``, the label proportion ``{p}%``, and ``finetuned``, the class
    column and the regression column where the config has them."""
    views = config.model.views
    views = [views] if isinstance(views, str) else list(views)
    tags = [str(config.data.name), str(config.model.name), *views, str(config.task), f"seed{config.seed}",
            f"{int(config.data.proportion * 100)}%"]
    if config.model.get("ckpt_path"):
        tags.append("finetuned")
    if config.data.get("class_column"):
        tags.append(str(config.data.class_column))
    if config.data.get("regression_column"):
        tags.append(str(config.data.regression_column))
    return sorted(set(tags))
