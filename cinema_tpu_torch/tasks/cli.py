"""The command line of the fine-tuning tasks (port of cinema_tpu/tasks/cli.py):
``--config``, ``--device`` and dotted ``key=value`` overrides."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Union

from cinema_tpu_torch.config import PACKAGED, apply_overrides, from_dict, load_config


def task_main(packaged: str, run_fn, doc: str, argv: Union[List[str], None] = None) -> None:
    """Parse the arguments and call ``run_fn(config, device=...)``; without ``--config`` the
    packaged config ``PACKAGED[packaged]`` is used."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--config", type=Path, help=f"YAML config (default: the packaged {packaged} config)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides, e.g. data.dir=studies")
    args = parser.parse_args(argv)
    config = load_config(args.config) if args.config else from_dict(PACKAGED[packaged])
    run_fn(apply_overrides(config, args.overrides), device=args.device)
