"""Run one cell of the benchmark of cinema_tpu_torch and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell asks for. The cell's
workload file (``perfbench/workloads/<cell>.json``) names its configuration, its driver and its
traffic; BENCHMARK.json names the metrics it reports. With ``--trace 0`` the last line of standard
output holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy seconds and the breakdown of one profiled span. Either way the run ends by comparing what the
timed path produced with the plain reference (``correct``); the numbers compared and their limits
are the last lines of standard error and the last key of the result.

Every kernel and cache the program builds stays under ``build/`` in the checkout, so that only a
cell's first run in a checkout builds. The run exits with an error, and prints no result, where
the devices are missing or where JAX, flax, optax or the JAX package was loaded into the process.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_CHECKOUT = Path(__file__).resolve().parents[1]
_BUILD = _CHECKOUT / "build"
os.environ["CINEMA_TORCH_BUILD_DIR"] = str(_BUILD / "kernels")
os.environ["TRITON_CACHE_DIR"] = str(_BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cinema_tpu")


def process_start() -> float:
    """The epoch time at which this process started (Linux's /proc), or now where that is unreadable."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        boot = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    import json

    started = process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from perfbench.harness import cell as cells
    from perfbench.harness import registry

    bench = registry.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"BENCHMARK.json has no workload {args.workload}.", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"The cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available.", file=sys.stderr)
        return 3
    cell = cells.Cell.load(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                           started=started)
    result = cell.run(bench)
    found = forbidden_modules()
    if found:
        print(f"The process loaded {', '.join(found)}: the benchmark must not run the JAX package.", file=sys.stderr)
        return 4
    for line in result.pop("_lines"):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
