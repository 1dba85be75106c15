"""The readings that the limits of ``correct`` are set from, for one cell, in one process.

    python3 -m perfbench.control --workload <cell> --seeds 11,12,... [--control-seeds 21,22,23]
        [--faults] [--seconds 3] [--out control-<cell>.json]

Each reading is a run of the cell's driver with a short window, judged by the cell's ``correct``:
for each of ``--seeds`` the program as it is; for each of ``--control-seeds`` the control
(``faults.CONTROL``: the plain reference with fp8 products in the program's place, on the same
sample); with ``--faults``, each fault of ``harness.faults`` that the cell's kind can have, planted
under the timed path, on the control seeds. Prints one JSON line per reading, with every number the
driver compares, and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from perfbench import run as _run  # noqa: F401  (the checkout's cache directories)
from perfbench.harness import cell as cells
from perfbench.harness import faults, registry


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", action="store_true")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("The readings are taken on a CUDA device; none is available.", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    kind = registry.workload(args.workload)["kind"]
    planted = faults.BY_KIND[kind] if args.faults else ()
    runs = [("program", s, None) for s in seeds] + [("control", s, faults.CONTROL) for s in control_seeds]
    runs += [(f, s, f) for f in planted for s in control_seeds]
    readings = []
    for what, seed, fault in runs:
        t0 = time.perf_counter()
        cell = cells.Cell.load(args.workload, seed, args.seconds, False, device, started=time.time(), fault=fault)
        result = cell.drive()
        correct, _ = cell.judge(result)
        reading = {"what": what, "seed": seed, "correct": correct, "numbers": result["numbers"],
                   "worst": result.get("worst"), "seconds": time.perf_counter() - t0}
        readings.append(reading)
        print(json.dumps(reading), flush=True)
        del cell, result
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"workload": args.workload, "device": torch.cuda.get_device_name(device), "readings": readings},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
