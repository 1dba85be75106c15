"""CPU tests of the data-parallel driver (``drivers/train_ddp.py``) on two gloo ranks at tiny widths,
and of the harness's readings of a run on several chips: a sound run keeps the replicas identical
(``rank_gap`` 0), a dead rank or one that loaded jax ends the run with an error, and a one-chip result
reads as before. Run with ``python -m pytest perfbench/tests -q``."""

from __future__ import annotations

import subprocess
import sys
import time


from perfbench.harness import faults, registry, trace
from perfbench.tests.tiny import tiny_cell

BENCH = registry.benchmark()


def test_a_sound_ddp_run_keeps_the_replicas_identical():
    out = tiny_cell("mae-pretrain-ddp4").run(BENCH)
    assert out["correct"] is True and out["checks"]["rank_gap"]["value"] == 0.0
    assert out["device"]["count"] == 2 and out["attempted"] >= 1


def test_replica_drift_is_caught_by_rank_gap_alone():
    out = tiny_cell("mae-pretrain-ddp4", fault="replica_drift").run(BENCH)
    checks = out["checks"]
    assert out["correct"] is False and checks["rank_gap"]["value"] > 0.0
    assert all(v["value"] <= v["limit"] for k, v in checks.items() if k != "rank_gap")


def _run_in_a_process(fault: str) -> subprocess.CompletedProcess:
    """A tiny run of the cell with ``fault``, in a process of its own (the watchdog may end it), which
    has to end within 120 s."""
    code = ("from perfbench.tests.tiny import tiny_cell\n"
            "from perfbench.harness import registry\n"
            f"tiny_cell('mae-pretrain-ddp4', fault={fault!r}).run(registry.benchmark())\n"
            "print('no error')\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.CHECKOUT, capture_output=True, text=True,
                         timeout=170)
    assert time.perf_counter() - t0 < 120
    return out


def test_a_rank_that_raises_ends_the_run_with_an_error():
    out = _run_in_a_process(faults.RANK_RAISES)
    assert out.returncode != 0 and "no error" not in out.stdout
    assert "rank 1 raised" in out.stderr


def test_a_spawned_rank_that_loads_jax_ends_the_run_with_an_error():
    out = _run_in_a_process(faults.RANK_LOADS_JAX)
    assert out.returncode != 0 and "no error" not in out.stdout
    assert "rank 1 loaded jax" in out.stderr


def _result(units: int, chips=None) -> dict:
    result = {"flop_per_unit": 2.5e12, "units": units, "window_s": 50.0, "memory_peak_bytes": 2**33}
    if chips is not None:
        result["chips"] = chips
    return result


def test_a_one_chip_result_reads_as_before_and_mfu_divides_by_the_chips():
    mfu = registry.metric_reader("mfu.ddp")
    one = mfu.read(_result(4000), None)
    assert one == 100.0 * 2.5e12 * 4000 / (50.0 * 989e12)
    assert mfu.read(_result(4000, chips=1), None) == one
    assert mfu.read(_result(16000, chips=4), None) == one


def test_allreduce_readers_take_the_collective_class_and_its_exposed_share():
    span = trace.Span(device=[("flash_fwd_bf16", 0, 10), ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 5, 25),
                              ("sm90_xmma_gemm", 30, 40)], host=[], wall_s=50e-6, units=2)
    span.classify(registry.kernel_classes())
    assert span.classes["ncclDevKernel_AllReduce_Sum_f32_RING_LL"] == "collective"
    assert registry.metric_reader("allreduce_ms.ddp").read({}, span) == 20e-6 * 1e3 / 2
    # 20 us of collective, 5 of them under the attention kernel
    assert abs(registry.metric_reader("allreduce_exposed.ddp").read({}, span) - 75.0) < 1e-9
    quiet = trace.Span(device=[("flash_fwd_bf16", 0, 10)], host=[], wall_s=1e-5, units=1)
    quiet.classify(registry.kernel_classes())
    assert registry.metric_reader("allreduce_ms.ddp").read({}, quiet) is None
    assert registry.metric_reader("allreduce_exposed.ddp").read({}, quiet) is None
