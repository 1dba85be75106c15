"""mfu.*: the model's floating-point operations of all units done in the window (counted once on
the plain reference at the cell's shapes, forward and, for training, backward, no recomputation)
over the window's seconds times the bf16 peak of the chips the run used (``chips``, 1 where the
result names none), in percent."""

from perfbench.harness import yardstick


def read(result, span):
    return 100.0 * result["flop_per_unit"] * result["units"] / (
        result["window_s"] * yardstick.PEAK_BF16_FLOPS * result.get("chips", 1))
