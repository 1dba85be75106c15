"""allreduce_exposed.*: the share of the collective class's device time in the profiled span during
which no kernel of another class ran on the device, in percent: the collectives' time that nothing
hides."""

from perfbench.harness.trace import union_us


def read(result, span):
    collective = [(a, b) for n, a, b in span.device if span.classes.get(n) == "collective"]
    others = [(a, b) for n, a, b in span.device if span.classes.get(n) != "collective"]
    busy = union_us(collective)
    if busy <= 0:
        return None
    return 100.0 * (union_us(collective + others) - union_us(others)) / busy
