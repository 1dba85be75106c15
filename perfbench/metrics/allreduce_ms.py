"""allreduce_ms.*: device milliseconds per unit in which a kernel of the collective class (NCCL's) ran
on the profiled rank (the union of their intervals in the span, over the span's units). A collective
kernel starts when this rank launches it and ends when the slowest rank has joined, so the time
includes the wait for the slowest rank."""


def read(result, span):
    busy = span.busy_s("collective")
    return busy * 1e3 / span.units if busy > 0 else None
