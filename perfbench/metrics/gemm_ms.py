"""gemm_ms.*: device milliseconds per unit in which a kernel of the gemm class ran (the union of
their intervals in the profiled span, over the span's units)."""


def read(result, span):
    busy = span.busy_s("gemm")
    return busy * 1e3 / span.units if busy > 0 else None
