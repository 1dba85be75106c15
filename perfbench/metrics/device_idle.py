"""device_idle.*: the share of the profiled span's host wall time in which no operation ran on
the device, in percent; busy time and wall time come from the same span."""


def read(result, span):
    return 100.0 * (1.0 - span.busy_s() / span.wall_s)
