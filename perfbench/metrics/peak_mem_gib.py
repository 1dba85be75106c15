"""peak_mem_gib.*: the device memory allocated at the peak of the window (the allocator's peak,
reset when the window opens), in GiB."""


def read(result, span):
    return result["memory_peak_bytes"] / 2**30 if result["memory_peak_bytes"] > 0 else None
