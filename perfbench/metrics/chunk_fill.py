"""chunk_fill.*: the share of the model's frame slots that held a frame of a study, in percent: the
program's counters ``serve.frames`` over ``serve.frame_slots`` (``cinema_tpu_torch.trace``; the ragged
last chunk of a study is filled with repeated frames, which take the other slots), over every study
the run's process served: the warm-up study, the window's and the two traced passes'. None where the
program keeps no such counters."""


def read(result, span):
    try:
        from cinema_tpu_torch import trace
    except ImportError:
        return None
    counts = trace.counters()
    slots = counts.get("serve.frame_slots", 0)
    return 100.0 * counts["serve.frames"] / slots if slots else None
