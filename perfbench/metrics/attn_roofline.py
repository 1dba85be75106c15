"""attn_roofline.*: the least time the attention work of the profiled span can take (its shapes'
flop at the bf16 peak or bytes at the HBM peak, whichever is larger, per layer), over the device
time in which a kernel of the attention class ran in the span, in percent."""

from perfbench.harness import yardstick


def read(result, span):
    busy = span.busy_s("attention")
    if busy <= 0:
        return None
    return 100.0 * yardstick.attention_min_s(result["span_attention_calls"]) * span.units / busy
