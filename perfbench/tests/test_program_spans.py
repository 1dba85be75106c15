"""CPU tests of what the benchmark reads from the program's own spans and counters
(``cinema_tpu_torch.trace``): ``chunk_fill`` over a whole cycle of the serving mix, and an idle gap
inside a program span with no torch operation, named by that span. Run with
``python -m pytest perfbench/tests -q``."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import registry, trace
from perfbench.harness import traffic as traffic_gen


class _FrameCounter(torch.nn.Module):
    """Stands in for ConvUNetR in ``segment_cine``: 2x2x1 frames, every label 0."""

    image_size_dict = {"sax": (2, 2, 1)}

    def __init__(self) -> None:
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(()))

    def predict_labels(self, images: dict) -> dict:
        return {"sax": torch.zeros(images["sax"].shape[:-1], dtype=torch.uint8)}


def test_chunk_fill_reads_87_5_over_a_whole_cycle_of_the_mix():
    from cinema_tpu_torch import trace as program
    from cinema_tpu_torch.serve import segment_cine

    shapes = traffic_gen.study_shapes(registry.workload("seg-serve-cine")["traffic"])
    program.reset("serve.frames", "serve.frame_slots")
    for _, _, _, t in shapes:
        segment_cine(_FrameCounter(), np.zeros((2, 2, 1, t), dtype=np.uint8))
    assert (program.counter("serve.frames"), program.counter("serve.frame_slots")) == (630, 720)
    assert registry.metric_reader("chunk_fill.serve").read({}, None) == 87.5


def test_a_gap_inside_a_program_span_with_no_torch_operation_is_named_by_it():
    span = trace.Span(device=[("cudnn_conv", 0, 10), ("cudnn_conv", 50, 60)],
                      host=[(trace.SPAN, -10, 110), ("serve.study", -5, 100), ("serve.preprocess", 12, 48),
                            ("aten::copy_", 49, 51)],
                      wall_s=120e-6, units=1)
    gaps = span.idle_gaps()
    assert [name for name, _ in gaps] == ["serve.study", "serve.preprocess"]
    assert [round(s * 1e6, 6) for _, s in gaps] == [60, 40]
    assert span.busy_s() == 20e-6
