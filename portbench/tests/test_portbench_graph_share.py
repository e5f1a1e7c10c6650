"""The reader of ``graph_share.prefill`` on windows made by hand, with the
helpers of ``test_portbench_program_spans``: the share of ``llama.forward``
spans that counted a replay, and nothing where the program records no
such span or its model has no graph counter."""

import pytest

from brpc_tpu_torch.models import llama
from portbench.tests.test_portbench_program_spans import MS, reader, span, \
    window


def test_graph_share_counts_the_forward_spans_that_replayed(monkeypatch):
    graph = llama.GRAPH_COUNTER
    spans = [span("llama.forward", (0, MS), **{graph: 1}),
             span("llama.forward", (2 * MS, 3 * MS), **{graph: 1}),
             span("llama.forward", (4 * MS, 5 * MS)),  # eager
             span("llama.forward", (6 * MS, 7 * MS), **{graph: 1}),
             span("llama.cast", (0, MS), **{graph: 1}),  # not read
             span("llama.forward", (2000 * MS, 2001 * MS),  # outside
                  **{graph: 1})]
    w = window(monkeypatch, spans, [(0, "k", 0, MS)])
    assert reader("graph_share.prefill").read(w) == pytest.approx(75.0)
    w = window(monkeypatch, [spans[2]], [])
    assert reader("graph_share.prefill").read(w) == 0.0


def test_graph_share_gives_nothing_without_spans_or_counter(monkeypatch):
    w = window(monkeypatch, [span("request.T512", (0, MS))], [])
    assert reader("graph_share.prefill").read(w) is None
    # a program whose model has no graph counter, as before the graphs
    w = window(monkeypatch, [span("llama.forward", (0, MS))], [])
    monkeypatch.delattr(llama, "GRAPH_COUNTER")
    assert reader("graph_share.prefill").read(w) is None
