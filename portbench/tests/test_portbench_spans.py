"""The readings of ``portbench/spans.py``: the host metrics from the
program's spans, the device metrics from kernels put down to the span
that launched them, the idle split, each on hand-made spans, operations
and runtime events (None where there is nothing to read), and one run of
the tiny cell on the CPU with the program's tracer on."""
import pytest

from portbench import spans as sp
from portbench.tests import tiny
from repro_torch import tracing

MS = 1_000_000


def _span(name, start_ms, end_ms, batch=None, parent=None):
    return tracing.Span(name, int(start_ms * MS), int(end_ms * MS), parent,
                        1, batch)


def _batch(b, at_ms, prepare=2, launch=1, wait=10, results=3):
    """One batch's engine spans from ``at_ms``: prepare, launch, complete
    (a wait, then results)."""
    p1 = at_ms + prepare
    l1 = p1 + launch
    c1 = l1 + wait + results
    return [_span("engine.prepare", at_ms, p1, b),
            _span("engine.launch", p1, l1, b),
            _span("engine.complete", l1, c1, b),
            _span("engine.results", l1 + wait, c1, b, "engine.complete")]


def test_host_metrics_read_the_engine_spans():
    spans = []
    at = 0.0
    for b, prepare in enumerate((2, 4, 6, 8)):
        spans += _batch(b, at, prepare=prepare)
        at += prepare + 1 + 13 + 5          # 5 ms of the harness's own
    got = sp.host(spans, 0, int(1e3 * MS))
    # gap b -> b+1: results (3) + harness (5) + next prepare (4, 6, 8).
    assert got["engine.host_gap_ms.backlog"] == pytest.approx(3 + 5 + 6)
    assert got["engine.prepare_ms.backlog"] == pytest.approx(5)
    assert got["engine.results_ms.backlog"] == pytest.approx(3)
    # Batches outside the window are left out; a lone batch has no gap.
    alone = sp.host(spans, 0, int(1 * MS))
    assert alone["engine.host_gap_ms.backlog"] is None
    assert alone["engine.prepare_ms.backlog"] == pytest.approx(2)
    assert sp.host([], 0, 10) == dict.fromkeys(sp.HOST_METRICS)


def test_innermost_holder_of_nested_spans():
    i = sp.Interval
    spans = [i("run_once", 0, 100), i("engine.launch", 10, 50),
             i("model.head", 30, 50), i("head.merge", 40, 45),
             i("submit", 100, 120)]
    h = sp.Holder(spans)
    assert [None if h.at(t) is None else h.at(t).name
            for t in (-1, 0, 10, 29, 30, 40, 45, 50, 99, 100, 119, 120)] == [
        None, "run_once", "engine.launch", "engine.launch", "model.head",
        "head.merge", "model.head", "run_once", "run_once", "submit",
        "submit", None]
    pieces = [(None if s is None else s.name, ns)
              for s, ns in h.split(35, 130)]
    assert pieces == [("model.head", 5), ("head.merge", 5),
                      ("model.head", 5), ("run_once", 50), ("submit", 20),
                      (None, 10)]
    assert list(sp.Holder([]).split(3, 7)) == [(None, 4)]


class _Event:
    def __init__(self, name, device, start, dur, corr):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_kernels_are_put_down_to_the_span_that_launched_them():
    """Device operations run later than their launches; each counts for
    the spans that hold its runtime call's host time."""
    events = [
        _Event("cudaLaunchKernel", "CPU", 12, 1, 1),    # backbone
        _Event("cudaLaunchKernel", "CPU", 14, 1, 2),    # backbone
        _Event("cudaLaunchKernel", "CPU", 31, 1, 3),    # head
        _Event("cudaLaunchKernel", "CPU", 41, 1, 4),    # merge
        _Event("cudaMemcpyAsync", "CPU", 52, 1, 5),     # launch, a copy
        _Event("cudaLaunchKernel", "CPU", 200, 1, 6),   # no program span
        _Event("gemm", "CUDA", 100, 40, 1),
        _Event("layer_norm", "CUDA", 140, 10, 2),
        _Event("pq_topk_fused_kernel", "CUDA", 150, 30, 3),
        _Event("DeviceSegmentedRadixSortKernel", "CUDA", 180, 20, 4),
        _Event("Memcpy DtoH (Device -> Pinned)", "CUDA", 200, 6, 5),
        _Event("fill", "CUDA", 210, 4, 6),
        _Event("orphan", "CUDA", 220, 10, 99),          # no runtime event
    ]
    ops = sp.ops_with_launches(events)
    assert [op.launched_ns for op in ops] == [12, 14, 31, 41, 52, 200, None]
    assert [op.kernel for op in ops] == [True] * 4 + [False] + [True] * 2
    i = sp.Interval
    spans = [i("engine.launch", 10, 60), i("model.backbone", 11, 30),
             i("model.head", 30, 50), i("head.merge", 40, 50)]
    got = sp.device(ops, spans, n_batches=2)
    assert got["backbone.span_device_ms.backlog"] == pytest.approx(
        50 / 1e6 / 2)
    assert got["head.span_device_ms.backlog"] == pytest.approx(50 / 1e6 / 2)
    assert got["head.merge_device_ms.backlog"] == pytest.approx(
        20 / 1e6 / 2)
    assert got["backbone.launches.backlog"] == 1.0
    # Covered: all but the fill (launched outside) and the orphan.
    assert got["coverage"] == pytest.approx(100 * 106 / 120)
    assert sp.device([], spans, 2) == dict.fromkeys(sp.DEVICE_METRICS
                                                    + ("coverage",))
    assert sp.device(ops, spans, 0)["coverage"] is None


def test_idle_time_is_split_over_the_innermost_spans():
    i = sp.Interval
    spans = [i(n, a * MS, b * MS) for n, a, b in (
        ("run_once", 0, 100), ("engine.complete", 60, 100),
        ("engine.results", 70, 100), ("submit", 100, 130))]
    got = sp.idle_split([(65 * MS, 110 * MS), (130 * MS, 140 * MS)], spans,
                        n_batches=5)
    assert got == pytest.approx({"engine.results": 6.0,
                                 "submit": 2.0, "engine.complete": 1.0,
                                 "harness": 2.0})
    assert list(got) == ["engine.results", "submit", "harness",
                         "engine.complete"]


def test_a_run_with_the_tracer_on_reads_its_window(tmp_path):
    root = tiny.make_root(tmp_path)
    row = sp.measure(root, "tiny.closed", 2 ** 31 + 17, 0.4, False, True,
                     device_name="cpu")
    assert row["correct"] and row["spans_dropped"] == 0
    host = row["window_host"]
    assert set(host) == set(sp.HOST_METRICS)
    assert all(v is not None and v > 0 for v in host.values()), host
    off = sp.measure(root, "tiny.closed", 5, 0.2, False, False,
                     device_name="cpu")
    assert off["correct"] and "window_host" not in off
    assert not tracing._on
    assert tracing.take().spans == []
