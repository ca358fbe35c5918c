"""The port's host spans (``repro_torch.tracing``) on the CPU: off, they are
one shared no-op and record nothing; on, one ``run_once`` records the
engine's, the model's and the merge's spans, nested as they run; threads
keep their parents apart; the cap drops the oldest; and the clock pair
puts a profiler event inside the span that held it."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.configs.base import get_reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import seqrec
from repro_torch.serving.engine import Request, RetrievalEngine

CFG = get_reduced("sasrec-recjpq").model
ENGINE = ("engine.prepare", "engine.launch", "engine.complete",
          "engine.results")


@pytest.fixture(autouse=True)
def off_after():
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture(scope="module")
def params():
    return seqrec.init_seqrec(torch.Generator().manual_seed(0), CFG)


@pytest.fixture(scope="module")
def engine(params):
    return RetrievalEngine.for_seqrec(params, CFG, k=5, max_batch=4,
                                      device="cpu")


def _serve(engine, n=3, first_id=0):
    rng = np.random.default_rng(first_id)
    for i in range(n):
        engine.submit(Request(first_id + i,
                              rng.integers(1, CFG.n_items + 1, 9), k=5))
    return engine.run_once()


def test_off_is_one_shared_no_op_and_records_nothing(engine):
    assert tracing.span("engine.prepare", 0) is tracing.span("model.head")
    with tracing.span("x") as s:
        assert s is tracing.span("y")
    assert len(_serve(engine)) == 3
    got = tracing.take()
    assert got.spans == [] and got.dropped == 0


def test_one_run_once_records_the_spans_nested(engine):
    _serve(engine)                      # an earlier batch: index 0 or more
    tracing.enable()
    assert len(_serve(engine, first_id=10)) == 3
    got = tracing.take()
    by = {s.name: s for s in got.spans}
    assert sorted(s.name for s in got.spans) == sorted(
        ENGINE + ("model.backbone", "model.head", "head.merge"))
    assert len(by) == len(got.spans)
    parents = {s.name: s.parent for s in got.spans}
    assert parents == {"engine.prepare": None, "engine.launch": None,
                       "model.backbone": "engine.launch",
                       "model.head": "engine.launch",
                       "head.merge": "model.head",
                       "engine.complete": None,
                       "engine.results": "engine.complete"}
    index = by["engine.prepare"].batch
    assert index >= 1
    assert {by[n].batch for n in ENGINE} == {index}
    assert {by[n].batch for n in ("model.backbone", "model.head",
                                  "head.merge")} == {None}
    assert len({s.thread for s in got.spans}) == 1
    for s in got.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    order = ["engine.prepare", "engine.launch", "engine.complete"]
    for a, b in zip(order, order[1:]):
        assert by[a].end_ns <= by[b].start_ns
    assert by["model.backbone"].end_ns <= by["model.head"].start_ns
    # The next batch takes the next index; take() cleared the first.
    _serve(engine, first_id=20)
    again = tracing.take()
    assert {s.batch for s in again.spans if s.name in ENGINE} == {index + 1}
    assert got.clock[0] > 0 and got.clock[1] > 0


@pytest.mark.parametrize("shards", [None, 2])
def test_serve_topk_spans_the_backbone_and_the_head(params, shards):
    """The flat and the item-sharded head each run inside ``model.head``,
    every merge of slot winners inside it."""
    mesh = None if shards is None else make_mesh(shards, ["cpu"] * shards)
    seqs = torch.randint(1, CFG.n_items + 1, (4, CFG.max_seq_len),
                         generator=torch.Generator().manual_seed(1))
    tracing.enable()
    ids, _ = seqrec.serve_topk(params, seqs, CFG, k=5,
                               method="pqtopk_fused", sharded_mesh=mesh)
    spans = tracing.take().spans
    assert ids.shape == (4, 5)
    names = [s.name for s in spans]
    assert names.count("model.backbone") == names.count("model.head") == 1
    assert names.count("head.merge") >= 1
    assert {s.parent for s in spans if s.name == "head.merge"} == {
        "model.head"}


def test_threads_keep_their_parents_apart():
    tracing.enable()
    inside = threading.Barrier(2, timeout=10)

    def work(name):
        with tracing.span(name):
            inside.wait()               # both outer spans are open now
            with tracing.span(name + ".child"):
                inside.wait()

    threads = [threading.Thread(target=work, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = {s.name: s for s in tracing.take().spans}
    assert {n: s.parent for n, s in spans.items()} == {
        "a": None, "b": None, "a.child": "a", "b.child": "b"}
    assert spans["a"].thread == spans["a.child"].thread
    assert spans["b"].thread == spans["b.child"].thread
    assert spans["a"].thread != spans["b"].thread


def test_the_cap_drops_the_oldest_and_counts_them():
    tracing.enable()
    extra = 5
    for i in range(tracing.CAPACITY + extra):
        with tracing.span("s", i):
            pass
    got = tracing.take()
    assert len(got.spans) == tracing.CAPACITY and got.dropped == extra
    assert got.spans[0].batch == extra
    assert got.spans[-1].batch == tracing.CAPACITY + extra - 1
    assert tracing.take() == ([], got.clock, 0)


def test_disable_stops_recording():
    tracing.enable()
    with tracing.span("kept"):
        pass
    with tracing.span("open at disable"):
        tracing.disable()
    with tracing.span("after"):
        pass
    assert [s.name for s in tracing.take().spans] == ["kept"]


def test_a_profiler_event_lands_inside_its_span_on_the_clock_pair():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        with tracing.span("outer"):
            time.sleep(0.002)
            with record_function("inner"):
                time.sleep(0.002)
            time.sleep(0.002)
    got = tracing.take()
    outer, = got.spans
    mono, unix = got.clock
    inner, = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inner"]
    start = inner.start_ns() - unix + mono
    end = start + inner.duration_ns()
    assert outer.start_ns < start < end < outer.end_ns
