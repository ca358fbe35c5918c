"""The harness's record of answers: copies by request id, and what counts
as failed."""
import numpy as np

from portbench.harness import Answers
from repro_torch.serving.engine import Result


def _result(rid, ids, shed=False):
    ids = np.asarray(ids, np.int32)
    return Result(rid, ids, np.linspace(1, 0, len(ids), dtype=np.float32),
                  latency_ms=2.0 + rid, shed=shed)


def test_answers_are_copied_and_judged():
    a = Answers(4, k=3)
    a.record([_result(0, [5, 6, 7]), _result(1, [1, 2, 3])], t=10.0)
    # A batch with a shed request and a repeated id takes the slow path.
    a.record([_result(2, [], shed=True), _result(3, [4, 4, 9])], t=11.0)
    a.record([_result(5, [8, 9, 10])], t=12.0)          # grows the store
    assert a.at[:6].tolist()[:4] == [10.0, 10.0, 11.0, 11.0]
    assert np.isnan(a.at[4]) and a.at[5] == 12.0
    assert a.ids[1].tolist() == [1, 2, 3]
    assert a.latency_ms[3] == 5.0
    # 2 shed, 3 repeats an id, 4 unanswered; 5's id 10 is out of 10 rows.
    assert a.failed(6, n_rows=11) == 3
    assert a.failed(6, n_rows=10) == 4


def test_a_batch_keeps_no_view_of_the_engines_buffers():
    buf = np.arange(6, dtype=np.int32).reshape(2, 3)
    a = Answers(2, k=3)
    a.record([Result(0, buf[0], np.zeros(3, np.float32), 1.0),
              Result(1, buf[1], np.zeros(3, np.float32), 1.0)], t=0.0)
    buf[:] = -1
    assert a.ids.tolist() == [[0, 1, 2], [3, 4, 5]]
