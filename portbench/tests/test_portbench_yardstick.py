"""The yardstick's arithmetic against values worked by hand at both
configurations' shapes."""
import json
from pathlib import Path

import pytest

from portbench import yardstick

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_roofline_at_gowalla():
    cfg = _cfg("sasrec-recjpq-gowalla")
    # 64 x 1,271,638 x 7 adds; codes 1,271,638 x 8 x 2 B, S 64 x 8 x 512
    # x 4 B, answers 64 x 10 x 8 B.
    assert yardstick.pq_topk_work(64, 1_271_638, 8, 2, 512, 10) == \
        (569_693_824, 20_346_208 + 1_048_576 + 5_120)
    t, by = yardstick.pq_topk_least_seconds(cfg, 64, 10)
    assert by == "operations"
    assert t == pytest.approx(569_693_824 / 67e12, rel=1e-12)
    assert t == pytest.approx(8.50289e-6, rel=1e-5)


def test_roofline_at_ten_million_items():
    cfg = _cfg("sasrec-recjpq-sim10m")
    adds, nbytes = yardstick.pq_topk_work(64, 10 ** 7, 8, 1, 256, 10)
    assert adds == 4_480_000_000
    assert nbytes == 80_000_000 + 524_288 + 5_120
    t, by = yardstick.pq_topk_least_seconds(cfg, 64, 10)
    assert by == "operations"
    assert t == pytest.approx(6.68657e-5, rel=1e-5)
    # One query: the bytes bound it.
    t1, by1 = yardstick.pq_topk_least_seconds(cfg, 1, 10)
    assert by1 == "bytes"
    assert t1 == pytest.approx((80_000_000 + 8_192 + 80) / 3.35e12)


@pytest.mark.parametrize("name,head", [
    ("sasrec-recjpq-gowalla", 2 * 512 * 512 + 1_271_638 * 7),
    ("sasrec-recjpq-sim10m", 2 * 256 * 512 + 10 ** 7 * 7)])
def test_request_flops(name, head):
    cfg = _cfg(name)
    # Two blocks of q, k, v, o (512 x 512) and the MLP (512 x 512 twice).
    assert yardstick.backbone_matmul_params(cfg) == 2 * 6 * 512 * 512
    backbone_40 = 2 * 3_145_728 * 40 + 2 * 4 * 40 * 40 * 512
    assert yardstick.request_flops(cfg, 40) == backbone_40 + head
    # Past max_seq_len the history is cut, as the engine cuts it.
    assert yardstick.request_flops(cfg, 500) == \
        yardstick.request_flops(cfg, 200)
