"""A configuration, traffic mix and metric dropped into a copy of the
benchmark are found by name, with no file edited."""
import json

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def test_a_new_cell_runs_from_its_files_alone(root):
    got = harness.run(root, "tiny.closed", 2 ** 31 + 3, 0.5, False,
                      device="cpu", log=lambda s: None)
    assert got["correct"], got["checks"]
    assert set(got["metrics"]) == {"req_per_s", "setup_s"}
    assert got["metrics"]["req_per_s"]["value"] > 0
    assert list(got)[-1] == "checks"


def test_an_open_cell_reports_its_tail(root):
    got = harness.run(root, "tiny.open", 4, 0.5, False, device="cpu",
                      log=lambda s: None)
    assert got["correct"], got["checks"]
    m = got["metrics"]
    assert set(m) == {"p95_ms", "mrt_ms", "setup_s"}
    assert m["p95_ms"]["value"] >= m["mrt_ms"]["value"] > 0


def test_a_configuration_is_checked_by_the_reference_it_names(root):
    """A new backbone brings its own reference file: a copy whose scores
    are all off by one makes the run not correct, so the harness reads
    the file the configuration names and no other."""
    refs = root / "portbench" / "reference"
    (refs / "tiny_shifted.py").write_text(
        (refs / "sasrec.py").read_text() + "\n\n_all_scores = all_scores\n\n"
        "def all_scores(*a, **kw):\n    return _all_scores(*a, **kw) + 1.0\n")
    cfg_path = root / "portbench" / "configs" / "tiny.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["reference"] = "portbench/reference/tiny_shifted.py"
    cfg_path.write_text(json.dumps(cfg))
    got = harness.run(root, "tiny.closed", 5, 0.3, False, device="cpu",
                      log=lambda s: None)
    assert not got["correct"]
    assert got["checks"]["score_err"]["value"] == pytest.approx(1.0,
                                                                abs=1e-5)


def test_a_new_metric_file_is_found_by_name(root):
    (root / "portbench" / "metrics" / "tiny.fill.new.py").write_text(
        "def read(ctx):\n    sizes = getattr(ctx, 'batch_sizes', None)\n"
        "    return None if not sizes else float(np.mean(sizes))\n"
        "import numpy as np\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "tiny.fill.new", "unit": "req",
                              "better": "higher", "source": "program_counter",
                              "layer": "engine", "moves": "req_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root)
    # No workloads key: every cell that reports req_per_s reports it.
    assert "tiny.fill.new" in [m["name"]
                               for m in bench.per_layer("tiny.closed")]
    assert "tiny.fill.new" not in [m["name"]
                                   for m in bench.per_layer("tiny.open")]
    read = bench.reader("tiny.fill.new")
    assert read(type("Ctx", (), {"batch_sizes": [8, 8, 4]})()) == \
        pytest.approx(np.mean([8, 8, 4]))
    assert read(type("Ctx", (), {})()) is None


def test_the_benchmark_names_files_that_exist():
    bench = harness.Bench(tiny.BENCH.parent)
    for c in bench.spec["configs"]:
        assert (bench.root / c["file"]).exists()
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"]
        assert callable(bench.reference(cfg).all_scores)
    for w in bench.spec["workloads"]:
        bench.traffic(w["traffic"])
        for m in bench.end_to_end(w["name"]) + bench.per_layer(w["name"]):
            assert callable(bench.reader(m["name"]))
