"""A copy of the benchmark at a size the CPU runs in a second: the tiny
configuration and two mixes, one closed and one open, in a fresh root."""
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

CONFIG = {
    "name": "tiny", "source": "a small SASRec-RecJPQ for tests",
    "backbone": "sasrec", "n_items": 1000, "d_model": 32, "n_blocks": 2,
    "n_heads": 2, "d_ff": 32, "max_seq_len": 16,
    "pq": {"m": 4, "b": 16, "code_dtype": "uint8"}, "dtype": "float32",
    "serve_method": "pqtopk_fused",
    "reference": "portbench/reference/sasrec.py",
    "check": {"sample": 8, "limits": {"score_err": 5e-5, "topk_gap": 2e-5}},
}
LENGTH = {"dist": "lognormal", "median": 6, "sigma": 1.0, "min": 2,
          "max": 16}
ITEMS = {"dist": "zipf", "exponent": 1.0}
MIXES = {
    "tiny-closed": {"loop": "closed", "max_batch": 8, "waiting": 16,
                    "pregen_req_per_s": 200, "k": 5, "length": LENGTH,
                    "items": ITEMS},
    "tiny-open": {"loop": "open", "arrivals": "poisson", "max_batch": 8,
                  "knee_req_per_s": 1000, "load": 0.8, "k": 5,
                  "length": LENGTH, "items": ITEMS},
}
CELLS = {"tiny.closed": "tiny-closed", "tiny.open": "tiny-open"}


def make_root(tmp: Path) -> Path:
    """A root holding BENCHMARK.json with the tiny cells and a copy of
    ``portbench/`` with their files added."""
    root = Path(tmp) / "root"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "tests"))
    (root / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(CONFIG))
    for name, mix in MIXES.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps({"name": name, **mix}))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": CONFIG["source"],
                            "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "tests"})
    for cell, mix in CELLS.items():
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": mix, "chips": 1, "why": "tests"})
    for m in spec["end_to_end"]:
        if m["name"] == "req_per_s":
            m["workloads"].append("tiny.closed")
    # The open loop's tail, whose readers no cell of the benchmark lists
    # yet.
    names = {m["name"] for m in spec["end_to_end"]}
    for name in ("p95_ms", "mrt_ms"):
        if name not in names:
            spec["end_to_end"].append(
                {"name": name, "unit": "ms", "better": "lower",
                 "bound": 0.25, "source": "host_clock", "workloads": []})
        next(m for m in spec["end_to_end"]
             if m["name"] == name)["workloads"].append("tiny.open")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
