"""Find the highest rate an open-loop cell sustains: one short run of the
cell at each offered rate, in one process.

  python3 portbench/sweep.py --workload NAME --rates 5000,6000,... \\
      [--seconds 10] [--seed N]

A rate is sustained where the window answered about what it offered and
the requests still unanswered at the close stay under two full batches:
past it the queue grows all through the window.  Prints one line a rate.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    import argparse
    import torch
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for rate in (float(r) for r in args.rates.split(",")):
        lines = []
        r = harness.run(ROOT, args.workload, args.seed, args.seconds, False,
                        mix_overrides={"knee_req_per_s": rate,
                                       "load": 1.0},
                        log=lines.append)
        m = r["metrics"]
        print(f"rate {rate}: offered {r['attempted']} in {args.seconds} s; "
              f"p95_ms {m['p95_ms']['value']} mrt_ms {m['mrt_ms']['value']}"
              f"; correct {r['correct']}; " + "; ".join(
                  s for s in lines if s.startswith(("window", "generator",
                                                    "answered"))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
