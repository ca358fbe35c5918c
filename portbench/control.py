"""The control of a cell's check, and the program's readings beside it.

  python3 portbench/control.py --workload NAME --seeds 11,12,... \\
      [--control-seeds 3] [--seconds 3] [--out FILE.json]

In one process, for each seed: one short run of the cell (its own
traffic and load, and the same check as a benchmark run), then, for the
first ``--control-seeds`` seeds, the control on the same sample: the
plain reference computed in TF32, put in the program's place and judged
by the same numbers.  The limits of ``configs/<name>.json`` are set
between the program's largest reading and the control's smallest.
Prints one line a seed, and with ``--out`` writes every reading there as
JSON.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    import argparse
    import torch
    from portbench import check, harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    rows = []
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        r = harness.run(ROOT, args.workload, seed, args.seconds, False,
                        control=j < args.control_seeds,
                        log=lambda s: None)
        row = {"seed": seed, "correct": r["correct"],
               "program": {n: r["checks"][n]["value"] for n in check.NUMBERS},
               "control": r.get("control"), "failed": r["failed"],
               "attempted": r["attempted"]}
        rows.append(row)
        print(f"seed {seed}: program {row['program']} control "
              f"{row['control']} failed {row['failed']} of "
              f"{row['attempted']} ({time.monotonic() - t:.1f} s)",
              flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(rows, indent=1))
    for name in check.NUMBERS:
        prog = max(row["program"][name] for row in rows)
        ctrl = [row["control"][name] for row in rows if row["control"]]
        print(f"{name}: program's largest {prog!r} over {len(rows)} seeds; "
              f"control's smallest {min(ctrl) if ctrl else None!r} over "
              f"{len(ctrl)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
