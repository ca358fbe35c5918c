"""CLI for the serve-path analysis: ``python -m repro_torch.analysis``.

Runs the default passes over the entrypoint registry on the card (or
``--device cpu`` / ``--device meta``), prints a pass/fail table per
(entrypoint, pass), optionally writes the JSON report, and exits non-zero
on any error finding.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="serve-path analysis of the port's routes")
    ap.add_argument("-e", "--entrypoint", action="append", default=None,
                    help="restrict to this entrypoint (repeatable)")
    ap.add_argument("-p", "--pass", dest="passes", action="append",
                    default=None,
                    help="restrict to this pass (repeatable)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full JSON report here")
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "cpu", "meta"),
                    help="where the entries run (and always on meta); "
                         "default the card")
    ap.add_argument("--list", action="store_true",
                    help="list registered entrypoints and passes, then exit")
    args = ap.parse_args(argv)

    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis import run_default
    from repro_torch.analysis.passes import default_passes

    if args.list:
        print("entrypoints:")
        for name, entry in ep.REGISTRY.items():
            print(f"  {name:22s} [{','.join(entry.tags)}] "
                  f"{entry.description}")
        print("passes:")
        for p in default_passes():
            print(f"  {p.name:22s} {p.description}")
        return 0

    if args.device == "cuda":
        from repro_torch import resolve_device
        resolve_device("cuda")
    report = run_default(entrypoints=args.entrypoint, passes=args.passes,
                         device=args.device)
    print(report.render())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=2)
        print(f"json report -> {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
