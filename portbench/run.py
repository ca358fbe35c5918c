"""Run one cell of the port's benchmark on the card(s) of this machine.

  python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints what it learns on standard error,
the compared numbers beside their limits last there, and one JSON object
as the last line of standard output.  Exits with another code than 0,
printing no result, where there is no CUDA card or fewer than the cell
asks for, and where ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` is loaded once the window has closed.
"""
import os
import time


def _process_start() -> float:
    """This process's start on ``time.monotonic``'s clock (to 10 ms)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start_ticks / os.sysconf("SC_CLK_TCK"))
        return time.monotonic() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic()


PROCESS_T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# Build and kernel caches stay in this checkout, at fixed paths; nothing
# that may load JAX by itself is let do so.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(CACHE / _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def loaded_forbidden():
    """Top-level names in ``sys.modules`` that the run may not hold."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    cell = harness.Bench(ROOT).cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{torch.cuda.device_count()} CUDA devices; the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda",
                         process_t0=PROCESS_T0,
                         log=lambda s: print(s, file=sys.stderr, flush=True))
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              "runs the port alone", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # Straight out: the device tracer's teardown at the interpreter's exit
    # can fault after the result is out.  The run holds no child process
    # and no file open for writing.
    os._exit(code)
