"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding the port (libllsm2_tpu_torch) on a
machine with an NVIDIA card.  BENCHMARK.json names the cells; harness.py
says what a run does.  The last line of standard output is the result,
one JSON object; the last lines of standard error give each number
compared beside its limit.  Without a card (or with fewer than the cell
asks for), without the port, or with jax / the JAX package loaded when
the window closes, it exits with another code than 0 and prints no
result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"
    return r.stdout.strip().replace("\n", "; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the configurations run in float32: the port reads this at import
    os.environ["LLSM_FP64"] = "0"
    sys.path.insert(0, str(REPO))
    from portbench import harness
    cell = harness.resolve(args.workload)
    import torch
    need = int(cell.entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"portbench: the cell needs {need} CUDA device(s); found "
              f"{have}", file=sys.stderr)
        return 3
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      T_START)
    if args.trace:
        # the roofline shares are against the published peaks at 700 W
        print(f"portbench: card power limit: {power_limit()}",
              file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
