"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  ``--trace 0`` measures the window and reports the cell's end-to-end
metrics; ``--trace 1`` traces a short window under torch.profiler and
reports its per-layer metrics.  Either way the reference checks what the
window produced and the last lines on standard error give each number
compared beside its limit; the last line on standard output is the
result, a JSON object.  Without the card, or with JAX or the JAX package
loaded in the process, the run prints no result and exits with 2.

The program builds its kernels into ``svo_raytracer_torch/_build/``
inside the checkout, a fixed path, so only a checkout's first run builds.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import Refused, run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, readings = run(args.workload, args.seed, args.seconds,
                               bool(args.trace), root=ROOT)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    for name, value, limit in readings:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
