"""The precision control: the reference, computed in bfloat16 (the
precision below the configuration's float32), put in the system's place
and judged by the same comparison, at the cell's own size.  It has to
come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 2]

For each seed it runs the cell as the benchmark does, with a short
window, and prints one JSON line: the system's readings (``checks``) and
the control's (``control``) of the same captured frames.  With
``--fault <kind>-<name>`` (``faults.all_faults``) it plants that fault in
the system instead, and ``checks`` are the fault's readings.  The
benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.faults import all_faults  # noqa: E402
from portbench.harness import run  # noqa: E402

LOW = torch.bfloat16


def control(drv, ref):
    """The control's readings of ``drv``'s window, by ``ref``."""
    return drv.control(ref, LOW)


def main(argv=None):
    faults = all_faults()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=sorted(faults),
                    help="plant this fault in the system and read it in "
                         "place of the control")
    args = ap.parse_args(argv)
    if args.fault:
        faults[args.fault](setattr)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run(args.workload, seed, args.seconds, False, root=ROOT,
                        control=None if args.fault else control)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "control": result.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
