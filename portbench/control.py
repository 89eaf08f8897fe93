"""Read the program's numbers and the control's, seed after seed.

Usage, from the root of a checkout on the card::

    python3 -m portbench.control --workload <name> --seconds <s> SEED...

Each seed is one run of the cell (``run.run_cell``: set-up, a window of
``--seconds`` at the cell's own load, the check at its own sizes) that
also judges the control: the reference with a bfloat16 distance fold
(``reference.align``, ``precision="bf16"``) put in the program's place
on the same sampled rows, its numbers held to the same limits
(``check.verdict``).  One JSON line a seed: the program's ``correct``
and numbers, and the control's.  The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .cells import Bench
from .run import RunError, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("seeds", type=int, nargs="+")
    a = ap.parse_args(argv)
    bench = Bench(os.getcwd())
    for seed in a.seeds:
        try:
            out = run_cell(bench, a.workload, seed, a.seconds, False,
                           control="bf16")
        except RunError as e:
            print(f"portbench.control: {e}", file=sys.stderr)
            return 2
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": out["correct"],
                          "program": {k: v["value"]
                                      for k, v in out["checks"].items()},
                          "control_correct": out["control"]["correct"],
                          "control": {k: v["value"] for k, v in
                                      out["control"]["checks"].items()},
                          "rows_checked": out["checked"]["rows_checked"],
                          "reference_s": out["checked"]["reference_s"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
