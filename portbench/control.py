"""The control of a cell's comparison: a run of the cell whose kept
batches are judged twice, as the program wrote them and as the control
re-renders them (reference/judge.py control_texts: each mapped read
scored end to end on its alignment's diagonal, no gap, no clip).  The
control has to come out not correct.  The benchmark's own runs never
run this.

    python3 -m portbench.control --workload <cell> --seed <n> --seconds <s>

prints the result line of the run with `control` beside `checks`.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench.run import RunError, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--bench", default="")
    a = ap.parse_args(argv)
    a.trace = 0
    try:
        res = run_cell(a, control=True)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    res.pop("timing_lines", None)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
