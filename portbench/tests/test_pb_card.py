"""On the card: every cell runs with its own sizes and window and comes
out correct, and its control comes out not correct.  Skips where
no CUDA card is visible."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run as R

BENCH = json.load(open(os.path.join(R.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_and_its_control_on_the_card(cell, card):
    p = subprocess.run([sys.executable, "-m", "portbench.control",
                        "--workload", cell, "--seed", "77", "--seconds",
                        str(BENCH["run_seconds"])],
                       cwd=R.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu" and res["correct"], res
    assert res["control_correct"] is False
    assert any(c["value"] is not None and c["value"] > c["limit"]
               for c in res["control"].values()), res["control"]
