"""Every cell that the benchmark's files define (tests/cells.py) runs end
to end on the CPU (--device cpu, --tiny: a 300 kb genome, batches of 256)
with and without --trace, comes out correct, and prints no device
metric; the control of every cell comes out not correct.  Each run is
its own process, as the benchmark's are."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run as R
from portbench.tests.cells import BENCH, CELLS, LISTED, bench_with

def _run(module, *args):
    # two torch threads a run: test workers side by side oversubscribe
    # the cores otherwise, and spinning OpenMP threads then crawl
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-m", module, *args, "--device",
                        "cpu", "--tiny"], cwd=R.ROOT, capture_output=True,
                       text=True, timeout=900, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


def test_every_file_is_in_a_cell():
    used = {"configs": set(), "traffic": set()}
    for cell in CELLS:
        config, traffic = cell.split(".", 1)
        w = next((w for w in BENCH["workloads"] if w["name"] == cell), None)
        if w is not None:
            config, traffic = w["config"], w["traffic"]
            config = next(c["file"] for c in BENCH["configs"]
                          if c["name"] == config)[len("portbench/configs/"):-5]
        used["configs"].add(config)
        used["traffic"].add(traffic)
    for folder, names in used.items():
        have = {f[:-5] for f in os.listdir(os.path.join(R.HERE, folder))
                if f.endswith(".json")}
        assert have == names, folder


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu(cell, trace, tmp_path):
    bench = bench_with(cell, tmp_path)
    res, err = _run("portbench.run", "--workload", cell, "--seed", "1",
                    "--seconds", "10", "--trace", str(trace),
                    "--bench", bench)
    c = R.load_cell(cell, bench)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    wanted = c.per_layer if trace else c.end_to_end
    device = {m["name"] for m in wanted if m["source"] == "device_trace"}
    assert not device & set(res["metrics"])
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in wanted}
    elif cell in LISTED:
        assert set(res["metrics"]) == {m["name"] for m in wanted} - device
    else:       # readers of the device's trace read nothing on the CPU
        assert set(res["metrics"]) <= {m["name"] for m in wanted} - device


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell, tmp_path):
    res, _ = _run("portbench.control", "--workload", cell, "--seed", "2",
                  "--seconds", "5", "--bench", bench_with(cell, tmp_path))
    assert res["correct"]
    ctl = res["control"]
    assert res["control_correct"] is False
    assert set(ctl) == set(res["checks"])
    assert any(c["value"] is not None and c["value"] > c["limit"]
               for c in ctl.values()), ctl
