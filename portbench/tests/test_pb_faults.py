"""A run with the timed path broken underneath comes out not correct:
for each fault a cell's mode can have (portbench/tests/faults/<mode>.py,
found by the configuration's `mode`; no exchange between chips: every
cell is one chip), the program is patched in the run's own process and
the run is driven as the benchmark drives it, on the CPU.  The cells are
those of BENCHMARK.json, and one of each mode that it has no cell of
(tests/cells.py).  Run these without pytest-xdist: runs side by side in
one worker each oversubscribe the cores."""
import importlib.util
import json
import os

import pytest

from portbench import run as R
from portbench.tests.cells import CELLS as ALL
from portbench.tests.cells import LISTED, bench_with, mode_of

# the cells of BENCHMARK.json, and one cell of each mode that it lacks
_MODES = {c: mode_of(c) for c in ALL}
CELLS = [(c, m) for c, m in _MODES.items() if c in LISTED]
CELLS += [(c, m) for m in sorted(set(_MODES.values()) - {m for _, m in CELLS})
          for c in [min(c for c in ALL if _MODES[c] == m)]]


def faults(mode):
    path = os.path.join(R.HERE, "tests", "faults", f"{mode}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_faults_" + mode.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAULTS


CASES = [(c, f) for c, mode in CELLS for f in faults(mode)]


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads, as the runs of test_pb_cpu_runs.py have: the
    runs here are in this process, and spinning OpenMP threads on a
    busy host slow them several times."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_mode_has_its_faults():
    for mode in set(_MODES.values()) | {
            f[:-3] for f in os.listdir(os.path.join(R.HERE, "entries"))
            if f.endswith(".py")}:
        assert len(faults(mode)) >= 3, mode


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_fault_comes_out_not_correct(cell, fault, monkeypatch, capsys,
                                     tmp_path):
    fault(monkeypatch)
    rc = R.main(["--workload", cell, "--seed", "4", "--seconds", "4",
                 "--device", "cpu", "--tiny", "--bench",
                 bench_with(cell, tmp_path)])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not res["correct"], res["checks"]
