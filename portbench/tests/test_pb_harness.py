"""The harness finds every configuration, traffic mix, limit file and
metric reader by the names in BENCHMARK.json; the window counts all
records after the warm-up over all of its seconds; and nothing of the
benchmark loads JAX or the JAX package."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import run as R

ROOT = R.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"reads_per_s", "placed_pct", "setup_s"} <= e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = R.load_cell(cell)
    entry = R.load_entry(c)
    assert callable(entry.build) and entry.reads_per_write(c) > 0
    assert c.mates in (1, 2) and c.traffic["batch"] % c.mates == 0
    assert all(isinstance(v, str) for v in c.config.get("env", {}).values())
    assert c.limits and {"missing", "record_mismatch"} <= set(c.limits)
    assert c.end_to_end and c.per_layer
    for m in c.end_to_end + c.per_layer:
        read = R.load_reader(m["name"])
        assert read(R.Run(c, "cpu")) in (None, 0.0)   # nothing to read


def test_unknown_cell_is_refused():
    with pytest.raises(R.RunError):
        R.load_cell("no-such.cell")


def test_entries_and_readers_are_found_by_name_only():
    with pytest.raises(R.RunError):
        R.load_file("entries", "../run", "x_")
    with pytest.raises(R.RunError):
        R.load_file("metrics", "no_such_metric", "x_")
    for f in os.listdir(os.path.join(ROOT, "portbench", "entries")):
        if f.endswith(".py") and f != "__init__.py":
            mod = R.load_file("entries", f[:-3], "x_")
            assert callable(mod.build) and callable(mod.reads_per_write)


def test_trace_env_comes_from_the_readers():
    c = R.load_cell(CELLS[0])
    env = R.trace_env(c)
    want = {}
    for m in c.per_layer:
        path = os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py")
        if "ENV = " in open(path).read():
            want.update(R.load_file("metrics", m["name"], "x_").ENV)
    assert env == want


class _Readers:
    def position(self):
        return 0


class _Ctl:
    def set_position(self, position):
        self.position = position

    def open_window(self, t):
        self.t_open = t


def test_window_counts_all_records_after_the_warm_up(monkeypatch):
    clock = iter([3.0, 4.0])
    monkeypatch.setattr(R.time, "monotonic", lambda: next(clock))
    sink = R.Sink(_Ctl(), _Readers(), warm=2 * 100,
                  keep_every=2, offset=1, max_kept=5)

    def stub_entry(out):             # 2 warm-up batches, then 5 more
        for b in range(7):
            out.write("".join(f"r{b}-{i}\tx\n" for i in range(100)))
    stub_entry(sink)
    seconds, reads = sink.window(10.5)
    assert sink.t_open == 3.0 and sink.n_open == 200
    assert (seconds, reads) == (7.5, 500)
    assert len(sink.kept) == 2 and sink.kept[0].startswith("r3-0")
    run = R.Run(R.load_cell(CELLS[0]), "cpu", window_s=seconds,
                window_reads=reads)
    assert R.load_reader("reads_per_s")(run) == 500 / 7.5


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, fs in os.walk(os.path.join(ROOT, "portbench")):
        yield from (os.path.join(d, f) for f in fs if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            top = mod.split(".", 1)[0]
            assert top not in R.FORBIDDEN, (path, mod)


def test_the_names_are_compared_whole():
    # smalt_tpu_torch begins with smalt_tpu and is not the JAX package
    assert "smalt_tpu_torch".split(".", 1)[0] not in R.FORBIDDEN
    assert "smalt_tpu.cli".split(".", 1)[0] in R.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "portbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".", 1)[0] not in ("smalt_tpu_torch",
                                                     "smalt_tpu"), (f, mod)


def test_loaded_modules_hold_no_jax():
    code = ("import sys, portbench.run, portbench.control, portbench.trace;"
            "import smalt_tpu_torch.map.fastmode, smalt_tpu_torch.cli;"
            "from portbench.run import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_trace_slice_busy_and_breakdown(tmp_path):
    from portbench import trace as T
    ev = [{"ph": "X", "name": "ProfilerStep#3", "cat": "user_annotation",
           "ts": 100, "dur": 50},
          {"ph": "X", "name": "ProfilerStep#4", "cat": "user_annotation",
           "ts": 150, "dur": 50},
          {"ph": "X", "name": "ProfilerStep#3", "cat": "gpu_user_annotation",
           "ts": 100, "dur": 100},
          {"ph": "X", "name": "void (anonymous namespace)::sw_full_kernel"
           "<true, 4>(int const*)", "cat": "kernel", "ts": 110, "dur": 20},
          {"ph": "X", "name": "k2", "cat": "kernel", "ts": 120, "dur": 20},
          {"ph": "X", "name": "Memcpy DtoH (Device -> Pinned)",
           "cat": "gpu_memcpy", "ts": 190, "dur": 30},
          {"ph": "X", "name": "aten::copy_", "cat": "cpu_op", "ts": 140,
           "dur": 45},
          {"ph": "X", "name": "outer", "cat": "cpu_op", "ts": 90, "dur": 200}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = T.load(str(p))
    assert (tr.t0, tr.t1, tr.steps) == (100, 200, 2)
    assert abs(tr.busy_s() - 40e-6) < 1e-12         # 110-140 and 190-200
    assert [d[0] for d in tr.kernels({"sw_full_kernel"})] == [ev[3]["name"]]
    bd = T.breakdown(tr)
    assert bd["device_ops"][0][0] == "sw_full_kernel"
    gaps = dict(bd["idle_gaps"])
    assert abs(gaps["aten::copy_"] - 50e-6) < 1e-12  # 140-190
    assert abs(gaps["outer"] - 10e-6) < 1e-12        # 100-110


def test_readers_find_how_far_the_port_read():
    import os
    name = f"pb-test-{os.getpid()}"
    fd = os.memfd_create(name, 0)
    os.write(fd, b"x" * 1000)
    try:
        rd = R.Readers([fd])
        assert rd.position() == 0          # its own descriptor is not read
        with open(f"/proc/self/fd/{fd}", "rb") as f:
            f.read(300)
            assert rd.position() >= 300
    finally:
        os.close(fd)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_result_without_the_program(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--device",
                        "cpu"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "not in this checkout" in p.stderr
