"""The cells that the benchmark's files define: those of BENCHMARK.json
and, beside them, one for each limit file `limits/<config>.<traffic>.json`
that BENCHMARK.json does not list, so that the tests run every
configuration, traffic mix and reader in portbench/."""
import json
import os

from portbench import run as R

BENCH = json.load(open(os.path.join(R.ROOT, "BENCHMARK.json")))
LISTED = {w["name"] for w in BENCH["workloads"]}
CELLS = sorted(LISTED | {f[:-5] for f in os.listdir(
    os.path.join(R.HERE, "limits")) if f.endswith(".json")})


def bench_with(cell: str, tmp_path) -> str:
    """A BENCHMARK.json that holds `cell` (as `<config>.<traffic>` where
    BENCHMARK.json lacks it, with the per-layer metrics of the cells of
    its mode)."""
    if cell in LISTED:
        return os.path.join(R.ROOT, "BENCHMARK.json")
    b = json.loads(json.dumps(BENCH))
    config, traffic = cell.split(".", 1)
    cfile = f"portbench/configs/{config}.json"
    mode = json.load(open(os.path.join(R.ROOT, cfile)))["mode"]
    if config not in {c["name"] for c in b["configs"]}:
        b["configs"].append({"name": config, "source": "test",
                             "file": cfile, "reduced": [], "why": "test"})
    b["workloads"].append({"name": cell, "config": config,
                           "traffic": traffic, "chips": 1, "why": "test"})
    readers = {f[:-3] for f in os.listdir(os.path.join(R.HERE, "metrics"))
               if f.endswith(".py")}
    modes = {c["name"]: json.load(open(os.path.join(R.ROOT, c["file"])))[
        "mode"] for c in BENCH["configs"]}
    same = {w["name"] for w in BENCH["workloads"]
            if modes[w["config"]] == mode}
    for m in b["per_layer"]:
        if same & set(m["workloads"]):
            m["workloads"].append(cell)
    for name in sorted(readers - {m["name"] for m in b["end_to_end"] +
                                  b["per_layer"]}):
        b["per_layer"].append({"name": name, "unit": "%", "better": "lower",
                               "source": "program_span", "layer": "test",
                               "moves": "reads_per_s", "workloads": [cell]})
    p = tmp_path / f"bench-{mode}.json"
    p.write_text(json.dumps(b))
    return str(p)


def mode_of(cell: str) -> str:
    """The `mode` of a cell's configuration."""
    w = next((w for w in BENCH["workloads"] if w["name"] == cell), None)
    if w is None:
        cfile = f"portbench/configs/{cell.split('.', 1)[0]}.json"
    else:
        cfile = next(c["file"] for c in BENCH["configs"]
                     if c["name"] == w["config"])
    return json.load(open(os.path.join(R.ROOT, cfile)))["mode"]
