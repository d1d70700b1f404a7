"""The readers of map --fast's batch lines (`# fx-batch`, map/fastmode.py
FastSpans) on made-up runs: each sums its spans over the loop's spans
but `write` (`main`) after the traffic's warm-up batches, and returns
None where the program printed no batch line (a program without them)
or where the lines lack one of its spans."""
import json
import os

import pytest

from portbench import run as R
from portbench.tests import cells

CELL = "ecoli-fast.se100-n6"
NEW = ("fast.read_pct", "fast.step_pct", "fast.pool_wait_pct")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The repo's BENCHMARK.json, which lists the --fast cell with these
    readers as its per-layer metrics."""
    return cells.bench_with(CELL, tmp_path_factory.mktemp("bench"))


def _line(period, read=0.0, encode=0.0, enqueue=0.0, sync=0.0, split=0.0,
          submit=None, pool_wait=None, render=None, write=0.001):
    ln = (f"# fx-batch n=4096 rows=4096 period={period:.6f} "
          f"read={read:.6f} encode={encode:.6f} enqueue={enqueue:.6f} "
          f"sync={sync:.6f} split={split:.6f}")
    for k, v in (("submit", submit), ("pool_wait", pool_wait),
                 ("render", render)):
        if v is not None:
            ln += f" {k}={v:.6f}"
    ln += f" write={write:.6f}"
    if submit is not None:
        ln += " chunks=6 wrender=0.150000"
    return ln


def _run(bench, lines):
    c = R.load_cell(CELL, bench)
    return R.Run(c, "cuda", stderr=["# SMALT_TIMING something", *lines])


def _warm(bench):
    return R.load_cell(CELL, bench).traffic["warmup_batches"]


def test_shares_of_main_skip_the_warm_up(bench):
    """Each share is of the batch's spans but the sink's `write`, summed
    over the batches after the warm-up (whose 50 s of pool start count in
    none of them)."""
    warm = [_line(60.0, read=5.0, enqueue=5.0, submit=0.1, pool_wait=50.0)
            ] * _warm(bench)
    after = [_line(0.04, read=0.001, encode=0.002, enqueue=0.006,
                   sync=0.0005, split=0.0001, submit=0.0004,
                   pool_wait=0.02, write=3.0),
             _line(0.05, read=0.003, encode=0.002, enqueue=0.008,
                   sync=0.0015, split=0.0003, submit=0.0006,
                   pool_wait=0.03, write=0.5)]
    run = _run(bench, warm + after)
    main = (0.001 + 0.002 + 0.006 + 0.0005 + 0.0001 + 0.0004 + 0.02 +
            0.003 + 0.002 + 0.008 + 0.0015 + 0.0003 + 0.0006 + 0.03)
    read = lambda m: R.load_reader(m)(run)
    assert read("fast.read_pct") == pytest.approx(100 * 0.004 / main)
    assert read("fast.step_pct") == pytest.approx(
        100 * (0.004 + 0.014 + 0.002) / main)
    assert read("fast.pool_wait_pct") == pytest.approx(
        100 * (0.05 + 0.001) / main)


def test_one_process_lines_count_render_in_main(bench):
    """-n 1 (no pool): `render` is in `main`, and the pool's share has no
    span to read."""
    lines = [_line(0.1, read=0.01, encode=0.01, enqueue=0.02,
                   render=0.06)] * (_warm(bench) + 3)
    run = _run(bench, lines)
    assert R.load_reader("fast.read_pct")(run) == pytest.approx(10.0)
    assert R.load_reader("fast.step_pct")(run) == pytest.approx(30.0)
    assert R.load_reader("fast.pool_wait_pct")(run) is None


@pytest.mark.parametrize("name", NEW)
def test_none_without_batch_lines(bench, name):
    """A program that prints no batch line (the parent of these lines),
    or only warm-up batches: nothing to read."""
    read = R.load_reader(name)
    assert read(_run(bench, [])) is None
    only_warm = [_line(0.1, read=0.01, submit=0.01, pool_wait=0.01)
                 ] * _warm(bench)
    assert read(_run(bench, only_warm)) is None


@pytest.mark.parametrize("name,drop", [("fast.read_pct", "read"),
                                       ("fast.step_pct", "enqueue"),
                                       ("fast.pool_wait_pct", "pool_wait")])
def test_none_where_a_span_is_missing(bench, name, drop):
    """A line that lacks one of the reader's spans: None, not a share of
    what is left."""
    full = _line(0.1, read=0.01, encode=0.01, enqueue=0.02, sync=0.01,
                 submit=0.01, pool_wait=0.03)
    cut = " ".join(f for f in full.split() if not f.startswith(drop + "="))
    run = _run(bench, [full] * _warm(bench) + [full, cut, full])
    assert R.load_reader(name)(run) is None


def test_none_where_main_is_zero(bench):
    run = _run(bench, [_line(0.0, submit=0.0, pool_wait=0.0)] * (_warm(bench) + 2))
    for name in NEW:
        assert R.load_reader(name)(run) is None


def test_readers_listed_and_their_environment(bench):
    """The repo's BENCHMARK.json gives these readers to its --fast cell
    alone; they move reads_per_s, and each turns the loop's lines on in
    the traced run."""
    repo = json.load(open(os.path.join(R.ROOT, "BENCHMARK.json")))
    assert CELL in {w["name"] for w in repo["workloads"]}
    assert set(NEW) <= {m["name"] for m in repo["per_layer"]}
    for name in NEW:
        m = next(m for m in R.load_cell(CELL, bench).per_layer
                 if m["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "reads_per_s"
        assert m["source"] == "program_span"
        assert R.load_file("metrics", name, "x_").ENV == {
            "SMALT_TIMING": "1"}
    for cell in ("chr20-exact.pe150", "chr20-exact.se100"):
        assert not set(NEW) & {m["name"] for m in
                               R.load_cell(cell).per_layer}
