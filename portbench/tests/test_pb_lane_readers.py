"""The readers of the device lanes' batch lines (lanelines.py and the
metrics that use it) on made-up runs: each sums the lines after the
traffic's warm-up batches, reads only its own lane's fields, and returns
None where the program printed no batch line (a program without them)."""
import pytest

from portbench import run as R

PE, SE = "chr20-exact.pe150", "chr20-exact.se100"
NEW = ("entry.read_pct", "exact.wait_pct", "exact.remap_pct",
       "exact.restaged_flag_pct", "exact.restaged_check_pct",
       "exact.oracle_pct")


def _line(tag, n, period, read=0.0, wait=0.0, remap=None, causes=(0,) * 6,
          oracle=None):
    keys = ("rs_h", "rs_dev", "rs_ck", "rs_stats", "rs_geom", "rs_simd")
    ln = (f"# {tag}-batch n={n} period={period:.6f} read={read:.6f} "
          f"pre=0.010000 stage=0.020000 wait={wait:.6f} post=0.030000 "
          f"tail=0.040000 oracle=0.000000 fallback=0.000000 write=0.000100 "
          f"collate=0.050000 fetch=0.001000 pass2=0.000000")
    if remap is not None:
        ln += f" remap={remap:.6f}"
    ln += f" restaged={sum(causes)} " + " ".join(
        f"{k}={v}" for k, v in zip(keys, causes))
    if oracle is not None:
        ln += f" oracle_pairs={oracle}"
    return ln


def _run(cell, lines):
    c = R.load_cell(cell)
    return R.Run(c, "cuda", stderr=["# dx-prep 0.100s", *lines,
                                    "# dx-total 9.000s n_restaged=1"])


def _warm(cell):
    return R.load_cell(cell).traffic["warmup_batches"]


def test_spans_over_main_skip_the_warm_up():
    """A span's share is of the main thread's spans of the same batches
    but the sink's `write` (0.1 s of other spans a line beside read and
    wait); the warm-up batches (here with a step build's 50 s) count in
    none of them."""
    warm = [_line("dx", 4096, 50.0, read=40.0, wait=40.0, remap=9.0)
            for _ in range(_warm(SE))]
    after = [_line("dx", 4096, 2.0, read=0.1, wait=0.5, remap=0.2),
             _line("dx", 4096, 2.0, read=0.3, wait=0.1, remap=0.1)]
    run = _run(SE, warm + after)
    main = 0.1 + 0.5 + 0.3 + 0.1 + 2 * 0.1
    read = lambda m: R.load_reader(m)(run)
    assert read("entry.read_pct") == pytest.approx(100 * 0.4 / main)
    assert read("exact.wait_pct") == pytest.approx(100 * 0.6 / main)
    assert read("exact.remap_pct") == pytest.approx(100 * 0.3 / main)


def test_causes_split_into_caps_and_checks():
    """rs_h + rs_dev over the rows, and the four checks over the rows; the
    two together are the re-stages over the rows."""
    warm = [_line("dxp", 4096, 1.0, causes=(4096,) * 6)] * _warm(PE)
    after = [_line("dxp", 4096, 1.0, causes=(100, 300, 10, 20, 30, 40)),
             _line("dxp", 4096, 1.0, causes=(0, 400, 0, 0, 0, 100))]
    run = _run(PE, warm + after)
    flag = R.load_reader("exact.restaged_flag_pct")(run)
    check = R.load_reader("exact.restaged_check_pct")(run)
    assert flag == pytest.approx(100.0 * 800 / 8192)
    assert check == pytest.approx(100.0 * 200 / 8192)
    assert flag + check == pytest.approx(100.0 * 1000 / 8192)


def test_oracle_share_is_of_pairs_and_of_pairs_only():
    """oracle_pairs over the pairs (half the mate rows); a single-end
    line has no oracle_pairs, and its share is None."""
    warm = [_line("dxp", 4096, 1.0, oracle=2048)] * _warm(PE)
    run = _run(PE, warm + [_line("dxp", 4096, 1.0, oracle=20),
                           _line("dxp", 4096, 1.0, oracle=0)])
    assert R.load_reader("exact.oracle_pct")(run) == \
        pytest.approx(100.0 * 20 / 4096)
    se = _run(SE, [_line("dx", 4096, 1.0)] * (_warm(SE) + 2))
    assert R.load_reader("exact.oracle_pct")(se) is None


def test_remap_needs_its_field():
    """Without the C blocks' profiler the lines hold no remap: None."""
    run = _run(SE, [_line("dx", 4096, 1.0)] * (_warm(SE) + 2))
    assert R.load_reader("exact.remap_pct")(run) is None
    assert R.load_reader("exact.wait_pct")(run) == 0.0


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("cell", [PE, SE])
def test_none_without_batch_lines(name, cell):
    """A program that prints no batch line, or only warm-up batches:
    nothing to read."""
    read = R.load_reader(name)
    assert read(_run(cell, [])) is None
    only_warm = [_line("dxp", 4096, 1.0, remap=0.1, oracle=1)] * _warm(cell)
    assert read(_run(cell, only_warm)) is None


def test_readers_listed_and_their_environment():
    """Each new reader is a per-layer metric of the cells it reads, turns
    the lane's lines on, and the remap share the C blocks' profiler."""
    for name in NEW:
        cells = [c for c in (PE, SE)
                 if name in {m["name"] for m in R.load_cell(c).per_layer}]
        assert cells == ([PE] if name == "exact.oracle_pct" else [PE, SE])
        env = R.load_file("metrics", name, "x_").ENV
        assert env["SMALT_DP1_TIMING"] == "1"
        assert ("SMALT_FL_TIMING" in env) == (name == "exact.remap_pct")
