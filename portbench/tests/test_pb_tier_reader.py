"""The reader of exact.tier_pct on made-up runs (as test_pb_lane_readers.py
makes them): the tier's rows over the rows after the traffic's warm-up
batches, and None for batch lines without `tier` (a program without the
repeat tier)."""
import pytest

from portbench import run as R
from portbench.tests.test_pb_lane_readers import PE, SE, _line, _run, _warm


def _tier(ln, tier, tier_rs=0):
    return f"{ln} tier={tier} tier_rs={tier_rs}"


@pytest.mark.parametrize("cell,tag", [(SE, "dx"), (PE, "dxp")])
def test_tier_share_skips_the_warm_up(cell, tag):
    warm = [_tier(_line(tag, 4096, 9.0), 4096)] * _warm(cell)
    after = [_tier(_line(tag, 4096, 1.0), 700, 12),
             _tier(_line(tag, 2048, 1.0), 380)]
    got = R.load_reader("exact.tier_pct")(_run(cell, warm + after))
    assert got == pytest.approx(100.0 * 1080 / 6144)


def test_tier_share_of_a_program_without_the_tier_is_none():
    lines = [_line("dx", 4096, 1.0)] * (_warm(SE) + 2)
    assert R.load_reader("exact.tier_pct")(_run(SE, lines)) is None
    assert R.load_reader("exact.tier_pct")(_run(SE, [])) is None
