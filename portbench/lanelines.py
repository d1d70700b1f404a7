"""The device lanes' batch lines (map/fastlane.py of the port, under
SMALT_DP1_TIMING): `# dx-batch`, `# dxp-batch` or `# dp1-batch`, one a
batch, written when the batch is: its rows (`n`, mate rows for pairs),
`period` (the seconds since the previous batch was written), the
seconds of each span of the batch, and its counters.  A program that
prints none gives the readers nothing to read.

A span belongs to the batch it works on, and the lane works on three
batches at once, so the spans of the first batches after the warm-up
began before the warm-up's last write: over a slice of the batches, a
span's share is taken of the main thread's spans of the same batches
(`main`), which the whole call's `period`s hold (the main thread's spans
cover nearly all of its loop), less `write`: that is the harness's SAM
sink, which in a traced run also steps the profiler (seconds at the
start and at the end of the traced slice)."""
import re

LINE = re.compile(r"# (?:dxp?|dp1)-batch (.*)")
FIELD = re.compile(r"(\w+)=([0-9.]+)")
# the main thread's spans (map/fastlane.py DevicePass1.MAIN_SPANS) but
# `write`, the call of the harness's sink
MAIN = ("read", "pre", "stage", "wait", "post", "tail", "oracle",
        "fallback")


def batches(run) -> list:
    """The batch lines of the run after the traffic's warm-up batches
    (whose first calls build the steps), as {field: number}, each with
    `main`, the sum of its main thread's spans but `write`, where it has
    them all."""
    got = [{k: float(v) for k, v in FIELD.findall(m.group(1))}
           for ln in run.stderr for m in [LINE.match(ln)] if m]
    for b in got:
        if all(k in b for k in MAIN):
            b["main"] = sum(b[k] for k in MAIN)
    return got[run.cell.traffic["warmup_batches"]:]


def share(run, fields, over: str):
    """100 x the sum of `fields` over the sum of `over`, over the batches
    after the warm-up; None where no batch line holds them all."""
    got = batches(run)
    if not got or any(k not in b for b in got for k in (*fields, over)):
        return None
    den = sum(b[over] for b in got)
    if den <= 0:
        return None
    return 100.0 * sum(b[k] for b in got for k in fields) / den
