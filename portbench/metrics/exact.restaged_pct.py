"""exact.restaged_pct: the reads (mates) the exact lane re-staged to the
host blocks (`n_restaged=` of its `# dx-total` / `# dxp-total` line) over
the reads it took: every record of the call less the batches it left to
the host (`host_batches=`)."""
import re

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1"}

TOTAL = re.compile(r"# dxp?-total .*n_restaged=(\d+).*host_batches=(\d+)")


def read(run):
    got = [m for ln in run.stderr for m in [TOTAL.match(ln)] if m]
    if not got:
        return None
    rest, host = int(got[-1].group(1)), int(got[-1].group(2))
    took = run.records - host * run.cell.traffic["batch"]
    return 100.0 * rest / took if took > 0 else None
