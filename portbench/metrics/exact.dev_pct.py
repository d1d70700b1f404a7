"""exact.dev_pct: the exact lane's device legs (the collate step on its
worker thread: the `# dx-dev` / `# dxp-dev` lines of map/fastlane.py)
over the lane's whole loop (`# dx-total` / `# dxp-total`)."""
import re

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1"}

DEV = re.compile(r"# dxp?-dev ([0-9.]+)s")
TOTAL = re.compile(r"# dxp?-total ([0-9.]+)s")


def read(run):
    dev = [float(m.group(1)) for ln in run.stderr
           for m in [DEV.match(ln)] if m]
    tot = [float(m.group(1)) for ln in run.stderr
           for m in [TOTAL.match(ln)] if m]
    if not dev or not tot or tot[-1] <= 0:
        return None
    return 100.0 * sum(dev) / tot[-1]
