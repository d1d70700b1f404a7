"""exact.wait_pct: the seconds the exact lane's main thread was blocked
on the card's leg (the `wait` span: the collate step's future, and the
pass-2 step's) over its spans of the same batches but the sink's
(`main`), after the warm-up batches (lanelines.py)."""
from portbench.lanelines import share

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1"}


def read(run):
    return share(run, ("wait",), "main")
