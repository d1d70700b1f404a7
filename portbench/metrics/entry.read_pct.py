"""entry.read_pct: the seconds the lane's main thread spent taking the
next batch from its FASTQ reader (the `read` span of its batch lines)
over its spans of the same batches but the sink's (`main`), after the
warm-up batches (lanelines.py)."""
from portbench.lanelines import share

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1"}


def read(run):
    return share(run, ("read",), "main")
