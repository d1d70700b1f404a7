"""exact.tier_pct: the reads (mates) the exact lane's repeat tier took,
over the rows it took, after the warm-up batches (lanelines.py): `tier`,
the rows whose host hit expansion passed the main collate step's H and
went to the tier's own collate step rather than to the host.  None for a
program whose batch lines have no `tier`."""
from portbench.lanelines import share

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1"}


def read(run):
    return share(run, ("tier",), "n")
