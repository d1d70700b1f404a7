"""exact.restaged_flag_pct: the reads (mates) the exact lane re-staged
because a cap was hit, over the rows it took, after the warm-up batches
(lanelines.py): the host hit expansion overflowed its H hits
(`rs_h`, SMALT_DX_H) or the collate step flagged the read (`rs_dev`: its
pool of SMALT_DX_POOL rows a read, among others)."""
from portbench.lanelines import share

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1"}


def read(run):
    return share(run, ("rs_h", "rs_dev"), "n")
