"""exact.restaged_check_pct: the reads (mates) the exact lane re-staged
because the card and the host disagreed, over the rows it took, after
the warm-up batches (lanelines.py): the post block's hit-info checksum
(`rs_ck`), depth stats (`rs_stats`), geometry (`rs_geom`) and SIMD
cross-check (`rs_simd`)."""
from portbench.lanelines import share

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1"}


def read(run):
    return share(run, ("rs_ck", "rs_stats", "rs_geom", "rs_simd"), "n")
