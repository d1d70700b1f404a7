"""exact.oracle_pct: the pairs the paired exact lane left to its Python
pair oracle (`oracle_pairs`: the pairs the C pair block did not cover)
over the pairs it took (half its mate rows), after the warm-up batches
(lanelines.py)."""
from portbench.lanelines import share

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1"}


def read(run):
    got = share(run, ("oracle_pairs",), "n")
    return None if got is None else 2.0 * got
