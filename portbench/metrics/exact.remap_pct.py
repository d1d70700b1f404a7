"""exact.remap_pct: the seconds the host C blocks spent mapping again the
reads the exact lane re-staged (`remap`: fl_pass2_block's re-stage
branch, the pair block's host mapping of a re-staged mate) over the main
thread's spans of the same batches but the sink's (`main`), after the
warm-up batches (lanelines.py)."""
from portbench.lanelines import share

# the program prints these lines only so, and `remap` only where the C
# blocks' profiler runs (in the traced run)
ENV = {"SMALT_DP1_TIMING": "1", "SMALT_FL_TIMING": "1"}


def read(run):
    return share(run, ("remap",), "main")
