"""sw_full.roofline_pct: the roofline bound of the Smith-Waterman work the
traced batches' reads need (reference/bounds.py: three windows of
window_len(Q) rows a read, the cells inside the query), over the time of
every kernel of ops/csrc/sw_full.cu in the trace.  The work is not
counted from the launches, so the share reads the same work whatever
computes it."""
from portbench.reference.bounds import sw_full_reads_bound_ms

KERNELS = {"sw_full_kernel", "sw_full_rec_kernel", "sw_strip_kernel",
           "sw_wave_kernel", "sw_wave_rec_kernel"}


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ms = sum(d for _, _, d, _ in tr.kernels(KERNELS)) * 1e-3
    if ms <= 0 or run.trace_reads <= 0:
        return None
    bound = sw_full_reads_bound_ms(run.trace_reads,
                                   run.cell.traffic["read_len"])
    return 100.0 * bound / ms
