"""The least time an H100 could take for the Smith-Waterman work of a
batch: a frozen copy of smalt_tpu_torch/ops/bounds.py's arithmetic and of
parallel/mesh.py's window length, kept here so that the yardstick does
not move with the program.

    bound = max(cells * OPS_PER_CELL / INT_OPS_PER_S, bytes / MEM_BYTES_PER_S)

OPS_PER_CELL = 5 integer-ALU instructions a DP cell (the affine
recurrence's max operations with 3-input instructions); INT_OPS_PER_S =
132 SMs x 64 int32 lanes x 1.98 GHz, the H100 SXM's highest SM clock, so
a clock read below it lowers no bound; MEM_BYTES_PER_S = 3.35e12.  Both
rates are the card's at its full 700 W limit.
"""
from __future__ import annotations

SMS = 132
INT_LANES_PER_SM = 64
CLOCK_HZ = 1.98e9
INT_OPS_PER_S = SMS * INT_LANES_PER_SM * CLOCK_HZ
MEM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 5
WINDOWS_PER_READ = 3      # the --fast step scores three windows a read


def window_len(Q: int) -> int:
    """Subject-window length for query length Q (parallel/mesh.py:66)."""
    slack = max(8, Q // 8)
    return max(128, -(-(Q + slack) // 128) * 128)


def padded_q(read_len: int) -> int:
    """The query length a batch of reads of read_len pads to
    (map/fastmode.py: a multiple of 16, at least 32)."""
    return max(32, -(-read_len // 16) * 16)


def bound_ms(cells: int, nbytes: int) -> float:
    return max(cells * OPS_PER_CELL / INT_OPS_PER_S,
               nbytes / MEM_BYTES_PER_S) * 1e3


def sw_full_reads_bound_ms(n_reads: int, read_len: int) -> float:
    """The bound of scoring n_reads reads of read_len: the cells inside
    the query of WINDOWS_PER_READ windows of window_len(Q) rows a read,
    and each window's query, subject and result moved once (int32)."""
    S = window_len(padded_q(read_len))
    B = WINDOWS_PER_READ * n_reads
    cells = B * S * read_len
    nbytes = 4 * (B * padded_q(read_len) + B * S + B) + 4 * B * 3
    return bound_ms(cells, nbytes)
