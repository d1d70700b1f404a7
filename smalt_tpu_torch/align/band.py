"""Banded alignment geometry — replica of ALIBAND (alignment.c:310-398).

The band is specified by [l_edge, r_edge] along the profiled (query)
sequence at subject position 0, and slides one query position per
subject row.  initALIBAND clips the band to the query/subject segment
box; inconsistent limits raise BandError (the reference returns
ERRCODE_FAILURE, which ends the recursion silently)."""
from __future__ import annotations

from dataclasses import dataclass


class BandError(Exception):
    pass


@dataclass
class AliBand:
    l_edge: int
    r_edge: int
    s_left: int
    s_len: int
    q_left: int
    q_len: int
    band_width: int
    s_totlen: int
    q_totlen: int

    @classmethod
    def make(cls, l_edge: int, r_edge: int,
             q_left: int, q_right: int, q_len: int,
             s_left: int, s_right: int, s_len: int) -> "AliBand":
        b_s_len = s_len if (s_right < 0 or s_right >= s_len) else s_right + 1
        b_q_len = q_len if (q_right < 0 or q_right >= q_len) else q_right + 1
        b_s_left = s_left if (0 < s_left < b_s_len) else 0
        b_q_left = q_left if (0 < q_left < b_q_len) else 0
        l_edge_orig, r_edge_orig = l_edge, r_edge
        bw = r_edge - l_edge + 1
        if bw <= 0:
            l_edge = b_q_left
            r_edge = b_q_len - 1
        else:
            if l_edge_orig + b_s_len > b_q_len:
                b_s_len = b_q_len - l_edge_orig
            l_edge += b_s_left
            if l_edge >= b_q_len or r_edge_orig + b_s_len <= b_q_left:
                raise BandError("band does not overlap query segment")
            r_edge += b_s_left
            if r_edge < b_q_left:
                b_s_left += b_q_left - r_edge
                l_edge += b_q_left - r_edge
                r_edge = b_q_left
            if r_edge > b_q_len - 1:
                r_edge = b_q_len - 1
        bw = r_edge - l_edge + 1
        if bw < 0:
            raise BandError("negative band width")
        return cls(l_edge=l_edge, r_edge=r_edge, s_left=b_s_left, s_len=b_s_len,
                   q_left=b_q_left, q_len=b_q_len, band_width=bw,
                   s_totlen=s_len, q_totlen=q_len)
