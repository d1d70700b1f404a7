from .collate import (SegLst, SegAliCands, Cand, seg_lst_fill_hits,
                      seg_cands_add_fast, seg_cands_stats,
                      calc_segment_offsets, CandWindow)
