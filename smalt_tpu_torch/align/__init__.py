from .diffstr import (DIFFCOD_M, DIFFCOD_D, DIFFCOD_I, DIFFCOD_S,
                      diffstr_reverse, diffstr_to_cigar, levenshtein,
                      ali_len, diffstr_get)
from .band import AliBand, BandError
from .core import (AliResult, align_band_fast, align_band_recursive,
                   ScoreProfile, sw_full_score)
