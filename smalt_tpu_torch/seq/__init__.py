from .codec import (
    CODE_A, CODE_C, CODE_G, CODE_T, CODE_X, CODE_N, CODE_TERM,
    ALPHA_MASK, STDNT_MASK, STDNT_TESTBIT, QVAL_OFFS,
    encode, decode, revcomp_codes, alpha, is_nonstd,
)
from .io import FastqReader, Read, open_maybe_gzip
from .refset import RefSet
