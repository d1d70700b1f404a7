"""Helper tool suite — functional equivalents of the reference misc/
programs (SURVEY.md 2.2): read simulation, quality tools, read-set
manipulation, and a SAM parsing library for tests.

    python -m smalt_tpu_torch.tools <tool> [args...]

tools: simread simqual basqcol mixreads splitmates splitreads
       readstats trunkreads fetchseq
"""
