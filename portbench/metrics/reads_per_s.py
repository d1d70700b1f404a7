"""reads_per_s: the records (one a read, one a mate) the port delivered to
the SAM sink in the window, over the window's seconds (host clock)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.window_reads / run.window_s
