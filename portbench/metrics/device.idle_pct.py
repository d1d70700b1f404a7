"""device.idle_pct: the traced slice of the window less the union of every
kernel, memcpy and memset interval on the card, over the slice
(torch.profiler's trace)."""


def read(run):
    tr = run.trace
    if tr is None or tr.span_s <= 0:
        return None
    return 100.0 * (tr.span_s - tr.busy_s()) / tr.span_s
