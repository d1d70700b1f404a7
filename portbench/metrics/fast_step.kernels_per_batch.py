"""fast_step.kernels_per_batch: the device kernels in the traced slice
over the batches (sink writes) it holds: the --fast step's launches a
batch (parallel/mesh.py device_map_step)."""


def read(run):
    tr = run.trace
    if tr is None or tr.steps <= 0:
        return None
    n = len(tr.kernels())
    return n / tr.steps if n else None
