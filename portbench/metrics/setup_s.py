"""setup_s: from the start of the process to the window's opening: genome,
index, load, engine or lane, tail pool and the warm-up batches (host
clock)."""


def read(run):
    return run.setup_s
