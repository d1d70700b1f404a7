"""placed_pct: the share of the kept batches' reads (mates) whose primary
record lies on the right strand within 8 bp of the generator's origin
(reference/judge.py)."""


def read(run):
    return run.judged.get("placed_pct")
