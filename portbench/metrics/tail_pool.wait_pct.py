"""tail_pool.wait_pct: the seconds the --fast device loop was blocked on
the tail pool's texts (its `# SMALT_TIMING tail pool` line, map/fastmode.py
TailPool.wait_s) over the entry call's seconds."""
import re

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_TIMING": "1"}

LINE = re.compile(r"# SMALT_TIMING tail pool: .* blocked on texts "
                  r"([0-9.]+) s")


def read(run):
    got = [float(m.group(1)) for ln in run.stderr
           for m in [LINE.match(ln)] if m]
    if not got or run.call_s <= 0:
        return None
    return 100.0 * got[-1] / run.call_s
