"""fast.read_pct: the seconds map --fast's loop spent taking the next
batch from its FASTQ reader (the `read` span of its `# fx-batch` lines,
map/fastmode.py FastSpans) over the loop's spans of the same batches but
the sink's `write` (`main`), after the traffic's warm-up batches."""
import re

# the program prints these lines only so (in the traced run)
ENV = {"SMALT_TIMING": "1"}

LINE = re.compile(r"# fx-batch (.*)")
FIELD = re.compile(r"(\w+)=([0-9.]+)")
# the loop's spans but `write`: `render` without a tail pool, `submit`
# and `pool_wait` with one
MAIN = ("read", "encode", "enqueue", "sync", "split", "render", "submit",
        "pool_wait")
PART = ("read",)


def read(run):
    got = [{k: float(v) for k, v in FIELD.findall(m.group(1))}
           for ln in run.stderr for m in [LINE.match(ln)] if m]
    got = got[run.cell.traffic["warmup_batches"]:]
    if not got or any(k not in b for b in got for k in PART):
        return None
    main = sum(v for b in got for k, v in b.items() if k in MAIN)
    if main <= 0:
        return None
    return 100.0 * sum(b[k] for b in got for k in PART) / main
