"""The per-batch account of `map --fast`'s loop (map/fastmode.py
FastSpans, `# fx-batch` lines under SMALT_TIMING=1) on the CPU, through
run_fast_pipeline at -n 1 and -n 2 (the tail pool), single-end and
pairs, on the small genome of tests/test_torch_fast_driver.py: one line
a batch, written when the batch is, whose `n` sum to the reads (mates);
the loop's spans but `write` (`main`) cover its periods; the pool's
lines carry its chunks and the workers' seconds, -n 1's the main
thread's render; a profiler sees the spans as `fx.<span>`; and with the
variable unset nothing is printed, nothing is annotated, and the SAM is
the timed run's byte for byte."""
import io
import re

import pytest
import torch

from smalt_tpu_torch.map import fastmode as tfast
from test_torch_fast_driver import N_PAIRS, N_READS, world  # noqa: F401

FIELD = re.compile(r"(\w+)=([0-9.]+)")
STEP = ("read", "encode", "enqueue", "sync", "split")
# reads (pairs) a batch: 10 batches of single reads, 2 of pairs
BATCH = {"single": 64, "paired": 32}
CASES = [(what, n) for what in ("single", "paired") for n in (1, 2)]


def _map(world, what, nthreads, timing, profile=False):
    """(SAM text, stderr lines, record_function contexts entered, the
    profiler's event names) of one run_fast_pipeline call."""
    refset, idx, name, fq, fq1, fq2 = world
    kw = {"mates_path": fq2} if what == "paired" else {}
    buf, err = io.StringIO(), io.StringIO()
    entered = [0]
    real = torch.profiler.record_function

    def counted(*a, **k):
        entered[0] += 1
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        if timing:
            mp.setenv("SMALT_TIMING", "1")
        else:
            mp.delenv("SMALT_TIMING", raising=False)
        mp.setattr(tfast.TailPool, "CHUNK_MIN", 16)  # 2 chunks a batch
        mp.setattr(torch.profiler, "record_function", counted)
        mp.setattr("sys.stderr", err)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) \
            if profile else None
        if prof is not None:
            prof.__enter__()
        try:
            tfast.run_fast_pipeline(
                refset, idx, fq1 if what == "paired" else fq, buf,
                nthreads=nthreads, batch=BATCH[what], device="cpu",
                index_name=name, **kw)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
    names = ({e.key for e in prof.key_averages()} if prof is not None
             else set())
    return buf.getvalue(), err.getvalue().splitlines(), entered[0], names


@pytest.fixture(scope="module")
def runs(world):
    """Each case timed and untimed, made once for the module."""
    got = {}

    def get(what, nthreads, timing):
        key = (what, nthreads, timing)
        if key not in got:
            got[key] = _map(world, what, nthreads, timing)
        return got[key]
    return get


def _batches(lines):
    return [{k: float(v) for k, v in FIELD.findall(ln)}
            for ln in lines if ln.startswith("# fx-batch ")]


@pytest.mark.parametrize("what,nthreads", CASES)
def test_one_line_a_batch(runs, what, nthreads):
    """A line a batch, its fields in order, `n` summing to the reads
    (mates for pairs), `rows` the batch's padded rows; the run's closing
    SMALT_TIMING lines as before."""
    _, err, _, _ = runs(what, nthreads, True)
    got = _batches(err)
    reads = N_READS if what == "single" else 2 * N_PAIRS
    rows = BATCH[what] * (2 if what == "paired" else 1)
    assert len(got) == -(-reads // rows)
    assert sum(b["n"] for b in got) == reads
    assert all(b["rows"] == rows for b in got)
    tail = ("submit", "pool_wait") if nthreads > 1 else ("render",)
    counters = ("chunks", "wrender") if nthreads > 1 else ()
    want = ("n", "rows", "period") + STEP + tail + ("write",) + counters
    for ln in err:
        if ln.startswith("# fx-batch "):
            assert tuple(k for k, _ in FIELD.findall(ln)) == want, ln
    assert sum(ln.startswith("# SMALT_TIMING fast pipeline: ")
               for ln in err) == 1
    assert sum(ln.startswith("# SMALT_TIMING tail pool: ")
               for ln in err) == (nthreads > 1)


@pytest.mark.parametrize("what,nthreads", CASES)
def test_main_covers_the_periods(runs, what, nthreads):
    """Over the call, the loop's spans but `write` (`main`) are within 5%
    of the periods' sum: the spans leave out none of the loop's work."""
    _, err, _, _ = runs(what, nthreads, True)
    got = _batches(err)
    spans = STEP + (("submit", "pool_wait") if nthreads > 1
                    else ("render",))
    main = sum(b[k] for b in got for k in spans)
    period = sum(b["period"] for b in got)
    assert main == pytest.approx(period, rel=0.05)
    assert all(b["enqueue"] > 0 for b in got)      # the step runs there


@pytest.mark.parametrize("what", ["single", "paired"])
def test_pool_lines_carry_chunks_and_worker_seconds(runs, what):
    """-n 2: each batch's chunks (2 for a full batch at CHUNK_MIN 16)
    summing to the pool's count in its closing line, and the workers'
    render seconds of them, which -n 1 renders on the main thread."""
    _, err, _, _ = runs(what, 2, True)
    got = _batches(err)
    pool = next(ln for ln in err if ln.startswith("# SMALT_TIMING tail "))
    total = int(re.search(r"(\d+) chunks", pool).group(1))
    assert sum(b["chunks"] for b in got) == total
    assert got[0]["chunks"] == 2
    assert all(b["wrender"] > 0 for b in got)
    one = _batches(runs(what, 1, True)[1])
    assert all(b["render"] > 0 for b in one)


@pytest.mark.parametrize("what,nthreads", CASES)
def test_timing_off_prints_nothing_and_keeps_the_sam(runs, what, nthreads):
    """With SMALT_TIMING unset: nothing on stderr, no record_function,
    and the SAM of the timed run, byte for byte (which is -n 1's)."""
    sam, err, entered, _ = runs(what, nthreads, False)
    assert err == [] and entered == 0
    assert sam == runs(what, nthreads, True)[0]
    assert sam == runs(what, 1, False)[0]
    assert len(sam.splitlines()) == (N_READS if what == "single"
                                     else 2 * N_PAIRS)


def test_spans_are_annotated_only_under_a_profiler(world, runs):
    """Timed, a profiler's trace holds the spans as `fx.<span>`; timed
    without a profiler, no record_function is entered."""
    assert runs("single", 2, True)[2] == 0
    _, _, entered, names = _map(world, "single", 2, True, profile=True)
    assert entered > 0
    assert {f"fx.{k}" for k in STEP + ("submit", "pool_wait",
                                       "write")} <= names
