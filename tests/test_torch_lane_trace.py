"""The exact lane's spans and counters (map/fastlane.py DevicePass1._span,
`# dx-batch` / `# dxp-batch` lines) on the CPU, single-end and paired
`map --device-exact --device cpu` on the repeat corpora of
tests/test_torch_exact.py and tests/test_device_exact_pe.py: one line a
batch with every field, the re-stage causes summing to the re-stages,
the main thread's spans covering its loop, the same SAM with timing off,
on and under `--profile` (whose trace holds the spans of both threads),
and nothing printed or annotated with timing off."""
import glob
import io
import json
import re

import pytest
import torch

from smalt_tpu_torch import cli as tcli
from smalt_tpu_torch.native import (FL_PROF_COUNTS, FL_PROF_SLOTS,
                                    FL_PROF_STAGES, FL_PROF_SUB, get_lib)
from test_device_exact_pe import _pe_world
from test_torch_exact import _corpus

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native lib required")

MODES = ["se", "pe"]
TIMING = {"SMALT_DP1_TIMING": "1", "SMALT_FL_TIMING": "1"}
MAIN = ("read", "pre", "stage", "wait", "post", "tail", "oracle",
        "fallback", "write")
WORKER = ("collate", "fetch", "pass2")
CAUSES = ("rs_h", "rs_dev", "rs_ck", "rs_stats", "rs_geom", "rs_simd")
# mate rows a batch: 64 reads, or 64 pairs
BATCH = {"se": 64, "pe": 128}
BATCHES = {"se": 4, "pe": 5}          # 204 reads, 300 pairs
FIELD = re.compile(r"(\w+)=([0-9.]+)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers run other CPU lanes beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _map(d, mode, env, extra=()):
    """The port's `map --device-exact --device cpu -r 1` on the corpus in
    `d` under `env`: (SAM lines without @PG, stderr text, the number of
    record_function contexts entered)."""
    reads = [str(d / "r.fq")] if mode == "se" else \
        [str(d / "r1.fq"), str(d / "r2.fq")]
    sam = d / f"out{len(list(d.glob('out*.sam')))}.sam"
    entered = [0]
    real = torch.profiler.record_function

    def counted(*a, **k):
        entered[0] += 1
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp, io.StringIO() as err:
        for k in TIMING:
            mp.delenv(k, raising=False)
        mp.delenv("SMALT_DX_P2", raising=False)
        mp.setenv("SMALT_DX_BATCH", str(BATCH[mode]))
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(torch.profiler, "record_function", counted)
        mp.setattr("sys.stderr", err)
        assert tcli.main(["map", "--device-exact", "--device", "cpu",
                          "-r", "1", "-o", str(sam), *extra,
                          str(d / "idx")] + reads) == 0
        text = err.getvalue()
    body = [ln for ln in sam.read_text().splitlines()
            if not ln.startswith("@PG")]
    return body, text, entered[0]


@pytest.fixture(scope="module", params=MODES)
def runs(request, tmp_path_factory):
    """{run: (SAM, stderr, record_functions entered)} for timing off,
    timing on (the lane's and the C blocks' timers) and timing off under
    --profile, on one corpus; and the profiler's trace events."""
    mode = request.param
    d = tmp_path_factory.mktemp(f"trace_{mode}")
    if mode == "se":
        _corpus(d, "two_seq")
    else:
        _pe_world(d, seed=41, nctg=2, k=11)
    with io.StringIO() as err, pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.stderr", err)
        assert tcli.main(["index", "-k", "11", "-s", "2", str(d / "idx"),
                          str(d / "g.fa")]) == 0
    got = {"off": _map(d, mode, {}), "on": _map(d, mode, TIMING),
           "prof": _map(d, mode, {}, ["--profile", str(d / "prof")])}
    traces = glob.glob(str(d / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    return mode, got, events


def _batches(text, mode):
    tag = "dx" if mode == "se" else "dxp"
    out = []
    for ln in text.splitlines():
        if ln.startswith(f"# {tag}-batch "):
            out.append({k: float(v) for k, v in FIELD.findall(ln)})
    return out


def _total(text, mode):
    tag = "dx" if mode == "se" else "dxp"
    return next(ln for ln in text.splitlines()
                if ln.startswith(f"# {tag}-total "))


def test_one_batch_line_a_batch_with_every_field(runs):
    """One `# dx(p)-batch` line a batch, each line one write with every
    span, the C blocks' re-mapping seconds and every counter (the repeat
    tier's among them), all >= 0;
    the rows sum to the reads (mates) mapped."""
    mode, got, _ = runs
    lines = _batches(got["on"][1], mode)
    assert len(lines) == BATCHES[mode]
    want = {"n", "period", *MAIN, *WORKER, "remap", "restaged", *CAUSES,
            "tier", "tier_rs"}
    if mode == "pe":
        want.add("oracle_pairs")
    for b in lines:
        assert set(b) == want, set(b) ^ want
        assert all(v >= 0 for v in b.values()), b
    assert sum(b["n"] for b in lines) == (204 if mode == "se" else 600)
    assert sum(b["collate"] for b in lines) > 0


def test_causes_sum_to_restaged(runs):
    """Per batch the six causes sum to `restaged`; over the call the
    re-stages are the total line's n_restaged (some reads re-stage on
    these repeats), and their re-mapping took time in the C blocks."""
    mode, got, _ = runs
    text = got["on"][1]
    lines = _batches(text, mode)
    for b in lines:
        assert sum(b[c] for c in CAUSES) == b["restaged"], b
    total = int(re.search(r"n_restaged=(\d+)", _total(text, mode)).group(1))
    assert sum(b["restaged"] for b in lines) == total > 0
    assert sum(b["remap"] for b in lines) > 0


def test_main_spans_cover_the_loop(runs):
    """The main thread's spans cover at least 80% of the seconds between
    the batches' writes."""
    mode, got, _ = runs
    lines = _batches(got["on"][1], mode)
    main = sum(b[k] for b in lines for k in MAIN)
    period = sum(b["period"] for b in lines)
    assert period > 0 and main >= 0.8 * period, (main, period)


def test_existing_lines_keep_their_text(runs):
    """The stage lines and the total line as the harness's readers and
    chip_smoke.py read them; the total line ends with steps_built and no
    new line starts as the old ones do."""
    mode, got, _ = runs
    text = got["on"][1]
    tag = "dx" if mode == "se" else "dxp"
    if mode == "se":
        assert re.search(r"# dx-total ([\d.]+)s n_restaged=(\d+) "
                         r"p2_used=(\d+) p2_fb=(\d+) p2_hit=(\d+) "
                         r"host_batches=(\d+) steps_built=(\d+)$", text,
                         re.M)
        stages = ("prep", "dev", "post", "pass2")
    else:
        assert re.search(r"# dxp-total ([\d.]+)s n_restaged=(\d+) "
                         r"host_batches=(\d+) npairs=300 steps_built=(\d+)$",
                         text, re.M)
        stages = ("prep", "dev", "post", "tail")
    for st in stages:
        assert len(re.findall(rf"^# {tag}-{st} ([\d.]+)s", text, re.M)) == \
            BATCHES[mode], st
    total = [ln for ln in text.splitlines() if ln.startswith(f"# {tag}-total ")]
    assert len(total) == 1


def test_sam_same_with_timing_off_on_and_profiled(runs):
    """Timing and a profiler change no byte of the SAM."""
    _, got, _ = runs
    assert len(got["off"][0]) > 200
    assert got["on"][0] == got["off"][0] == got["prof"][0]


def test_profile_trace_holds_spans_of_both_threads(runs):
    """--profile on the exact lane: the trace names the main thread's
    spans and the worker thread's collate step, each a user annotation,
    on two threads."""
    mode, got, events = runs
    tag = "dx" if mode == "se" else "dxp"
    spans = [e for e in events if e.get("cat") == "user_annotation" and
             str(e.get("name", "")).startswith(f"{tag}.")]
    names = {e["name"] for e in spans}
    assert {f"{tag}.{k}" for k in ("read", "pre", "stage", "wait", "post",
                                   "tail", "write", "collate",
                                   "fetch")} <= names, names
    tids = lambda k: {e["tid"] for e in spans if e["name"] == f"{tag}.{k}"}
    assert len(tids("post") | tids("collate")) == 2
    assert tids("post").isdisjoint(tids("collate"))
    assert got["prof"][2] > 0


def test_timing_off_prints_and_annotates_nothing(runs):
    """Without SMALT_DP1_TIMING and without a profiler the lane prints no
    line of its own and enters no record_function."""
    _, got, _ = runs
    _, text, entered = got["off"]
    assert not re.search(r"^# dx", text, re.M), text
    assert entered == 0


def test_profiler_slots_have_one_name_each():
    """fl_prof_acc's slots: each named once, in one group, and the report
    keeps counts apart from seconds."""
    from smalt_tpu_torch.native import fl_prof_report
    assert len(set(FL_PROF_SLOTS)) == len(FL_PROF_SLOTS) == \
        len(FL_PROF_STAGES) + len(FL_PROF_SUB) + len(FL_PROF_COUNTS)
    assert "remap" in FL_PROF_SUB
    rep = fl_prof_report(reset=False)       # raises on a slot count change
    if rep:
        assert set(rep) == set(FL_PROF_STAGES) | {"_sub", "_counts"}
        assert set(rep["_counts"]) == set(FL_PROF_COUNTS)
