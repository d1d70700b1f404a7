"""One run of one benchmark cell of smalt_tpu_torch (the PyTorch/CUDA
port), on the machine it starts on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json `workloads`) names
a configuration (its `file`: genome, index, device mode, the settings of
the program's environment) and a traffic mix
(`portbench/traffic/<traffic>.json`: the kind of reads, their lengths and
errors, batch, -n, warm-up, sampling).  Each is found by its name: the
configuration's `mode` is the entry `portbench/entries/<mode>.py`, the
traffic's `reads` the generator `portbench/gen/kinds/<reads>.py`,
`portbench/limits/<cell>.json` holds the limits of the comparison that
decides `correct`, and each metric is read by
`portbench/metrics/<metric>.py`.  Nothing here names a cell, a mode or a
kind of reads.

Set-up (`setup_s`, from the start of this process): the genome from the
seed, its FASTA and the port's `index` command under TMPDIR, the index
loaded, the engine or lane built, the tail pool started, and the
traffic's warm-up batches through the same entry call that the window
then continues.  The feeder (gen/feeder.py) appends reads to the port's
FASTQ files from its own process.  The window opens when the SAM sink
has the warm-up batches' last record and closes when the entry returns,
`--seconds` after the feeder's last chunk was due.  `reads_per_s` is all
records the sink received in the window over the window's seconds.

The sink keeps every `keep_every`-th batch whole; after the window the
reference (reference/judge.py) judges them.  With --trace 1 the program's
timing lines are on, torch.profiler traces a slice of the window and
nvidia-smi is sampled; the result then carries the per-layer metrics.

The last line on stdout is the result; the last lines on stderr are the
numbers compared, each beside its limit.  --device cpu and --tiny are
for the tests only: a CPU run prints no device metric.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import numpy as np  # noqa: E402

from portbench import trace as tracing  # noqa: E402
from portbench.errors import RunError  # noqa: E402
from portbench.gen.feeder import Control, Readers, write_all  # noqa: E402
from portbench.gen.genome import make_genome, write_fasta  # noqa: E402
from portbench.gen.reads import kind, nominal_len, record_len  # noqa: E402
from portbench.reference.judge import control_texts, judge  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "smalt_tpu")
# the program's build and kernel caches, at fixed paths in the checkout
# (the port's nvcc builds go to build/kernels there by itself)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton",
              "CUDA_CACHE_PATH": "build/nv_compute_cache"}
# the program's own lines (timings, counters) start so; they are kept
# for the readers and not shown
PROGRAM_LINES = "# "
FILE_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int
    mates: int = 1


@dataclass
class Run:
    """What a metric reader gets (metrics/<name>.py: read(run))."""
    cell: Cell
    device: str
    setup_s: float = 0.0
    window_s: float = 0.0
    window_reads: int = 0
    call_s: float = 0.0
    records: int = 0
    judged: dict = field(default_factory=dict)
    stderr: list = field(default_factory=list)   # the program's lines
    trace: object = None                          # trace.Trace
    smi: dict = field(default_factory=dict)
    trace_reads: int = 0
    judged_control: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)     # load and CPU of the call


def load_cell(name: str, bench_path: str = "") -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench_path`, which only
    the tests give), with its files."""
    with open(bench_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cfg_file = next((c["file"] for c in bench["configs"]
                     if c["name"] == cell["config"]), None)
    if cfg_file is None:
        raise RunError(f"no configuration {cell['config']!r} in "
                       f"BENCHMARK.json")

    def js(path):
        with open(os.path.join(ROOT, path)) as f:
            return json.load(f)

    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moves)]
    for n in (name, cell["traffic"]):
        if not FILE_NAME.match(n):
            raise RunError(f"{n!r} is no name of a file")
    traffic = js(f"portbench/traffic/{cell['traffic']}.json")
    try:
        mates = kind(traffic).MATES
    except (ValueError, ImportError) as e:
        raise RunError(f"traffic {cell['traffic']!r}: {e}") from None
    return Cell(name, js(cfg_file), traffic,
                js(f"portbench/limits/{name}.json"), e2e, layer,
                int(cell["chips"]), mates)


def shrink(cell: Cell) -> None:
    """--tiny (tests only): a 300 kb genome and small batches."""
    g = cell.config["genome"]
    ratio = 300_000 / g["length"]
    g["length"] = 300_000
    for fam in g.get("families", []):
        if "copies" in fam:
            fam["copies"] = max(1, int(fam["copies"] * ratio))
    t = cell.traffic
    t.update(batch=256, chunk=1024, warmup_batches=1, keep_every=1,
             max_kept=3, trace_skip=0, trace_batches=2, lead_batches=16,
             nthreads=min(2, t["nthreads"]), tiny=True)


def load_file(folder: str, name: str, prefix: str):
    """The module portbench/<folder>/<name>.py, loaded from its file (a
    name may hold `.` and `-`)."""
    if not FILE_NAME.match(name):
        raise RunError(f"{name!r} is no name of a file")
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.exists(path):
        raise RunError(f"no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(cell: Cell):
    """The entry of the cell's configuration: portbench/entries/<mode>.py
    (`build(cell, prefix, reads, device)` -> call(out), and
    `reads_per_write(cell)`)."""
    return load_file("entries", cell.config["mode"], "portbench_entry_")


def lead_bytes(cell: Cell, per_write: int) -> int:
    """How far (bytes a file) the feeder stays ahead of the port's reads:
    `lead_batches` batches, which the port takes longer to map than the
    feeder takes to append the next chunk, so the port never reads to
    the end early.  What is written when the window's seconds are up is
    mapped before the entry returns."""
    t = cell.traffic
    return t["lead_batches"] * per_write * record_len(nominal_len(t))


class Sink:
    """The SAM sink passed to the port as `out`: per write (one batch) it
    counts the records, tells the feeder how far the port has read, opens
    the window after the warm-up, keeps every keep_every-th batch of the
    window whole (at most max_kept, from an offset drawn from the seed)
    and steps the profiler.  The rest is dropped; nothing is parsed
    here."""

    def __init__(self, ctl: Control, readers: Readers, warm: int,
                 keep_every: int, offset: int, max_kept: int):
        self.ctl, self.readers, self.warm = ctl, readers, warm
        self.k, self.off, self.max_kept = keep_every, offset, max_kept
        self.n = self.writes = self.n_open = 0
        self.t_open = None
        self.kept: list = []
        self.prof = None
        self.prof_steps = 0

    def write(self, text: str) -> None:
        self.n += text.count("\n")
        self.ctl.set_position(self.readers.position())
        if self.t_open is None:
            if self.n >= self.warm:
                self.t_open = time.monotonic()
                self.n_open = self.n
                self.ctl.open_window(self.t_open)
            return
        if self.writes % self.k == self.off and len(self.kept) < self.max_kept:
            self.kept.append(text)
        self.writes += 1
        if self.prof is not None:
            self.prof.step()
            self.prof_steps += 1

    def flush(self) -> None:
        pass

    def window(self, t_close: float):
        """(seconds, records) of the window that closed at t_close: every
        record after the warm-up's last, over all of its seconds."""
        return t_close - self.t_open, self.n - self.n_open


class StderrLog:
    """sys.stderr during the entry call: the program's timing lines are
    kept and not shown; other lines pass through."""

    def __init__(self, real):
        self.real, self.lines, self.part = real, [], ""

    def write(self, s: str) -> int:
        self.part += s
        while "\n" in self.part:
            line, self.part = self.part.split("\n", 1)
            self.lines.append(line)
            if not line.startswith(PROGRAM_LINES):
                self.real.write(line + "\n")
        return len(s)

    def flush(self) -> None:
        self.real.flush()


def stolen_s() -> float:
    """Seconds the hypervisor gave this machine's CPUs to others (the
    `steal` column of /proc/stat), summed over the CPUs; 0 where it is
    not kept."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def memfd_path(fd: int) -> str:
    return f"/proc/{os.getpid()}/fd/{fd}"


def build_index(cell: Cell, genome: np.ndarray, tmp: str) -> str:
    """The genome's FASTA and the port's `index` command on it."""
    from smalt_tpu_torch import cli
    fa = os.path.join(tmp, "genome.fa")
    write_fasta(fa, genome)
    prefix = os.path.join(tmp, "idx")
    ix = cell.config["index"]
    log = StderrLog(sys.stderr)
    old, sys.stderr = sys.stderr, log
    try:
        rc = cli.main(["index", "-k", str(ix["k"]), "-s", str(ix["s"]),
                       prefix, fa])
    finally:
        sys.stderr = old
    if rc != 0:
        raise RunError(f"index failed ({rc}): " +
                       " | ".join(log.lines[-5:]))
    os.remove(fa)
    return prefix


def load_reader(name: str):
    """The reader of a metric: portbench/metrics/<name>.py `read(run)`;
    its `ENV` (if any) is what the program must have in its environment
    for the traced run to print what the reader reads."""
    return load_file("metrics", name, "portbench_metric_").read


def trace_env(cell: Cell) -> dict:
    """The settings that the cell's per-layer readers ask for."""
    env = {}
    for m in cell.per_layer:
        env.update(getattr(load_file("metrics", m["name"],
                                     "portbench_metric_"), "ENV", {}))
    return env


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} &
                  set(FORBIDDEN))


def check_device(cell: Cell, device: str):
    """The torch module where the run drives a card (None on the CPU);
    raises where the program or the cards the cell needs are absent."""
    if importlib.util.find_spec("smalt_tpu_torch") is None:
        raise RunError("the program, smalt_tpu_torch, is not in this "
                       "checkout")
    import torch
    if device == "cpu":
        return None
    if not torch.cuda.is_available():
        raise RunError("no CUDA device is visible")
    if torch.cuda.device_count() < cell.chips:
        raise RunError(f"the cell needs {cell.chips} cards, "
                       f"{torch.cuda.device_count()} are visible")
    return torch


def run_cell(args, control: bool = False) -> dict:
    """One run of the cell; with `control` (portbench/control.py, never
    the benchmark's runs) the result also holds the control's readings
    on the same kept batches (reference/judge.py control_texts)."""
    cell = load_cell(args.workload, args.bench)
    if args.tiny:
        shrink(cell)
    for k, v in CACHE_DIRS.items():
        os.environ[k] = os.path.join(ROOT, v)
    traced = trace_env(cell)
    for k in traced:
        os.environ.pop(k, None)
    if args.trace:
        os.environ.update(traced)
    # the deployment's settings of the program (the configuration's env)
    os.environ.update({k: str(v) for k, v in
                       cell.config.get("env", {}).items()})
    entry = load_entry(cell)
    torch = check_device(cell, args.device)
    t, seed = cell.traffic, args.seed
    run = Run(cell, args.device)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    ctl_fd, ctl = Control.create()
    fds, feeder, smi = [], None, None
    try:
        genome, repeats = make_genome(cell.config["genome"], seed, True)
        gfd = os.memfd_create("portbench-genome", 0)
        fds.append(gfd)
        write_all(gfd, genome.tobytes())
        mates = cell.mates
        per = entry.reads_per_write(cell)
        rfds = [os.memfd_create(f"portbench-mate{m + 1}", 0)
                for m in range(mates)]
        fds += rfds
        lead = lead_bytes(cell, per)
        feeder = subprocess.Popen(
            [sys.executable, "-m", "portbench.gen.feeder", json.dumps(
                {"genome_fd": gfd, "genome_len": len(genome),
                 "out_fds": rfds, "ctl_fd": ctl_fd, "seed": seed,
                 "seconds": args.seconds, "lead": lead, "traffic": t})],
            cwd=ROOT, pass_fds=[gfd, ctl_fd] + rfds)
        prefix = build_index(cell, genome, tmp)
        reads = [memfd_path(fd) for fd in rfds]
        while ctl.written < t["lead_batches"] * per * mates:
            if feeder.poll() is not None:
                raise RunError(f"the feeder exited ({feeder.returncode})")
            time.sleep(0.01)
        call = entry.build(cell, prefix, reads, args.device)
        warm = t["warmup_batches"] * per * mates
        sink = Sink(ctl, Readers(rfds), warm, t["keep_every"],
                    seed % t["keep_every"], t["max_kept"])
        prof = None
        if args.trace and torch is not None:
            from torch.profiler import ProfilerActivity, profile, schedule
            path = os.path.join(tmp, "trace.json")
            prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=t["trace_skip"], warmup=1,
                                  active=t["trace_batches"], repeat=1),
                on_trace_ready=lambda p: None, acc_events=True)
            smi = tracing.Smi()
        log = StderrLog(sys.stderr)
        old = sys.stderr
        load0, cpu0, steal0 = os.getloadavg()[0], os.times(), stolen_s()
        t_call = time.monotonic()
        try:
            sys.stderr = log
            if prof is not None:
                with prof:
                    sink.prof = prof
                    call(sink)
            else:
                call(sink)
        finally:
            sys.stderr = old
            ctl.abort()
        t_close = time.monotonic()
        cpu1 = os.times()
        run.host = {"cores": os.cpu_count(), "load1_before": load0,
                    "load1_after": os.getloadavg()[0],
                    "cpu_s": cpu1.user + cpu1.system - cpu0.user -
                    cpu0.system, "stolen_s": stolen_s() - steal0}
        if smi is not None:
            run.smi = smi.stop()
            smi = None
        feeder.wait(timeout=60)
        feeder = None
        if sink.t_open is None:
            raise RunError("the warm-up batches never all came back")
        written = ctl.written
        if t_close < sink.t_open + args.seconds and sink.n >= written:
            raise RunError("the entry returned before the window's "
                           "seconds: the feeder fell behind the port")
        run.setup_s = sink.t_open - T_START
        run.window_s, run.window_reads = sink.window(t_close)
        run.call_s = t_close - t_call
        run.records = sink.n
        run.stderr = log.lines
        if prof is not None:
            if sink.prof_steps < t["trace_skip"] + 1 + t["trace_batches"]:
                raise RunError("the window held fewer batches than "
                               "trace_skip + trace_batches + 1")
            prof.export_chrome_trace(path)      # after the window
            run.trace = tracing.load(path)
            run.trace_reads = run.trace.steps * per * mates
        device_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                       "memory_peak_bytes": 0}
        if torch is not None:
            device_info = {"platform": "gpu",
                           "kind": torch.cuda.get_device_name(0),
                           "count": cell.chips,
                           "memory_peak_bytes": max(
                               torch.cuda.max_memory_allocated(d)
                               for d in range(cell.chips))}
        del call
        gc.collect()
        found = forbidden_modules()
        if found:
            raise RunError(f"modules of JAX or the JAX package are loaded: "
                           f"{', '.join(found)}")
        total = -(-written // mates)
        run.judged = judge(sink.kept, t, cell.config["scores"], genome, seed,
                           total, per, repeats)
        # reads fed to the port less the records it wrote (either way)
        run.judged["lost"] = abs(written - sink.n)
        if control:
            run.judged_control = judge(
                control_texts(sink.kept, genome, cell.config["scores"]), t,
                cell.config["scores"], genome, seed, total, per, repeats)
            # the control re-renders the same records: as many were lost
            run.judged_control["lost"] = run.judged["lost"]
    finally:
        ctl.abort()
        if smi is not None:
            smi.stop()
        if feeder is not None:
            feeder.kill()
            feeder.wait()
        for fd in fds:
            os.close(fd)
        ctl.close()
        os.close(ctl_fd)
        shutil.rmtree(tmp, ignore_errors=True)
    return result(run, args, device_info, written)


def held(judged: dict, limits: dict):
    """({name: {"value", "limit"}}, correct) of readings against their
    limits: correct where some reads were judged and every reading is at
    or under its limit (a missing reading fails)."""
    checks = {k: {"value": judged.get(k), "limit": lim}
              for k, lim in limits.items()}
    correct = judged.get("reads", 0) > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return checks, correct


def result(run: Run, args, device_info: dict, written: int) -> dict:
    cell = run.cell
    metrics = {}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        if args.device == "cpu" and m["source"] == "device_trace":
            continue          # never a device number from a CPU run
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks, correct = held(run.judged, cell.limits)
    warm = run.records - run.window_reads
    out = {"correct": bool(correct), "attempted": written - warm,
           "failed": written - run.records, "metrics": metrics,
           "device": device_info}
    if args.trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s()
        out["device"]["window_s"] = run.trace.span_s
        out["breakdown"] = tracing.breakdown(run.trace)
    if run.smi:
        out["card"] = run.smi
    out["host"] = run.host
    out["judged_reads"] = run.judged.get("reads", 0)
    out["timing_lines"] = [ln for ln in run.stderr
                           if ln.startswith("# SMALT_TIMING")]
    out["readings"] = {k: v for k, v in run.judged.items()
                       if k not in cell.limits}
    if run.judged_control:
        out["control"], out["control_correct"] = held(run.judged_control,
                                                      cell.limits)
        out["control_readings"] = {k: v for k, v in
                                   run.judged_control.items()
                                   if k not in cell.limits}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help=argparse.SUPPRESS)       # tests only
    ap.add_argument("--tiny", action="store_true",
                    help=argparse.SUPPRESS)       # tests only
    ap.add_argument("--bench", default="",
                    help=argparse.SUPPRESS)       # tests only
    args = ap.parse_args(argv)
    try:
        res = run_cell(args)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for line in res.pop("timing_lines", []):
        print(line, file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
