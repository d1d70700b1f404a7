"""What a traced run reads beside the window: the device's operations from
a torch.profiler trace, and the card's SM clock and power from
nvidia-smi.

The profiler runs over a steady slice of the window, stepped by the SAM
sink's writes (one a batch): `skip` batches after the window opens, one
to warm up, then `active` batches.  Its chrome trace gives every kernel,
memcpy and memset interval on the card; the slice is the span of its
ProfilerStep annotations.
"""
from __future__ import annotations

import heapq
import json
import subprocess
import threading
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclass
class Trace:
    """Device intervals [(name, start_us, dur_us, cat)], host intervals
    of the same kinds, the traced slice [t0, t1) in us and the batches
    (sink writes) it holds."""
    device: list
    host: list
    t0: float
    t1: float
    steps: int
    merged: list = field(default_factory=list)

    @property
    def span_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged) * 1e-6

    def kernels(self, names=None) -> list:
        """Kernel intervals in the slice whose short name is in `names`
        (all kernels when None)."""
        return [d for d in self.device if d[3] == "kernel" and
                (names is None or short(d[0]) in names)]


def short(name: str) -> str:
    """A kernel's function name without return type, namespaces,
    templates or arguments: 'void (anonymous namespace)::sw_full_kernel<
    true, 4>(int const*, ...)' -> 'sw_full_kernel'."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    base = base.split("(", 1)[0].split("<", 1)[0].strip()
    return base.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def _merge(iv) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def load(path: str) -> Trace:
    """The slice of a chrome trace exported by torch.profiler."""
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    steps = [e for e in ev if e.get("ph") == "X" and
             e.get("cat") != "gpu_user_annotation" and
             str(e.get("name", "")).startswith("ProfilerStep#")]
    xs = [e for e in ev if e.get("ph") == "X" and "dur" in e]
    if steps:
        t0 = min(e["ts"] for e in steps)
        t1 = max(e["ts"] + e["dur"] for e in steps)
    else:
        t0 = min(e["ts"] for e in xs)
        t1 = max(e["ts"] + e["dur"] for e in xs)
    dev, host = [], []
    for e in xs:
        a, d = float(e["ts"]), float(e["dur"])
        if a + d <= t0 or a >= t1:
            continue
        a, b = max(a, t0), min(a + d, t1)
        item = (e["name"], a, b - a, e.get("cat", ""))
        if item[3] in DEVICE_CATS:
            dev.append(item)
        elif item[3] in HOST_CATS and not item[0].startswith("ProfilerStep#"):
            host.append(item)
    tr = Trace(dev, host, t0, t1, len({e["name"] for e in steps}))
    tr.merged = _merge([(a, a + d) for _, a, d, _ in dev])
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing in them (the shortest host
    interval that covers a gap's middle; 'host outside torch ops' where
    none does)."""
    ops: dict = {}
    for name, _, d, cat in tr.device:
        key = short(name) if cat == "kernel" else name.split(" (", 1)[0]
        ops[key] = ops.get(key, 0.0) + d * 1e-6
    gaps: dict = {}
    edges = [tr.t0] + [x for ab in tr.merged for x in ab] + [tr.t1]
    host = sorted(tr.host, key=lambda h: h[1])
    active: list = []             # heap of (end, duration, name)
    i = 0
    for a, b in zip(edges[0::2], edges[1::2]):     # in time order
        if b <= a:
            continue
        mid = (a + b) / 2
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(active, (host[i][1] + host[i][2], host[i][2],
                                    host[i][0]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = min(active, key=lambda h: h[1])[2] if active else \
            "host outside torch ops"
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


class Smi:
    """nvidia-smi sampled every `ms` milliseconds while it runs: the SM
    clock (MHz), power draw and power limit (W) of card 0."""

    def __init__(self, ms: int = 250):
        self.rows: list = []
        self.p = subprocess.Popen(
            ["nvidia-smi", "-i", "0",
             "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader,nounits", f"--loop-ms={ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.t = threading.Thread(target=self._read, daemon=True)
        self.t.start()

    def _read(self) -> None:
        for line in self.p.stdout:
            try:
                self.rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue

    def stop(self) -> dict:
        self.p.terminate()
        try:
            self.p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.p.kill()
            self.p.wait()
        self.t.join(timeout=10)
        if not self.rows:
            return {}
        col = lambda k: sorted(r[k] for r in self.rows)[len(self.rows) // 2]
        return {"sm_clock_mhz": col(0), "power_draw_w": col(1),
                "power_limit_w": col(2), "samples": len(self.rows)}
