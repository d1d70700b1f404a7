"""Batch-granular checkpoint/resume for long mapping runs (SURVEY §5:
the one aux capability the reference lacks — `smalt map` restarts from
scratch on any failure).

A mapping run with `-o OUT --resume` appends a sidecar `OUT.resume`
recording, every CHECKPOINT_BATCHES rendered batches:

    {"reads_done": N, "out_bytes": B, "rng": X, "args": H}

On restart the run truncates OUT to B bytes, skips the first N reads,
restores the drand48 state X and continues — output is byte-identical
to an uninterrupted run (the exact serial lane consumes one global
drand48 stream; the fast lane reseeds per read serial, so both
streams re-synchronise exactly).  `args` hashes the option surface so
a resume with different options is refused instead of silently mixing
output conventions.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

CHECKPOINT_BATCHES = 32


def args_digest(argv) -> str:
    return hashlib.sha256(" ".join(map(str, argv)).encode()).hexdigest()[:16]


class ResumeLog:
    def __init__(self, out_path: str, argv):
        self.path = out_path + ".resume"
        self.out_path = out_path
        self.digest = args_digest(argv)
        self._since = 0

    def load(self) -> Optional[dict]:
        """Returns the saved state when a compatible checkpoint exists;
        truncates the output file to the recorded byte count."""
        if not os.path.exists(self.path) or \
                not os.path.exists(self.out_path):
            return None
        try:
            with open(self.path) as f:
                st = json.load(f)
        except (ValueError, OSError):
            return None
        if st.get("args") != self.digest:
            raise ValueError(
                f"{self.path} was written by a run with different "
                f"options; delete it to restart from scratch")
        if os.path.getsize(self.out_path) < st["out_bytes"]:
            return None          # output shorter than checkpoint: restart
        with open(self.out_path, "r+") as f:
            f.truncate(st["out_bytes"])
        return st

    def tick(self, reads_done: int, out_bytes: int, rng: int) -> None:
        """Record progress every CHECKPOINT_BATCHES calls (atomic)."""
        self._since += 1
        if self._since < CHECKPOINT_BATCHES:
            return
        self._since = 0
        self.save(reads_done, out_bytes, rng)

    def save(self, reads_done: int, out_bytes: int, rng: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"reads_done": reads_done, "out_bytes": out_bytes,
                       "rng": rng, "args": self.digest}, f)
        os.replace(tmp, self.path)

    def done(self) -> None:
        """Run completed: remove the sidecar."""
        for p in (self.path, self.path + ".tmp"):
            try:
                os.remove(p)
            except OSError:
                pass
