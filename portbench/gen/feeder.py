"""The feeder: a process that appends reads to the run's FASTQ files
while the port maps them.

    python -m portbench.gen.feeder '<json>'

The files are memory-backed (memfd) regular files that the harness hands
to the port by a /proc/<pid>/fd path: the port's readers open a path,
peek at it and seek back, which a pipe does not allow.  So the feeder
keeps the files ahead of the port instead: it appends a chunk (all
mates of it together) whenever a file holds less than `lead` bytes past
the point the port has read it to (Readers, which the harness's SAM sink
reads at each batch it gets), and so never lets the port reach the end
early.  The window opens when the harness sets
`Control.t_open`; the feeder appends no chunk once `seconds` have passed
after it, and then exits, so the port reads to the end of what was
written and its entry returns.

The json holds: genome_fd, genome_len, out_fds, ctl_fd, seed, seconds,
lead (bytes), traffic (the traffic file's dict).
"""
from __future__ import annotations

import json
import mmap
import os
import sys
import time

import numpy as np

from portbench.gen.reads import fastq, make_chunk


class Control:
    """64-bit slots shared by the harness and the feeder through a memfd:
    how far the port has read the files (Readers), when the window
    opened, the records the feeder wrote, and a stop."""

    SIZE = 64

    def __init__(self, fd: int):
        self.mm = mmap.mmap(fd, self.SIZE)
        self.i = np.frombuffer(self.mm, np.int64, 8)
        self.f = np.frombuffer(self.mm, np.float64, 8)

    @classmethod
    def create(cls):
        fd = os.memfd_create("portbench-ctl", 0)
        os.ftruncate(fd, cls.SIZE)
        return fd, cls(fd)

    position = property(lambda s: int(s.i[0]))
    t_open = property(lambda s: float(s.f[1]))
    written = property(lambda s: int(s.i[2]))

    def set_position(self, position: int) -> None:
        self.i[0] = position

    def open_window(self, t: float) -> None:
        self.f[1] = t

    def abort(self) -> None:
        self.i[3] = 1

    def close(self) -> None:
        del self.i, self.f
        self.mm.close()


class Readers:
    """How far the port, in this process, has read the files: the least,
    over the files, of the furthest offset of any descriptor open on it
    (found by its inode; its offset by lseek, which moves nothing), but
    the ones handed to the feeder (`own`, which share the feeder's
    offset).  The descriptors are found again every RESCAN calls, since
    the port opens the files itself."""

    RESCAN = 16

    def __init__(self, own: list):
        self.own = set(own)
        self.ids = [self._id(fd) for fd in own]
        self.found: dict = {}
        self.calls = 0

    @staticmethod
    def _id(fd: int):
        st = os.fstat(fd)
        return st.st_dev, st.st_ino

    def _scan(self) -> None:
        self.found = {i: [] for i in self.ids}
        for name in os.listdir("/proc/self/fd"):
            fd = int(name)
            if fd in self.own:
                continue
            try:
                key = self._id(fd)
            except OSError:
                continue
            if key in self.found:
                self.found[key].append(fd)

    def position(self) -> int:
        if self.calls % self.RESCAN == 0 or not all(self.found.values()):
            self._scan()
        self.calls += 1
        far = []
        for key in self.ids:
            pos = 0
            for fd in self.found[key]:
                try:
                    if self._id(fd) == key:
                        pos = max(pos, os.lseek(fd, 0, os.SEEK_CUR))
                except OSError:
                    continue
            far.append(pos)
        return min(far)


def write_all(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def feed(args: dict) -> None:
    traffic = args["traffic"]
    n = int(args["genome_len"])
    gmm = mmap.mmap(args["genome_fd"], n, prot=mmap.PROT_READ)
    genome = np.frombuffer(gmm, np.uint8, n)
    ctl = Control(args["ctl_fd"])
    fds, seed, lead = args["out_fds"], int(args["seed"]), int(args["lead"])
    seconds = float(args["seconds"])
    written, nbytes, c = 0, 0, 0
    try:
        while not ctl.i[3]:
            t_open = ctl.t_open
            if t_open and time.monotonic() >= t_open + seconds:
                break
            if nbytes >= ctl.position + lead:
                time.sleep(0.001)
                continue
            mates, first = make_chunk(traffic, genome, seed, c)
            size = []
            for fd, m in zip(fds, mates):
                text = fastq(m.codes, first, m.lens)
                write_all(fd, text)
                size.append(len(text))
            nbytes += min(size)
            written += sum(len(m.lens) for m in mates)
            ctl.i[2] = written
            c += 1
    finally:
        for fd in fds:
            os.close(fd)
        ctl.close()
        del genome
        gmm.close()


if __name__ == "__main__":
    feed(json.loads(sys.argv[1]))
