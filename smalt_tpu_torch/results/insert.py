"""Insert-size sampling and histograms (insert.c).

`smalt sample` collects insert sizes from confidently mapped pairs,
bins them around the median (range = 2*3*IQR, ~3*sqrt(n) bins,
insert.c:330-384), smooths with a Gaussian kernel whose bandwidth is
Silverman's rule 0.9*n^-0.2*iqr/1.34 (insert.c:497-503), and writes a
text histogram file that `smalt map -g` reads back to weight the pair
probability model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

KERNEL_CUTOFF_BANDFAC = 3
KERNEL_MIN_WIDTH = 3
IQR_RANGE_FAC = 3
HISTO_MIN_BINNUM = 16
HISTO_MAX_BINNUM = 1028
SAMPLE_TARGETSIZ = 4098

IOFIL_HEADER = "# SMALT histogram of insert sizes\n"


class InsSample:
    """Reservoir of sampled insert sizes (InsSample, insert.c:66-70)."""

    def __init__(self):
        self.sample: List[int] = []
        self.readival = 1

    def set_read_interval(self, nreads: int, nrskip: int):
        """insSetSamplingInterval semantics: sample ~SAMPLE_TARGETSIZ pairs."""
        n = nreads // SAMPLE_TARGETSIZ
        self.readival = max(int(n), 1)
        if 0 < nrskip < self.readival:
            self.readival = nrskip

    def add(self, isiz: int):
        self.sample.append(int(isiz))

    def is_in_sample(self, readno: int) -> bool:
        return readno % self.readival == 0


@dataclass
class InsHist:
    counts: np.ndarray          # int32 [span]
    smooth: np.ndarray          # int32 [span]
    span: int
    insizlo: int
    insizhi: int
    scalfac: int
    num: int
    median: int
    quart_lo: int
    quart_hi: int
    smoothed: bool = False

    # ------------- queries -------------

    def _idx(self, insiz: int) -> int:
        if insiz < self.insizlo:
            return 0
        if insiz > self.insizhi:
            return self.span - 1
        idx = (insiz - self.insizlo) // self.scalfac
        return min(idx, self.span - 1)

    def count(self, insiz: int, is_smooth: bool = True):
        """insGetHistoCount: (count, totnum)."""
        rv = 0
        if self.insizlo <= insiz <= self.insizhi:
            arr = self.smooth if (is_smooth and self.smoothed) else self.counts
            rv = int(arr[self._idx(insiz)])
        return rv, self.num

    def count_cumulative(self, insiz: int, is_smooth: bool = True):
        """insGetHistoCountCumulative: (cumulative count, totnum)."""
        cc = 0
        if self.insizlo <= insiz <= self.insizhi:
            arr = self.smooth if (is_smooth and self.smoothed) else self.counts
            cc = int(arr[: self._idx(insiz) + 1].sum())
        return cc, self.num

    # ------------- construction -------------

    @classmethod
    def from_sample(cls, samp: InsSample) -> Optional["InsHist"]:
        """insMakeHistoFromSample (insert.c:330-384)."""
        vals = sorted(samp.sample)
        if not vals:
            return None
        ns = len(vals)
        med = vals[int(ns * 0.5)]
        qlo = vals[int(ns * 0.25)]
        qhi = vals[int(ns * 0.75)]
        irange = (qhi - qlo) * IQR_RANGE_FAC * 2
        nbins = int(3 * math.sqrt(ns))
        nbins = max(HISTO_MIN_BINNUM, min(nbins, HISTO_MAX_BINNUM))
        scf = irange // nbins if nbins else 0
        if scf < 1:
            nbins = irange
            scf = 1
        else:
            irange = scf * nbins
        if nbins < 1:
            return None
        h = cls(counts=np.zeros(nbins, dtype=np.int64),
                smooth=np.zeros(nbins, dtype=np.int64),
                span=nbins, insizlo=med - irange // 2,
                insizhi=(med - irange // 2) + irange - 1,
                scalfac=scf, num=0, median=med, quart_lo=qlo, quart_hi=qhi)
        for v in vals:
            if h.insizlo <= v <= h.insizhi:
                h.counts[h._idx(v)] += 1
                h.num += 1
        h.smooth_gauss()
        return h

    def smooth_gauss(self):
        """insSmoothHisto + smoothGauss (insert.c:253-305, 472-512)."""
        if self.num < 2:
            return
        iqr = 0
        if self.span > 3:
            n = 0
            q = 0
            quart = [0, 0, 0]
            th = self.num // 4
            for i in range(self.span):
                if q >= 3:
                    break
                n += int(self.counts[i])
                if n > th:
                    quart[q] = i
                    q += 1
                    n -= int(self.counts[i]) // 2
                    th = self.num * q // 4
            if q > 2:
                iqr = quart[2] - quart[0]
        kbw = int(0.9 * (self.num ** -0.2) * iqr / 1.34) if self.num > 0 else 0
        if kbw < KERNEL_MIN_WIDTH:
            kbw = KERNEL_MIN_WIDTH
        bw = kbw
        cutoff = KERNEL_CUTOFF_BANDFAC * bw
        imax = 2 * cutoff + 1
        n = self.span
        if imax > n:
            bw = (n - 1) // (2 * KERNEL_CUTOFF_BANDFAC)
        if bw < KERNEL_MIN_WIDTH:
            bw = KERNEL_MIN_WIDTH
        cutoff = KERNEL_CUTOFF_BANDFAC * bw
        imax = 2 * cutoff + 1
        normfac = math.sqrt(2 * math.pi)
        K = [math.exp(-(((i - cutoff) / bw) ** 2) / 2) / normfac
             for i in range(imax)]

        def kget(k):
            # For i <= cutoff the reference starts the kernel at k=i
            # (insert.c:284) and can index past the imax kernel values into
            # the calloc'd remainder of its span-sized buffer, reading 0.0.
            return K[k] if k < imax else 0.0

        for i in range(n):
            if i > cutoff:
                j, k = i - cutoff, 0
            else:
                j, k = 0, i
            jmax = i + cutoff if i + cutoff < n else n
            tt = 0.0
            while j < jmax:
                tt += int(self.counts[j]) * kget(k)
                j += 1
                k += 1
            self.smooth[i] = int(tt / bw)
        self.smoothed = True

    # ------------- text file io (insWriteHisto/insReadHisto) -------------

    def write(self, fp, is_smooth: bool = False):
        arr = self.smooth if (is_smooth and self.smoothed) else self.counts
        totnum = int(arr.sum())
        fp.write(IOFIL_HEADER)
        fp.write("HISTO_START\n")
        fp.write(f"HISTO_BINNUM {self.span}\nHISTO_SCALFAC {self.scalfac}\n"
                 f"HISTO_INSIZLO {self.insizlo}\nHISTO_INSIZHI {self.insizhi}\n"
                 f"HISTO_TOTNUM {totnum}\n"
                 f"HISTO_QUARTILES {self.quart_lo} {self.median} {self.quart_hi}\n")
        for i in range(self.span):
            fp.write(f"{self.insizlo + i * self.scalfac} {int(arr[i])}\n")
        fp.write("HISTO_END\n")

    @classmethod
    def read(cls, path: str) -> "InsHist":
        with open(path) as fp:
            lines = fp.read().splitlines()
        it = iter(lines)
        for ln in it:
            if ln.startswith("HISTO_START"):
                break
        kv = {}
        rows = []
        quart = (0, 0, 0)
        for ln in it:
            if ln.startswith("HISTO_END"):
                break
            if ln.startswith("HISTO_QUARTILES"):
                parts = ln.split()
                quart = (int(parts[1]), int(parts[2]), int(parts[3]))
            elif ln.startswith("HISTO_"):
                k, v = ln.split()
                kv[k] = int(v)
            else:
                a, b = ln.split()
                rows.append(int(b))
        span = kv["HISTO_BINNUM"]
        counts = np.asarray(rows[:span], dtype=np.int64)
        h = cls(counts=counts, smooth=np.zeros(span, dtype=np.int64),
                span=span, insizlo=kv["HISTO_INSIZLO"],
                insizhi=kv["HISTO_INSIZHI"], scalfac=kv["HISTO_SCALFAC"],
                num=int(counts.sum()), median=quart[1], quart_lo=quart[0],
                quart_hi=quart[2])
        h.smooth_gauss()
        return h

    def print_ascii(self, fp, linwidth: int = 80, is_smooth: bool = False):
        """insPrintHisto (insert.c:574-601)."""
        arr = self.smooth if (is_smooth and self.smoothed) else self.counts
        nz = np.flatnonzero(self.counts)
        if len(nz) == 0:
            fp.write("# Histogram of insert sizes is empty.\n")
            return
        lo, hi = int(nz[0]), int(nz[-1])
        mx = int(self.counts[lo:hi + 1].max())
        wf = min(linwidth / mx, 1.0)
        for i in range(lo, hi + 1):
            fp.write(f"#{self.insizlo + i * self.scalfac:5d} ")
            fp.write("*" * int(int(arr[i]) * wf))
            fp.write("\n")
