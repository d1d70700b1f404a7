"""Native host-side kernels, built on first import with the system C
compiler (no pip dependencies).  Falls back to None if no compiler is
available — callers must provide pure-Python paths.

Two source files compile into one shared object:
  swdp.c    — exact-replica Smith-Waterman kernels + NR quicksorts
  mapcore.c — per-read seeding/collation core (hit info, hit lists,
              seeds/segments/candidates; hashhit.c + segment.c replicas)

Set SMALT_TPU_NO_NATIVE=1 to force the pure-Python paths (used by the
differential tests that validate the C against the Python oracle).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "swdp.c"), os.path.join(_DIR, "mapcore.c"),
         os.path.join(_DIR, "fastlane.c")]
_SO = os.path.join(_DIR, f"_smalt_{sys.platform}.so")

_lib = None
_loaded = False


def _fresh() -> bool:
    newest_src = max(os.path.getmtime(s) for s in _SRCS)
    return os.path.exists(_SO) and os.path.getmtime(_SO) >= newest_src


def _build():
    """Compile the sources into _SO.  Several processes may import the
    package before the library exists (test workers): one builds under
    a file lock, to a temporary name moved into place when complete, so
    no process ever loads a half-written library; the others wait and
    find it fresh."""
    import fcntl
    cc = os.environ.get("CC", "cc")
    tmp = f"{_SO}.{os.getpid()}.tmp"
    # -march=native unlocks the AVX2/AVX-512 kernel variants in swdp.c
    # (the .so is built per-host on first import, so native is safe);
    # -ffp-contract=off keeps the double-precision mapq/probability
    # formulas bit-stable — FMA contraction would round differently
    # than the baseline build and break golden byte-parity.
    base = [cc, "-O3", "-shared", "-fPIC", "-o", tmp] + _SRCS
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():
            return
        try:
            for extra in (["-march=native", "-ffp-contract=off"], []):
                try:
                    subprocess.run(base[:2] + extra + base[2:], check=True,
                                   capture_output=True)
                    break
                except subprocess.CalledProcessError:
                    continue
            else:
                # surface the plain build's error if both failed
                subprocess.run(base, check=True, capture_output=True)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _declare(lib):
    """All array pointers are declared c_void_p so call sites can pass
    cached raw addresses (ints) with no per-call ctypes marshalling."""
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    ci = ctypes.c_int

    lib.sw_band_fast.restype = ci
    lib.sw_band_fast.argtypes = [vp, ci, vp] + [ci] * 8 + [vp, vp]
    lib.sw_band_track.restype = ci
    lib.sw_band_track.argtypes = [vp, ci, vp] + [ci] * 9 + [vp, vp, vp, vp, vp]
    lib.sw_prof8_set.restype = ci
    lib.sw_prof8_set.argtypes = [ci, vp, ci, ci, ci]
    lib.sw_prof8_score.restype = ci
    lib.sw_prof8_score.argtypes = [ci, vp, ci]
    lib.sw_full_wide.restype = ci
    lib.sw_full_wide.argtypes = [vp, ci, vp, ci, ci, ci, vp, vp]
    lib.sw_full.restype = ci
    lib.sw_full.argtypes = [vp, ci, vp, ci, ci, ci, vp, vp]
    lib.nr_sort2.restype = ci
    lib.nr_sort2.argtypes = [vp, vp, ci]
    lib.nr_sort2_64_32.restype = ci
    lib.nr_sort2_64_32.argtypes = [vp, vp, ci]
    lib.nr_sort64.restype = ci
    lib.nr_sort64.argtypes = [vp, ci]

    lib.mc_hitinfo_collect.restype = i64
    lib.mc_hitinfo_collect.argtypes = [
        vp, vp, i64, vp, ci, ci,            # words, starts, nwords, table, k, nskip
        vp, vp, i64, ci, i64, ci,           # codes, qual, qlen, is_rev, maxhit, basq
        i64, i64,                           # seq_start, seq_end
        vp, vp, vp, vp]                     # qmask, qoffs, nhits, slot
    lib.mc_max_rank.restype = i64
    lib.mc_max_rank.argtypes = [vp, vp, vp, i64, i64, ci, ci,
                                i64, i64, i64, vp]
    lib.mc_cover_deficit.restype = i64
    lib.mc_cover_deficit.argtypes = [vp, vp, i64, ci, i64,
                                     vp, i64, ci, ci, vp]
    lib.mc_collect_cutoff.restype = i64
    lib.mc_collect_cutoff.argtypes = [vp, vp,
                                      vp, vp, vp, vp, i64,
                                      i64, ci, ci, i64, i64, vp, vp]
    lib.mc_collect_segment.restype = i64
    lib.mc_collect_segment.argtypes = [vp, vp,
                                       vp, vp, vp, vp, i64, ci,
                                       i64, ci, ci, i64, i64, i64, i64,
                                       vp, vp]
    lib.mc_seg_fill.restype = None
    lib.mc_seg_fill.argtypes = [vp, i64, vp, i64, ci, ci, i64,
                                vp, vp, vp, vp, vp, vp, vp,
                                vp, vp, vp, vp]
    lib.mc_cands_add.restype = i64
    lib.mc_cands_add.argtypes = [vp, vp, vp, vp, vp,
                                 vp, vp, i64, ci, ci, i64, ci,
                                 i64, vp, vp, vp]
    lib.mc_collect_all.restype = i64
    lib.mc_collect_all.argtypes = [
        vp, vp,                              # starts, pos
        vp, vp, vp, vp, i64, i64,            # hitinfo arrays, n_all, rank
        i64, ci, ci, ci,                     # qlen, ktup, nskip, is_rev
        ci, ci, vp, i64,                     # mode, use_short, ivals, nivals
        i64, i64, i64, i64,                  # maxhit, budget, min_ktup, mincover
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,  # scratch
        vp, i64, vp, i64, vp]                # rows10, cap10, out11, cap, maxcov
    lib.mc_traceback.restype = i64
    lib.mc_traceback.argtypes = [vp, i64, vp,
                                 i64, i64, i64, i64,
                                 i64, i64, i64, vp,
                                 ci, ci, ci, vp, i64, vp, vp]
    lib.mc_hitinfo_short2.restype = i64
    lib.mc_hitinfo_short2.argtypes = [
        vp, vp, i64, vp, ci, ci,             # index + table, k, nskip
        vp, vp, i64, i64, i64, ci,           # codes, qual, qlen, limits, basq
        vp, vp, vp, vp, vp,                  # F outputs
        vp, vp, vp, vp, vp,                  # R outputs
        vp, vp, vp]                          # qbuf, keybuf, out
    lib.mc_fast_align.restype = i64
    lib.mc_fast_align.argtypes = [
        vp, i64, ci, vp, vp, i64,            # qcodes, qlen, rc, matrix, subj, slen
        i64, i64, i64, i64, ci, ci,          # band, minscore/len, gaps
        vp, vp, vp, vp, i64, vp, i64,        # W, H, E, dirm/cap, back/cap
        vp, i64, vp, i64]                    # diffpool/cap, res/cap
    lib.mc_score_cands.restype = i64
    lib.mc_score_cands.argtypes = [
        vp, vp, i64,                         # rows, sort_idx, n_sort
        ci, ci,                              # ktup, nskip
        vp, vp, i64, i64,                    # refcodes, offsets, nseq, qlen
        vp, vp, ci, ci, i64, i64,            # Wf, Wr, gaps, avgs
        ci, i64, i64,                        # best flag, deficits
        vp, vp, vp, vp]                      # H, E, out, out_max
    lib.mc_align_recursive.restype = i64
    lib.mc_align_recursive.argtypes = [
        vp, i64, vp, i64,                    # W, qlen, subj, slen
        i64, i64, i64, i64, i64, i64,        # band + q/s segments
        i64, i64, ci, ci,                    # minscore, minscorlen, gaps
        vp, vp, vp, i64, vp, i64,            # H, E, dirm/cap, back/cap
        vp, i64, vp, i64,                    # diffpool/cap, res/cap
        ctypes.c_int, ctypes.c_double]       # use_cplx, lam
    lib.mc_align_recursive_dev.restype = i64
    lib.mc_align_recursive_dev.argtypes = (
        lib.mc_align_recursive.argtypes +
        [i64, i64, i64, vp, i64, vp])        # dev best/mi/mj/rec/nrows/used


def _declare_fastlane(lib):
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    ci = ctypes.c_int
    dbl = ctypes.c_double
    lib.fl_map_block.restype = i64
    lib.fl_map_block.argtypes = [
        vp, vp, i64, vp, vp, ci, ci,        # index
        vp, vp, i64, vp, vp, vp,            # reference + names
        vp, ci, ci, i64, i64,               # scoring
        i64, i64, dbl, i64, i64, ci,        # params 1
        i64, i64, ci, ci,                   # params 2
        i64, i64, dbl, ci, ci,              # filter + sam opts
        ci, ci,                             # out_fmt, ali_out (-a)
        ci, ci,                             # codes_are_ascii, names_raw
        i64, vp, vp, vp, vp, vp, vp,        # reads
        vp, vp, i64, dbl]                   # rng + output + lam
    lib.fl_prof_fetch.restype = i64
    lib.fl_prof_fetch.argtypes = [vp, ci]
    lib.fl_scratch_new.restype = vp
    lib.fl_scratch_new.argtypes = [i64]
    lib.fl_scratch_del.restype = None
    lib.fl_scratch_del.argtypes = [vp]
    lib.fl_hit_count.restype = i64
    lib.fl_hit_count.argtypes = [
        vp, vp, i64, vp, vp, ci, ci,        # index
        i64, i64, ci,                       # cutoffs
        vp, vp, i64, vp]                    # read + scratch
    lib.fl_single_rs.restype = i64
    lib.fl_single_rs.argtypes = [
        vp, vp, i64, vp, vp, ci, ci,        # index
        vp, vp, i64, vp,                    # reference + seq_ivals
        vp, i64,                            # override ivals
        vp, ci, ci, i64, i64,               # scoring
        i64, i64, dbl, i64, i64, ci,        # params 1
        i64, i64, ci,                       # params 2
        vp, vp, i64,                        # read
        vp, i64, vp, i64, vp, vp, vp, vp,   # outputs + scratch
        dbl]                                # lam
    lib.fl_fast_tail_block.restype = i64
    lib.fl_fast_tail_block.argtypes = [
        vp, vp, i64, vp, vp,                # reference + names
        vp, ci, ci, i64, i64, ci, ci,       # scoring + sam opts
        i64, i64, i64,                      # window geometry
        i64, vp, vp, vp, vp, vp, vp, vp, vp, vp,  # reads (off/len form)
        vp, vp, vp, vp, vp, vp, vp, vp,     # device outputs
        vp, vp,                             # tb anchors (NULL = banded)
        vp,                                 # skip mask
        vp, i64, vp]                        # out text, cap, out_offs
    lib.fl_fast_tail_pairs.restype = i64
    lib.fl_fast_tail_pairs.argtypes = [
        vp, vp, i64, vp, vp,                # reference + names
        vp, ci, ci, i64, i64, ci, ci,       # scoring + sam opts
        i64, i64, i64,                      # window geometry
        i64, i64, ci,                       # inserts + libcode
        i64, vp, vp, vp, vp, vp, vp, vp, vp, vp,  # reads (off/len form)
        vp, vp, vp, vp, vp, vp, vp, vp,     # device outputs
        vp, vp,                             # tb anchors (NULL = banded)
        vp, i64, i64, i64, i64, i64,        # -g histogram (NULL = flat)
        vp, vp,                             # skip mask + pair extents
        vp, i64]                            # out text, cap
    lib.fl_map_pair_block.restype = i64
    lib.fl_map_pair_block.argtypes = [
        vp, vp, i64, vp, vp, ci, ci,        # index
        vp, vp, i64, vp, vp, vp,            # reference + names
        vp, ci, ci, i64, i64,               # scoring
        i64, i64, dbl, i64, i64, ci,        # params 1
        i64, i64, ci, ci,                   # params 2
        i64, i64, dbl, ci, ci,              # filter + sam opts
        ci, ci,                             # out_fmt, ali_out (-a)
        i64, i64, ci,                       # pair params
        vp, i64, i64, i64, i64, i64,        # -g insert histogram
        ci, ci,                             # ascii_codes, names_raw
        i64, vp, vp, vp, vp, vp, vp,        # reads A
        vp, vp, vp, vp, vp, vp,             # reads B
        vp, vp, i64, vp, dbl,               # rng, out, cap, done, lam
        vp, vp, vp, vp, i64]                # device-exact state/scores
    lib.fl_fastq_scan.restype = i64
    lib.fl_fastq_scan.argtypes = [
        vp, i64, i64,                       # buf, len, max_rec
        vp, vp, vp, vp, vp, vp]             # extents + consumed
    lib.fl_fastq_encode.restype = i64
    lib.fl_fastq_encode.argtypes = [
        vp, i64, vp, vp, i64, vp]           # buf, n, off, len, Q, enc
    lib.mc_dev_align.restype = i64
    lib.mc_dev_align.argtypes = [
        vp, i64, ci, vp, vp, i64,           # query, revcomp, matrix, subj
        i64, i64, i64, i64,                 # ti, tj, sc_hint, minscore
        ci, ci,                             # gaps
        vp, vp, vp,                         # Wbuf, Hbuf, Ebuf
        vp, i64, vp, i64, vp, i64,          # dirm, back, diffpool
        vp]                                 # res (7 int64)
    lib.fl_pass1_block.restype = i64
    lib.fl_pass1_block.argtypes = [
        vp, vp, i64, vp, vp, ci, ci,        # index
        vp, vp, i64, vp,                    # reference
        vp, ci, ci, i64, i64,               # scoring
        i64, i64, dbl, i64, i64, ci,        # params 1
        i64, i64, ci,                       # params 2 (rmapflg)
        ci,                                 # codes_are_ascii
        i64, vp, vp, vp, vp,                # reads
        vp, i64, vp,                        # state
        vp, i64]                            # windows
    lib.fl_pass2_block.restype = i64
    lib.fl_pass2_block.argtypes = [
        vp, vp, i64, vp, vp, ci, ci,        # index
        vp, vp, i64, vp, vp, vp,            # reference + names
        vp, ci, ci, i64, i64,               # scoring
        i64, i64, dbl, i64, i64, ci,        # params 1
        i64, i64, ci, ci,                   # params 2
        i64, i64, dbl, ci, ci, ci, ci,      # filter + sam opts + fmt + -a
        ci, ci,                             # codes_are_ascii, names_raw
        i64, vp, vp, vp, vp, vp, vp,        # reads
        vp, vp,                             # state
        vp, i64,                            # scores
        vp, vp, i64, dbl,                   # rng + output + lam
        vp, vp,                             # pres, phdr (prep replay)
        vp, vp, vp, vp, vp, i64, i64,       # dev pass-2 arrays
        vp]                                 # dev_stats
    lib.fl_pass2_prep_block.restype = i64
    lib.fl_pass2_prep_block.argtypes = [
        vp, ci, ci, i64, i64,               # matrix + penalties + avgs
        vp, vp, i64, ci, ci,                # reference, wordlen, nskip
        i64, i64, ci,                       # minscor, belowmax, rmapflg
        ci,                                 # codes_are_ascii
        i64, vp, vp,                        # reads
        vp, vp,                             # state
        vp, i64,                            # scores
        vp, vp,                             # pres, phdr
        vp, i64]                            # win, win_cap
    if hasattr(lib, "fl_exact_pre_block"):
        lib.fl_exact_pre_block.restype = i64
        lib.fl_exact_pre_block.argtypes = [
            vp, vp, i64, vp, ci, ci,        # index
            i64, i64, ci, dbl,              # cutoffs + basq + coverfrac
            ci,                             # codes_are_ascii
            i64, vp, vp, vp, vp,            # reads
            i64, vp, vp,                    # Qpad, pre, selmask
            vp, i64, vp, vp, vp,            # pos, Hcap, k1, k2, tot
            vp, i64, vp]                    # seq_offsets, nseq, ks
        lib.fl_exact_post_block.restype = i64
        lib.fl_exact_post_block.argtypes = [
            ci, ci, vp, i64,                # wordlen/nskip/offsets/nseq
            i64, i64, i64,                  # belowmax, match/mismatch avg
            i64, i64, ci,                   # depth + rmapflg
            i64, vp, vp,                    # n_reads, read_offs, pre
            vp, vp, vp, i64,                # pool, counts2, scores, n_pool
            vp, vp,                         # dev_fallback, dev_cksum
            vp, i64, vp, vp]                # state, cap, offs, n_restage


def _load():
    global _lib, _loaded
    if _loaded:
        return _lib
    _loaded = True
    if os.environ.get("SMALT_TPU_NO_NATIVE"):
        return None
    if not _fresh():
        try:
            _build()
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
        _declare(lib)
        _declare_fastlane(lib)
        _declare_counters(lib)
        _declare_tier(lib)
    except (OSError, AttributeError):
        return None
    _lib = lib
    return lib


def get_lib():
    return _load()


def ptr(a: np.ndarray, ct=None):
    """Raw data address of a contiguous array (for c_void_p args)."""
    return a.ctypes.data


# fl_prof_acc's slots (native/fastlane.c, SMALT_FL_TIMING), in slot order,
# one quantity each: the stages (seconds, additive), the sub-splits
# (seconds within the stages, not additive with them) and the counts
FL_PROF_STAGES = ("seed/collate", "pass1-score", "pass2-align",
                  "report/SAM", "pair-probe", "pair-report")
FL_PROF_SUB = ("hitinfo", "collect", "candstats", "profiles",
               "pass2-dp", "pass2-post", "remap")
FL_PROF_COUNTS = ("shortcut-hits", "dp-runs", "fast-retries",
                  "fast-retry-gap")
FL_PROF_SLOTS = FL_PROF_STAGES + FL_PROF_SUB + FL_PROF_COUNTS
# the causes fl_exact_post_block counts a re-staged read under, in the
# order fl_restage_fetch gives them
RESTAGE_CAUSES = ("dev", "ck", "stats", "geom", "simd")


def _declare_counters(lib):
    import ctypes
    lib.fl_prof_set.restype = None
    lib.fl_prof_set.argtypes = [ctypes.c_int]
    lib.fl_prof_take.restype = ctypes.c_double
    lib.fl_prof_take.argtypes = [ctypes.c_int64]
    lib.fl_restage_fetch.restype = ctypes.c_int64
    lib.fl_restage_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int]


def _declare_tier(lib):
    """The port's pre block takes the repeat tier's arrays after the
    reference's arguments (fastlane.c fl_exact_pre_block: Ht, Bt, t_k1,
    t_k2, t_ks, t_tot, t_row)."""
    import ctypes
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.fl_exact_pre_block.argtypes = \
        lib.fl_exact_pre_block.argtypes + [i64, i64, vp, vp, vp, vp, vp]


def fl_prof_report(reset: bool = True):
    """What the C lane's profiler accumulated since the last reset:
    {stage: seconds} for FL_PROF_STAGES, with "_sub" {sub-split:
    seconds} and "_counts" {count: value} beside them; empty when the
    lane is unavailable or SMALT_FL_TIMING wasn't set (the C side only
    accumulates under that env var, fastlane.c fl_prof)."""
    import ctypes
    lib = _load()
    if lib is None:
        return {}
    buf = (ctypes.c_double * len(FL_PROF_SLOTS))()
    if lib.fl_prof_fetch(buf, 1 if reset else 0) != len(FL_PROF_SLOTS):
        raise RuntimeError("fastlane.c's profiler slots differ from "
                           "FL_PROF_SLOTS")
    vals = dict(zip(FL_PROF_SLOTS, buf))
    if not any(vals.values()):
        return {}
    out = {k: vals[k] for k in FL_PROF_STAGES}
    out["_sub"] = {k: vals[k] for k in FL_PROF_SUB}
    out["_counts"] = {k: vals[k] for k in FL_PROF_COUNTS}
    return out


def fl_prof_set(on: bool) -> None:
    """The C lane's profiler on or off from now on (it reads
    SMALT_FL_TIMING once, at its first use in the process)."""
    lib = _load()
    if lib is not None:
        lib.fl_prof_set(1 if on else 0)


def fl_prof_take(name: str) -> float:
    """One profiler slot's value since its last take (0 where the lane
    is unavailable), and the slot set to zero."""
    lib = _load()
    return 0.0 if lib is None else \
        lib.fl_prof_take(FL_PROF_SLOTS.index(name))


def fl_restage_fetch(reset: bool = True) -> dict:
    """{cause: reads} that fl_exact_post_block re-staged since the last
    reset, under RESTAGE_CAUSES (always counted)."""
    lib = _load()
    out = np.zeros(len(RESTAGE_CAUSES), np.int64)
    if lib is not None and lib.fl_restage_fetch(
            out.ctypes.data, 1 if reset else 0) != len(RESTAGE_CAUSES):
        raise RuntimeError("fastlane.c's re-stage causes differ from "
                           "RESTAGE_CAUSES")
    return dict(zip(RESTAGE_CAUSES, out.tolist()))


class GrowBuf:
    """Reusable scratch array with a cached raw address."""
    __slots__ = ("arr", "addr", "dtype")

    def __init__(self, dtype, n: int = 16):
        self.dtype = np.dtype(dtype)
        self.arr = np.empty(max(n, 1), self.dtype)
        self.addr = self.arr.ctypes.data

    def ensure(self, n: int) -> np.ndarray:
        if len(self.arr) < n:
            self.arr = np.empty(n + (n >> 1) + 16, self.dtype)
            self.addr = self.arr.ctypes.data
        return self.arr


class _NrSortModule:
    """Adapter exposing sort2 for sort_nr."""

    def __init__(self, lib):
        self._lib = lib

    def sort2(self, a: np.ndarray, b: np.ndarray):
        assert a.dtype == np.uint32 and b.dtype == np.uint32
        assert a.flags.c_contiguous and b.flags.c_contiguous
        rc = self._lib.nr_sort2(a.ctypes.data, b.ctypes.data, len(a))
        if rc != 0:
            raise RuntimeError("nr_sort2 stack overflow")


_l = _load()
nrsort = _NrSortModule(_l) if _l is not None else None
