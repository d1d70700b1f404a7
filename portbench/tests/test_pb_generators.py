"""The generators repeat exactly for a seed, and make what their
parameters say."""
import numpy as np

from portbench.gen.genome import make_genome, write_fasta
import pytest

from portbench.gen.reads import (ACGT, fastq, kind, lengths, make_chunk,
                                 record_len, serial_of)
from portbench.reference.sw import local_best, score_table

GENOME = {"length": 50_000, "families": [
    {"kind": "dispersed", "unit_len": [300, 300], "units": 2, "share": 0.1,
     "fragment": None, "divergence": [0.0, 0.0]},
    {"kind": "dispersed", "unit_len": [2000, 2000], "units": 1, "copies": 4,
     "fragment": [500, 1000], "divergence": [0.05, 0.05]},
    {"kind": "tandem", "unit_len": [3, 3], "array_units": [10, 10],
     "copies": 5, "divergence": [0.0, 0.0]}]}
SE = {"reads": "single", "read_len": 100, "substitutions": 0.01,
      "reverse_share": 0.5, "chunk": 1024}
GEN_PLAIN = {"length": 50_000, "families": []}
PE = {"reads": "pairs", "read_len": 150, "substitutions": 0.01,
      "insert_mean": 300, "insert_sd": 30, "chunk": 1024}


def test_genome_repeats_for_a_seed():
    a, b = make_genome(GENOME, 7), make_genome(GENOME, 7)
    assert a.dtype == np.uint8 and len(a) == 50_000 and a.max() <= 3
    assert np.array_equal(a, b)
    assert not np.array_equal(a, make_genome(GENOME, 8))


def test_genome_takes_large_seeds():
    g = {"length": 1000, "families": []}
    assert np.array_equal(make_genome(g, 2**31 + 5), make_genome(g, 2**31 + 5))
    assert not np.array_equal(make_genome(g, 2**31 + 5), make_genome(g, 5))


def test_dispersed_copies_share_their_unit():
    # undiverged full-length copies of 2 units: many 300-mers repeat
    g = make_genome({"length": 50_000, "families": GENOME["families"][:1]}, 3)
    words = {g[i:i + 40].tobytes() for i in range(len(g) - 40)}
    assert len(words) < 0.95 * (len(g) - 40)


def test_fasta_lines(tmp_path):
    g = make_genome({"length": 205, "families": []}, 1)
    p = tmp_path / "g.fa"
    write_fasta(str(p), g)
    lines = p.read_bytes().split(b"\n")
    assert lines[0] == b">chr" and [len(x) for x in lines[1:4]] == [80, 80, 45]
    assert b"".join(lines[1:]) == ACGT[g].tobytes()


def test_chunks_repeat_exactly_and_differ():
    g = make_genome(GENOME, 1)
    (a, fa), (b, fb) = make_chunk(SE, g, 9, 3), make_chunk(SE, g, 9, 3)
    assert fa == fb == 3 * 1024
    for f in ("codes", "lens", "truth", "span", "rev"):
        assert np.array_equal(getattr(a[0], f), getattr(b[0], f))
    c, _ = make_chunk(SE, g, 9, 4)
    assert not np.array_equal(a[0].codes, c[0].codes)


def test_single_reads_match_their_origin():
    g = make_genome(GENOME, 1)
    [m], _ = make_chunk(SE, g, 2, 0)
    codes, pos, rev = m.codes, m.truth, m.rev
    assert (m.lens == 100).all() and (m.span == 100).all()
    fwd = np.where(rev[:, None], 3 - codes[:, ::-1], codes)
    src = g[pos[:, None] + np.arange(100)]
    diff = (fwd != src).mean()
    assert 0.005 < diff < 0.015 and 0.4 < rev.mean() < 0.6


def test_pairs_are_fr_with_their_inserts():
    g = make_genome(GENOME, 1)
    mates, first = make_chunk(PE, g, 2, 1)
    assert first == 512 and len(mates) == 2
    (t1, r1), (t2, r2) = ((m.truth, m.rev) for m in mates)
    assert np.array_equal(r1, ~r2)
    left, right = np.minimum(t1, t2), np.maximum(t1, t2)
    ins = right + 150 - left
    assert abs(ins.mean() - 300) < 6 and 20 < ins.std() < 40


def test_fastq_records():
    codes = np.array([[0, 1, 2, 3], [3, 3, 0, 0]], np.uint8)
    text = fastq(codes, 41)
    assert text == (b"@r0000000041\nACGT\n+\nIIII\n"
                    b"@r0000000042\nTTAA\n+\nIIII\n")
    assert len(text) == 2 * record_len(4)
    assert serial_of("r0000000042") == 42


def test_kind_of_reads_is_found_by_name():
    assert kind(SE).MATES == 1 and kind(PE).MATES == 2
    for bad in ("no_such_kind", "../run", "Single"):
        with pytest.raises((ValueError, ImportError)):
            kind({"reads": bad})


def test_laws_of_lengths():
    rng = np.random.default_rng(1)
    assert (lengths(rng, {"read_len": 150}, 5) == 150).all()
    u = lengths(rng, {"read_len": {"law": "uniform", "min": 1000,
                                   "max": 2000}}, 4000)
    assert u.min() >= 1000 and u.max() <= 2000 and abs(u.mean() - 1500) < 30
    ln = lengths(rng, {"read_len": {"law": "lognormal", "median": 10000,
                                    "sigma": 0.5, "min": 500,
                                    "max": 40000}}, 4000)
    assert 9000 < np.median(ln) < 11000 and ln.min() >= 500


def test_reads_with_indels_align_over_their_span():
    g = make_genome(GEN_PLAIN, 4)
    t = {"reads": "single", "substitutions": 0.0, "indels": 0.015,
         "reverse_share": 0.5, "chunk": 64,
         "read_len": {"law": "uniform", "min": 300, "max": 500}}
    [m], _ = make_chunk(t, g, 3, 0)
    assert m.codes.shape == (64, int(m.lens.max()))
    assert (m.codes[np.arange(m.codes.shape[1]) >= m.lens[:, None]] == 4).all()
    assert (m.span != m.lens).any()           # the gaps move the span
    fwd = np.where(m.rev[:, None], 0, m.codes)
    for k in np.nonzero(m.rev)[0]:
        L = m.lens[k]
        fwd[k, :L] = 3 - m.codes[k, :L][::-1]
        fwd[k, L:] = 4
    S = int(m.span.max())
    win = np.full((64, S), 4, np.uint8)
    for k in range(64):
        win[k, :m.span[k]] = g[m.truth[k]: m.truth[k] + m.span[k]]
    got = local_best(fwd, win, score_table(1, -2), 4, 3)
    # about 1.5% of bases inserted and 1.5% deleted: each gap costs <= 7
    assert (got > 0.7 * m.lens).all()


def test_pairs_of_varied_lengths_keep_their_mates_apart():
    g = make_genome(GEN_PLAIN, 4)
    t = {**PE, "read_len": {"law": "uniform", "min": 100, "max": 150}}
    m1, m2 = make_chunk(t, g, 3, 0)[0]
    assert m1.codes.shape[1] == m2.codes.shape[1] == max(m1.lens.max(),
                                                         m2.lens.max())
    left = np.minimum(m1.truth, m2.truth)
    right = np.maximum(m1.truth + m1.span, m2.truth + m2.span)
    assert abs((right - left).mean() - 300) < 10


def test_fastq_of_varied_lengths():
    codes = np.array([[0, 1, 2, 3], [3, 3, 4, 4]], np.uint8)
    text = fastq(codes, 7, np.array([4, 2]))
    assert text == b"@r0000000007\nACGT\n+\nIIII\n@r0000000008\nTT\n+\nII\n"
    assert len(text) == record_len(4) + record_len(2)
