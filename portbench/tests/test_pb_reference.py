"""The plain reference against hand-made alignments and records."""
import numpy as np

from portbench.gen.reads import make_chunk
from portbench.reference import judge as J
from portbench.reference.sw import (cigar_score, local_best, parse_cigar,
                                    score_table)

T = score_table(1, -2)


def codes(s):
    return np.array(["ACGT".index(c) for c in s], np.uint8)


def best(q, s, go=4, ge=3):
    return int(local_best(codes(q)[None], codes(s)[None], T, go, ge)[0])


def test_exact_match_scores_its_length():
    assert best("ACGTACGTAC", "TTACGTACGTACTT") == 10


def test_mismatch_in_the_middle_and_at_an_end():
    assert best("ACGTTCGTAC", "ACGTACGTAC") == 9 - 2   # 9 matches, 1 subst
    # a mismatch at the first base is clipped, not scored
    assert best("TCGTACGTAC", "ACGTACGTAC") == 9


def test_affine_gaps():
    q = "AAAACCCCGGGGTTTTACGTAC" + "GATTACAGATTACAGATTACA"
    s = "AAAACCCCGGGGTTTTACGTAC" + "TTT" + "GATTACAGATTACAGATTACA"
    # 43 matches and a 3-base deletion: 43 - (4 + 2 * 3)
    assert best(q, s) == 43 - 10
    assert best(q, s, go=5, ge=1) == 43 - 7


def test_cigar_scores():
    g = codes("GGGGAAAACCCCGGGGTTTTACGTACTTTGATTACA")
    read = codes("AAAACCCCGGGGTTTTACGTACGATTACA")
    got = cigar_score(parse_cigar("22M3D7M"), read, g, 4, 1, -2, 4, 3)
    assert got == (29 - 10, 3, 32)
    clip = cigar_score(parse_cigar("2S20M7S"), read, g, 6, 1, -2, 4, 3)
    assert clip == (20, 0, 20)
    assert cigar_score(parse_cigar("28M"), read, g, 4, 1, -2, 4, 3) is None


GEN = {"length": 20_000, "families": []}
SE = {"reads": "single", "read_len": 60, "substitutions": 0.0,
      "reverse_share": 0.5, "chunk": 64, "batch": 32}
SCORES = {"match": 1, "subst": -2, "gapopen": 4, "gapext": 3}


def _records(g, first=0, n=32, traffic=SE):
    """SAM records placing reads [first, first + n) at their origin (no
    errors: each read matches its origin whole)."""
    [m], f0 = make_chunk(traffic, g, 5, first // traffic["chunk"])
    out = []
    for k in range(first - f0, first - f0 + n):
        L = int(m.lens[k])
        c = m.codes[k, :L]
        seq = 3 - c[::-1] if m.rev[k] else c
        s = "".join("ACGT"[x] for x in seq)
        out.append(f"r{f0 + k:010d}\t{16 if m.rev[k] else 0}\tchr\t"
                   f"{m.truth[k] + 1}\t60\t{L}M\t*\t0\t0\t{s}\t{'I' * L}"
                   f"\tNM:i:0\tAS:i:{L}")
    return out


def test_judge_passes_true_records():
    from portbench.gen.genome import make_genome
    g = make_genome(GEN, 1)
    got = J.judge(["\n".join(_records(g)) + "\n"], SE, SCORES, g, 5, 1000, 32, np.zeros(len(g), bool))
    assert got["reads"] == 32 and got["missing"] == 0
    assert got["record_mismatch"] == 0 and got["below_local_pct"] == 0
    assert got["missed_unique_pct"] == 0 and got["placed_pct"] == 100


def test_judge_counts_what_is_wrong():
    from portbench.gen.genome import make_genome
    g = make_genome(GEN, 1)
    recs = _records(g)
    del recs[3]                                       # a read left out
    f = recs[5].split("\t")
    f[3] = str(int(f[3]) + 1)                         # moved by one base
    recs[5] = "\t".join(f)
    f = recs[7].split("\t")
    f[1], f[2], f[3], f[5] = "4", "*", "0", "*"       # left unmapped
    f[-1] = "AS:i:0"
    recs[7] = "\t".join(f)
    got = J.judge(["\n".join(recs) + "\n"], SE, SCORES, g, 5, 1000, 32, np.zeros(len(g), bool))
    assert got["missing"] == 1 and got["record_mismatch"] == 1
    # the moved record still claims AS 60, so 2 reads missed their origin
    assert got["missed_unique_pct"] == 100 * 2 / 32
    assert got["placed_pct"] == 100 * 30 / 32    # one base off is placed


def test_control_fails_where_an_end_mismatch_is_clipped():
    from portbench.gen.genome import make_genome
    g = make_genome(GEN, 1)
    recs = _records(g, n=4)
    f = recs[0].split("\t")
    seq = list(f[9])
    seq[0] = "A" if seq[0] != "A" else "C"            # an end mismatch
    f[9], f[3], f[5] = "".join(seq), str(int(f[3]) + 1), "1S59M"
    f[-2], f[-1] = "NM:i:0", "AS:i:59"
    text = "\n".join([recs[0]] + recs[1:]) + "\n"
    rendered = J.control_texts(["\t".join(f) + "\n"], g, SCORES)[0]
    c = rendered.split("\t")
    assert c[5] == "60M" and c[-1].strip() == "AS:i:57"
    assert text  # the program's own record keeps its clip


def test_pair_fields():
    rec = J.Records([
        "r0000000000\t99\tchr\t100\t60\t10M\tchr\t300\t210\tA\tI\tAS:i:1\n"
        "r0000000000\t147\tchr\t300\t60\t10M\tchr\t100\t-210\tA\tI\tAS:i:1\n"
        "r0000000001\t99\tchr\t100\t60\t10M\tchr\t301\t210\tA\tI\tAS:i:1\n"
        "r0000000001\t147\tchr\t300\t60\t10M\tchr\t100\t-210\tA\tI\tAS:i:1\n"])
    at = np.array([[0, 1], [2, 3]])
    assert J.pair_fields(rec, at) == 2                # the second pair's PNEXT


def test_missed_origin_counts_unique_sequence_only():
    from portbench.gen.genome import make_genome
    g = make_genome(GEN, 1)
    recs = _records(g, n=4)
    for k in (1, 2):                                  # two reads left unmapped
        f = recs[k].split("\t")
        f[1], f[2], f[3], f[5], f[-1] = "4", "*", "0", "*", "AS:i:0"
        recs[k] = "\t".join(f)
    [m], _ = make_chunk(SE, g, 5, 0)
    rep = np.zeros(len(g), bool)
    rep[m.truth[1] + 10] = True                       # read 1 is from a repeat
    got = J.judge(["\n".join(recs) + "\n"], {**SE, "batch": 4}, SCORES, g,
                  5, 1000, 4, rep)
    assert got["missed_unique_pct"] == 100 * 1 / 3
    # read 1 is the repeat reads' one miss
    assert got["repeat_reads"] == 1 and got["missed_repeat_pct"] == 100


def test_judge_takes_each_read_at_its_own_length():
    from portbench.gen.genome import make_genome
    g = make_genome(GEN, 1)
    var = {**SE, "read_len": {"law": "uniform", "min": 40, "max": 90}}
    recs = _records(g, traffic=var)
    got = J.judge(["\n".join(recs) + "\n"], var, SCORES, g, 5, 1000, 32,
                  np.zeros(len(g), bool))
    assert got["reads"] == 32 and got["missing"] == 0
    assert got["record_mismatch"] == 0 and got["below_local_pct"] == 0
    assert got["missed_unique_pct"] == 0 and got["placed_pct"] == 100
    f = recs[2].split("\t")
    f[9], f[10] = f[9][:-1], f[10][:-1]               # a base short
    f[5] = f"{len(f[9])}M"
    recs[2] = "\t".join(f)
    got = J.judge(["\n".join(recs) + "\n"], var, SCORES, g, 5, 1000, 32,
                  np.zeros(len(g), bool))
    assert got["record_mismatch"] == 1


def test_windows_take_each_rows_width():
    g = np.arange(20, dtype=np.uint8) % 4
    w = J.windows(g, np.array([-2, 5, 17]), np.array([4, 3, 6]))
    assert w.shape == (3, 6)
    assert w[0].tolist() == [4, 4, 0, 1, 4, 4]
    assert w[1].tolist() == [1, 2, 3, 4, 4, 4]
    assert w[2].tolist() == [1, 2, 3, 4, 4, 4]


def test_judge_reads_the_origin_of_reads_with_gaps_over_their_span():
    # reads with indels left unmapped: each one's best at its origin (over
    # its span) is near its length, so every one of them is a miss
    from portbench.gen.genome import make_genome
    g = make_genome(GEN, 1)
    t = {**SE, "indels": 0.02, "read_len": {"law": "uniform", "min": 80,
                                            "max": 120}}
    [m], _ = make_chunk(t, g, 5, 0)
    recs = [f"r{k:010d}\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\tAS:i:0"
            for k in range(32)]
    got = J.judge(["\n".join(recs) + "\n"], t, SCORES, g, 5, 1000, 32,
                  np.zeros(len(g), bool))
    assert got["reads"] == 32 and got["missing"] == 0
    assert got["missed_unique_pct"] == 100 and got["placed_pct"] == 0
    fwd = [m.codes[k, :m.lens[k]] for k in range(3)]
    assert all(len(f) >= 80 for f in fwd)
