"""The port's device mesh (smalt_tpu_torch/parallel/spmd.py and the mesh
steps of parallel/mesh.py) against smalt_tpu.parallel.mesh on the same
seeded inputs, on the CPU: exact integer equality.  The JAX side runs on
the virtual 8-device CPU mesh tests/conftest.py sets up, its windows
scored by the jnp oracles the Pallas kernels equal (jax_full_oracle,
jax_band_oracle); the port's members all sit on the CPU.  Also the
run-level checks: run_fast_pipeline and the CLI over meshes write the
single-device SAM, mesh_shape, and the halo the port repairs."""
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from smalt_tpu.align import core as ali
from smalt_tpu.index.table import build_index
from smalt_tpu.ops import sw as jsw
from smalt_tpu.parallel import mesh as jm
from smalt_tpu.seq import codec
from smalt_tpu.seq.refset import RefSet
from smalt_tpu_torch.align import core as tali
from smalt_tpu_torch.map import fastmode as tfast
from smalt_tpu_torch.parallel import mesh as tm
from smalt_tpu_torch.parallel.spmd import Mesh
from test_torch_mesh import jax_band_oracle  # noqa: F401  (fixture)
from test_torch_standalone import port_index, port_refset


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers run other CPU lanes beside it,
    and a mesh step's many small ops stall on each other's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_full_oracle(monkeypatch):
    """The JAX steps score full-matrix windows with the jnp oracle
    sw_score_ref, which the Pallas kernel equals
    (tests/test_sw_kernel.py)."""

    def full_oracle(q, s, sl, mat, go, ge, interpret=None, track=False):
        return jsw.sw_score_ref(q, s, sl, mat, go, ge, track=track)

    monkeypatch.setattr(jm, "sw_score_batch", full_oracle)


def _jmesh(dp, ip):
    devs = jax.devices()
    assert len(devs) >= dp * ip, "needs the 8-device virtual CPU mesh"
    return JMesh(np.array(devs[: dp * ip]).reshape(dp, ip), ("dp", "ip"))


def _cpu_mesh(dp, ip):
    return Mesh(dp, ip, ["cpu"] * (dp * ip))


def _fasta(tmp, name, g):
    fa = os.path.join(tmp, name)
    with open(fa, "w") as f:
        f.write(">" + name + "\n")
        for i in range(0, len(g), 60):
            f.write(g[i : i + 60] + "\n")
    return RefSet.from_fasta(fa)


def _seg(refset, st, n, rev):
    seg = codec.alpha(refset.codes[st : st + n]).astype(np.int32)
    return np.where(seg & 4, seg, seg ^ 3)[::-1] if rev else seg


def _straddle_reads(refset, seed, B, Q, n_cut=8, qlen=None):
    """tests/test_mesh.py:72's batch: the first n_cut reads straddle the
    cut at total_len/2, the rest anywhere; 2% substitutions, odd rows
    reverse-complemented, a pad row of 7s last."""
    rng = np.random.default_rng(seed)
    qlen = qlen or Q
    reads = np.full((B, Q), 7, np.int32)
    half = refset.total_len // 2
    for i in range(B - 1):
        st = half - qlen // 2 - i if i < n_cut else \
            int(rng.integers(0, refset.total_len - qlen))
        seg = _seg(refset, st, qlen, i % 2 == 1).copy()
        m = rng.random(qlen) < 0.02
        seg[m] = rng.integers(0, 4, int(m.sum()))
        reads[i, :qlen] = seg
    return reads


@pytest.fixture(scope="module")
def xrep(tmp_path_factory):
    """tests/test_mesh.py:164's genome: a 4 kb repeat whose copies lie
    in different halves (shards) of a 40 kb genome; k13 s4."""
    rng = np.random.default_rng(44)
    bases = np.array(list(b"ACGT"), np.uint8)
    seg, f1, f2, f3 = (rng.choice(bases, n).tobytes().decode()
                       for n in (4000, 8000, 16000, 8000))
    refset = _fasta(str(tmp_path_factory.mktemp("xrep")), "xrep",
                    f1 + seg + f2 + seg + f3)
    return refset, build_index(refset, 13, 4)


def _same_out(got: dict, want: dict, what: str):
    for k in tm.OUT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")


def _single(refset, idx, reads):
    """The port's single-device step on the CPU."""
    m, go, ge = tali.make_score_matrix()
    di = tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu")
    return tm.make_device_step(di, m, -go, -ge)(torch.from_numpy(reads))


# ------------------------------------------------------------------
# ShardedDeviceIndex
# ------------------------------------------------------------------

_SFIELDS = ("words", "starts", "pos", "ref_alpha", "shard_base",
            "local_len", "hi_table", "words_lo")


def _same_sharded(tsdi, jsdi):
    for f in _SFIELDS:
        a, b = getattr(tsdi, f), getattr(jsdi, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == np.int32, f
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    for f in ("wordlen", "nskip", "n_shards", "ref_len", "lo_steps"):
        assert getattr(tsdi, f) == getattr(jsdi, f), f


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_index_equals_jax_build(indexed, n_shards):
    refset, idx = indexed
    jsdi = jm.ShardedDeviceIndex.build(refset, idx, n_shards)
    tsdi = tm.ShardedDeviceIndex.build(port_refset(refset), port_index(idx),
                                       n_shards)
    _same_sharded(tsdi, jsdi)
    assert tsdi.halo == tm.ShardedDeviceIndex.DEFAULT_HALO == 640
    m = tsdi.member(1, "cpu")
    assert m.table is None and m.ref_len == int(jsdi.local_len[1])
    assert torch.equal(m.pos, torch.from_numpy(tsdi.pos[1]))


@pytest.mark.parametrize("k", [16, 20])
def test_sharded_index_split_words_equal_jax_build(k):
    rng = np.random.default_rng(67)
    g = rng.choice(np.array(list(b"ACGT"), np.uint8), 30000)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        refset = _fasta(d, "g", g.tobytes().decode())
    idx = build_index(refset, k, 4 if k == 16 else 13)
    jsdi = jm.ShardedDeviceIndex.build(refset, idx, 2)
    tsdi = tm.ShardedDeviceIndex.build(port_refset(refset), port_index(idx),
                                       2)
    assert tsdi.hi_table.shape == (2, 1 << 24, 2) and tsdi.lo_steps >= 1
    _same_sharded(tsdi, jsdi)


def test_sharded_index_refuses_int32_bases(indexed):
    """Shard bases and window starts are int32, as in the JAX step: a
    reference of 2^31 bases is refused, naming the limit, before any
    array is made."""
    _, idx = indexed

    class Huge:
        total_len = 1 << 31
        codes = None

    with pytest.raises(ValueError, match="2\\^31"):
        tm.ShardedDeviceIndex.build(Huge(), port_index(idx), 2)


# ------------------------------------------------------------------
# the collectives, the sharded seed votes, the combine
# ------------------------------------------------------------------

def test_spmd_collectives():
    """psum / pmax / all_gather over ip in member order, on every member,
    and the bytes they move counted as separate cards would move them."""
    mesh = _cpu_mesh(2, 3)
    assert mesh.devices[1][2] == torch.device("cpu") and mesh.ip == 3
    xs = [torch.tensor([1, -5, 7], dtype=torch.int32) * (j + 1)
          for j in range(3)]
    for got in mesh.psum(xs):
        assert got.tolist() == [6, -30, 42] and got.dtype == torch.int32
    assert all(g.tolist() == [3, -5, 21] for g in mesh.pmax(xs))
    for g in mesh.all_gather(xs):
        assert torch.equal(g, torch.stack(xs))
    assert mesh.moved == 2 * (2 * 2 * 12) + 3 * 2 * 12
    with pytest.raises(ValueError, match="3 tensors"):
        mesh.psum(xs[:2])
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh(2, 2, ["cpu"] * 3)


@jax.jit
def _jax_cascade(runs):
    """The JAX step's merge of sorted runs (mesh.py:598-611): each padded
    on the left to a power of 2, then merged pairwise by bitonic merges."""
    neg = np.int32(-(1 << 30))
    n = 1
    while n < runs[0].shape[1]:
        n *= 2
    runs = [jnp.pad(r, ((0, 0), (n - r.shape[1], 0)), constant_values=neg)
            for r in runs]
    while len(runs) > 1:
        nxt = [jm._merge_sorted_asc(runs[j], runs[j + 1])
               for j in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(jnp.pad(runs[-1], ((0, 0), (runs[0].shape[1], 0)),
                               constant_values=neg))
        runs = nxt
    return runs[0]


def test_merge_sorted_equals_bitonic_cascade():
    """The merge of the members' sorted shift runs: the last N lanes of
    torch.sort of the union are the JAX step's bitonic cascade's."""
    rng = np.random.default_rng(3)
    for ip in (2, 3):
        runs = [np.sort(np.where(rng.random((8, 120)) < 0.7,
                                 rng.integers(-50, 50, (8, 120)),
                                 -(1 << 30)).astype(np.int32), axis=1)
                for _ in range(ip)]
        want = np.asarray(_jax_cascade(tuple(jnp.asarray(r) for r in runs)))
        got = tm._merge_sorted_asc([torch.from_numpy(r) for r in runs])
        np.testing.assert_array_equal(got[:, -120:].numpy(), want[:, -120:])


def _sharded_votes(refset, idx, reads, ip):
    tsdi = tm.ShardedDeviceIndex.build(port_refset(refset), port_index(idx),
                                       ip)
    mesh = _cpu_mesh(1, ip)
    dis = [tsdi.member(j, "cpu") for j in range(ip)]
    t = torch.from_numpy(reads)
    return tm.device_seed_votes_sharded(
        mesh, dis, [t] * ip, [int(b) // idx.nskip for b in tsdi.shard_base])


@pytest.mark.parametrize("kn,ip", [((13, 4), 2), ((13, 4), 3),
                                   ((16, 2), 2)],
                         ids=["k13s4-1x2", "k13s4-1x3", "k16s2-1x2"])
def test_sharded_seed_votes_equal_single_device(xrep, kn, ip):
    """Every member's seed votes (both strands' b1, v1, b2, v2, nc2 and
    the hit counters) equal the JAX single-device device_seed_votes, bit
    for bit: the direct-table and sorted-word lookups at k13, the split
    words at k16; reads across the cut, on the cross-shard repeat and
    elsewhere."""
    refset, _ = xrep
    idx = build_index(refset, *kn)
    reads = _straddle_reads(refset, 5, 40, 112, qlen=100)
    reads[20:30] = _straddle_reads(refset, 6, 11, 112, 0, 100)[:10]
    for i in range(20, 26):                 # copy 1 of the repeat
        reads[i, :100] = _seg(refset, 8000 + 400 * i, 100, i % 2 == 0)
    jdi = jm.DeviceIndex.build(refset, idx, direct=False)  # same lookups
    wo, wu, wt = jax.jit(lambda r: jm.device_seed_votes(jdi, r))(
        jnp.asarray(reads))
    got = _sharded_votes(refset, idx, reads, ip)
    assert len(got) == ip
    for outs, used, tot in got:
        np.testing.assert_array_equal(used.numpy(), np.asarray(wu))
        np.testing.assert_array_equal(tot.numpy(), np.asarray(wt))
        for w5, g5 in zip(wo, outs):
            for w, g in zip(w5, g5):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(wo[0][1]) > 0).sum() > 10


@pytest.mark.parametrize("ip,hits_mode", [(2, "sum"), (3, "max")])
def test_combine_over_ip_equals_jax(ip, hits_mode):
    """Random per-member winners with forced cross-shard ties (equal best
    scores at different starts) and duplicate sightings (equal best
    scores at the same start): every member's combined outputs equal
    JAX's _combine_over_ip under shard_map."""
    rng = np.random.default_rng(ip * 10 + len(hits_mode))
    B = 64
    ins = {k: rng.integers(0, 40, (ip, B)).astype(np.int32)
           for k in ("score", "score2", "start", "start2", "hits_used",
                     "hits_tot", "n2nd", "tb_i", "tb_j")}
    ins["strand"] = rng.integers(0, 2, (ip, B)).astype(np.int32)
    ins["strand2"] = rng.integers(0, 2, (ip, B)).astype(np.int32)
    ins["ambig"] = rng.integers(0, 2, (ip, B)).astype(np.int32)
    ins["score"][1, :16] = ins["score"][0, :16]           # ties ...
    ins["start"][1, :8] = ins["start"][0, :8]             # ... duplicates
    ins["score"][:, 40:48] = 30                           # all tie
    ins["score2"] = np.minimum(ins["score2"], ins["score"])
    keys = ("score", "score2", "start", "strand", "start2", "strand2",
            "hits_used", "hits_tot", "n2nd", "ambig")

    def jstep(*a):
        d = dict(zip(keys + ("tb_i", "tb_j"), a))
        return jm._combine_over_ip(*(d[k] for k in keys),
                                   hits_mode=hits_mode, tb_i=d["tb_i"],
                                   tb_j=d["tb_j"])

    fn = jm.shard_map(jstep, mesh=_jmesh(1, ip),
                      in_specs=(P("ip"),) * 12,
                      out_specs={k: P("ip") for k in tm.OUT_KEYS})
    want = fn(*(jnp.asarray(ins[k].reshape(-1))
                for k in keys + ("tb_i", "tb_j")))
    mesh = _cpu_mesh(1, ip)
    got = tm._combine_over_ip(
        mesh, [{k: torch.from_numpy(ins[k][j]) for k in ins}
               for j in range(ip)], hits_mode=hits_mode)
    for j in range(ip):
        for k in tm.OUT_KEYS:
            np.testing.assert_array_equal(
                got[j][k].numpy(), np.asarray(want[k]).reshape(ip, B)[j],
                err_msg=f"member {j}: {k}")
    tie = got[0]["score2"] == got[0]["score"]
    assert tie[:16].sum() >= 4 and tie[40:48].all()


# ------------------------------------------------------------------
# the mesh steps
# ------------------------------------------------------------------

@pytest.mark.parametrize("dp,ip", [(4, 2), (8, 1)])
def test_sharded_step_equals_jax_and_single(indexed, jax_full_oracle, dp,
                                            ip):
    """make_sharded_step (the replicated index; k11 s2, a direct table
    of 32 MiB a member) on 4 x 2 and 8 x 1: all 12 OUT_KEYS equal to
    the JAX step on the same mesh shape and to the port's single-device
    step, reads across the midpoint included."""
    refset, _ = indexed
    idx = build_index(refset, 11, 2)
    reads = _straddle_reads(refset, 9, 32, 112, qlen=100)
    m, go, ge = ali.make_score_matrix()
    jmesh = _jmesh(dp, ip)
    jstep = jm.make_sharded_step(jm.DeviceIndex.build(refset, idx), jmesh,
                                 m, -go, -ge)
    with jmesh:
        want = jstep(jnp.asarray(reads))
    tmat, tgo, tge = tali.make_score_matrix()
    di = tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu")
    step = tm.make_sharded_step(di, _cpu_mesh(dp, ip), tmat, -tgo, -tge)
    parts = step(torch.from_numpy(reads))
    assert len(parts) == dp
    got = tm.join_parts(parts)
    _same_out(got, want, f"{dp}x{ip} against JAX")
    _same_out(got, _single(refset, idx, reads), f"{dp}x{ip} against single")
    packed = tm.make_sharded_step(di, _cpu_mesh(dp, ip), tmat, -tgo, -tge,
                                  pack=True)(torch.from_numpy(reads))
    assert torch.equal(tm.join_parts(packed), tm.pack_outputs(got))
    assert (got["score"][:-1] > 80).all()


@pytest.mark.parametrize("genome", ["bundled", "xrep"])
def test_index_sharded_step_equals_jax_and_single(indexed, xrep,
                                                  jax_full_oracle, genome):
    """make_index_sharded_step on 4 x 2 (k13 s4, the range-sharded index):
    all 12 OUT_KEYS equal to the JAX step and to the single-device step:
    on the bundled genome with reads straddling the cut
    (tests/test_mesh.py:72), and on tests/test_mesh.py:164's cross-shard
    repeat, whose copies lie in different shards (score2 == score)."""
    refset, idx = indexed if genome == "bundled" else xrep
    reads = _straddle_reads(refset, 21, 32, 112, qlen=100)
    if genome == "xrep":
        for i in range(16):
            reads[i, :100] = _seg(refset, 8000 + 200 * i, 100, i % 2 == 1)
    m, go, ge = ali.make_score_matrix()
    jmesh = _jmesh(4, 2)
    jstep = jm.make_index_sharded_step(
        jm.ShardedDeviceIndex.build(refset, idx, 2), jmesh, m, -go, -ge)
    with jmesh:
        want = jstep(jnp.asarray(reads))
    tmat, tgo, tge = tali.make_score_matrix()
    mesh = _cpu_mesh(4, 2)
    tsdi = tm.ShardedDeviceIndex.build(port_refset(refset), port_index(idx),
                                       2)
    got = tm.join_parts(tm.make_index_sharded_step(
        tsdi, mesh, tmat, -tgo, -tge)(torch.from_numpy(reads)))
    _same_out(got, want, "4x2 index-sharded against JAX")
    _same_out(got, _single(refset, idx, reads), "against single")
    assert mesh.moved > 0
    if genome == "xrep":
        assert (got["score2"][:16] == got["score"][:16]).all()
        assert ((got["start"][:16] - got["start2"][:16]).abs() > 10000).all()


# ------------------------------------------------------------------
# the halo
# ------------------------------------------------------------------

def test_halo_covers_kilobase_windows(indexed):
    """At Q = 1,504 (S = 1,792) a window starting 100 bases before the
    cut belongs to shard 0 and runs 1,692 bases past it.  The port's
    index with halo = window_len(Q) gathers it equal to the reference;
    the JAX build's default 640-base halo would clamp it at the slice's
    end (the JAX step's gather, mesh.py:1019-1025), so the JAX content
    differs; and the port's step refuses an index whose halo is short."""
    refset, idx = indexed
    Q = 1504
    S = tm.window_len(Q)
    assert S == 1792
    alpha = codec.alpha(refset.codes).astype(np.int32)
    tsdi = tm.ShardedDeviceIndex.build(port_refset(refset), port_index(idx),
                                       2, halo=S)
    cut = int(tsdi.shard_base[1])
    start = cut - 100
    want = alpha[start : start + S]
    starts = torch.tensor([start, cut + 5], dtype=torch.int32)
    mine = torch.tensor([True, False])
    got = tm._owned_windows(tsdi.member(0, "cpu"), 0, starts, mine, S)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert (got[1] == 0).all()
    # the JAX build at its default halo: the gather clamps at the slice end
    jsdi = jm.ShardedDeviceIndex.build(refset, idx, 2)
    refa0 = np.asarray(jsdi.ref_alpha)[0]
    gidx = np.clip(start + np.arange(S), 0, refa0.shape[0] - 1)
    assert (refa0[gidx] != want).sum() > 100
    mat, go, ge = tali.make_score_matrix()
    short = tm.ShardedDeviceIndex.build(port_refset(refset),
                                        port_index(idx), 2)
    step = tm.make_index_sharded_step(short, _cpu_mesh(1, 2), mat, -go, -ge)
    with pytest.raises(ValueError, match="halo of at least 1792"):
        step(torch.full((2, Q), 7, dtype=torch.int32))


def test_index_sharded_long_reads_across_cut(indexed, jax_full_oracle):
    """1,500 bp reads across the cut through the index-sharded step on
    1 x 2: equal in all 12 OUT_KEYS to the JAX step over a
    ShardedDeviceIndex built with halo = window_len(Q); both score every
    window full-matrix (the port's CPU path; sw_full.cu's strip path on
    a card)."""
    refset, idx = indexed
    Q = 1504
    S = tm.window_len(Q)
    reads = _straddle_reads(refset, 31, 6, Q, n_cut=4, qlen=1500)
    m, go, ge = ali.make_score_matrix()
    jmesh = _jmesh(1, 2)
    jstep = jm.make_index_sharded_step(
        jm.ShardedDeviceIndex.build(refset, idx, 2, halo=S), jmesh, m, -go,
        -ge)
    with jmesh:
        want = jstep(jnp.asarray(reads))
    tmat, tgo, tge = tali.make_score_matrix()
    tsdi = tm.ShardedDeviceIndex.build(port_refset(refset), port_index(idx),
                                       2, halo=S)
    got = tm.join_parts(tm.make_index_sharded_step(
        tsdi, _cpu_mesh(1, 2), tmat, -tgo, -tge)(torch.from_numpy(reads)))
    _same_out(got, want, "1x2 index-sharded, Q = 1,504")
    assert (got["score"][:-1] > 1300).all()


# ------------------------------------------------------------------
# run_fast_pipeline and the CLI over meshes
# ------------------------------------------------------------------

def test_mesh_shape():
    ms = tfast.mesh_shape
    assert ms("4,2", "cpu", 0) == (4, 2)
    assert ms("3,1", "cuda", 4) == (3, 1)
    assert ms(None, "cuda", 4) == (4, 1)       # this host's cards, pure dp
    assert ms(None, "cuda", 1) == (1, 1)
    assert ms(None, "cpu", 0) == (1, 1)
    assert ms("", "cpu", 0) == (1, 1)
    with pytest.raises(ValueError, match="needs 4 GPUs; 1 visible"):
        ms("2,2", "cuda", 1)
    for bad in ("2", "2,x", "0,1", "2,2,2"):
        with pytest.raises(ValueError):
            ms(bad, "cpu", 0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_fast_mesh_cli.py's corpus (two contigs, k11 s2, 90
    reads of 72 bp, no multiple of dp = 8) and 45 pairs on it, saved."""
    rng = np.random.default_rng(31)
    bases = np.array(list(b"ACGT"), np.uint8)
    contigs = [rng.choice(bases, n).tobytes().decode() for n in (9000, 7000)]
    d = tmp_path_factory.mktemp("tmeshcli")
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">c{i}\n")
            for j in range(0, len(c), 60):
                f.write(c[j : j + 60] + "\n")
    from smalt_tpu_torch.index.table import build_index as tbuild
    from smalt_tpu_torch.seq.refset import RefSet as TRefSet
    refset = TRefSet.from_fasta(fa)
    idx = tbuild(refset, 11, 2)
    name = os.path.join(d, "idx")
    refset.save(name)
    idx.save(name)
    comp = str.maketrans("ACGT", "TGCA")
    recs, m1, m2 = [], [], []
    for i in range(90):
        ci = i % 2
        st = int(rng.integers(0, len(contigs[ci]) - 72))
        s = contigs[ci][st : st + 72]
        if i % 3 == 0:
            s = s.translate(comp)[::-1]
        recs.append(f"@m{i}\n{s}\n+\n{'I' * 72}\n")
    for i in range(45):
        c = contigs[i % 2]
        st = int(rng.integers(0, len(c) - 400))
        a, b = c[st : st + 70], c[st + 230 : st + 300]
        m1.append(f"@p{i}/1\n{a}\n+\n{'I' * 70}\n")
        m2.append(f"@p{i}/2\n{b.translate(comp)[::-1]}\n+\n{'I' * 70}\n")
    paths = []
    for fn, text in (("r.fq", recs), ("p1.fq", m1), ("p2.fq", m2)):
        paths.append(os.path.join(d, fn))
        with open(paths[-1], "w") as f:
            f.write("".join(text))
    return (refset, idx, name) + tuple(paths)


def _pipe(world, spec, mates=False):
    refset, idx, _, fq, p1, p2 = world
    buf = io.StringIO()
    if mates:
        tfast.run_fast_pipeline(refset, idx, p1, buf, batch=16,
                                device="cpu", mesh_spec=spec, mates_path=p2)
    else:
        tfast.run_fast_pipeline(refset, idx, fq, buf, batch=32,
                                device="cpu", mesh_spec=spec)
    return buf.getvalue()


def test_pipeline_over_meshes_is_single_device_sam(world):
    """tests/test_fast_mesh_cli.py's check on the port: meshes 8,1 and
    4,2 (every member on the CPU) write the single run's SAM byte for
    byte; pairs on 4,2 too."""
    single = _pipe(world, None)
    assert single.count("\n") == 90
    for spec in ("8,1", "4,2"):
        assert _pipe(world, spec) == single, f"mesh {spec} diverged"
    pairs = _pipe(world, None, mates=True)
    assert pairs.count("\n") == 90
    assert _pipe(world, "4,2", mates=True) == pairs


def test_cli_mesh_flag(world, tmp_path, capsys):
    """`map --fast --device cpu --mesh 4,2` through the port's CLI writes
    the SAM of the run without --mesh; a malformed --mesh exits 1 naming
    the form."""
    from smalt_tpu_torch import cli
    _, _, name, fq, _, _ = world
    outs = [str(tmp_path / f"{x}.sam") for x in ("a", "b")]
    assert cli.main(["map", "--fast", "--device", "cpu", "-o", outs[0],
                     name, fq]) == 0
    assert cli.main(["map", "--fast", "--device", "cpu", "--mesh", "4,2",
                     "-o", outs[1], name, fq]) == 0
    body = [[ln for ln in open(p) if not ln.startswith("@PG")]
            for p in outs]
    assert body[0] == body[1] and len(body[0]) > 90
    assert cli.main(["map", "--fast", "--device", "cpu", "--mesh", "4",
                     name, fq]) == 1
    assert "--mesh takes DP,IP" in capsys.readouterr().err
