"""Query-engine conformance: batched plQuery / binary search vs the oracle."""

import numpy as np
import pytest

from sapling_tpu.config import IndexConfig
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.io.fasta import Genome
from sapling_tpu.ops import pack as packops
from sapling_tpu.sim.genomes import gc_biased_genome, repeat_genome, uniform_genome

from .oracle import OracleSapling


def _index_and_oracle(seq, k, buckets):
    o = OracleSapling(bytes(seq), k=k, buckets=buckets)
    idx = SaplingIndex.build(
        Genome(seq=seq, chr_ends=[(len(seq), "sim")]),
        IndexConfig(k=k, buckets=buckets),
    )
    # build parity is asserted in test_pwl; sanity check bounds here
    assert (idx.table.most_over, idx.table.most_under) == (o.most_over, o.most_under)
    return idx, o


def _sample_queries(seq, num, length, seed, include_absent=True):
    rng = np.random.default_rng(seed)
    n = len(seq)
    pos = rng.integers(0, n - length + 1, num)
    q = seq[pos[:, None] + np.arange(length)]
    if include_absent:
        m = max(1, num // 8)
        rand = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, (m, length))
        ]
        q = np.concatenate([q, rand])
    return q


@pytest.mark.parametrize(
    "gen,k,buckets,length",
    [
        (lambda: uniform_genome(800, seed=10), 8, 5, 8),    # L == k
        (lambda: uniform_genome(800, seed=11), 8, 5, 5),    # L < k
        (lambda: uniform_genome(800, seed=12), 8, 5, 20),   # L > k
        (lambda: gc_biased_genome(1500, 0.85, seed=13), 10, 7, 10),
        (lambda: repeat_genome(900, 23, seed=14), 8, 6, 16),  # heavy repeats
        (lambda: uniform_genome(3000, seed=15), 12, 9, 12),
    ],
)
def test_plquery_position_parity(gen, k, buckets, length):
    seq = gen()
    idx, o = _index_and_oracle(seq, k, buckets)
    q = _sample_queries(seq, 200, length, seed=99)
    codes = packops.encode_bases(q)
    got = idx.query_positions(codes)
    for i in range(q.shape[0]):
        s = bytes(q[i])
        km = o.kmerize_adjusted(length, s)
        want = o.pl_query(s, km, length)
        assert got[i] == want, (
            f"lane {i}: got {got[i]} want {want} query {s.decode()}"
        )


def test_plquery_self_check():
    """Every in-genome query must land on a matching substring
    (reference correctness criterion: sapling_example.cpp:143-154)."""
    seq = uniform_genome(5000, seed=20)
    idx, _ = _index_and_oracle(seq, 10, 8)
    q = _sample_queries(seq, 500, 10, seed=21, include_absent=False)
    codes = packops.encode_bases(q)
    got = idx.query_positions(codes)
    ok = idx.verify_hits(codes, got)
    assert ok.all()


def test_binsearch_parity():
    seq = uniform_genome(1200, seed=30)
    idx, o = _index_and_oracle(seq, 8, 6)
    q = _sample_queries(seq, 150, 8, seed=31, include_absent=False)
    codes = packops.encode_bases(q)
    got = idx.query_positions_binsearch(codes)
    for i in range(q.shape[0]):
        want = o.b_query(bytes(q[i]))
        assert got[i] == want


def test_query_length_sweep_self_check():
    """Mirrors the reference's 6-length experiment sweep
    (sapling_example.cpp:91-99) at miniature scale."""
    seq = uniform_genome(4000, seed=40)
    k = 12
    idx, o = _index_and_oracle(seq, k, 8)
    for length in (k - 10, k, k + 10, k + 20, k + 30, k + 80):
        q = _sample_queries(seq, 64, length, seed=41 + length,
                            include_absent=False)
        codes = packops.encode_bases(q)
        got = idx.query_positions(codes)
        ok = idx.verify_hits(codes, got)
        # short queries can return any position matching the prefix; the
        # self-check criterion is substring equality, matching the reference.
        assert ok.all(), f"length={length}: {int((~ok).sum())} bad"
        for i in range(8):  # spot positional parity per length too
            s = bytes(q[i])
            want = o.pl_query(s, o.kmerize_adjusted(length, s), length)
            assert got[i] == want


def test_window_scan_equals_sequential_path():
    """The wide-window fast path must return bit-identical positions to
    the sequential probe cascade on genomes with heavy duplication,
    boundary predictions, and absent queries."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.query import plquery_batch
    from sapling_tpu.sim.genomes import repeat_genome, uniform_genome

    g = np.concatenate([
        uniform_genome(30_000, seed=41),
        repeat_genome(6_000, 13, seed=42),
        uniform_genome(4_000, seed=43),
    ])
    idx = SaplingIndex.build(g, IndexConfig(k=21))
    rng = np.random.default_rng(17)
    for length in (11, 21, 31, 60):
        m = idx.n - length + 1
        starts = rng.integers(0, m, 4000)
        codes = idx.codes[starts[:, None] + np.arange(length)]
        # mix in absent queries + extreme-rank patterns
        codes[:50] = rng.integers(0, 4, (50, length))
        codes[50:60] = 0   # poly-A -> rank ~0 boundary
        codes[60:70] = 3   # poly-T -> rank ~n boundary
        qw = packops.pack_queries(codes)
        x = packops.batch_kmers_adjusted(codes, idx.k)
        t = idx.table
        kw = dict(n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
                  most_over=t.most_over, most_under=t.most_under,
                  max_over=t.max_over, max_under=t.max_under)
        fast = np.asarray(plquery_batch(
            idx.packed, idx.rev, t.xlist, t.ylist, qw, x,
            window_scan=True, **kw))
        slow = np.asarray(plquery_batch(
            idx.packed, idx.rev, t.xlist, t.ylist, qw, x,
            window_scan=False, **kw))
        np.testing.assert_array_equal(fast, slow)


def test_uint32_rank_storage_matches_int32():
    """uint32 rev/inv storage (GRCh38-scale memory layout) must produce
    identical positions through both query kernels."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(30_000, seed=91)
    a = SaplingIndex.build(g, IndexConfig(k=21, pos_dtype="int32"))
    b = SaplingIndex.build(g, IndexConfig(k=21, pos_dtype="uint32"))
    assert b.rev.dtype == np.uint32 and b.inv.dtype == np.uint32
    rng = np.random.default_rng(2)
    starts = rng.integers(0, a.n - 21, 2000)
    codes = a.codes[starts[:, None] + np.arange(21)]
    codes[:40] = rng.integers(0, 4, (40, 21))  # absent queries too
    pa = a.query_positions(codes)
    pb = b.query_positions(codes)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(
        a.query_positions_binsearch(codes), b.query_positions_binsearch(codes))


def test_prefix_probe_equals_packed_probe():
    """The uint64 per-rank prefix probe path must return bit-identical
    positions to the packed-genome probe path, including absent queries
    and genome-end boundary suffixes."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.query import plquery_batch
    from sapling_tpu.sim.genomes import repeat_genome, uniform_genome

    g = np.concatenate([uniform_genome(25_000, seed=51),
                        repeat_genome(5_000, 9, seed=52)])
    idx = SaplingIndex.build(g, IndexConfig(k=21))
    assert idx.prefix64 is not None
    import jax.numpy as jnp

    pref = jnp.asarray(idx.prefix64)
    rng = np.random.default_rng(3)
    for length in (11, 16, 21, 31, 32):
        m = idx.n - length + 1
        starts = rng.integers(0, m, 3000)
        codes = idx.codes[starts[:, None] + np.arange(length)]
        codes[:60] = rng.integers(0, 4, (60, length))
        codes[60:70] = 0
        codes[70:80] = 3
        # queries matching at the genome tail (short-suffix pad handling)
        for j in range(80, 90):
            s = idx.n - length - (j - 80)
            codes[j] = idx.codes[s : s + length]
        qw = packops.pack_queries(codes)
        x = packops.batch_kmers_adjusted(codes, idx.k)
        t = idx.table
        kw = dict(n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
                  most_over=t.most_over, most_under=t.most_under,
                  max_over=t.max_over, max_under=t.max_under)
        fast = np.asarray(plquery_batch(
            idx.packed, idx.rev, t.xlist, t.ylist, qw, x, pref, **kw))
        slow = np.asarray(plquery_batch(
            idx.packed, idx.rev, t.xlist, t.ylist, qw, x, None, **kw))
        np.testing.assert_array_equal(fast, slow, err_msg=f"length={length}")


def test_prefix3_probe_equals_packed_probe():
    """The 3-bit rank-prefix path (one gather per probe, rank-tracked)
    must return bit-identical positions to the packed-genome path,
    including absent queries and genome-tail suffixes."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.query import plquery_batch
    from sapling_tpu.sim.genomes import repeat_genome, uniform_genome

    g = np.concatenate([uniform_genome(25_000, seed=61),
                        repeat_genome(5_000, 9, seed=62)])
    idx = SaplingIndex.build(g, IndexConfig(k=21))
    assert idx.prefix3 is not None
    import jax.numpy as jnp

    p3 = jnp.asarray(idx.prefix3)
    rng = np.random.default_rng(9)
    for length in (11, 16, 21):
        m = idx.n - length + 1
        starts = rng.integers(0, m, 3000)
        codes = idx.codes[starts[:, None] + np.arange(length)]
        codes[:60] = rng.integers(0, 4, (60, length))
        codes[60:70] = 0
        codes[70:80] = 3
        for j in range(80, 90):  # tail suffixes exercise the pad ordering
            s = idx.n - length - (j - 80)
            codes[j] = idx.codes[s : s + length]
        qw = packops.pack_queries(codes)
        x = packops.batch_kmers_adjusted(codes, idx.k)
        q3 = packops.pack_queries3(codes)
        t = idx.table
        kw = dict(n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
                  most_over=t.most_over, most_under=t.most_under,
                  max_over=t.max_over, max_under=t.max_under)
        fast = np.asarray(plquery_batch(
            idx.packed, idx.rev, t.xlist, t.ylist, qw, x, None, p3, q3, **kw))
        slow = np.asarray(plquery_batch(
            idx.packed, idx.rev, t.xlist, t.ylist, qw, x, **kw))
        np.testing.assert_array_equal(fast, slow, err_msg=f"length={length}")


def test_banked_rev_matches_flat():
    """Banked [banks, 2^b] rev layout (gathers want int32-indexable
    operands at GRCh38 scale) must give identical results through both
    query kernels and all prefix paths."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(30_000, seed=71)
    a = SaplingIndex.build(g, IndexConfig(k=21))
    b = SaplingIndex.build(g, IndexConfig(k=21))
    # force 8 banks of 4096 + the legacy split-u32 tables
    b.device_arrays(rev_bank_bits=12, use_ptab=False, use_pred2=False)
    assert isinstance(b._device["rev"], tuple) and len(b._device["rev"]) == 8
    assert isinstance(b._device["xlist"], tuple)  # split-u32 tables
    rng = np.random.default_rng(5)
    for length in (16, 21, 31):
        starts = rng.integers(0, a.n - length, 2000)
        codes = a.codes[starts[:, None] + np.arange(length)]
        codes[:40] = rng.integers(0, 4, (40, length))
        np.testing.assert_array_equal(
            a.query_positions(codes), b.query_positions(codes),
            err_msg=f"length={length}")
    np.testing.assert_array_equal(
        a.query_positions_binsearch(codes), b.query_positions_binsearch(codes))


def test_paired_rev_matches_flat():
    """PairedU32 rev layout (uint64 pair view + half select — the one-
    gather-op replacement for the banked layout at GRCh38 scale) must
    give identical results through both query kernels and all paths."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops.query import PairedU32
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(30_001, seed=72)  # odd n: exercises the pad word
    a = SaplingIndex.build(g, IndexConfig(k=21))
    b = SaplingIndex.build(g, IndexConfig(k=21))
    b.device_arrays(rev_pair=True)
    assert isinstance(b._device["rev"], PairedU32)
    rng = np.random.default_rng(6)
    for length in (16, 21, 31):
        starts = rng.integers(0, a.n - length, 2000)
        codes = a.codes[starts[:, None] + np.arange(length)]
        codes[:40] = rng.integers(0, 4, (40, length))
        np.testing.assert_array_equal(
            a.query_positions(codes), b.query_positions(codes),
            err_msg=f"length={length}")
    np.testing.assert_array_equal(
        a.query_positions_binsearch(codes), b.query_positions_binsearch(codes))


def test_ptab_matches_default():
    """use_ptab=True (interleaved checkpoint table, ops.predict.pack_ptab
    — flag-off search-space variant, measured slower) must give
    bit-identical query results to the default xy64+xhi16 repack path."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(30_000, seed=73)
    a = SaplingIndex.build(g, IndexConfig(k=21))
    b = SaplingIndex.build(g, IndexConfig(k=21))
    b.device_arrays(use_ptab=True)
    assert b._device["ptab"] is not None and b._device["xlist"] is None
    rng = np.random.default_rng(7)
    for length in (16, 21, 31):
        starts = rng.integers(0, a.n - length, 2000)
        codes = a.codes[starts[:, None] + np.arange(length)]
        codes[:40] = rng.integers(0, 4, (40, length))
        np.testing.assert_array_equal(
            a.query_positions(codes), b.query_positions(codes),
            err_msg=f"length={length}")


def test_halves_rev_matches_flat():
    """HalvesU32 rev layout (even/odd u32 halves — the default at
    GRCh38 scale: 2 gather ops, no X64Split arg doubling) must give
    identical results through both query kernels and all paths."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops.query import HalvesU32
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(30_001, seed=76)  # odd n: exercises the pad word
    a = SaplingIndex.build(g, IndexConfig(k=21))
    b = SaplingIndex.build(g, IndexConfig(k=21))
    b._device = dict(b.device_arrays())
    b._device["rev"] = HalvesU32.pack(b.rev)
    rng = np.random.default_rng(10)
    for length in (16, 21, 31):
        starts = rng.integers(0, a.n - length, 2000)
        codes = a.codes[starts[:, None] + np.arange(length)]
        codes[:40] = rng.integers(0, 4, (40, length))
        np.testing.assert_array_equal(
            a.query_positions(codes), b.query_positions(codes),
            err_msg=f"length={length}")
    np.testing.assert_array_equal(
        a.query_positions_binsearch(codes), b.query_positions_binsearch(codes))


def test_pred2_split_quad_matches_pair():
    """The pre-split u32 quad shipping of pack_pred2 (used at multi-Gbp
    scale to dodge the 2x HBM cost of u64 args) must predict bit-
    identically to the u64 pair form."""
    import jax.numpy as jnp
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops.predict import pack_pred2, predict_pwl
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(25_000, seed=77)
    idx = SaplingIndex.build(g, IndexConfig(k=21))
    t = idx.table
    p2 = pack_pred2(t.xlist, t.ylist, 2 * idx.k)
    quad = tuple(
        jnp.asarray(((a >> np.uint64(32)) if hi else
                     (a & np.uint64(0xFFFFFFFF))).astype(np.uint32))
        for a in (p2[0], p2[1]) for hi in (True, False))
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.integers(0, 1 << 42, 4000, dtype=np.int64))
    pair = predict_pwl(x, None, None, 2 * idx.k, idx.buckets, idx.n,
                       pred2=(jnp.asarray(p2[0]), jnp.asarray(p2[1])),
                       pred2_bits=p2[2])
    qd = predict_pwl(x, None, None, 2 * idx.k, idx.buckets, idx.n,
                     pred2=quad, pred2_bits=p2[2])
    np.testing.assert_array_equal(np.asarray(pair), np.asarray(qd))


def test_pred2_matches_legacy():
    """pack_pred2 (2-gather uint64 checkpoint pair — the default fast
    prediction) must give bit-identical query results to the legacy
    endpoint layout, across query lengths and all phases."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(30_000, seed=74)
    a = SaplingIndex.build(g, IndexConfig(k=21))
    b = SaplingIndex.build(g, IndexConfig(k=21))
    a.device_arrays(use_pred2=False)
    b.device_arrays(use_pred2=True)
    assert a._device["pred2"] is None and b._device["pred2"] is not None
    assert b._device["xlist"] is None
    rng = np.random.default_rng(8)
    for length in (16, 21, 31):
        starts = rng.integers(0, a.n - length, 2000)
        codes = a.codes[starts[:, None] + np.arange(length)]
        codes[:40] = rng.integers(0, 4, (40, length))
        np.testing.assert_array_equal(
            a.query_positions(codes), b.query_positions(codes),
            err_msg=f"length={length}")


def test_pred2_spill_path():
    """When bucket widths exceed 64-2k bits (few buckets, wide genome
    value range) the d field spills into y2 — predictions must remain
    exactly equal to the int64 reference math for every k-mer, including
    out-of-genome values."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops.predict import pack_pred2, predict_pwl

    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(20_000, seed=75)
    idx = SaplingIndex.build(g, IndexConfig(k=21, buckets=6))
    t = idx.table
    p2 = pack_pred2(t.xlist, t.ylist, 2 * idx.k)
    assert p2 is not None and p2[2][2] > 0, "expected spill > 0"
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 42, 5000, dtype=np.int64)
    x = np.concatenate([x, idx.kmerize_batch(
        idx.codes[np.arange(100)[:, None] + np.arange(idx.k)])])
    ref = predict_pwl(jnp.asarray(x), jnp.asarray(t.xlist),
                      jnp.asarray(t.ylist), 2 * idx.k, idx.buckets, idx.n)
    got = predict_pwl(jnp.asarray(x), None, None, 2 * idx.k, idx.buckets,
                      idx.n, pred2=(jnp.asarray(p2[0]), jnp.asarray(p2[1])),
                      pred2_bits=p2[2])
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_u64_packed_probe_equals_u32():
    """words_to_u64 pairing + parity-select in probe_at returns identical
    positions to the uint32 word path (the uint64 view is the device
    representation for multi-Gbp no-prefix indices)."""
    import jax.numpy as jnp

    from sapling_tpu.ops.query import plquery_batch

    seq = np.concatenate([repeat_genome(1024, period=48, seed=31),
                          uniform_genome(7168, seed=32)])
    idx = SaplingIndex.build(
        Genome(seq=seq, chr_ends=[(len(seq), "sim")]),
        IndexConfig(k=21, buckets=9))
    for length in (12, 21, 33):   # wq = 1, 2, 3
        q = _sample_queries(seq, 300, length, seed=41)
        codes = packops.encode_bases(q)
        qw = packops.pack_queries(codes)
        x = packops.batch_kmers_adjusted(codes, idx.k)
        t = idx.table
        kw = dict(n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
                  most_over=t.most_over, most_under=t.most_under,
                  max_over=t.max_over, max_under=t.max_under)
        r32 = plquery_batch(jnp.asarray(idx.packed), jnp.asarray(idx.rev),
                            jnp.asarray(t.xlist), jnp.asarray(t.ylist),
                            qw, x, **kw)
        u64 = jnp.asarray(packops.words_to_u64(idx.packed))
        r64 = plquery_batch(u64, jnp.asarray(idx.rev),
                            jnp.asarray(t.xlist), jnp.asarray(t.ylist),
                            qw, x, **kw)
        np.testing.assert_array_equal(np.asarray(r64), np.asarray(r32))


def test_adaptive_bounds_variant():
    """adaptive_bounds=True probes the bucket's own max-error window first
    (flagged: search order differs from the reference, so duplicate-run
    members may differ). Invariants vs the parity engine: every lane the
    parity engine resolves to a VERIFIED hit stays a verified hit, and
    UNIQUE hits return the identical position. (Absent queries carry no
    invariant: the reference itself returns -1 or an unverified rank
    depending on search path — base case src/sapling_api.h:136.)"""
    from sapling_tpu.config import QueryConfig

    seq = np.concatenate([repeat_genome(2048, period=64, seed=51),
                          uniform_genome(6144, seed=52)])
    idx = SaplingIndex.build(
        Genome(seq=seq, chr_ends=[(len(seq), "sim")]),
        IndexConfig(k=21, buckets=8))
    assert idx.table.bounds is not None
    qc = QueryConfig(adaptive_bounds=True)
    n = idx.n
    for length in (11, 21, 33):   # fast3 / fast3 / packed-probe paths
        q = _sample_queries(seq, 400, length, seed=61 + length)
        codes = packops.encode_bases(q)
        base = idx.query_positions(codes)
        adap = idx.query_positions(codes, qc)
        ok_b = idx.verify_hits(codes, base)
        ok_a = idx.verify_hits(codes, adap)
        assert (ok_a | ~ok_b).all(), f"lost verified hits L={length}"
        # unique verified hits must agree exactly
        win = np.lib.stride_tricks.sliding_window_view(seq, length)
        for i in np.flatnonzero(ok_b)[:80]:
            cnt = int((win == q[i]).all(axis=1).sum())
            if cnt == 1:
                assert adap[i] == base[i], f"unique hit L={length} lane {i}"


def test_compact_escalate_bit_parity():
    """compact_escalate bisects the escalated tail in a compacted batch;
    every returned position must be BIT-IDENTICAL to the default engine
    (same per-lane decision sequence, different execution batch) — on
    the fast3 path, the packed-probe path, and under a tiny forced cap
    that overflows (overflow lanes fall back to the full-width loop)."""
    from sapling_tpu.config import QueryConfig

    seq = np.concatenate([repeat_genome(3000, period=48, seed=83),
                          gc_biased_genome(27_000, seed=84)])
    idx = SaplingIndex.build(
        Genome(seq=seq, chr_ends=[(len(seq), "sim")]),
        IndexConfig(k=21, buckets=9))
    for length in (11, 21, 33):   # fast3 / fast3 / packed-probe paths
        q = _sample_queries(seq, 600, length, seed=71 + length)
        codes = packops.encode_bases(q)
        base = idx.query_positions(codes)
        for cap in (None, 4):     # auto cap; tiny cap forcing overflow
            got = idx.query_positions(
                codes, QueryConfig(compact_escalate=True, compact_cap=cap))
            np.testing.assert_array_equal(
                got, base, err_msg=f"length={length} cap={cap}")


def test_compact_indices_matches_nonzero():
    """_compact_indices (blocked int32 scan; replaces jnp.nonzero, whose
    bool cumsum promotes to int64 under global x64 and once failed to
    compile at 5M lanes) must agree with np.nonzero
    first-cap semantics at every size/cap corner."""
    import jax

    from sapling_tpu.ops.query import _compact_indices

    rng = np.random.default_rng(5)
    for b in (1, 7, 511, 512, 513, 5000):
        for frac in (0.0, 0.1, 0.9, 1.0):
            mask = rng.random(b) < frac
            for cap in (1, 8, max(1, b // 2), b):
                got = np.asarray(jax.jit(
                    lambda m: _compact_indices(m, cap))(mask))
                want = np.full(cap, b, np.int32)
                nz = np.flatnonzero(mask)[:cap]
                want[: len(nz)] = nz
                np.testing.assert_array_equal(
                    got, want, err_msg=f"b={b} frac={frac} cap={cap}")


def test_compact_unresolved_bit_parity():
    """compact_unresolved runs every post-prediction-probe phase in a
    compacted drained batch (nested tail compaction inside); positions
    must be BIT-IDENTICAL to the default engine — including under a tiny
    forced cap whose drain loop takes many trips and whose nested tail
    capacity overflows (overflow lanes are re-drained, same decisions)."""
    from sapling_tpu.config import QueryConfig

    seq = np.concatenate([repeat_genome(3000, period=48, seed=83),
                          gc_biased_genome(27_000, seed=84)])
    idx = SaplingIndex.build(
        Genome(seq=seq, chr_ends=[(len(seq), "sim")]),
        IndexConfig(k=21, buckets=9))
    # 11/21: fast3 path; 33: packed-probe general path; 45 > k: general
    # path including the phase C stride scan inside the refine
    for length in (11, 21, 33, 45):
        q = _sample_queries(seq, 600, length, seed=71 + length)
        codes = packops.encode_bases(q)
        base = idx.query_positions(codes)
        for cap in (None, 8):    # auto 3B/8; tiny cap forcing overflow
            got = idx.query_positions(
                codes, QueryConfig(compact_unresolved=True,
                                   compact_cap=cap))
            np.testing.assert_array_equal(
                got, base, err_msg=f"length={length} cap={cap}")


def test_count_hits_vs_reference_loop():
    """SaplingIndex.count_hits replicates the reference countHitsLeft/
    countHitsRight scalar walks (src/sapling_api.h:254-303) — except the
    left walk's one-step-late stop (which lets the caller read rev[-1]):
    left is clamped to sa_rank."""
    seq = repeat_genome(6000, period=32, seed=91)  # dense lcp>=k runs
    k = 16
    idx = SaplingIndex.build(
        Genome(seq=seq, chr_ends=[(len(seq), "sim")]),
        IndexConfig(k=k, buckets=8))
    n = idx.n
    # reconstruct the reference lcp array from the index's inverse SA
    sa = np.empty(n, dtype=np.int64)
    sa[idx.inv] = np.arange(n)
    lcp = np.zeros(n, dtype=np.int64)
    for r in range(n - 1):
        a, b = sa[r], sa[r + 1]
        m = 0
        while a + m < n and b + m < n and seq[a + m] == seq[b + m]:
            m += 1
        lcp[r] = m

    def ref_right(sa_pos, mh):
        for i in range(mh):
            if i + sa_pos > n - k or lcp[i + sa_pos] < k:
                return i
        return mh

    def ref_left(sa_pos, mh):
        for i in range(mh):
            if sa_pos < i or lcp[sa_pos - i] < k:
                return i
        return mh

    rng = np.random.default_rng(17)
    ranks = np.concatenate([[0, 1, n - 2, n - 1],
                            rng.integers(0, n, 400)])
    for mh in (4, 32):
        left, right = idx.count_hits(ranks, mh)
        for j, r in enumerate(ranks):
            assert right[j] == ref_right(int(r), mh), (r, mh)
            assert left[j] == min(ref_left(int(r), mh), int(r)), (r, mh)


def test_rows2d_rev_matches_flat():
    """Rows2D rev layout ([2, ceil(n/2)] operand, ONE 2-D-indexed gather
    per rank lookup — candidate replacement for HalvesU32 at GRCh38
    scale) must give identical results through both query kernels and
    all paths."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops.query import Rows2D
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(30_001, seed=77)  # odd n: exercises the pad slot
    a = SaplingIndex.build(g, IndexConfig(k=21))
    b = SaplingIndex.build(g, IndexConfig(k=21))
    b.device_arrays(rev_rows2d=True)
    assert isinstance(b._device["rev"], Rows2D)
    rng = np.random.default_rng(11)
    for length in (16, 21, 31):
        starts = rng.integers(0, a.n - length, 2000)
        codes = a.codes[starts[:, None] + np.arange(length)]
        codes[:40] = rng.integers(0, 4, (40, length))
        np.testing.assert_array_equal(
            a.query_positions(codes), b.query_positions(codes),
            err_msg=f"length={length}")
    np.testing.assert_array_equal(
        a.query_positions_binsearch(codes), b.query_positions_binsearch(codes))


def test_swap_table_matches_fresh_device_arrays():
    """SaplingIndex.swap_table re-ships ONLY the table entries; queries
    through the swapped state match an index built directly at the new
    bucket count (the bench_query_scale ab=1 A/B path)."""
    import numpy as np

    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.sim.genomes import uniform_genome

    g = uniform_genome(150_000, seed=21)
    idx = SaplingIndex.build(g, IndexConfig(k=13, buckets=12))
    direct = SaplingIndex.build(g, IndexConfig(k=13, buckets=14))
    rng = np.random.default_rng(3)
    pos = rng.integers(0, idx.n - 13, 2000)
    codes = packops.encode_bases(g[pos[:, None] + np.arange(13)])
    base_out = idx.query_positions(codes)          # devices resident now
    idx.swap_table(direct.table)
    assert idx.buckets == 14
    swapped_out = idx.query_positions(codes)
    direct_out = direct.query_positions(codes)
    assert np.array_equal(swapped_out, direct_out)
    assert idx.verify_hits(codes, swapped_out).all()
    # sanity: the base table genuinely differed somewhere
    assert base_out.shape == swapped_out.shape
