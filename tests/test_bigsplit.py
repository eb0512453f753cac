""">= 2^32-base (wheat-axis) build substrate, exercised at unit scale.

The real >4.3 Gbp artifact is built offline by tools/build_big_index.py
(split path); these tests pin every piece of that path against the
proven < 2^32 implementations on the same data:
  * fused native Kasai (split inv limbs + lcp>=k runs, no LCP array)
  * codes-derived k-mer checkpoints incl. the wide-position keys
  * streamed error-value histogram audit + histogram order statistics
  * format-v4 artifacts (split rev) loading into a SplitRanks device
    layout with query parity
"""

import os

import numpy as np

from sapling_tpu.config import IndexConfig
from sapling_tpu.index import pwl
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.native import (build_suffix_array, lcp_kasai,
                                lcp_ge_k_fwd_split)
from sapling_tpu.index.suffix_array import lcp_ge_k_runs
from sapling_tpu.ops.pack import encode_bases, kmers_scan
from sapling_tpu.sim.genomes import uniform_genome


def _suffix_bits(n=120_000, k=13, seed=4):
    g = uniform_genome(n, seed=seed)
    codes = encode_bases(g)
    sa = build_suffix_array(g, np.int64)
    lo, hi, fwd = lcp_ge_k_fwd_split(g, sa, k)
    return g, codes, sa, lo, hi, fwd, k


def test_fused_kasai_matches_reference_path():
    g, codes, sa, lo, hi, fwd, k = _suffix_bits()
    inv, lcp = lcp_kasai(g, sa)
    fwd_ref, _ = lcp_ge_k_runs(lcp, k)
    inv2 = lo.astype(np.int64) | (hi.astype(np.int64) << 32)
    assert np.array_equal(inv2, inv)
    assert np.array_equal(fwd.astype(np.int64), fwd_ref.astype(np.int64))


def test_checkpoints_codes_path_and_wide_posbits():
    g, codes, sa, lo, hi, fwd, k = _suffix_bits()
    nb = 9
    inv64 = lo.astype(np.int64) | (hi.astype(np.int64) << 32)
    kmers = kmers_scan(codes, k)
    y = inv64[: kmers.shape[0]]
    xl0, yl0 = pwl.build_checkpoints(kmers, y, 2 * k, nb)
    xl1, yl1 = pwl.build_checkpoints_fast(
        None, pwl.SplitInv(lo, hi), 2 * k, nb, workers=2, codes=codes, k=k)
    # wide keys: what a > 2^32 position stream uses (posbits > 32)
    xl2, yl2 = pwl.build_checkpoints_fast(
        None, pwl.SplitInv(lo, hi), 2 * k, nb, workers=2, codes=codes,
        k=k, _posbits=34)
    for xl, yl in ((xl1, yl1), (xl2, yl2)):
        np.testing.assert_array_equal(xl, xl0)
        np.testing.assert_array_equal(yl, yl0)


def test_audit_hist_matches_full_audit():
    g, codes, sa, lo, hi, fwd, k = _suffix_bits()
    nb = 9
    inv64 = lo.astype(np.int64) | (hi.astype(np.int64) << 32)
    kmers = kmers_scan(codes, k)
    xl, yl = pwl.build_checkpoints(kmers, inv64[: kmers.shape[0]],
                                   2 * k, nb)
    audit = pwl.error_audit(kmers, inv64, None, xl, yl, k, nb,
                            codes.shape[0], fwd=fwd)
    vals, counts, perfect = pwl.error_audit_hist(
        codes, lo, hi, fwd, xl, yl, k, nb, codes.shape[0], workers=2)
    assert perfect == audit.perfect_predictions
    ref_vals, ref_counts = np.unique(audit.errors, return_counts=True)
    nz = ref_vals != 0
    np.testing.assert_array_equal(vals, ref_vals[nz].astype(np.int64))
    np.testing.assert_array_equal(counts, ref_counts[nz].astype(np.int64))
    assert pwl.error_stats_from_hist(vals, counts, perfect) == \
        pwl.error_stats(audit)


def test_split_build_tool_and_v4_artifact(tmp_path):
    """tools/build_big_index.build_split at unit scale: the emitted
    format-v4 artifact (split rev limbs) loads, queries through the
    SplitRanks device layout, and returns positions identical to the
    standard build on the same genome."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from build_big_index import build_split

    n, k, nb = 400_000, 21, 10
    out = str(tmp_path / "big.stpu.npz")
    build_split(n, k, nb, workers=2, out=out)

    idx = SaplingIndex.load(out)
    assert idx.rev_hi is not None and idx.rev_hi.dtype == np.uint8
    z = np.load(out)
    assert int(z["format_version"]) == 4

    from sapling_tpu.sim.genomes import benchmark_genome

    g = benchmark_genome(n)
    ref = SaplingIndex.build(g, IndexConfig(k=k, buckets=nb),
                             keep_aligner_arrays=False)
    # same table -> same decision sequence; compare end to end
    np.testing.assert_array_equal(idx.table.xlist, ref.table.xlist)
    np.testing.assert_array_equal(idx.table.ylist, ref.table.ylist)
    assert (idx.table.most_over, idx.table.most_under,
            idx.table.max_over, idx.table.max_under) == \
        (ref.table.most_over, ref.table.most_under,
         ref.table.max_over, ref.table.max_under)

    rng = np.random.default_rng(0)
    starts = rng.integers(0, n - k, 2000)
    codes2d = idx.codes[starts[:, None] + np.arange(k)]
    pos_split = idx.query_positions(codes2d)
    pos_ref = ref.query_positions(codes2d)
    np.testing.assert_array_equal(pos_split, pos_ref)
    assert idx.verify_hits(codes2d, pos_split).all()


def test_build_tool_aligner_artifact_parity(tmp_path):
    """tools/build_big_index.py aligner=1 (non-split path) produces an
    artifact whose inv + uint8-capped lcp>=k run arrays match a direct
    SaplingIndex.build, and that drives the aligner to identical
    alignments — the contract behind the GRCh38-scale aligner bench."""
    import subprocess
    import sys

    from sapling_tpu.align.aligner import SeedExtendAligner
    from sapling_tpu.config import AlignerConfig
    from sapling_tpu.io.fastq import Read
    from sapling_tpu.ops.pack import decode_bases
    from sapling_tpu.sim.genomes import benchmark_genome, simulate_reads

    out = str(tmp_path / "tool_align.stpu.npz")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, os.path.join(root, "tools", "build_big_index.py"),
         "n=400000", "k=16", "nb=14", "aligner=1", "workers=2",
         f"out={out}"],
        check=True, env=env, capture_output=True)
    idx_tool = SaplingIndex.load(out)
    idx_ref = SaplingIndex.build(benchmark_genome(400_000),
                                 IndexConfig(k=16, buckets=14))
    assert np.array_equal(idx_tool.inv, idx_ref.inv)
    assert np.array_equal(idx_tool.lcpk_fwd, idx_ref.lcpk_fwd)
    assert np.array_equal(idx_tool.lcpk_bwd, idx_ref.lcpk_bwd)
    assert np.array_equal(idx_tool.rev, idx_ref.rev)

    reads_arr, pos, _ = simulate_reads(decode_bases(idx_ref.codes), 300,
                                       100, sub_rate=0.02, seed=11)
    reads = [Read(name=f"r{i}", seq=reads_arr[i].tobytes(), qual="I" * 100)
             for i in range(300)]
    a_tool = SeedExtendAligner(idx_tool, AlignerConfig()).align_block(reads)
    a_ref = SeedExtendAligner(idx_ref, AlignerConfig()).align_block(reads)
    for x, y in zip(a_tool, a_ref):
        assert x.aligned == y.aligned
        if x.aligned:
            assert x.alignment.ref_begin == y.alignment.ref_begin
            assert x.alignment.cigar == y.alignment.cigar


def test_retable_tool_matches_direct_build(tmp_path):
    """tools/retable_index.py rebuilds the PWL table at a new bucket
    count from a saved artifact (codes+inv, NO Kasai rerun) and the
    result is bit-identical — xlist/ylist AND audit stats — to a direct
    SaplingIndex.build at that bucket count. Also pins
    fwd_runs_from_rank_kmers == lcp_ge_k_runs' fwd."""
    import subprocess
    import sys

    from sapling_tpu.index.suffix_array import (build_suffix_data,
                                                fwd_runs_from_rank_kmers)
    from sapling_tpu.io.artifacts import load_npz
    from sapling_tpu.sim.genomes import benchmark_genome

    g = benchmark_genome(300_000)
    k = 13
    # direct fwd vs rank-kmer-equality fwd
    sd = build_suffix_data(g, np.int64)
    fwd_ref, _ = lcp_ge_k_runs(sd.lcp, k)
    kmers = kmers_scan(encode_bases(g), k)
    fwd_rk = fwd_runs_from_rank_kmers(kmers, sd.inv, len(g))
    assert np.array_equal(fwd_rk, fwd_ref[: len(g) - 1])

    idx16 = SaplingIndex.build(g, IndexConfig(k=k, buckets=12))
    src = str(tmp_path / "toy.stpu.npz")
    idx16.save(src)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = str(tmp_path / "toy_nb14.table.npz")
    subprocess.run(
        [sys.executable, os.path.join(root, "tools", "retable_index.py"),
         src, "nb=14", "workers=2", f"out={out}"],
        check=True, env=env, capture_output=True)
    z = load_npz(out)
    direct = SaplingIndex.build(g, IndexConfig(k=k, buckets=14))
    t = direct.table
    assert int(z["buckets"]) == 14
    assert np.array_equal(z["xlist"], t.xlist)
    assert np.array_equal(z["ylist"], t.ylist)
    assert z["stats"].tolist() == [t.max_over, t.max_under, t.mean_error,
                                   t.most_over, t.most_under]

    # tools/swap_table_artifact.py rewrites the artifact in place with
    # the retabled table; the reloaded artifact must carry the new
    # table bit-identically and answer queries like the direct build
    # (r5: the 3.1 Gbp artifact ships the measured-best 2^27 table).
    subprocess.run(
        [sys.executable,
         os.path.join(root, "tools", "swap_table_artifact.py"), src, out],
        check=True, env=env, capture_output=True)
    re = SaplingIndex.load(src)
    assert re.buckets == 14
    assert np.array_equal(re.table.xlist, t.xlist)
    assert np.array_equal(re.table.ylist, t.ylist)
    assert (re.table.max_over, re.table.max_under) == (t.max_over,
                                                       t.max_under)
    rng = np.random.default_rng(5)
    starts = rng.integers(0, len(g) - k + 1, 500)
    q = encode_bases(g)[starts[:, None] + np.arange(k)]
    assert np.array_equal(re.query_positions(q), direct.query_positions(q))
