"""NN-predictor query engine (models.serve): the research model serving
the real cascade, flag-gated.

The correctness contract mirrors the PWL engine's: audit-derived
max-error windows guarantee every PRESENT query resolves to a verified
position (found status exact); duplicate-run member choice follows the
predictor's search order, so only unique k-mers pin exact position
parity with the PWL engine."""

import numpy as np
import pytest

from sapling_tpu.config import IndexConfig
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.models.serve import NNQueryEngine, train_serving
from sapling_tpu.ops import pack as packops
from sapling_tpu.sim.genomes import uniform_genome

K = 13


@pytest.fixture(scope="module")
def nn_setup():
    g = uniform_genome(200_000, seed=3)
    idx = SaplingIndex.build(g, IndexConfig(k=K, buckets=12))
    srv = train_serving(idx, num_chunks=8, layer_size=8, epochs=150,
                        seed=1)
    return g, idx, srv, NNQueryEngine(idx, srv)


def test_nn_engine_present_queries_found_and_verified(nn_setup):
    g, idx, srv, eng = nn_setup
    rng = np.random.default_rng(0)
    pos = rng.integers(0, idx.n - K + 1, 3000)
    codes = packops.encode_bases(g[pos[:, None] + np.arange(K)])
    out_nn = eng.query_positions(codes)
    out_pwl = idx.query_positions(codes)
    # audit windows make found-status exact for present queries — both
    # engines must find every one
    assert (out_nn >= 0).all()
    assert (out_pwl >= 0).all()
    assert idx.verify_hits(codes, out_nn).all()
    # unique k-mers leave no duplicate-choice freedom: exact parity
    km = packops.kmers_scan(idx.codes, K)
    _vals, counts = np.unique(km, return_counts=True)
    kq = idx.kmerize_batch(codes)
    cnt = counts[np.searchsorted(_vals, kq)]
    uniq = cnt == 1
    assert uniq.sum() > 2000  # corpus sanity
    assert np.array_equal(out_nn[uniq], out_pwl[uniq])


def test_nn_engine_absent_queries_never_false_verify(nn_setup):
    g, idx, srv, eng = nn_setup
    rng = np.random.default_rng(7)
    # random 13-mers: 4^13 = 67M >> 200k, nearly all absent
    codes = rng.integers(0, 4, (2000, K)).astype(np.uint8)
    out_nn = eng.query_positions(codes)
    ver = idx.verify_hits(codes, out_nn)
    # a verified hit must really be present (cross-check vs the genome)
    km = packops.kmers_scan(idx.codes, K)
    kq = idx.kmerize_batch(codes)
    present = np.isin(kq, km)
    assert (ver <= present).all()  # verified => present
    # present ones (if any collided) must be found
    assert (out_nn[present] >= 0).all()
    assert ver[present].all()


def test_nn_audit_windows_cover_errors(nn_setup):
    g, idx, srv, eng = nn_setup
    # re-run the audit and pin the invariant the engine relies on:
    # windows are maxima of the shifted error distribution
    from sapling_tpu.models.serve import audit_serving

    audit = audit_serving(srv, idx)
    err = audit.errors
    assert srv.max_over >= int(err.max(initial=0))
    assert srv.max_under >= int(-err.min(initial=0))
    assert srv.most_over >= 1 and srv.most_under >= 1


def test_nn_engine_rejects_other_lengths(nn_setup):
    _g, _idx, _srv, eng = nn_setup
    with pytest.raises(NotImplementedError):
        eng.query_positions(np.zeros((4, K + 2), np.uint8))


def test_untrained_model_still_correct():
    """Bounds, not model quality, carry correctness: a nearly-untrained
    model (2 epochs) must still find every present query — its audited
    max windows are just wider."""
    g = uniform_genome(60_000, seed=9)
    idx = SaplingIndex.build(g, IndexConfig(k=K, buckets=10))
    srv = train_serving(idx, num_chunks=4, layer_size=4, epochs=2, seed=5)
    eng = NNQueryEngine(idx, srv)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, idx.n - K + 1, 500)
    codes = packops.encode_bases(g[pos[:, None] + np.arange(K)])
    out = eng.query_positions(codes)
    assert (out >= 0).all()
    assert idx.verify_hits(codes, out).all()
