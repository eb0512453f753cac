"""Artifact interop with the reference implementation.

Both directions:
  * reference-built .sa is loaded by our from_fasta (exercised implicitly
    by test_aligner byte-parity, and directly here);
  * OUR .sa and .sap are byte-identical to what the reference's own build
    produces, and the reference benchmark binary loads our files and
    passes its 100% self-check without rebuilding.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import pytest

from sapling_tpu.config import IndexConfig
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.index.suffix_array import build_suffix_data
from sapling_tpu.io import artifacts
from sapling_tpu.io.fasta import write_fasta
from sapling_tpu.sim.genomes import uniform_genome

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "_build")
REF_SRC = "/root/reference/src"


@pytest.fixture(scope="module")
def ref_example_bin():
    os.makedirs(BUILD, exist_ok=True)
    exe = os.path.join(BUILD, "sapling_example")
    if not os.path.exists(exe):
        res = subprocess.run(
            ["g++", "-O2", "-std=c++11", "-o", exe,
             os.path.join(REF_SRC, "sapling_example.cpp"), "-I", REF_SRC],
            capture_output=True, text=True)
        if res.returncode != 0:
            pytest.skip(f"reference build failed: {res.stderr}")
    return exe


def test_artifacts_byte_identical_and_loadable(ref_example_bin, tmp_path):
    g = uniform_genome(60_000, seed=11)
    ours = tmp_path / "ours"
    theirs = tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    for d in (ours, theirs):
        write_fasta(str(d / "ref.fa"), [("chr1", bytes(g))])

    # our build -> reference-format artifacts
    suffix = build_suffix_data(g)
    idx = SaplingIndex.build(g, IndexConfig(k=21), suffix=suffix)
    our_sa = str(ours / "ref.fa.sa")
    our_sap = str(ours / "ref.fa.sap")
    idx.write_reference_artifacts(our_sa, our_sap, suffix=suffix)

    # reference builds its own from scratch (writes .sa/.sap next to fasta)
    res = subprocess.run(
        [ref_example_bin, str(theirs / "ref.fa"), "nq=1000"],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "1000 out of 1000" in res.stdout

    ref_sa = (theirs / "ref.fa.sa").read_bytes()
    ref_sap = (theirs / "ref.fa.sap").read_bytes()
    assert open(our_sa, "rb").read() == ref_sa, ".sa bytes differ"
    assert open(our_sap, "rb").read() == ref_sap, ".sap bytes differ"

    # reference binary must load OUR artifacts without rebuilding and pass
    # its own self-check
    res = subprocess.run(
        [ref_example_bin, str(ours / "ref.fa"), "nq=1000"],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "Reading Sapling from file" in res.stdout
    assert "1000 out of 1000" in res.stdout

    # and we load THEIR .sa transparently
    idx2 = SaplingIndex.from_fasta(str(theirs / "ref.fa"),
                                   IndexConfig(k=21), cache=False)
    rng = np.random.default_rng(0)
    starts = rng.integers(0, idx2.n - 21, 500)
    codes = idx2.codes[starts[:, None] + np.arange(21)]
    pos = idx2.query_positions(codes)
    assert idx2.verify_hits(codes, pos).all()


def test_sap_roundtrip_quirk():
    """buckets <= 30 uses a 32-bit size field (reference:
    src/sapling_api.h:619-636,659-667)."""
    xl = np.arange((1 << 5) + 1, dtype=np.int64)
    yl = xl * 3
    import io as _io
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.sap")
        artifacts.write_sap(p, 5, xl, yl, 7, 8, 1, 2, 3)
        b, x2, y2, stats = artifacts.read_sap(p)
        assert b == 5 and stats == (7, 8, 1, 2, 3)
        np.testing.assert_array_equal(x2, xl)
        np.testing.assert_array_equal(y2, yl)
        # header: 4-byte buckets + 4-byte size for buckets<=30
        raw = open(p, "rb").read()
        assert len(raw) == 4 + 4 + 2 * 8 * 33 + 20


def test_errors_text_byte_identical(ref_example_bin, tmp_path):
    """Our errFn dump is byte-identical to the reference binary's
    `.errors` text output (src/sapling_api.h:467: one
    "hash rank predict error" line per genome k-mer) — the input format
    of eval/ErrorsPerBin/PerBinErrors.java and eval/HighlightBins."""
    from sapling_tpu.index.pwl import error_audit
    from sapling_tpu.ops.pack import kmers_scan
    from sapling_tpu.ops.predict import predict_pwl_f64

    g = uniform_genome(40_000, seed=7)
    write_fasta(str(tmp_path / "ref.fa"), [("chr1", bytes(g))])
    ref_err = tmp_path / "ref.errors"
    res = subprocess.run(
        [ref_example_bin, str(tmp_path / "ref.fa"), "nq=10",
         f"errFn={ref_err}"],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr

    idx = SaplingIndex.build(g, IndexConfig(k=21))
    inv64, lcp64 = artifacts.read_sa(str(tmp_path / "ref.fa.sa"))
    kmers = kmers_scan(idx.codes, idx.k)
    audit = error_audit(kmers, inv64, lcp64, idx.table.xlist,
                        idx.table.ylist, idx.k, idx.buckets, idx.n)
    pred = predict_pwl_f64(kmers, idx.table.xlist, idx.table.ylist,
                           2 * idx.k, idx.buckets, idx.n)
    ours = tmp_path / "ours.errors"
    artifacts.write_errors_text(str(ours), kmers, inv64[: kmers.shape[0]],
                                pred, audit.errors, idx.buckets)
    assert ours.read_bytes() == ref_err.read_bytes()


def test_npz_mmap_and_skip_load(tmp_path):
    """load_npz(mmap=True) maps large members in place of copying and
    skip= leaves members out; a SaplingIndex loaded either way queries
    identically to the eager load (amortized big-artifact loading)."""
    import numpy as np

    g = uniform_genome(300_000, seed=13)
    idx = SaplingIndex.build(g, IndexConfig(k=21))
    p = str(tmp_path / "toy.stpu.npz")
    idx.save(p)

    z_eager = artifacts.load_npz(p)
    z_mmap = artifacts.load_npz(p, mmap=True)
    assert set(z_eager) == set(z_mmap)
    for k in z_eager:
        a, b = z_eager[k], z_mmap[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    # large members (>= 1 MB) really are memory-mapped, not copies
    assert isinstance(z_mmap["rev"], np.memmap)
    assert isinstance(z_mmap["inv"], np.memmap)

    z_skip = artifacts.load_npz(p, skip=("inv",), mmap=True)
    assert "inv" not in z_skip

    m = SaplingIndex.load(p, skip=("inv",), mmap=True)
    assert m.inv.size == 0
    from sapling_tpu.ops import pack as packops
    rng = np.random.default_rng(5)
    pos = rng.integers(0, m.n - 21, 500)
    codes = packops.encode_bases(g[pos[:, None] + np.arange(21)])
    full = SaplingIndex.load(p)
    got_m = np.asarray(m.query_positions(codes))
    got_f = np.asarray(full.query_positions(codes))
    assert np.array_equal(got_m, got_f)
    assert m.verify_hits(codes, got_m).all()
