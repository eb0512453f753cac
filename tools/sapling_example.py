#!/usr/bin/env python
"""Index build + timed query benchmark driver.

Same CLI surface as the reference benchmark binary (reference:
src/sapling_example.cpp:30-99):

    python tools/sapling_example.py <genome.fa> [saFn=..] [sapFn=..]
        [nb=<log2 buckets>] [maxMem=<genome/val bucket cap>] [k=<k>]
        [nq=<num queries>] [errFn=<error dump>] [qLen=<query length>]

Runs the reference's experiment sweep (qLen in {k-10, k, k+10, k+20,
k+30, k+80}, or one qLen) over nq random genome substrings, timing the
batched device query path and verifying every answer by substring equality
(reference: src/sapling_example.cpp:106-155). Also times the classic
binary-search baseline on the same queries.
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def run_experiment(idx, qlen: int, nq: int, batch: int, rng, baseline=False):
    import jax

    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.query import binsearch_batch, plquery_batch

    if qlen > idx.n:
        print(f"qLen {qlen} > genome; skipped")
        return
    starts = rng.integers(0, idx.n - qlen + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(qlen)]
    q_words = packops.pack_queries(codes2d)
    x = packops.batch_kmers_adjusted(codes2d, idx.k)
    dev = idx.device_arrays()
    t = idx.table

    def pl(qw, xx):
        return plquery_batch(
            dev["packed"], dev["rev"], dev["xlist"], dev["ylist"], qw, xx,
            dev.get("prefix"), ptab=dev.get("ptab"),
            pred2=dev.get("pred2"), pred2_bits=dev.get("pred2_bits"),
            n=idx.n, length=qlen, k=idx.k, buckets=idx.buckets,
            most_over=t.most_over, most_under=t.most_under,
            max_over=t.max_over, max_under=t.max_under,
            compact_escalate=True)

    # warmup (compile)
    pl(q_words[:batch], x[:batch]).block_until_ready()
    t0 = time.time()
    outs = []
    for i in range(0, nq, batch):
        outs.append(pl(q_words[i:i + batch], x[i:i + batch]))
    jax.block_until_ready(outs)
    dt = time.time() - t0
    pos = np.concatenate([np.asarray(o) for o in outs])
    good = int(idx.verify_hits(codes2d, pos).sum())
    print(f"qLen={qlen}: {nq} queries in {dt:.3f}s ({nq / dt:,.0f} q/s); "
          f"piecewise linear correctness: {good} out of {nq}")
    if baseline:
        bs = binsearch_batch(dev["packed"], dev["rev"], q_words[:batch],
                             n=idx.n, length=qlen)
        bs.block_until_ready()
        t0 = time.time()
        bs = binsearch_batch(dev["packed"], dev["rev"], q_words[:batch],
                             n=idx.n, length=qlen)
        bs.block_until_ready()
        bdt = (time.time() - t0) * (nq / batch)
        print(f"  binary-search baseline (extrapolated): {bdt:.3f}s "
              f"({nq / bdt:,.0f} q/s)")


def main(argv):
    from sapling_tpu.config import IndexConfig, parse_keyval_args
    from sapling_tpu.index.sapling import SaplingIndex

    if len(argv) < 2:
        print(__doc__)
        return 0
    ref_fn = argv[1]
    kv = parse_keyval_args(argv[2:])
    cfg = IndexConfig(
        k=int(kv.get("k", -1)) if int(kv.get("k", -1)) > 0 else 21,
        buckets=int(kv.get("nb", -1)),
        max_mem=int(kv.get("maxMem", 10)),
    )
    nq = int(kv.get("nq", 5_000_000))
    qlen = int(kv.get("qLen", -1))
    batch = int(kv.get("batch", 1_000_000))

    t0 = time.time()
    idx = SaplingIndex.from_fasta(ref_fn, cfg)
    print(f"index ready in {time.time() - t0:.1f}s "
          f"(n={idx.n}, buckets=2^{idx.buckets})")
    if kv.get("errFn"):
        # dump every signed per-k-mer prediction error in the reference's
        # `.errors` TEXT format (src/sapling_api.h:456-481: one
        # "hash rank predict error" line per k-mer) so the reference eval
        # tools (eval/ErrorsPerBin/PerBinErrors.java:5,
        # eval/HighlightBins/BestAndWorstBins.java) run on our dump
        from sapling_tpu.index.pwl import error_audit
        from sapling_tpu.ops.pack import kmers_scan
        from sapling_tpu.ops.predict import predict_pwl_f64
        from sapling_tpu.io import artifacts

        inv64, lcp64 = artifacts.read_sa(ref_fn + ".sa")
        kmers = kmers_scan(idx.codes, idx.k)
        audit = error_audit(kmers, inv64, lcp64, idx.table.xlist,
                            idx.table.ylist, idx.k, idx.buckets, idx.n)
        pred = predict_pwl_f64(kmers, idx.table.xlist, idx.table.ylist,
                               2 * idx.k, idx.buckets, idx.n)
        artifacts.write_errors_text(kv["errFn"], kmers,
                                    inv64[: kmers.shape[0]], pred,
                                    audit.errors, idx.buckets)
        print(f"wrote {kv['errFn']} "
              f"({audit.perfect_predictions} perfect predictions)")
    if kv.get("sapFn"):
        idx.write_reference_artifacts(None, kv["sapFn"])
        print(f"wrote {kv['sapFn']}")

    rng = np.random.default_rng(int(kv.get("seed", 0)))
    if qlen == -1:
        for ql in (idx.k - 10, idx.k, idx.k + 10, idx.k + 20, idx.k + 30,
                   idx.k + 80):
            run_experiment(idx, ql, nq, batch, rng, baseline=True)
    else:
        run_experiment(idx, qlen, nq, batch, rng, baseline=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
