#!/usr/bin/env python
"""Classic suffix-array binary-search benchmark — the baseline Sapling is
measured against (reference: src/binarysearch.cpp:167-273).

    python tools/binarysearch.py <genome.fa> [nq=5000000] [qLen=21]
        [batch=1000000] [fancy=0]

Runs nq random genome substrings through the batched binary-search kernel
and verifies every answer by substring comparison. fancy=1 uses the
Manber-Myers llcp/rlcp-pruned variant (the reference's unused
fancyBinarySearch, src/binarysearch.cpp:90-153).
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main(argv):
    import jax

    from sapling_tpu.config import IndexConfig, parse_keyval_args
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.query import binsearch_batch

    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    nq = int(kv.get("nq", 5_000_000))
    qlen = int(kv.get("qLen", 21))
    batch = int(kv.get("batch", 1_000_000))
    fancy = bool(int(kv.get("fancy", 0)))
    idx = SaplingIndex.from_fasta(argv[1], IndexConfig(k=min(qlen, 21)))
    dev = idx.device_arrays()
    rng = np.random.default_rng(0)
    starts = rng.integers(0, idx.n - qlen + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(qlen)]
    q_words = packops.pack_queries(codes2d)

    if fancy:
        from sapling_tpu.index.suffix_array import (build_llcp_rlcp,
                                                    build_suffix_data)
        from sapling_tpu.ops.query import fancy_binsearch_batch

        suffix = build_suffix_data(idx.codes)
        llcp, rlcp = build_llcp_rlcp(np.asarray(suffix.lcp, np.int64),
                                     idx.n)

        def run(qw):
            return fancy_binsearch_batch(dev["packed"], dev["rev"], llcp,
                                         rlcp, qw, n=idx.n, length=qlen)
    else:
        def run(qw):
            return binsearch_batch(dev["packed"], dev["rev"], qw,
                                   n=idx.n, length=qlen)

    # q_words is WORD-MAJOR [WQ, B]: lanes slice on AXIS 1 (an axis-0
    # slice silently runs the full batch every time — the same bug that
    # once understated bench.py's baseline); results are materialized
    np.asarray(run(q_words[:, :batch]))
    t0 = time.time()
    outs = [np.asarray(run(q_words[:, i : i + batch]))
            for i in range(0, nq, batch)]
    dt = time.time() - t0
    pos = np.concatenate(outs)
    good = int(idx.verify_hits(codes2d, pos).sum())
    print(f"binary search: {nq} queries in {dt:.3f}s ({nq / dt:,.0f} q/s); "
          f"correctness: {good} out of {nq}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
