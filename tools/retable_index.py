#!/usr/bin/env python
"""Rebuild the PWL bucket table of a saved index at a different bucket
count — without re-running SA-IS or Kasai.

    python tools/retable_index.py <index.stpu.npz> nb=27
        [out=<index>_nb27.table.npz] [workers=N] [full=0]

The reference sweeps bucket counts to 2^29 on GRCh38
(eval/TimingPlot/multitoolplot.py:19-28); our GRCh38 artifact shipped at
2^26 (46 suffixes/bucket). Slim checkpoints cost 10 B each on device, so
2^27/2^28 fit next to the 12.4 GB Rows2D rev; this tool re-runs sweep 1
(checkpoints) + sweep 2 (error audit) from the artifact's own
codes + inv, deriving the lcp>=k runs from k-mer equality in rank space
(index.suffix_array.fwd_runs_from_rank_kmers) instead of a Kasai pass.

Default output is a small TABLE-ONLY npz (xlist/ylist/stats/buckets,
~10 B x 2^nb) loadable via bench_query_scale's table= override — A/B
without duplicating a 30 GB artifact. full=1 writes a complete new
index artifact instead.
"""

import gc
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _kmers_span(span):
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.utils import parhost

    lo, hi = span
    c = parhost.ctx()
    k = c["k"]
    return lo, packops.kmers_scan(c["codes"][lo : hi + k - 1], k)[: hi - lo]


def main(argv):
    from sapling_tpu.config import parse_keyval_args
    from sapling_tpu.index.pwl import (PwlTable, build_checkpoints_fast,
                                       error_audit, error_stats)
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.index.suffix_array import fwd_runs_from_rank_kmers
    from sapling_tpu.io import artifacts
    from sapling_tpu.utils import parhost

    if len(argv) < 2:
        print(__doc__)
        return 1
    src = argv[1]
    kv = parse_keyval_args(argv[2:])
    nb = int(kv["nb"])
    workers = int(kv.get("workers", parhost.default_workers()))
    full = bool(int(kv.get("full", 0)))
    out = kv.get("out")
    if out is None:
        stem = src[: -len(".stpu.npz")] if src.endswith(".stpu.npz") else src
        out = f"{stem}_nb{nb}" + (".stpu.npz" if full else ".table.npz")
    if os.path.exists(out):
        log(f"{out} exists; nothing to do")
        return 0

    t0 = time.time()
    idx = SaplingIndex.load(src, skip=("lcpk_fwd", "lcpk_bwd", "rev_hi")
                            if not full else (), mmap=True)
    if idx.inv is None or len(idx.inv) != idx.n:
        raise SystemExit(f"{src} has no full inv array — cannot retable")
    if idx.inv_hi is not None:
        raise SystemExit("split-limb (inv_hi) retable unsupported here")
    if idx.codes is None:
        raise SystemExit(f"{src} carries no codes — cannot retable")
    n, k = idx.n, idx.k
    log(f"mapped {src} (n={n:,}, k={k}, 2^{idx.buckets} -> 2^{nb}) "
        f"in {time.time()-t0:.0f}s")
    codes = np.array(idx.codes)
    inv = np.array(idx.inv)

    log(f"k-mer scan ({workers} workers)")
    t1 = time.time()
    m = n - k + 1
    kmers = np.empty(m, dtype=np.int64)
    for lo, kch in parhost.run_forked(
            _kmers_span, parhost.spans_of(m, 1 << 26),
            {"codes": codes, "k": k}, workers=workers):
        kmers[lo : lo + kch.shape[0]] = kch
    log(f"kmers done ({time.time()-t1:.0f}s); deriving lcp>=k runs "
        f"from rank k-mer equality")
    t1 = time.time()
    fwd = fwd_runs_from_rank_kmers(kmers, inv, n)
    gc.collect()
    log(f"runs done ({time.time()-t1:.0f}s); checkpoints (sort-free, "
        f"{workers} workers)")
    t1 = time.time()
    xlist, ylist = build_checkpoints_fast(kmers, inv, 2 * k, nb,
                                          workers=workers)
    log(f"checkpoints done ({time.time()-t1:.0f}s); error audit")
    t1 = time.time()
    audit = error_audit(kmers, inv, None, xlist, ylist, k, nb, n,
                        fwd=fwd, workers=workers)
    del fwd, kmers
    gc.collect()
    mo, mu, me, so, su = error_stats(audit)
    log(f"audit done ({time.time()-t1:.0f}s): max=({mo},{mu}) "
        f"most=({so},{su}) mean={me} perfect={audit.perfect_predictions}")
    del audit
    gc.collect()

    if full:
        idx.table = PwlTable(buckets=nb, xlist=xlist, ylist=ylist,
                             max_over=mo, max_under=mu, mean_error=me,
                             most_over=so, most_under=su)
        idx.buckets = nb
        idx.codes = codes
        idx.inv = inv
        log(f"saving full artifact {out}")
        idx.save(out)
    else:
        log(f"saving table-only {out}")
        artifacts.save_npz(
            out, buckets=np.int64(nb), xlist=xlist, ylist=ylist,
            stats=np.array([mo, mu, me, so, su], dtype=np.int64),
            src_n=np.int64(n), src_k=np.int64(k))
    log(f"TOTAL {time.time()-t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
