#!/usr/bin/env python
"""A/B aligner configurations against ONE loaded index artifact.

    python tools/bench_align_ab.py [n=3100000000] [reads=100000]
        [len=100] [sub=0.01] [repeats=2]
        [configs=base,seedcu,block32k,coalesce4]

Loads the cached aligner artifact once (mmap; host-gathered arrays
materialized), simulates one read corpus, then for each named config
runs one full untimed warm pass (every jit shape) + `repeats` timed
passes and reports the median, without paying a multi-minute artifact
load per experiment.

Configs:
  base       block=16384 workers=8 coalesce=2 (the measured default)
  seedcu     base + SAPLING_SEED_COMPACTU=1 (compact_unresolved for the
             seed queries — measured slower at 20 Mbp, never re-A/B'd
             at 3.1 Gbp)
  block32k   block=32768 workers=8 coalesce=1 (halve dispatch count)
  coalesce4  block=16384 workers=8 coalesce=4 (fewer seed-query dispatches)
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

CONFIGS = {
    "base": dict(block=16384, workers=8, coalesce=2, seedcu=False),
    "seedcu": dict(block=16384, workers=8, coalesce=2, seedcu=True),
    "block32k": dict(block=32768, workers=8, coalesce=1, seedcu=False),
    "coalesce4": dict(block=16384, workers=8, coalesce=4, seedcu=False),
}


def main(argv):
    from sapling_tpu.align.aligner import SeedExtendAligner
    from sapling_tpu.config import AlignerConfig, parse_keyval_args
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.io.fastq import Read
    from sapling_tpu.ops.pack import decode_bases
    from sapling_tpu.sim.genomes import simulate_reads

    kv = parse_keyval_args(argv[1:])
    n = int(kv.get("n", 3_100_000_000))
    n_reads = int(kv.get("reads", 100_000))
    rlen = int(kv.get("len", 100))
    repeats = int(kv.get("repeats", 2))
    names = kv.get("configs", "base,seedcu").split(",")

    cache = os.path.join(_ROOT, ".bench_cache", f"align_{n}_k16.stpu.npz")
    t0 = time.time()
    idx = SaplingIndex.load(cache, mmap=True)
    idx.codes = np.array(idx.codes)
    idx.inv = np.array(idx.inv)
    idx.lcpk_fwd = np.array(idx.lcpk_fwd)
    idx.lcpk_bwd = np.array(idx.lcpk_bwd)
    print(f"index mapped+materialized in {time.time()-t0:.0f}s "
          f"(n={idx.n:,})", flush=True)
    g_ascii = decode_bases(idx.codes)
    reads_arr, pos, _rc = simulate_reads(g_ascii, n_reads, rlen,
                                         sub_rate=float(kv.get("sub", 0.01)),
                                         seed=42)
    reads = [Read(name=f"r{i}", seq=reads_arr[i].tobytes(),
                  qual="I" * rlen) for i in range(n_reads)]

    results = {}
    for name in names:
        c = CONFIGS[name]
        os.environ["SAPLING_SEED_COMPACTU"] = "1" if c["seedcu"] else "0"
        aligner = SeedExtendAligner(idx, AlignerConfig())
        block, workers, coalesce = c["block"], c["workers"], c["coalesce"]

        def passes():
            blocks = (reads[lo:lo + block]
                      for lo in range(0, n_reads, block))
            cnt = good = ri = 0
            for out in aligner.align_blocks(blocks, workers=workers,
                                            coalesce=coalesce):
                for ar in out:
                    if ar.aligned:
                        cnt += 1
                        if abs(ar.alignment.ref_begin - pos[ri]) <= 10:
                            good += 1
                    ri += 1
            return cnt, good

        print(f"[{name}] warm pass (compiles)...", flush=True)
        t0 = time.time()
        passes()
        print(f"[{name}] warm {time.time()-t0:.0f}s", flush=True)
        aligner.phase_seconds.clear()
        times = []
        for _ in range(repeats):
            t0 = time.time()
            cnt, good = passes()
            times.append(time.time() - t0)
        dt = float(np.median(times))
        rps = n_reads / dt
        results[name] = rps
        prof = sorted(aligner.phase_seconds.items(), key=lambda s: -s[1])
        tot = sum(aligner.phase_seconds.values()) or 1.0
        print(f"[{name}] {rps:,.0f} reads/s (median of {repeats}: "
              f"{['%.2f' % t for t in times]}; {cnt} aligned, "
              f"{good} within 10bp)\n  phases: " + "  ".join(
                  f"{k}={v:.1f}s({100*v/tot:.0f}%)" for k, v in prof[:6]),
              flush=True)
    print("A/B: " + "  ".join(f"{k}:{v:,.0f}" for k, v in results.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
