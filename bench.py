"""Headline benchmark: PWL suffix-array query throughput on one chip.

Workload mirrors the reference's sapling_example benchmark
(reference: src/sapling_example.cpp:21,110-141): 5,000,000 random 21-mers
drawn from the genome, every answer self-checked. Three genome scales:

  * 4.6 Mbp (E. coli class, always available — built on first run)
  * 230 Mbp (chr1 class)      } measured only when their cached index
  * 3.1 Gbp (GRCh38 class)    } artifacts exist (tools/build_big_index.py)

Plus the second headline: end-to-end aligner reads/s on the cached
chr1-class artifact.

Prints ONE JSON line, naming the device it ran on (platform,
device_kind, count); it refuses to run without a GPU. The metric name is
STABLE across hosts (it does not depend on which artifacts exist);
`primary_scale` names the largest scale actually measured and
`skipped_scales` flags what was unavailable, so runs on hosts without
the big caches are visibly non-comparable. `vs_baseline` is measured
qps / the reference's best published same-scale config
(eval/TimingPlot/plot.py:16-24).

Timing:
  * every scale's timed run repeats REPEATS times after warm; the
    headline is the MEDIAN and `spread_pct` = (max-min)/median reports
    run-to-run noise.
  * K data-chained iterations run inside ONE jitted program; timed
    runs materialize a [2] digest (checksum + chained carry) and
    correctness is checked from an untimed full fetch. The data chain
    threads sum(out) so no iteration can be elided.

Extra diagnostics go to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

K = 21
NQ = 5_000_000
REPEATS = 3
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")

# Per-scale config: reference best q/s (5M / best published seconds,
# eval/TimingPlot/plot.py:16-24), reference binary-search q/s, the
# compact_unresolved cap tuned per artifact (not yet re-tuned on a GPU),
# chained iters.
SCALES = [
    dict(label="4.6Mbp", npz="bench_4600000_k21_b22.stpu.npz",
         ref_qps=5e6 / 19.0, ref_bs_qps=5e6 / 93.8,
         cap=13 << 17, iters=10, bs_iters=3),
    # 230 Mbp artifact ships the 2^27 table (unresolved 1.81M of 5M
    # after the prediction probe); cap sized with ~8% headroom
    dict(label="230Mbp", npz="bench_230000000_k21.stpu.npz",
         ref_qps=5e6 / 57.6, ref_bs_qps=5e6 / 192.3,
         cap=1_950_000, iters=6, bs_iters=3),
    # 3.1 Gbp artifact ships the 2^27 table (unresolved 3.78M of 5M
    # after the prediction probe); cap sized to that with ~3% headroom
    dict(label="3.1Gbp", npz="bench_3100000000_k21.stpu.npz",
         ref_qps=5e6 / 83.7, ref_bs_qps=5e6 / 288.3,
         cap=3_900_000, iters=4, bs_iters=2),
]

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_small_index(npz):
    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.sim.genomes import benchmark_genome

    t0 = time.time()
    genome = benchmark_genome(4_600_000)
    idx = SaplingIndex.build(genome, IndexConfig(k=K, buckets=22))
    log(f"index build: {time.time() - t0:.1f}s (n={idx.n})")
    idx.save(npz)
    return idx


def bench_scale(idx, cap, iters, bs_iters):
    """Returns a per-scale result dict; self-check enforced."""
    import jax
    import jax.numpy as jnp

    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.query import (_rev_dtype, binsearch_batch,
                                       plquery_batch)

    t = idx.table
    rng = np.random.default_rng(99)
    starts = rng.integers(0, idx.n - K + 1, NQ)
    codes2d = idx.codes[starts[:, None] + np.arange(K)]
    # pre-pack on host and stage in HBM: the reference's timed loop reads
    # pre-generated queries from RAM (sapling_example.cpp:110-141); HBM
    # is this engine's RAM. One launch for all NQ lanes.
    q_words = jax.device_put(packops.pack_queries(codes2d))
    x = jax.device_put(packops.batch_kmers_adjusted(codes2d, K))
    use3 = idx.prefix3 is not None and K <= packops.P3_BASES
    q3 = jax.device_put(packops.pack_queries3(codes2d)) if use3 else None
    darr = idx.device_arrays()
    arrs = [darr["packed"], darr["rev"], darr["xlist"], darr["ylist"],
            darr.get("prefix"), darr.get("prefix3"), darr.get("ptab"),
            darr.get("pred2")]
    p2bits = darr.get("pred2_bits")
    rev_dtype = _rev_dtype(darr["rev"])
    if np.dtype(rev_dtype) == np.uint32:
        rev_dtype = np.int64

    # index arrays are ARGUMENTS (closure capture would bake them into
    # the lowering as constants and ship GBs to the remote compiler)
    @jax.jit
    def run_k(qw, xx0, q3a, packed, rev, xl, yl, pfx, pfx3, ptab, pred2):
        def body(_, carry):
            xx, _prev = carry
            out = plquery_batch(
                packed, rev, xl, yl, qw, xx, pfx, pfx3, q3a, ptab=ptab,
                pred2=pred2, pred2_bits=p2bits,
                n=idx.n, length=K, k=idx.k, buckets=idx.buckets,
                most_over=t.most_over, most_under=t.most_under,
                max_over=t.max_over, max_under=t.max_under,
                # everything after the prediction probe runs in a
                # compacted [cap] batch — bit-identical results, caps
                # per scale (SCALES)
                compact_unresolved=True, compact_cap=cap)
            # chain iter i+1's input on a REDUCTION of iter i's output:
            # every lane of every iteration stays live
            return xx + jnp.sum(out).astype(xx.dtype) * 0, out

        _, out = jax.lax.fori_loop(
            0, iters, body, (xx0, jnp.zeros(xx0.shape[0], rev_dtype)))
        digest = jnp.stack([jnp.sum(out), out[1234]]).astype(jnp.int64)
        return out, digest

    np.asarray(run_k(q_words, x, q3, *arrs)[1])  # compile + warm
    # Outlier discipline (same as the aligner's): a rep right after a
    # big compile can stall far past the device time (a 3.1 Gbp rep
    # once read ~218 s against a 3.44 s median — worker settling, not
    # the engine). Up to 2 extra reps when any rep lands >2x the best;
    # median over ALL reps, spread over the central 3 sorted times,
    # raw times published.
    times = []
    for _ in range(REPEATS):
        t0 = time.time()
        np.asarray(run_k(q_words, x, q3, *arrs)[1])  # digest-only fetch
        times.append((time.time() - t0) / iters)
    extra = 0
    while max(times) > 2.0 * min(times) and extra < 2:
        extra += 1
        t0 = time.time()
        np.asarray(run_k(q_words, x, q3, *arrs)[1])
        times.append((time.time() - t0) / iters)
    srt = sorted(times)
    mid = srt[max(0, len(srt) // 2 - 1):][:3]
    dt = float(np.median(times))
    qps = NQ / dt
    spread = 100.0 * (mid[-1] - mid[0]) / dt
    log(f"plquery: {NQ} queries in {dt:.3f}s -> {qps:,.0f} q/s "
        f"(median of {len(times)} runs x {iters} chained iters, "
        f"central spread {spread:.1f}%, times {['%.3f' % x for x in times]})")
    pos = np.asarray(run_k(q_words, x, q3, *arrs)[0])  # untimed full fetch
    sample = rng.choice(NQ, 200_000, replace=False)
    good = idx.verify_hits(codes2d[sample], pos[sample])
    n_good = int(good.sum())
    log(f"correctness: {n_good} out of {len(sample)}")
    if n_good != len(sample):
        raise SystemExit("self-check FAILED")

    # in-repo binary-search baseline on the same chip. q_words is
    # WORD-MAJOR [WQ, B] — the lane slice is axis 1 (an axis-0 slice
    # silently times the full batch; that bug once understated this
    # baseline).
    nb_lanes = 1_000_000
    qb = q_words[:, :nb_lanes]

    @jax.jit
    def run_bs(q, packed, rev):
        def body(_, carry):
            qq, _prev = carry
            out = binsearch_batch(packed, rev, qq, n=idx.n, length=K)
            return qq.at[0, 0].add(
                jnp.sum(out).astype(jnp.uint32) * 0), out

        out = jax.lax.fori_loop(
            0, bs_iters, body, (q, jnp.zeros(nb_lanes, rev_dtype)))[1]
        return jnp.stack([jnp.sum(out), out[99]]).astype(jnp.int64)

    np.asarray(run_bs(qb, darr["packed"], darr["rev"]))  # compile + warm
    bs_times = []
    for _ in range(REPEATS):
        t0 = time.time()
        np.asarray(run_bs(qb, darr["packed"], darr["rev"]))
        bs_times.append((time.time() - t0) / bs_iters)
    bs_dt = float(np.median(bs_times))
    bs_qps = nb_lanes / bs_dt
    log(f"binsearch baseline: {nb_lanes} queries in {bs_dt:.3f}s -> "
        f"{bs_qps:,.0f} q/s (margin {qps / bs_qps:.2f}x)")
    out = dict(qps=qps, spread_pct=round(spread, 1), bs_qps=bs_qps,
               times_s=[round(x, 3) for x in times])
    if extra:
        out["outlier_reps"] = extra
    return out


def bench_aligner(n=230_000_000, label="230Mbp_100bp", ref_rps=6960,
                  tag="aligner"):
    """Second headline: end-to-end FASTQ->SAM reads/s on a cached
    aligner artifact — same corpus recipe as tools/bench_align.py
    (100 bp reads, 1% substitutions). One full untimed warm pass covers
    every jit shape, then timed passes. Reference comparison (230 Mbp):
    the compiled inv-fixed reference binary measured 6,960 reads/s on
    this genome class on a host CPU (docs/measured.json at commit
    9faeb07, alignment loop isolated); at 3.1 Gbp the reference's in-memory DC3 build cannot complete on this
    host, so ref_rps is None there."""
    from sapling_tpu.align.aligner import SeedExtendAligner
    from sapling_tpu.config import AlignerConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.io.fastq import Read
    from sapling_tpu.ops.pack import decode_bases
    from sapling_tpu.sim.genomes import simulate_reads

    npz = os.path.join(CACHE, f"align_{n}_k16.stpu.npz")
    if not os.path.exists(npz) or os.environ.get("SAPLING_BENCH_ALIGNER") == "0":
        log(f"[{tag}] no cached aligner artifact ({npz}) — skipped")
        return None
    t0 = time.time()
    idx = SaplingIndex.load(npz, mmap=True)
    # the aligner's host phases gather RANDOMLY from codes/inv/lcpk —
    # materialize those (sequential read); rev/packed stay mapped, they
    # only stream to the device
    idx.codes = np.array(idx.codes)
    idx.inv = np.array(idx.inv)
    idx.lcpk_fwd = np.array(idx.lcpk_fwd)
    idx.lcpk_bwd = np.array(idx.lcpk_bwd)
    log(f"[{tag}] artifact mapped in {time.time()-t0:.0f}s (n={idx.n:,})")
    # 100k reads = 7 blocks of 16384: enough steady-state for the
    # 8-worker pipeline (fewer blocks measure mostly ramp/drain)
    n_reads, rlen = 100_000, 100
    g_ascii = decode_bases(idx.codes)
    reads_arr, pos, _rc = simulate_reads(g_ascii, n_reads, rlen,
                                         sub_rate=0.01, seed=42)
    reads = [Read(name=f"r{i}", seq=reads_arr[i].tobytes(), qual="I" * rlen)
             for i in range(n_reads)]
    aligner = SeedExtendAligner(idx, AlignerConfig())
    block, workers, coalesce = 16384, 8, 2
    warm = (reads[lo:lo + block] for lo in range(0, n_reads, block))
    for _ in aligner.align_blocks(warm, workers=workers, coalesce=coalesce):
        pass
    # the aligner pipeline mixes host stages with many small device
    # dispatches per block, so unlike the chained query programs its
    # wall time jitters, and a host-contended rep can stall far longer.
    # Discipline: REPEATS passes, up to 2 extra if a pass lands >2x the
    # best so far; headline = median over ALL passes, spread over the
    # central 3 sorted times, raw times logged so nothing is hidden.
    times = []
    n_aligned = n_good = 0

    def one_pass():
        nonlocal n_aligned, n_good
        t0 = time.time()
        n_aligned = n_good = ri = 0
        blocks = (reads[lo:lo + block] for lo in range(0, n_reads, block))
        for out in aligner.align_blocks(blocks, workers=workers,
                                        coalesce=coalesce):
            for ar in out:
                if ar.aligned:
                    n_aligned += 1
                    if abs(ar.alignment.ref_begin - pos[ri]) <= 10:
                        n_good += 1
                ri += 1
        times.append(time.time() - t0)

    for rep in range(REPEATS):
        one_pass()
    extra = 0
    while len(times) >= 2 and max(times) > 2.0 * min(times) and extra < 2:
        extra += 1
        one_pass()
    srt = sorted(times)
    mid = srt[max(0, len(srt) // 2 - 1):][:3]  # central 3 of the sorted times
    dt = float(np.median(times))
    rps = n_reads / dt
    spread = 100.0 * (mid[-1] - mid[0]) / dt
    log(f"[{tag}] {n_reads} reads in {dt:.2f}s -> {rps:,.0f} reads/s "
        f"(median of {len(times)}: {['%.2f' % x for x in times]}, "
        f"central spread {spread:.0f}%; {n_aligned} aligned, "
        f"{n_good} within 10bp of truth)")
    if n_aligned < 0.99 * n_reads or n_good < 0.85 * n_reads:
        raise SystemExit("aligner quality check FAILED")
    out = dict(label=label, reads_per_s=round(rps),
               spread_pct=round(spread, 1), ref_reads_per_s=ref_rps,
               times_s=[round(x, 2) for x in times])
    if ref_rps:
        out["vs_ref"] = round(rps / ref_rps, 2)
    if extra:
        out["outlier_reps"] = extra
    return out


def main():
    import jax

    from sapling_tpu.index.sapling import SaplingIndex

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's first device is "
                         f"{dev.platform} ({dev.device_kind})")
    log(f"device: {dev.platform} {dev.device_kind} x{len(devs)}")
    os.makedirs(CACHE, exist_ok=True)

    only = os.environ.get("SAPLING_BENCH_SCALES")  # e.g. "4.6Mbp,230Mbp"
    results = []
    skipped = []
    for sc in SCALES:
        if only and sc["label"] not in only.split(","):
            skipped.append(sc["label"])
            continue
        npz = os.path.join(CACHE, sc["npz"])
        if not os.path.exists(npz):
            if sc["label"] == "4.6Mbp":
                idx = build_small_index(npz)
            else:
                log(f"[{sc['label']}] no cached index ({sc['npz']}) — "
                    f"skipped (build with tools/build_big_index.py)")
                skipped.append(sc["label"])
                continue
        else:
            t0 = time.time()
            # query path never touches inv / the aligner run arrays;
            # mmap defers disk reads to the members actually used
            idx = SaplingIndex.load(
                npz, skip=("inv", "inv_hi", "lcpk_fwd", "lcpk_bwd"),
                mmap=True)
            # queries gather random rows of codes — materialize it
            # sequentially instead of paging 5M random faults
            idx.codes = np.array(idx.codes)  # force RAM copy: queries gather randomly
            log(f"[{sc['label']}] mapped in {time.time()-t0:.0f}s "
                f"(n={idx.n:,}, buckets=2^{idx.buckets})")
        r = bench_scale(idx, sc["cap"], sc["iters"], sc["bs_iters"])
        rd = dict(
            label=sc["label"], qps=round(r["qps"]),
            spread_pct=r["spread_pct"],
            vs_ref_best=round(r["qps"] / sc["ref_qps"], 2),
            vs_ref_binsearch=round(r["qps"] / sc["ref_bs_qps"], 2),
            onchip_binsearch_qps=round(r["bs_qps"]),
            onchip_margin=round(r["qps"] / r["bs_qps"], 2),
            times_s=r["times_s"])
        if r.get("outlier_reps"):
            rd["outlier_reps"] = r["outlier_reps"]
        results.append(rd)
        del idx  # free ~30 GB of host arrays before the next scale

    if not results:
        raise SystemExit("no scale benchmarked")
    aligner = bench_aligner()
    # GRCh38-scale aligner joins the contract when its artifact exists
    # (no reference figure at this scale: its in-memory DC3 SA build
    # cannot complete on this host — README). SAPLING_BENCH_ALIGNER=0
    # skips both aligner entries.
    aligner_big = bench_aligner(n=3_100_000_000, label="3.1Gbp_100bp",
                                ref_rps=None, tag="aligner-3.1Gbp")
    primary = results[-1]  # largest measured scale = the north star
    out = {
        "metric": "plquery_qps_k21",
        "value": primary["qps"],
        "unit": "queries/sec/chip",
        "vs_baseline": primary["vs_ref_best"],
        "primary_scale": primary["label"],
        "skipped_scales": skipped,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)},
        "scales": results,
    }
    if aligner:
        out["aligner"] = aligner
    if aligner_big:
        out["aligner_grch38"] = aligner_big
    print(json.dumps(out))


if __name__ == "__main__":
    main()
