"""Smoke run of the main paths on one NVIDIA GPU (or four with --four).

    python chip_smoke.py          # one card: device, build, query, aligner,
                                  # Smith-Waterman parity
    python chip_smoke.py --four   # four cards: dp-sharded and index-sharded
                                  # query engines against one card

Every phase checks its own results and any failure ends the run with a
non-zero exit and no result line. Timings and rates are printed for
information; they are not a benchmark. The last line of standard output
is one JSON object naming the device as JAX reports it:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The run needs a GPU: on a host without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

GENOME_N = 4_600_000          # E. coli scale (bench.py's 4.6 Mbp cell)
K = 21
BUCKETS = 22
N_QUERIES = 5_000_000
CPU_SAMPLE = 65_536           # lanes re-run on the CPU backend
ORACLE_SAMPLE = 2_000         # lanes re-run through tests/oracle.py
BINSEARCH_LANES = 1_000_000
COMPACT_CAP = 13 << 17        # bench.py's 4.6 Mbp compaction cap
N_READS, READ_LEN, BLOCK = 100_000, 100, 16_384
SAM_SAMPLE = 2_000
SW_BATCH = 16_384
SW_WIDTHS = (128, 256)        # 100 bp and 250 bp reads
SW_CHAIN = 8


def log(*a):
    print(*a, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: ok ({time.perf_counter() - self.t0:.1f} s)")
        return False


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# --- phases -----------------------------------------------------------------

def device_phase(count: int, platform: str = "gpu"):
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != platform:
        raise SystemExit(f"no {platform}: JAX's first device is "
                         f"{d.platform} ({d.device_kind})")
    if len(devs) < count:
        raise SystemExit(f"need {count} devices, JAX sees {len(devs)}")
    from sapling_tpu.utils.compile_cache import use_compile_cache

    log(f"device_kind: {d.device_kind} (x{len(devs)})")
    if platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
        log(f"nvidia-smi: {smi}")
    import jaxlib

    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {use_compile_cache()}")
    return devs


def build_phase(with_aligner: bool):
    from sapling_tpu.config import IndexConfig
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.native.build import build_cuda, build_native
    from sapling_tpu.sim.genomes import benchmark_genome

    t0 = time.perf_counter()
    log(f"native library: {build_native()} "
        f"({time.perf_counter() - t0:.1f} s)")
    if with_aligner:
        t0 = time.perf_counter()
        log(f"CUDA library: {build_cuda()} "
            f"({time.perf_counter() - t0:.1f} s)")
    genome = benchmark_genome(GENOME_N)
    t0 = time.perf_counter()
    idx = SaplingIndex.build(genome, IndexConfig(k=K, buckets=BUCKETS))
    log(f"k={K} index: n={idx.n:,} buckets=2^{idx.buckets} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not with_aligner:
        return genome, idx, None
    t0 = time.perf_counter()
    idx16 = SaplingIndex.build(genome, IndexConfig(k=16))
    log(f"k=16 aligner index: buckets=2^{idx16.buckets} "
        f"({time.perf_counter() - t0:.1f} s)")
    return genome, idx, idx16


def _on_cpu_copy(idx):
    """A view of the index whose device arrays are placed afresh (the
    cached ones live on the GPU)."""
    cp = copy.copy(idx)
    cp._device = {}
    return cp


def _queries(idx, nq, seed=99):
    rng = np.random.default_rng(seed)   # bench.py's query draw
    starts = rng.integers(0, idx.n - K + 1, nq)
    return idx.codes[starts[:, None] + np.arange(K)]


def _oracle_for(idx, genome):
    """tests/oracle.py's scalar plQuery over this index's own arrays (its
    naive constructor is quadratic; the search is what is checked)."""
    from tests.oracle import OracleSapling

    o = object.__new__(OracleSapling)
    t = idx.table
    o.ref, o.n, o.k, o.alpha = genome.tobytes(), idx.n, idx.k, 2
    o.rev, o.buckets = idx.rev, idx.buckets
    o.xlist, o.ylist = t.xlist.tolist(), t.ylist.tolist()
    o.most_over, o.most_under = t.most_over, t.most_under
    o.max_over, o.max_under = t.max_over, t.max_under
    return o


def query_phase(idx, genome):
    import jax

    from sapling_tpu.config import QueryConfig

    codes = _queries(idx, N_QUERIES)
    cfgs = {"default": QueryConfig(),
            "compact": QueryConfig(compact_unresolved=True,
                                   compact_cap=COMPACT_CAP)}
    pos = {}
    for name, qcfg in cfgs.items():
        t0 = time.perf_counter()
        idx.query_positions(codes, qcfg)          # compile + warm
        t1 = time.perf_counter()
        pos[name] = idx.query_positions(codes, qcfg)
        dt = time.perf_counter() - t1
        log(f"plquery[{name}]: first call {t1 - t0:.1f} s, then "
            f"{N_QUERIES:,} queries in {dt:.3f} s = {N_QUERIES / dt:,.0f} q/s "
            "(host packing and fetch included)")
        good = int(idx.verify_hits(codes, pos[name]).sum())
        log(f"plquery[{name}]: self-check {good:,}/{N_QUERIES:,}")
        check(good == N_QUERIES, f"self-check {name}")
    check(np.array_equal(pos["default"], pos["compact"]),
          "default and compact configs agree")

    cpu = jax.devices("cpu")[0]
    icpu = _on_cpu_copy(idx)
    sample = codes[:CPU_SAMPLE]
    with jax.default_device(cpu):
        for name, qcfg in cfgs.items():
            got = icpu.query_positions(sample, qcfg)
            check(np.array_equal(got, pos[name][:CPU_SAMPLE]),
                  f"{name}: GPU == CPU on {CPU_SAMPLE} lanes")
    log(f"plquery: GPU positions == CPU backend on {CPU_SAMPLE:,} lanes")

    o = _oracle_for(idx, genome)
    ascii_ = np.frombuffer(b"ACGT", np.uint8)
    for i in range(ORACLE_SAMPLE):
        s = ascii_[codes[i]].tobytes()
        want = o.pl_query(s, o.kmerize(s), K)
        check(int(pos["default"][i]) == int(want), f"oracle lane {i}")
    log(f"plquery: == tests/oracle.py on {ORACLE_SAMPLE:,} lanes")

    bq = codes[:BINSEARCH_LANES]
    idx.query_positions_binsearch(bq)              # compile + warm
    t0 = time.perf_counter()
    bpos = idx.query_positions_binsearch(bq)
    dt = time.perf_counter() - t0
    check(np.array_equal(bpos >= 0, pos["default"][:BINSEARCH_LANES] >= 0),
          "binsearch found/-1 status")
    log(f"binsearch: {BINSEARCH_LANES:,} queries in {dt:.3f} s = "
        f"{BINSEARCH_LANES / dt:,.0f} q/s; found status agrees")


def aligner_phase(genome, idx16):
    import jax

    from sapling_tpu.align.aligner import SeedExtendAligner
    from sapling_tpu.config import AlignerConfig
    from sapling_tpu.io.fastq import Read
    from sapling_tpu.sim.genomes import simulate_reads

    arr, pos, _rc = simulate_reads(genome, N_READS, READ_LEN, sub_rate=0.01,
                                   seed=42)      # bench.py's read recipe
    reads = [Read(name=f"r{i}", seq=arr[i].tobytes(), qual="I" * READ_LEN)
             for i in range(N_READS)]

    def run(aligner, rd):
        blocks = (rd[lo:lo + BLOCK] for lo in range(0, len(rd), BLOCK))
        return [ar for out in aligner.align_blocks(blocks) for ar in out]

    aligner = SeedExtendAligner(idx16, AlignerConfig())
    t0 = time.perf_counter()
    run(aligner, reads)                            # compiles every shape
    t1 = time.perf_counter()
    out = run(aligner, reads)
    dt = time.perf_counter() - t1
    n_aligned = sum(ar.aligned for ar in out)
    n_good = sum(ar.aligned and abs(ar.alignment.ref_begin - pos[i]) <= 10
                 for i, ar in enumerate(out))
    log(f"aligner: warm pass {t1 - t0:.1f} s, then {N_READS:,} reads in "
        f"{dt:.2f} s = {N_READS / dt:,.0f} reads/s; {n_aligned:,} aligned, "
        f"{n_good:,} within 10 bp of truth")
    check(n_aligned >= 0.99 * N_READS and n_good >= 0.85 * N_READS,
          "aligner quality bar (bench.py)")

    # align_block runs every stage in this thread (align_blocks' worker
    # threads would not see the default-device context)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_out = SeedExtendAligner(_on_cpu_copy(idx16), AlignerConfig()
                                    ).align_block(reads[:SAM_SAMPLE])
    for i in range(SAM_SAMPLE):
        check(out[i].to_sam() == cpu_out[i].to_sam(), f"SAM record {i}")
    log(f"aligner: SAM of the first {SAM_SAMPLE:,} reads byte-identical "
        "to the CPU backend")


def _sw_batch(rng, b, w, r):
    q = rng.integers(0, 5, (b, w)).astype(np.int8)
    ref = rng.integers(0, 5, (b, r)).astype(np.int8)
    ql = rng.integers(w // 2, w + 1, b).astype(np.int32)
    rl = rng.integers(r // 2, r + 1, b).astype(np.int32)
    for i in range(0, b, 2):        # half the lanes hold a mutated copy
        off = int(rng.integers(0, 8))
        ln = min(int(ql[i]), r - off)
        seg = q[i, :ln].copy()
        mut = rng.random(ln) < 0.03
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        ref[i, off:off + ln] = seg
    q[np.arange(w)[None, :] >= ql[:, None]] = 0
    ref[np.arange(r)[None, :] >= rl[:, None]] = 0
    return q, ql, ref, rl


def _time_chain(fn, args, kw, reps=3):
    """Median seconds of SW_CHAIN data-chained passes in one program,
    fenced with block_until_ready (compile excluded)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(q, ql, ref, rl, term):
        def body(_, carry):
            ql_, acc = carry
            s = fn(q, ql_, ref, rl, term, **kw)["score"]
            # scores are < 2^30, so this keeps ql_ but XLA cannot know it
            return jnp.minimum(ql_, ql_ + (s >> 30)), acc + s[0]
        return jax.lax.fori_loop(0, SW_CHAIN, body,
                                 (ql, jnp.zeros((), jnp.int32)))[1]

    dargs = [jax.device_put(a) for a in args]
    jax.block_until_ready(chain(*dargs))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(*dargs))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def sw_phase(platform: str = "gpu"):
    import jax

    from sapling_tpu.ops.sw import sw_align_ends, sw_kernel, sw_pass

    kernel = sw_kernel(platform)
    cpu = jax.devices("cpu")[0]
    log(f"kept pass on {platform}: {kernel.__module__}.{kernel.__name__}")
    rng = np.random.default_rng(2024)
    for w in SW_WIDTHS:
        q, ql, ref, rl = _sw_batch(rng, SW_BATCH, w, w)
        no_term = np.full(SW_BATCH, -1, np.int32)
        with jax.default_device(cpu):
            term = np.asarray(sw_pass(q, ql, ref, rl, no_term)["score"],
                              np.int32)
        modes = {
            "pad16": (no_term, {}),
            "pad8": (no_term, dict(pad_to=8, second_inclusive=True)),
            "terminate": (term, {}),
            "score_only": (no_term, dict(score_only=True)),
        }
        for mode, (tm, kw) in modes.items():
            with jax.default_device(cpu):
                want = {k: np.asarray(v) for k, v in
                        sw_pass(q, ql, ref, rl, tm, **kw).items()}
            got_k = {k: np.asarray(v) for k, v in
                     kernel(q, ql, ref, rl, tm, **kw).items()}
            got_s = {k: np.asarray(v) for k, v in
                     sw_pass(q, ql, ref, rl, tm, **kw).items()}
            for f in want:
                check(np.array_equal(got_k[f], want[f]),
                      f"W={w} {mode} {f}: kernel == sw_pass on CPU")
                check(np.array_equal(got_s[f], want[f]),
                      f"W={w} {mode} {f}: sw_pass on {platform} == CPU")
            log(f"sw W=R={w} B={SW_BATCH} {mode}: fields "
                f"{sorted(want)} equal (kernel, sw_pass {platform}, "
                "sw_pass cpu)")
        # begins: forward + terminate-at-score reverse pass
        with jax.default_device(cpu):
            want = sw_align_ends(q, ql, ref, rl)
        for use_kernel in (True, False):
            got = sw_align_ends(q, ql, ref, rl, use_kernel=use_kernel)
            for f in want:
                check(np.array_equal(np.asarray(got[f]), want[f]),
                      f"W={w} sw_align_ends {f} use_kernel={use_kernel}")
        log(f"sw W=R={w}: sw_align_ends fields {sorted(want)} equal "
            "(kernel, sw_pass, CPU)")
        for mode in ("pad16", "score_only"):
            tm, kw = modes[mode]
            tk = _time_chain(kernel, (q, ql, ref, rl, tm), kw)
            ts = _time_chain(sw_pass, (q, ql, ref, rl, tm), kw)
            log(f"sw timing W=R={w} B={SW_BATCH} {mode}, {SW_CHAIN} chained "
                f"passes: kernel {tk * 1e3:.2f} ms, XLA scan {ts * 1e3:.2f} "
                f"ms ({ts / tk:.1f}x)")


def four_phase(idx):
    import jax

    from sapling_tpu.ops.predict import predict_pwl
    from sapling_tpu.parallel.mesh import make_mesh
    from sapling_tpu.parallel.query import ShardedQueryEngine, error_histogram
    from sapling_tpu.parallel.sharded_index import IndexShardedEngine

    codes = _queries(idx, N_QUERIES)

    def timed(name, fn):
        fn(codes)                                  # compile + warm
        t0 = time.perf_counter()
        out = fn(codes)
        dt = time.perf_counter() - t0
        log(f"{name}: {N_QUERIES:,} queries in {dt:.3f} s = "
            f"{N_QUERIES / dt:,.0f} q/s")
        return out

    base = timed("plquery on device 0", idx.query_positions)
    check(idx.verify_hits(codes, base).all(), "baseline self-check")
    dp = make_mesh(4)
    eng = ShardedQueryEngine(idx, dp)
    check(np.array_equal(timed("ShardedQueryEngine dp=4",
                               eng.query_positions), base),
          "dp=4 positions == device 0")
    im = make_mesh(4, tp=4, axes=("dp", "idx"))
    ieng = IndexShardedEngine(idx, im, rev_storage="split")
    check(np.array_equal(timed("IndexShardedEngine idx=4 split",
                               ieng.query_positions), base),
          "idx=4 positions == device 0")
    t = idx.table
    pred = predict_pwl(idx.kmerize_batch(codes), t.xlist, t.ylist, 2 * K,
                       idx.buckets, idx.n, xp=np)
    errs = idx.inv[base].astype(np.int64) - pred
    h = error_histogram(errs, dp, nbins=64)
    lo, hi = int(errs.min()), int(errs.max()) + 1
    width = max(1, (hi - lo + 63) // 64)
    want = np.bincount(np.clip((errs - lo) // width, 0, 63), minlength=64)
    check(np.array_equal(h, want), "error_histogram psum == numpy")
    log(f"error_histogram over dp=4: {int(h.sum()):,} errors, "
        f"range [{lo}, {hi}), equals numpy")
    log(f"devices: {[str(d) for d in jax.devices()[:4]]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded query phase")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    with Phase("device"):
        devs = device_phase(count)
    with Phase("build (host)"):
        # both indexes are built before the first device op
        genome, idx, idx16 = build_phase(with_aligner=not args.four)
    if args.four:
        with Phase("four cards"):
            four_phase(idx)
    else:
        with Phase("query"):
            query_phase(idx, genome)
        del idx
        with Phase("aligner"):
            aligner_phase(genome, idx16)
        with Phase("smith-waterman parity"):
            sw_phase()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}),
        flush=True)


if __name__ == "__main__":
    main()
