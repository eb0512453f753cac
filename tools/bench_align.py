#!/usr/bin/env python
"""End-to-end aligner throughput benchmark.

Simulated reads against a cached benchmark genome, full FASTQ -> SAM
pipeline (seeding + SW extension + traceback + emission), reads/sec
measured wall-clock with results materialized, plus simulation-truth
quality (AlignmentQuality semantics, eval/Aligner/AlignmentQuality.java).

    python tools/bench_align.py [n=230000000] [reads=50000] [len=100]
        [sub=0.01] [block=8192] [ref=0]

ref=1 additionally times the compiled reference aligner
(tests/_build/align_fixed, the inv-fixed src/align.cpp:391 binary) on
the SAME genome + FASTQ. Its index build is untimed (cached .sa/.sap,
same artifact-caching the reference itself uses, sapling_api.h:559-675);
per-read throughput isolates the alignment loop by subtracting a
1-read run's startup (genome read + .sa/.sap load) from the full run.
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main(argv):
    from sapling_tpu.align.aligner import SeedExtendAligner
    from sapling_tpu.config import AlignerConfig, IndexConfig, parse_keyval_args
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.io.fastq import Read
    from sapling_tpu.sim.genomes import benchmark_genome, simulate_reads

    kv = parse_keyval_args(argv[1:])
    n = int(kv.get("n", 230_000_000))
    n_reads = int(kv.get("reads", 50_000))
    rlen = int(kv.get("len", 100))
    sub = float(kv.get("sub", 0.01))
    block = int(kv.get("block", 16384))

    cache = os.path.join(_ROOT, ".bench_cache", f"align_{n}_k16.stpu.npz")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    t0 = time.time()
    if os.path.exists(cache):
        # mmap + selective materialization (bench.py's pattern): the
        # aligner's host phases gather RANDOMLY from codes/inv/lcpk —
        # copy those to RAM; rev/packed only stream to the device, a
        # sequential read the mmap serves fine (36 GB full RAM load at
        # 3.1 Gbp took ~310 s before this).
        idx = SaplingIndex.load(cache, mmap=True)
        idx.codes = np.array(idx.codes)
        idx.inv = np.array(idx.inv)
        if idx.lcpk_fwd is not None:
            idx.lcpk_fwd = np.array(idx.lcpk_fwd)
            idx.lcpk_bwd = np.array(idx.lcpk_bwd)
        genome = None
    else:
        if n > 1_000_000_000:
            raise SystemExit(
                f"no cached aligner index for n={n}; build it with the "
                f"memory-lean pipeline first:\n  python "
                f"tools/build_big_index.py n={n} k=16 nb=26 aligner=1 "
                f"out={cache}")
        genome = benchmark_genome(n)
        idx = SaplingIndex.build(genome, IndexConfig(k=16))
        idx.save(cache)
    print(f"index ready ({time.time()-t0:.0f}s, n={idx.n})", flush=True)

    from sapling_tpu.ops.pack import decode_bases

    g_ascii = decode_bases(idx.codes)
    reads_arr, pos, is_rc = simulate_reads(g_ascii, n_reads, rlen,
                                           sub_rate=sub, seed=42)
    reads = [Read(name=f"r{i}", seq=reads_arr[i].tobytes(), qual="I" * rlen)
             for i in range(n_reads)]
    aligner = SeedExtendAligner(idx, AlignerConfig())

    workers = int(kv.get("workers", 8))
    coalesce = int(kv.get("coalesce", 2))
    # warm compiles with ONE full untimed pass over the corpus: the tail
    # group's seed-query batch is a different jit shape than the full
    # groups' — a partial warmup once leaked a tail-shape compile into
    # the timed loop and read as a large aligner regression.
    warm = (reads[lo : lo + block] for lo in range(0, n_reads, block))
    for _ in aligner.align_blocks(warm, workers=workers, coalesce=coalesce):
        pass
    aligner.phase_seconds.clear()
    t0 = time.time()
    n_aligned = n_good = 0
    blocks = (reads[lo : lo + block] for lo in range(0, n_reads, block))
    ri = 0
    for out in aligner.align_blocks(blocks, workers=workers,
                                    coalesce=coalesce):
        for ar in out:
            if ar.aligned:
                n_aligned += 1
                if abs((ar.alignment.ref_begin) - pos[ri]) <= 10:
                    n_good += 1
            ri += 1
    dt = time.time() - t0
    print(f"aligned {n_reads} reads in {dt:.2f}s -> {n_reads/dt:,.0f} reads/s")
    print(f"aligned: {n_aligned}/{n_reads}; within 10bp of truth: {n_good}")
    tot = sum(aligner.phase_seconds.values()) or 1.0
    print("phases: " + "  ".join(
        f"{k}={v:.2f}s({100*v/tot:.0f}%)"
        for k, v in sorted(aligner.phase_seconds.items(),
                           key=lambda kv: -kv[1])))

    if int(kv.get("ref", 0)):
        ref_rps = bench_reference(n, g_ascii, reads, rlen)
        if ref_rps:
            print(f"reference align_fixed: {ref_rps:,.0f} reads/s "
                  f"-> speedup {n_reads/dt/ref_rps:.2f}x")
    return 0


def _build_align_fixed():
    """Compile the inv-fixed reference aligner (same recipe as
    tests/test_aligner.py ref_align_bin; patched source stays out of the
    repo tree — oracle binary only)."""
    import subprocess
    import tempfile

    build = os.path.join(_ROOT, "tests", "_build")
    os.makedirs(build, exist_ok=True)
    exe = os.path.join(build, "align_fixed")
    if os.path.exists(exe):
        return exe
    ref_src = "/root/reference/src"
    with tempfile.TemporaryDirectory(prefix="sapling_oracle_") as td:
        patched = os.path.join(td, "align_fixed.cpp")
        with open(os.path.join(ref_src, "align.cpp")) as f:
            src = f.read()
        src = src.replace("sapling->sa[ref_pos]", "sapling->lsa.inv[ref_pos]")
        with open(patched, "w") as f:
            f.write(src)
        subprocess.run(
            ["g++", "-O2", "-std=c++11", "-msse4.1", "-o", exe, patched,
             os.path.join(ref_src, "ssw_cpp.cpp"),
             os.path.join(ref_src, "ssw.c"), "-I", ref_src],
            check=True)
    return exe


def bench_reference(n, g_ascii, reads, rlen):
    """Time the reference aligner on the same corpus. Returns reads/s of
    its alignment loop (startup measured via a 1-read run and subtracted;
    index build is untimed — both sides load cached artifacts)."""
    import subprocess

    exe = _build_align_fixed()
    wd = os.path.join(_ROOT, ".bench_cache", f"ref_align_{n}")
    os.makedirs(wd, exist_ok=True)
    ref_fa = os.path.join(wd, "ref.fa")
    if not os.path.exists(ref_fa):
        with open(ref_fa, "w") as f:
            f.write(">chr1\n")
            g = g_ascii.tobytes().decode()
            for lo in range(0, len(g), 80):
                f.write(g[lo:lo + 80] + "\n")

    def write_fastq(path, rs):
        with open(path, "w") as f:
            for r in rs:
                f.write(f"@{r.name}\n{r.seq.decode()}\n+\n{'I' * rlen}\n")

    full_fq = os.path.join(wd, "reads.fastq")
    one_fq = os.path.join(wd, "one.fastq")
    write_fastq(full_fq, reads)
    write_fastq(one_fq, reads[:1])

    def run(fq, tag):
        t0 = time.time()
        res = subprocess.run([exe, fq, ref_fa, os.path.join(wd, tag + ".sam")],
                             capture_output=True, text=True, cwd=wd)
        dt = time.time() - t0
        if res.returncode != 0:
            print(f"reference aligner failed: {res.stderr[-500:]}")
            return None
        return dt

    if not os.path.exists(ref_fa + ".sa"):
        print("building reference .sa/.sap (untimed, one-time)...",
              flush=True)
        if run(one_fq, "warm") is None:
            return None
    t_one = run(one_fq, "one")
    t_full = run(full_fq, "full")
    if t_one is None or t_full is None:
        return None
    loop = t_full - t_one
    print(f"reference align_fixed: startup {t_one:.2f}s, "
          f"full {t_full:.2f}s, loop {loop:.2f}s for {len(reads)} reads")
    return (len(reads) - 1) / max(loop, 1e-9)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
