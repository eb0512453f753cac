#!/usr/bin/env python
"""Multi-config benchmark sweep + plots.

Reproduces the reference's published experiment axes with MEASURED numbers
(the reference hard-codes its results into plotting scripts,
eval/TimingPlot/plot.py etc.):

  * genome-size sweep (4.6 Mbp E. coli scale ... 230 Mbp chr1 scale ...)
  * query-length sweep (11/21/31/41/51/101, eval/VarQuery)
  * PWL vs binary-search baseline
  * index memory per size (eval/Memory)

    python tools/bench_sweep.py [sizes=4600000,46000000,230000000]
        [nq=5000000] [out=bench_out]

Writes JSON results + PNG plots into the output directory.
"""

import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def measure(idx, qlen: int, nq: int, baseline: bool = False,
            iters: int = 6):
    """Current-engine measurement: fast3 prefixes when present,
    compact_unresolved cascade, and `iters` data-chained iterations
    inside ONE dispatch."""
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.query import binsearch_batch, plquery_batch

    rng = np.random.default_rng(99)
    starts = rng.integers(0, idx.n - qlen + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(qlen)]
    import jax
    import jax.numpy as jnp

    q_words = jax.device_put(packops.pack_queries(codes2d))
    x = jax.device_put(packops.batch_kmers_adjusted(codes2d, idx.k))
    dev = idx.device_arrays()
    use3 = (dev.get("prefix3") is not None
            and qlen <= min(idx.k, packops.P3_BASES))
    q3 = (jax.device_put(packops.pack_queries3(codes2d)) if use3 else None)
    t = idx.table
    from sapling_tpu.ops.query import _rev_dtype

    state_dt = (jnp.int64 if np.dtype(_rev_dtype(dev["rev"])) == np.uint32
                else _rev_dtype(dev["rev"]))

    @jax.jit
    def run_k(qw, xx0, q3a):
        def body(_, carry):
            xx, _p = carry
            out = plquery_batch(
                dev["packed"], dev["rev"], dev["xlist"], dev["ylist"],
                qw, xx, dev.get("prefix"), dev.get("prefix3"), q3a,
                ptab=dev.get("ptab"), pred2=dev.get("pred2"),
                pred2_bits=dev.get("pred2_bits"),
                n=idx.n, length=qlen, k=idx.k, buckets=idx.buckets,
                most_over=t.most_over, most_under=t.most_under,
                max_over=t.max_over, max_under=t.max_under,
                compact_escalate=True, compact_unresolved=True)
            return xx + out[0] * 0, out

        return jax.lax.fori_loop(
            0, iters, body, (xx0, jnp.zeros(xx0.shape[0], state_dt)))[1]

    np.asarray(run_k(q_words, x, q3))          # compile + warm
    t0 = time.time()
    pos = np.asarray(run_k(q_words, x, q3))
    qps = nq / ((time.time() - t0) / iters)
    sample = np.random.default_rng(1).choice(nq, min(nq, 100_000), False)
    good = int(idx.verify_hits(codes2d[sample], pos[sample]).sum())
    assert good == len(sample), f"self-check {good}/{len(sample)}"
    res = {"qlen": qlen, "nq": nq, "plquery_qps": round(qps)}
    if baseline:
        # q_words is WORD-MAJOR [WQ, B]: lanes slice on axis 1. Chained
        # iterations amortize the per-dispatch cost that would otherwise
        # understate the baseline (and overstate the speedup).
        nb = min(nq, 1_000_000)
        qb = q_words[:, :nb]
        bs_iters = 3

        @jax.jit
        def run_bs(q):
            def body(_, carry):
                qq, _p = carry
                out = binsearch_batch(dev["packed"], dev["rev"], qq,
                                      n=idx.n, length=qlen)
                return qq.at[0, 0].add(out[0].astype(jnp.uint32) * 0), out

            return jax.lax.fori_loop(
                0, bs_iters, body, (q, jnp.zeros(nb, state_dt)))[1]

        np.asarray(run_bs(qb))
        t0 = time.time()
        np.asarray(run_bs(qb))
        res["binsearch_qps"] = round(nb / ((time.time() - t0) / bs_iters))
    return res


def main(argv):
    from sapling_tpu.config import IndexConfig, parse_keyval_args
    from sapling_tpu.evalx import plots
    from sapling_tpu.evalx.memory import index_memory_report
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.sim.genomes import benchmark_genome

    kv = parse_keyval_args(argv[1:])
    sizes = [int(s) for s in kv.get("sizes", "4600000,46000000").split(",")]
    nq = int(kv.get("nq", 5_000_000))
    out_dir = kv.get("out", os.path.join(_ROOT, "bench_out"))
    os.makedirs(out_dir, exist_ok=True)
    cache = os.path.join(_ROOT, ".bench_cache")
    os.makedirs(cache, exist_ok=True)

    results = {"sizes": [], "qlen_sweep": None}
    for n in sizes:
        npz = os.path.join(cache, f"bench_{n}_k21.stpu.npz")
        t0 = time.time()
        if os.path.exists(npz):
            idx = SaplingIndex.load(npz)
        else:
            idx = SaplingIndex.build(benchmark_genome(n), IndexConfig(k=21))
            idx.save(npz)
        build_s = time.time() - t0
        r = measure(idx, 21, nq, baseline=True)
        r.update(n=n, build_or_load_s=round(build_s, 1),
                 memory=index_memory_report(idx))
        results["sizes"].append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "memory"}),
              flush=True)
        if n == sizes[-1]:
            sweep = []
            for ql in (11, 21, 31, 41, 51, 101):
                sweep.append(measure(idx, ql, nq))
                print(json.dumps(sweep[-1]), flush=True)
            results["qlen_sweep"] = {"n": n, "points": sweep}
        del idx

    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    ns = [r["n"] for r in results["sizes"]]
    plots.timing_plot(
        ns,
        {"sapling-tpu (1 chip)": [r["plquery_qps"] for r in results["sizes"]],
         "binary search (1 chip)": [r["binsearch_qps"] for r in results["sizes"]]},
        os.path.join(out_dir, "timing.png"))
    plots.memory_plot(
        [f"{r['n']/1e6:.0f}Mbp" for r in results["sizes"]],
        [r["memory"]["total_bytes"] / 1e9 for r in results["sizes"]],
        os.path.join(out_dir, "memory.png"))
    if results["qlen_sweep"]:
        pts = results["qlen_sweep"]["points"]
        plots.query_length_plot(
            [p["qlen"] for p in pts],
            {"sapling-tpu": [p["plquery_qps"] for p in pts]},
            os.path.join(out_dir, "query_length.png"))
    print(f"wrote {out_dir}/results.json + plots")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
