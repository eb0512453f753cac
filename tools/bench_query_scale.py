#!/usr/bin/env python
"""Query-throughput benchmark for any cached index artifact.

    python tools/bench_query_scale.py <index.stpu.npz> [nq=5000000]
        [qLen=21] [iters=10] [adaptive=0] [compact=0] [compact_u=0]
        [cap=N] [hitrate=0] [sweep=SPEC]

sweep=SPEC runs several configs after ONE index load/transfer; SPEC is
comma-separated tokens: `off` (plain cascade), `cu:<cap>`
(compact_unresolved at that cap), `ce:<cap>` (compact_escalate).
hitrate=1 first measures the prediction-probe hit rate (the
compact_unresolved cap-sizing signal).

Timing: index arrays passed as jit ARGUMENTS (closure capture would bake
them into the program as constants), K data-chained iterations inside
one program, a [2] digest (full-reduction checksum + sampled lane)
materialized in the timed region; the full position vector is fetched
UNTIMED for the self-check — same as bench.py.
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main(argv):
    import jax
    import jax.numpy as jnp

    from sapling_tpu.config import parse_keyval_args
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.predict import predict_pwl
    from sapling_tpu.ops.query import make_rank_probe, plquery_batch

    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    nq = int(kv.get("nq", 5_000_000))
    qlens = [int(v) for v in str(kv.get("qLen", "21")).split(",")]
    iters = int(kv.get("iters", 10))
    adaptive = bool(int(kv.get("adaptive", 0)))
    want_hitrate = bool(int(kv.get("hitrate", 0)))

    # config list: one config from the flat flags, or several via sweep=
    def _cfg(tok):
        if tok == "off":
            return dict(compact=False, compact_u=False, cap=None)
        kind, _, caps = tok.partition(":")
        cap = int(caps) if caps else None
        if kind == "cu":
            return dict(compact=False, compact_u=True, cap=cap)
        if kind == "ce":
            return dict(compact=True, compact_u=False, cap=cap)
        raise SystemExit(f"bad sweep token {tok!r}")

    if "sweep" in kv:
        configs = [_cfg(t) for t in kv["sweep"].split(",") if t]
    else:
        configs = [dict(compact=bool(int(kv.get("compact", 0))),
                        compact_u=bool(int(kv.get("compact_u", 0))),
                        cap=int(kv["cap"]) if "cap" in kv else None)]

    t0 = time.time()
    # query path never touches inv or the aligner run arrays; mmap
    # defers disk reads to the members actually used (bench.py does the
    # same)
    idx = SaplingIndex.load(
        argv[1], skip=("inv", "inv_hi", "lcpk_fwd", "lcpk_bwd"), mmap=True)
    idx.codes = np.array(idx.codes)  # force RAM copy: queries gather randomly
    # table=: a retabled PWL table (tools/retable_index.py) for
    # bucket-count A/Bs without duplicating the 30 GB artifact.
    # ab=1 runs the artifact's own table FIRST, then swaps in table=
    # and reruns — one load, one rev/packed transfer (swap_table
    # re-ships only the ~1 GB table).
    over_table = None
    if "table" in kv:
        from sapling_tpu.index.pwl import PwlTable
        from sapling_tpu.io.artifacts import load_npz

        z = load_npz(kv["table"])
        if int(z["src_n"]) != idx.n or int(z["src_k"]) != idx.k:
            raise SystemExit(f"table {kv['table']} was built for "
                             f"n={int(z['src_n'])},k={int(z['src_k'])}")
        st = z["stats"]
        over_table = PwlTable(
            buckets=int(z["buckets"]), xlist=z["xlist"], ylist=z["ylist"],
            max_over=int(st[0]), max_under=int(st[1]),
            mean_error=int(st[2]), most_over=int(st[3]),
            most_under=int(st[4]))
        if not int(kv.get("ab", 0)):
            idx.swap_table(over_table)
            over_table = None
            print(f"table override: 2^{idx.buckets} buckets from "
                  f"{kv['table']}", flush=True)
    t = idx.table
    print(f"loaded n={idx.n:,} buckets=2^{idx.buckets} "
          f"most=({t.most_over},{t.most_under}) "
          f"max=({t.max_over},{t.max_under}) in {time.time()-t0:.0f}s",
          flush=True)
    # rows2d=1/0 forces the Rows2D / HalvesU32 rev layout at >2^31 ranks
    # (unset = engine default: Rows2D)
    rows2d = kv.get("rows2d")
    darr = idx.device_arrays(
        rev_rows2d=None if rows2d is None else bool(int(rows2d)))
    arrs = [darr["packed"], darr["rev"], darr["xlist"], darr["ylist"],
            darr.get("prefix"), darr.get("prefix3"), darr.get("bounds"),
            darr.get("ptab"), darr.get("pred2")]
    p2bits = darr.get("pred2_bits")
    if adaptive and darr.get("bounds") is None:
        raise SystemExit("adaptive=1 needs a v3 index with bounds "
                         "(rebuild or tools/add_bucket_bounds.py)")
    from sapling_tpu.ops.query import _rev_dtype, _state_dtype

    rdt = _rev_dtype(darr["rev"])
    state_dt = jnp.int64 if np.dtype(rdt) == np.uint32 else rdt

    results = {}
    for qlen in qlens:  # one index load/transfer, many query lengths
        results[qlen] = _bench_len(
            idx, qlen, nq, iters, configs, adaptive, want_hitrate,
            darr, arrs, p2bits, state_dt)
    if len(qlens) > 1:
        print("qLen sweep: " + "  ".join(
            f"{ql}:{qps:,.0f}" for ql, qps in results.items()))
    if over_table is not None:
        idx.swap_table(over_table)
        darr = idx.device_arrays()
        arrs[2], arrs[3] = darr["xlist"], darr["ylist"]
        arrs[6] = darr.get("bounds")
        print(f"--- A/B: swapped to 2^{idx.buckets} buckets from "
              f"{kv['table']} (rev/packed stay resident)", flush=True)
        results_b = {}
        for qlen in qlens:
            results_b[qlen] = _bench_len(
                idx, qlen, nq, iters, configs, adaptive, want_hitrate,
                darr, arrs, p2bits, state_dt)
        for ql in qlens:
            print(f"A/B qLen={ql}: base {results[ql]:,.0f} vs "
                  f"2^{idx.buckets} {results_b[ql]:,.0f} "
                  f"({results_b[ql]/results[ql]:.2f}x)")
    return 0


def _bench_len(idx, qlen, nq, iters, configs, adaptive, want_hitrate,
               darr, arrs, p2bits, state_dt):
    import jax
    import jax.numpy as jnp

    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.predict import predict_pwl
    from sapling_tpu.ops.query import (_rev_dtype, _state_dtype,
                                       make_rank_probe, plquery_batch)

    t = idx.table
    rng = np.random.default_rng(99)
    starts = rng.integers(0, idx.n - qlen + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(qlen)]
    q_words = jax.device_put(packops.pack_queries(codes2d))
    x = jax.device_put(packops.batch_kmers_adjusted(codes2d, idx.k))
    use3 = (idx.prefix3 is not None
            and qlen <= min(idx.k, packops.P3_BASES))
    q3 = jax.device_put(packops.pack_queries3(codes2d)) if use3 else None
    rdt = _rev_dtype(darr["rev"])

    if want_hitrate:
        idt = _state_dtype(rdt)

        @jax.jit
        def hitrate(qw, xx, packed, rev, xl, yl, pfx, ptab, pred2):
            pred = predict_pwl(xx, xl, yl, 2 * idx.k, idx.buckets, idx.n,
                               ptab=ptab, pred2=pred2,
                               pred2_bits=p2bits).astype(idt)
            probe = make_rank_probe(packed, rev, pfx, qw, n=idx.n,
                                    length=qlen, idt=idt)
            _, p0 = probe(pred)
            return p0.match.sum()

        print("compiling hitrate probe...", flush=True)
        hits = int(hitrate(q_words, x, darr["packed"], darr["rev"],
                           darr["xlist"], darr["ylist"],
                           darr.get("prefix"), darr.get("ptab"),
                           darr.get("pred2")))
        print(f"prediction-probe hit rate: {hits}/{nq} "
              f"({hits/nq:.1%}); unresolved {nq-hits} "
              f"({(nq-hits)/nq:.1%})", flush=True)

    def run_config(compact, compact_u, cap):
        @jax.jit
        def run_k(qw, xx0, q3a, packed, rev, xl, yl, pfx, pfx3, bnd, ptab,
                  pred2):
            def body(_, carry):
                xx, _p = carry
                out = plquery_batch(
                    packed, rev, xl, yl, qw, xx, pfx, pfx3, q3a, bnd, ptab,
                    pred2, pred2_bits=p2bits,
                    n=idx.n, length=qlen, k=idx.k, buckets=idx.buckets,
                    most_over=t.most_over, most_under=t.most_under,
                    max_over=t.max_over, max_under=t.max_under,
                    adaptive_bounds=adaptive, compact_escalate=compact,
                    compact_cap=cap, compact_unresolved=compact_u)
                # chain on a REDUCTION of the output: every lane of
                # every iteration stays live (bench.py doctrine)
                return xx + jnp.sum(out).astype(xx.dtype) * 0, out

            out = jax.lax.fori_loop(
                0, iters, body, (xx0, jnp.zeros(xx0.shape[0], state_dt)))[1]
            # digest-only timed fetch: the [nq] position transfer is not
            # the engine's work — the full vector is fetched untimed for
            # the self-check. The sum may wrap in a
            # 32-bit state dtype; fine — the digest is a liveness/sync
            # value, not a checksum the self-check depends on.
            digest = jnp.stack(
                [jnp.sum(out), out[min(1234, nq - 1)]]).astype(jnp.int64)
            return out, digest

        tag = (f"adaptive={adaptive}, compact={compact}, "
               f"compact_u={compact_u}, cap={cap}")
        print(f"compiling [{tag}]...", flush=True)
        t0 = time.time()
        np.asarray(run_k(q_words, x, q3, *arrs)[1])
        print(f"compiled in {time.time()-t0:.0f}s", flush=True)
        times = []
        for _ in range(3):
            t0 = time.time()
            np.asarray(run_k(q_words, x, q3, *arrs)[1])
            times.append((time.time() - t0) / iters)
        dt = float(np.median(times))
        spread = 100.0 * (max(times) - min(times)) / dt
        pos = np.asarray(run_k(q_words, x, q3, *arrs)[0])  # untimed
        sample = min(nq, 200_000)
        ok = int(idx.verify_hits(codes2d[:sample], pos[:sample]).sum())
        print(f"plquery qLen={qlen} [{tag}] fast3={use3}: "
              f"{nq/dt:,.0f} q/s (median of 3, spread {spread:.1f}%); "
              f"self-check {ok}/{sample}", flush=True)
        if ok != sample:
            raise SystemExit("self-check FAILED")
        return nq / dt

    best = max(run_config(**c) for c in configs)
    print(f"best qLen={qlen}: {best:,.0f} q/s")
    return best


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
