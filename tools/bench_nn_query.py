#!/usr/bin/env python
"""A/B the NN-predictor query engine against the PWL engine on a cached
index artifact (the reference's NN never serves; here it drives the real
cascade, flag-gated — models.serve).

    python tools/bench_nn_query.py <index.stpu.npz> [nq=5000000]
        [chunks=64] [size=16] [epochs=300] [stride=1] [iters=6]

Reports: NN audit windows vs the PWL table's, both engines' q/s (same
timing as bench.py: data-chained iterations in one program), and the
self-check.
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
    from sapling_tpu.models.serve import train_serving
    from sapling_tpu.ops import pack as packops
    from sapling_tpu.ops.query import _rev_dtype, plquery_batch

    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    nq = int(kv.get("nq", 5_000_000))
    iters = int(kv.get("iters", 6))

    t0 = time.time()
    idx = SaplingIndex.load(argv[1], skip=("lcpk_fwd", "lcpk_bwd"),
                            mmap=True)
    idx.codes = np.array(idx.codes)
    print(f"loaded n={idx.n:,} 2^{idx.buckets} in {time.time()-t0:.0f}s",
          flush=True)
    t0 = time.time()
    srv = train_serving(idx, num_chunks=int(kv.get("chunks", 64)),
                        layer_size=int(kv.get("size", 16)),
                        epochs=int(kv.get("epochs", 300)),
                        sample_stride=int(kv.get("stride", 1)))
    t = idx.table
    print(f"trained+audited in {time.time()-t0:.0f}s\n"
          f"  NN  windows: most=({srv.most_over},{srv.most_under}) "
          f"max=({srv.max_over},{srv.max_under})\n"
          f"  PWL windows: most=({t.most_over},{t.most_under}) "
          f"max=({t.max_over},{t.max_under})", flush=True)

    K = idx.k
    rng = np.random.default_rng(99)
    starts = rng.integers(0, idx.n - K + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(K)]
    q_words = jax.device_put(packops.pack_queries(codes2d))
    x = jax.device_put(packops.batch_kmers_adjusted(codes2d, K))
    use3 = idx.prefix3 is not None and K <= packops.P3_BASES
    q3 = jax.device_put(packops.pack_queries3(codes2d)) if use3 else None
    darr = idx.device_arrays()
    arrs = [darr["packed"], darr["rev"], darr["xlist"], darr["ylist"],
            darr.get("prefix"), darr.get("prefix3")]
    rdt = _rev_dtype(darr["rev"])
    state_dt = jnp.int64 if np.dtype(rdt) == np.uint32 else rdt
    srv_params = jax.device_put(srv.params)
    srv.params = srv_params

    def run_engine(tag, use_nn, windows):
        mo, mu, xo, xu = windows

        @jax.jit
        def run_k(qw, xx0, q3a, packed, rev, xl, yl, pfx, pfx3):
            def body(_, carry):
                xx, _p = carry
                pred = srv.predict_ranks(xx) if use_nn else None
                out = plquery_batch(
                    packed, rev, xl, yl, qw, xx, pfx, pfx3, q3a,
                    n=idx.n, length=K, k=K, buckets=idx.buckets,
                    most_over=mo, most_under=mu, max_over=xo,
                    max_under=xu, pred64=pred)
                return xx + jnp.sum(out).astype(xx.dtype) * 0, out

            _, out = jax.lax.fori_loop(
                0, iters, body, (xx0, jnp.zeros(xx0.shape[0], state_dt)))
            return out, jnp.stack([jnp.sum(out), out[123]]).astype(jnp.int64)

        print(f"compiling [{tag}]...", flush=True)
        np.asarray(run_k(q_words, x, q3, *arrs)[1])
        t0 = time.time()
        np.asarray(run_k(q_words, x, q3, *arrs)[1])
        dt = (time.time() - t0) / iters
        pos = np.asarray(run_k(q_words, x, q3, *arrs)[0])
        sample = rng.choice(nq, 100_000, replace=False)
        ok = int(idx.verify_hits(codes2d[sample], pos[sample]).sum())
        print(f"[{tag}] {nq/dt:,.0f} q/s; self-check {ok}/{len(sample)}",
              flush=True)
        if ok != len(sample):
            raise SystemExit(f"[{tag}] self-check FAILED")
        return nq / dt

    pwl_qps = run_engine("PWL", False, (t.most_over, t.most_under,
                                        t.max_over, t.max_under))
    nn_qps = run_engine("NN", True, (srv.most_over, srv.most_under,
                                     srv.max_over, srv.max_under))
    print(f"NN/PWL = {nn_qps/pwl_qps:.2f}x "
          f"({nn_qps:,.0f} vs {pwl_qps:,.0f} q/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
