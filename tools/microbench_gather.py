#!/usr/bin/env python
"""Gather-layout microbenchmarks for >= 2^31-element rank arrays.

The GRCh38-scale query engine spends most of its time in random
device-memory gathers; this tool A/Bs the candidate layouts for the two
hot array kinds on the device at hand:

  rev (uint32, n >= 2^31 entries — beyond int32 gather indexing):
    halves   even/odd split: 2 one-element gathers + select (current
             default, ops.query.HalvesU32)
    rev2d    one [2, ceil(n/2)] operand, ONE gather op with (row, col)
             int32 index pairs (ops.query.Rows2D)

  packed genome (uint32 words; probes fetch 3 consecutive words):
    words32  3 independent u32 takes (current big-scale default)
    words64  2 u64 takes over the paired view (8-byte granule; the u64
             ARG is materialized twice on device — X64Split temps)

Timing: K data-chained iterations inside ONE jitted program, result
materialized. Operands are FILLED ON DEVICE (jnp.ones) — a 12 GB
host->device staging would dominate the run, and gather cost is
content-independent.

    python tools/microbench_gather.py [n=3100000000] [lanes=5000000]
        [iters=8] [which=rev2d,halves,words32,words64]
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

    kv = parse_keyval_args(argv[1:])
    n = int(kv.get("n", 3_100_000_000))
    lanes = int(kv.get("lanes", 5_000_000))
    iters = int(kv.get("iters", 8))
    which = kv.get("which", "halves,rev2d,words32,words64").split(",")

    rng = np.random.default_rng(7)
    idx0 = jax.device_put(rng.integers(0, n, lanes, dtype=np.int64))
    half = (n + 1) // 2

    def chain(take):
        """iters data-chained gathers: next indices derive from values.
        Operands cross the jit boundary as ARGUMENTS — closure capture
        would bake them into the lowering as constants and ship GBs to
        the remote compiler (the bench.py rule)."""
        def run(i0, *ops):
            def body(_, ix):
                v = take(ix, *ops)
                return (ix + v.astype(jnp.int64)) % n
            return jax.lax.fori_loop(0, iters, body, i0)
        return jax.jit(run)

    def bench(name, fn, *args):
        np.asarray(fn(*args))  # compile + warm
        t0 = time.time()
        np.asarray(fn(*args))
        dt = (time.time() - t0) / iters
        print(f"{name:8s} {dt*1e3:8.1f} ms/round "
              f"({lanes/dt/1e6:7.1f} M lanes/s)", flush=True)
        return dt

    def fill(shape, dtype=jnp.uint32):
        return jax.jit(lambda: jnp.ones(shape, dtype))()

    if "halves" in which:
        even = fill((half,))
        odd = fill((half,))

        def take_h(ix, even, odd):
            j = (ix >> 1).astype(jnp.int32)
            return jnp.where((ix & 1) == 0, jnp.take(even, j),
                             jnp.take(odd, j)).astype(jnp.uint32)

        bench("halves", chain(take_h), idx0, even, odd)
        del even, odd

    if "rev2d" in which:
        two_d = fill((2, half))

        def take_2d(ix, two_d):
            r = (ix & 1).astype(jnp.int32)
            c = (ix >> 1).astype(jnp.int32)
            dn = jax.lax.GatherDimensionNumbers(
                offset_dims=(), collapsed_slice_dims=(0, 1),
                start_index_map=(0, 1))
            return jax.lax.gather(
                two_d, jnp.stack([r, c], axis=-1), dn,
                slice_sizes=(1, 1),
                mode=jax.lax.GatherScatterMode.CLIP)

        bench("rev2d", chain(take_2d), idx0, two_d)
        del two_d

    nw = n // 16
    if "words32" in which:
        dev = fill((nw,))

        def take_w32(ix, dev):
            w0 = (ix >> 4).astype(jnp.int32)
            s = jnp.take(dev, w0)
            for j in (1, 2):
                s = s + jnp.take(dev, w0 + j)
            return s

        bench("words32", chain(take_w32), idx0, dev)
        del dev

    if "words64" in which:
        dev = fill((nw // 2,), jnp.uint64)

        def take_w64(ix, dev):
            u0 = (ix >> 5).astype(jnp.int32)
            s = jnp.zeros(ix.shape, jnp.uint32)
            for j in (0, 1):
                pair = jax.lax.bitcast_convert_type(
                    jnp.take(dev, u0 + j), jnp.uint32)
                s = s + pair[..., 0] + pair[..., 1]
            return s

        bench("words64", chain(take_w64), idx0, dev)

    # --- device sort cost: the price of MAKING lanes near-sorted ---------
    # (argsort by predicted rank inside the timed program; candidate
    # mechanism for the locality-sorted cascade)
    if "argsort" in which:
        def run_sort(keys):
            def body(_, kv):
                k, acc = kv
                p = jnp.argsort(k)
                return k + acc[0], acc + p[:1]
            return jax.lax.fori_loop(
                0, iters, body,
                (keys, jnp.zeros(1, keys.dtype)))[1]

        keys0 = jax.device_put(rng.integers(0, n, lanes, dtype=np.int64))
        bench("argsort64", jax.jit(run_sort), keys0)
        keys32 = jax.device_put(
            rng.integers(0, 1 << 31, lanes, dtype=np.int32))
        bench("argsort32", jax.jit(run_sort), keys32)

    # --- index-LOCALITY sensitivity: random vs near-sorted lanes ---------
    # Hypothesis behind the pred-sorted query engine: per-take cost at
    # multi-GB operands is HBM-page-locality bound, so gathering with
    # SORTED per-lane indices (what lanes look like after a counting sort
    # by predicted rank) is much cheaper than random. Chain keeps order:
    # each round adds a small content-derived drift.
    if "sorted" in which or "randref" in which:
        gb = [float(s) for s in str(kv.get("gb", "12.4")).split(",")]
        for g in gb:
            m = int(g * (1 << 30) / 4)

            def mk(mname, m=m):
                dev = jax.jit(
                    lambda: (jnp.arange(m, dtype=jnp.uint32)
                             * jnp.uint32(2654435761)) & jnp.uint32(63))()

                def take1(ix, dev):
                    return jnp.take(dev, ix.astype(jnp.int32))

                def run(i0, dev):
                    def body(_, ix):
                        v = take1(ix, dev)
                        return jnp.minimum(ix + v.astype(jnp.int64),
                                           m - 1)
                    return jax.lax.fori_loop(0, iters, body, i0)

                return jax.jit(run), dev

            if "randref" in which:
                fn, dev = mk("rand")
                i0 = jax.device_put(
                    rng.integers(0, m - 64 * iters, lanes,
                                 dtype=np.int64))
                bench(f"rand {g:5.2f}G", fn, i0, dev)
                del dev
            if "sorted" in which:
                fn, dev = mk("sorted")
                i0 = jax.device_put(np.sort(
                    rng.integers(0, m - 64 * iters, lanes,
                                 dtype=np.int64)))
                bench(f"sort {g:5.2f}G", fn, i0, dev)
                del dev
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
