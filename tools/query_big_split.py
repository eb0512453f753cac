#!/usr/bin/env python
"""Exercise a >= 2^32-base (format-v4 split-limb) index end to end on the
virtual CPU mesh: hi limbs genuinely nonzero at scale.

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python tools/query_big_split.py <index.stpu.npz> [nq=200000] [idx=4]
        [dp=2]

Checks, in order:
  1. loads the split artifact (rev limbs stay 5 B/rank host-side);
  2. IndexShardedEngine over an ("idx", "dp") mesh queries nq random
     k-mers; every hit self-checked by substring equality (the
     reference's correctness criterion, sapling_example.cpp:143-154);
  3. a biased sample drawn from positions > 2^32 must return hi-limb
     nonzero positions exactly (the limb path does real work);
  4. single-device SplitRanks run (banked limbs) for cross-parity with
     the sharded engine;
  5. prints the per-device memory budget of what the sharded layout
     replicates vs shards at this n, beside the device's own limit.
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main(argv):
    import jax

    from sapling_tpu.config import parse_keyval_args
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.parallel.mesh import make_mesh
    from sapling_tpu.parallel.sharded_index import IndexShardedEngine

    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    nq = int(kv.get("nq", 200_000))
    n_idx = int(kv.get("idx", 4))
    n_dp = int(kv.get("dp", 2))

    t0 = time.time()
    idx = SaplingIndex.load(argv[1])
    assert idx.rev_hi is not None, "not a split-limb (v4) artifact"
    t = idx.table
    print(f"loaded n={idx.n:,} buckets=2^{idx.buckets} "
          f"most=({t.most_over},{t.most_under}) "
          f"max=({t.max_over},{t.max_under}) in {time.time()-t0:.0f}s; "
          f"{np.count_nonzero(idx.rev_hi != 0):,} ranks have hi != 0",
          flush=True)
    small = bool(int(kv.get("force_small", 0)))  # smoke-test mode only
    if not small:
        assert idx.n > 0xFFFFFFFF and (idx.rev_hi != 0).any(), \
            "hi limbs are all zero — this run would not prove anything"

    k = idx.k
    rng = np.random.default_rng(7)
    # half uniform, half drawn beyond 2^32 so hi-limb reassembly is load-
    # bearing for the answer, not just exercised
    hi_floor = 0 if small else 1 << 32
    s_uni = rng.integers(0, idx.n - k + 1, nq // 2)
    s_hi = rng.integers(hi_floor, idx.n - k + 1, nq - nq // 2)
    starts = np.concatenate([s_uni, s_hi])
    codes2d = idx.codes[starts[:, None] + np.arange(k)]

    mesh = make_mesh(n_idx * n_dp, tp=n_idx, axes=("dp", "idx"))
    print(f"mesh: {dict(mesh.shape)}", flush=True)
    eng = IndexShardedEngine(idx, mesh)
    t0 = time.time()
    pos = eng.query_positions(codes2d)
    print(f"sharded query: {nq} lanes in {time.time()-t0:.0f}s "
          f"(compile incl.)", flush=True)
    good = idx.verify_hits(codes2d, pos)
    print(f"self-check: {int(good.sum())}/{nq}")
    assert good.all(), "sharded self-check FAILED"
    hi_out = pos[nq // 2 :] >> 32
    print(f"positions with hi limb nonzero: "
          f"{int((pos >> 32 != 0).sum()):,}/{nq}")
    if not small:
        assert (hi_out != 0).any(), \
            "no returned position exercised the limb"

    # single-device SplitRanks cross-parity (banked limbs; CPU RAM backs
    # all virtual devices, so this fits where a real chip would not)
    if int(kv.get("single", 1)):
        t0 = time.time()
        pos1 = idx.query_positions(codes2d)
        print(f"single-device query: {time.time()-t0:.0f}s", flush=True)
        assert np.array_equal(np.asarray(pos1), np.asarray(pos)), \
            "sharded vs single-device positions differ"
        print("sharded == single-device: exact")

    # per-device memory budget at this n (the one-device feasibility
    # check), against the limit the device itself reports
    rep = idx.packed.nbytes + t.xlist.nbytes + t.ylist.nbytes
    shd = (idx.rev.nbytes + idx.rev_hi.nbytes) // n_idx
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    lim = (f"device limit {limit/2**30:.2f} GiB" if limit
           else "device reports no memory limit")
    print(f"memory budget/device at idx={n_idx}: replicated "
          f"{rep/2**30:.2f} GiB (packed genome + PWL table) + sharded rev "
          f"{shd/2**30:.2f} GiB = {(rep+shd)/2**30:.2f} GiB ({lim}; "
          f"one-device rev alone would be "
          f"{(idx.rev.nbytes + idx.rev_hi.nbytes)/2**30:.2f} GiB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
