"""Index-sharded query execution: genomes bigger than one device's memory.

The data-parallel engine (parallel.query) replicates the index per device
— fine up to GRCh38 scale (~13 GB of hot arrays), but the
reference's largest published benchmark genome is wheat at 14.3 Gbp
(reference: eval/TimingPlot/plot.py:16), whose rank array alone is 72 GB
at 40-bit positions. The reference handles that scale by int64-patching
libdivsufsort (reference: suffixarray/refToSuffixArray.sh:12) and paying
~369 s per 5M queries on one CPU thread; the answer here is to
shard the big per-RANK arrays (rev, probe prefixes) by contiguous
suffix-array rank ranges over a mesh axis "idx", keep the small packed
genome + PWL table replicated, and combine each probe's local masked
gather with one psum over "idx" (NCCL over NVLink on GPUs).

Why this is fast: probes for ranks owned elsewhere gather local index 0
(cached — no device-memory traffic), so total gather traffic per probe round equals
the replicated engine's, split across the shards; the only added cost is
one [B]-sized psum per gather. Decision sequences are untouched, so
results are bit-identical to the single-device engine (and hence to the
reference).

Composes with data parallelism on a 2-D ("dp", "idx") mesh: query lanes
shard over "dp", every dp row holds one full copy of the index spread
over its "idx" columns.

Memory budget, wheat 14.3 Gbp on idx=4 (arithmetic from the shapes):
  rev as SplitRanks (uint32 lo + uint8 hi = 5 B/rank) sharded  -> 17.9 GB
  packed 2-bit genome, replicated                              ->  3.6 GB
  PWL table 2^26 buckets int64 x+y, replicated                 ->  1.1 GB
  total per device                                             ~ 22.6 GB
(per-rank prefix arrays are the first thing to drop at this scale;
SaplingIndex.build already gates them on cfg.prefix_max_n.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import pack as packops
from ..ops.query import SplitRanks, binsearch_batch, plquery_batch
from .mesh import pad_to_multiple


def _pad_1d(a: np.ndarray, total: int) -> np.ndarray:
    """Zero-pad a 1-D array up to `total` entries (equal-sized shards).
    Padding ranks are never probed: every probed rank is < n."""
    if a.shape[0] == total:
        return a
    out = np.zeros(total, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


class IndexShardedEngine:
    """Rank-sharded query engine over a ("dp", "idx") mesh.

    Same query surface as SaplingIndex / ShardedQueryEngine; the per-rank
    arrays live sharded by contiguous rank range over `idx_axis`, query
    batches shard over `dp_axis`, and all probes combine with psum over
    the index axis (ops.query.make_take). rev_storage:
      "flat"  — keep the index's storage dtype (uint32 up to 4.3 Gbp);
      "split" — 5 B/rank SplitRanks for 40-bit positions (>= 4.3 Gbp);
      "auto"  — flat when positions fit uint32, else split.
    """

    def __init__(self, index, mesh: Mesh, *, idx_axis: str = "idx",
                 dp_axis: str = "dp", rev_storage: str = "auto",
                 use_prefix: bool = True):
        self.index = index
        self.mesh = mesh
        self.idx_axis = idx_axis
        self.dp_axis = dp_axis
        nsh = mesh.shape[idx_axis]
        n = index.n
        self.shard_size = -(-n // nsh)
        total = nsh * self.shard_size
        rep = NamedSharding(mesh, P())
        shd = NamedSharding(mesh, P(idx_axis))

        rev = np.asarray(index.rev)
        if rev_storage == "auto":
            rev_storage = ("split" if n > np.iinfo(np.uint32).max - 1
                           else "flat")
        if getattr(index, "rev_hi", None) is not None:
            # v4 split-limb index: limbs are already stored separately —
            # shard them directly, no 8-byte int64 temp at wheat scale
            self.rev = SplitRanks(
                lo=jax.device_put(_pad_1d(rev, total), shd),
                hi=jax.device_put(_pad_1d(index.rev_hi, total), shd),
            )
        elif rev_storage == "split":
            rev64 = rev.astype(np.int64)
            self.rev = SplitRanks(
                lo=jax.device_put(
                    _pad_1d((rev64 & 0xFFFFFFFF).astype(np.uint32), total),
                    shd),
                hi=jax.device_put(
                    _pad_1d((rev64 >> 32).astype(np.uint8), total), shd),
            )
        elif rev_storage == "flat":
            self.rev = jax.device_put(_pad_1d(rev, total), shd)
        else:
            raise ValueError(f"rev_storage={rev_storage!r}")
        self.prefix = (
            jax.device_put(_pad_1d(index.prefix64, total), shd)
            if use_prefix and index.prefix64 is not None else None)
        self.prefix3 = (
            jax.device_put(_pad_1d(index.prefix3, total), shd)
            if use_prefix and index.prefix3 is not None else None)
        pk = (packops.words_to_u64(index.packed)
              if self.prefix is None else index.packed)
        self.packed = jax.device_put(pk, rep)
        t = index.table
        self.xlist = jax.device_put(t.xlist, rep)
        self.ylist = jax.device_put(t.ylist, rep)
        # per-BUCKET bounds are small -> replicated; probes stay local
        self.bounds = (jax.device_put(t.bounds, rep)
                       if t.bounds is not None else None)
        self._fns: dict = {}

    # --- internals ----------------------------------------------------------

    def _shard_spec(self) -> tuple[str, int]:
        return (self.idx_axis, self.shard_size)

    def _pack_batch(self, codes2d: np.ndarray):
        """Pack + pad a [B, L] batch for dp sharding. Pad lanes are
        all-A queries whose outputs are dropped."""
        idx = self.index
        ndp = self.mesh.shape[self.dp_axis]
        length = int(codes2d.shape[1])
        q_words = packops.pack_queries(codes2d)           # [WQ, B]
        qw_t, b = pad_to_multiple(np.ascontiguousarray(q_words.T), ndp, 0)
        q_words = np.ascontiguousarray(qw_t.T)
        x, _ = pad_to_multiple(
            packops.batch_kmers_adjusted(codes2d, idx.k), ndp, 0)
        use3 = (self.prefix3 is not None
                and length <= min(idx.k, packops.P3_BASES))
        q3 = None
        if use3:
            q3, _ = pad_to_multiple(packops.pack_queries3(codes2d), ndp, 0)
        return q_words, x, q3, b, length

    def _sharded_call(self, kind: str, length: int, use3: bool,
                      max_stride_steps: int, adaptive_bounds: bool = False):
        """Build (and cache) the shard_map-wrapped kernel for one query
        shape class. The inner plquery/binsearch jit caches per shape; the
        outer jit caches the shard_map wrapping."""
        key = (kind, length, use3, max_stride_steps, adaptive_bounds)
        if key in self._fns:
            return self._fns[key]
        idx = self.index
        t = idx.table
        dp, ia = self.dp_axis, self.idx_axis
        spec = self._shard_spec()

        names = ["packed", "rev", "xlist", "ylist", "q_words", "x"]
        specs = [P(), P(ia), P(), P(), P(None, dp), P(dp)]
        if kind == "plquery":
            if self.prefix is not None:
                names.append("prefix")
                specs.append(P(ia))
            if use3:
                names += ["prefix3", "q3"]
                specs += [P(ia), P(dp)]
            if adaptive_bounds:
                names.append("bounds")
                specs.append(P())

        def shard_fn(*a):
            kw = dict(zip(names, a))
            if kind == "binsearch":
                return binsearch_batch(
                    kw["packed"], kw["rev"], kw["q_words"],
                    n=idx.n, length=length, shard_spec=spec)
            return plquery_batch(
                kw["packed"], kw["rev"], kw["xlist"], kw["ylist"],
                kw["q_words"], kw["x"], kw.get("prefix"),
                kw.get("prefix3"), kw.get("q3"), kw.get("bounds"),
                n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
                most_over=t.most_over, most_under=t.most_under,
                max_over=t.max_over, max_under=t.max_under,
                max_stride_steps=max_stride_steps, shard_spec=spec,
                adaptive_bounds=adaptive_bounds,
                # compaction composes with index sharding: probe outcomes
                # are psum'd, hence identical on every idx shard, so the
                # compacted masks/indices stay uniform and the per-round
                # psums line up (compact_unresolved's cond-gated fallback
                # is likewise uniform: its predicate derives from psum'd
                # probe results)
                compact_escalate=True,
                compact_unresolved=not adaptive_bounds)

        fn = jax.jit(jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=tuple(specs), out_specs=P(dp)))
        self._fns[key] = (fn, names)
        return fn, names

    def _base_args(self, names, q_words, x, q3):
        by_name = {
            "packed": self.packed, "rev": self.rev, "xlist": self.xlist,
            "ylist": self.ylist, "q_words": q_words, "x": x,
            "prefix": self.prefix, "prefix3": self.prefix3, "q3": q3,
            "bounds": self.bounds,
        }
        return [by_name[nm] for nm in names]

    # --- queries ------------------------------------------------------------

    def query_positions(self, codes2d: np.ndarray,
                        max_stride_steps: int = 1 << 20,
                        adaptive_bounds: bool = False) -> np.ndarray:
        """[B, L] base codes -> [B] genome positions; bit-identical to
        SaplingIndex.query_positions (same decision sequence, distributed
        gathers). adaptive_bounds: see ops.query.plquery_batch (flagged
        search-order variant)."""
        q_words, x, q3, b, length = self._pack_batch(codes2d)
        use3 = q3 is not None
        fn, names = self._sharded_call("plquery", length, use3,
                                       max_stride_steps, adaptive_bounds)
        out = fn(*self._base_args(names, q_words, x, q3))
        return np.asarray(out)[:b]

    def query_positions_binsearch(self, codes2d: np.ndarray) -> np.ndarray:
        q_words, x, _q3, b, length = self._pack_batch(codes2d)
        fn, names = self._sharded_call("binsearch", length, False, 0)
        out = fn(*self._base_args(names, q_words, x, None))
        return np.asarray(out)[:b]
