"""Data-parallel sharded query execution.

The equivalent of running N independent copies of the reference's
single-threaded query loop (reference: src/sapling_example.cpp:133-141),
expressed as ONE pjit-ed program: query lanes shard over the mesh "dp"
axis, the index arrays (packed genome, rev, PWL table) are replicated, and
XLA compiles the same predict -> window -> masked-binary-search program
per shard with no cross-device traffic on the query path. Collectives
appear only in the statistics reductions (psum of error histograms / hit
counts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.query import plquery_batch
from .mesh import dp_sharded, pad_to_multiple, replicated


class ShardedQueryEngine:
    """Holds replicated device arrays + runs dp-sharded query batches.

    Equivalent role to one `Sapling` struct shared by N workers; here the
    hot arrays are placed once with a replicated sharding and each
    query_positions call shards its batch over "dp".
    """

    def __init__(self, index, mesh: Mesh, use_pred2: bool = False):
        self.index = index
        self.mesh = mesh
        rep = replicated(mesh)
        t = index.table
        self.prefix = (jax.device_put(index.prefix64, rep)
                       if index.prefix64 is not None else None)
        self.prefix3 = (jax.device_put(index.prefix3, rep)
                        if index.prefix3 is not None else None)
        from ..ops import pack as packops

        pk = (packops.words_to_u64(index.packed)
              if index.prefix64 is None else index.packed)
        self.packed = jax.device_put(pk, rep)
        self.rev = jax.device_put(index.rev, rep)
        if use_pred2:
            # flag-off variant: 2-gather prediction measured slower end
            # to end despite fewer ops (ops.predict.pack_pred2)
            from ..ops.predict import pack_pred2

            p2 = pack_pred2(t.xlist, t.ylist, 2 * index.k)
            if p2 is None:
                raise ValueError("table does not fit the pack_pred2 "
                                 "bit budget")
            self.xlist = self.ylist = None
            self.pred2 = (jax.device_put(p2[0], rep),
                          jax.device_put(p2[1], rep))
            self.pred2_bits = p2[2]
        else:
            self.xlist = jax.device_put(t.xlist, rep)
            self.ylist = jax.device_put(t.ylist, rep)
            self.pred2 = None
            self.pred2_bits = None
        self._fns: dict = {}

    def _dp_call(self, length: int, use3: bool, max_stride_steps: int):
        """Build (and cache) the shard_map-wrapped kernel for one query
        shape class. shard_map — not plain GSPMD sharding — so each dp
        shard compacts its own escalated tail locally (ops.query
        compact_escalate needs a local nonzero; under GSPMD that would be
        a cross-device gather). The query path still has zero collectives."""
        key = (length, use3, max_stride_steps)
        if key in self._fns:
            return self._fns[key]
        idx = self.index
        t = idx.table
        # compact_unresolved/compact_escalate below run per-shard: each dp
        # shard compacts its own unresolved lanes locally (a GSPMD-global
        # compaction would force a cross-device gather)
        names = ["packed", "rev", "q_words", "x"]
        specs = [P(), P(), P(None, "dp"), P("dp")]
        for nm in ("xlist", "ylist", "prefix", "pred2"):
            if getattr(self, nm) is not None:
                names.append(nm)
                specs.append(P())
        if use3:
            names += ["prefix3", "q3"]
            specs += [P(), P("dp")]

        def shard_fn(*a):
            kw = dict(zip(names, a))
            return plquery_batch(
                kw["packed"], kw["rev"], kw.get("xlist"), kw.get("ylist"),
                kw["q_words"], kw["x"], kw.get("prefix"),
                kw.get("prefix3"), kw.get("q3"), pred2=kw.get("pred2"),
                pred2_bits=self.pred2_bits,
                n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
                most_over=t.most_over, most_under=t.most_under,
                max_over=t.max_over, max_under=t.max_under,
                max_stride_steps=max_stride_steps,
                compact_escalate=True, compact_unresolved=True)

        fn = jax.jit(jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=tuple(specs), out_specs=P("dp")))
        self._fns[key] = (fn, names)
        return fn, names

    def query_positions(self, codes2d: np.ndarray, max_stride_steps: int = 1 << 20):
        """[B, L] base codes -> [B] genome positions, dp-sharded."""
        from ..ops import pack as packops

        idx = self.index
        ndp = self.mesh.shape["dp"]
        length = int(codes2d.shape[1])
        q_words = packops.pack_queries(codes2d)  # [WQ, B] word-major
        x = packops.batch_kmers_adjusted(codes2d, idx.k)
        q_words_p, b = pad_to_multiple(
            np.ascontiguousarray(q_words.T), ndp, 0)
        q_words = np.ascontiguousarray(q_words_p.T)
        x, _ = pad_to_multiple(x, ndp, 0)
        qs = jax.device_put(q_words,
                            NamedSharding(self.mesh, P(None, "dp")))
        xs = jax.device_put(x, dp_sharded(self.mesh, 1))
        use3 = (self.prefix3 is not None
                and length <= min(idx.k, packops.P3_BASES))
        q3s = None
        if use3:
            q3, _ = pad_to_multiple(packops.pack_queries3(codes2d), ndp, 0)
            q3s = jax.device_put(q3, dp_sharded(self.mesh, 1))
        fn, names = self._dp_call(length, use3, max_stride_steps)
        by_name = {
            "packed": self.packed, "rev": self.rev, "xlist": self.xlist,
            "ylist": self.ylist, "q_words": qs, "x": xs,
            "prefix": self.prefix, "prefix3": self.prefix3, "q3": q3s,
            "pred2": self.pred2,
        }
        out = fn(*[by_name[nm] for nm in names])
        return np.asarray(out)[:b]


@functools.partial(jax.jit, static_argnames=("nbins", "mesh"))
def _hist_psum(errors, lo, width, *, nbins: int, mesh: Mesh):
    def shard_fn(e):
        b = jnp.clip((e - lo) // width, 0, nbins - 1)
        h = jnp.zeros((nbins,), jnp.int32).at[b].add(1)
        return jax.lax.psum(h, "dp")

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=P("dp"), out_specs=P(),
    )(errors)


def error_histogram(errors: np.ndarray, mesh: Mesh, nbins: int = 64,
                    lo: int | None = None, hi: int | None = None) -> np.ndarray:
    """Distributed histogram of signed prediction errors: shards count
    locally, then psum over "dp" (the reference gathers the same statistics
    serially in errorStats, src/sapling_api.h:342-379)."""
    errors = np.asarray(errors, dtype=np.int64)
    lo = int(errors.min()) if lo is None else lo
    hi = int(errors.max()) + 1 if hi is None else hi
    width = max(1, (hi - lo + nbins - 1) // nbins)
    ndp = mesh.shape["dp"]
    padded, b = pad_to_multiple(errors, ndp, lo)  # pad lands in bin 0
    e = jax.device_put(padded, dp_sharded(mesh))
    h = np.asarray(_hist_psum(e, lo, width, nbins=nbins, mesh=mesh))
    if padded.shape[0] != b:  # subtract the padding from bin 0
        h[0] -= padded.shape[0] - b
    return h
