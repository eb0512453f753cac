"""Serve the residual NN as the query-path predictor (flag-gated).

The reference's NN/ pipeline is offline research: fit.py trains per-chunk
MLPs and test.py reports error percentiles, but the production query
engine never consumes the model (reference: NN/README.md — the learned
index that SHIPS is the PWL table, src/sapling_api.h:384+). This module
goes one step further on that research axis: the trained residual model
(models.residual, the NN/fit.py replication) becomes the rank predictor
of the real query cascade via ops.query.plquery_batch's `pred64` seam,
with error bounds measured by the SAME audit semantics the PWL table
uses (index.pwl.error_audit / getError, src/sapling_api.h:309-337).

Correctness argument, identical to the PWL engine's: the audit bounds
(max_over/max_under) are maxima over ALL genome k-mers, so every present
query's true rank lies inside the probed window — found/-1 status is
exact for present queries no matter how well the NN trained. Which
member of a duplicate run is returned follows the predictor's search
order (as it does between different PWL bucket counts). Absent-query
status is predictor-dependent in the reference too.

Serving cost model: prediction is 4 per-lane param gathers (w1/b1/w2 rows
+ chunk lookup) of s elements each — O(s) gather-lanes per query vs the
PWL's 3 fixed gathers. The NN engine pays that for a (potentially) much
tighter `most` window; tools/bench_nn_query.py is the A/B.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..index.pwl import ErrorAudit, error_stats
from ..ops import pack as packops
from ..ops.query import plquery_batch
from .residual import Trainer, prepare_dataset


@dataclass
class NNServing:
    """Trained per-chunk residual model + everything needed to serve it
    as a rank predictor: chunk x-boundaries, un-scaling constants, and
    the audit-derived error windows."""

    params: list                 # stacked [C, ...] pytree (host or device)
    xb: np.ndarray               # float32 [C] first scaled-x per chunk
    x_max: float
    res_min: float
    res_ptp: float
    line_m: float
    line_c: float
    n: int
    k: int
    # audit-derived windows (error_stats semantics, like the PWL table)
    most_over: int = 1
    most_under: int = 1
    max_over: int = 2
    max_under: int = 2

    def predict_ranks(self, x):
        """[B] int64 adjusted k-mer values -> [B] int64 predicted ranks.

        Traceable (used inside the jitted query program). Chunk routing
        is a searchsorted over the C chunk boundaries; the per-lane MLP
        gathers each lane's chunk parameters (hidden_layers == 1 only —
        the reference default architecture, fit.py:185-209) and runs the
        1 -> s -> 1 forward in float32 exactly as training/audit did;
        un-scaling runs in float64 (ranks exceed f32's 2^24 integer
        range at Gbp scale)."""
        if len(self.params) != 2:
            raise NotImplementedError(
                "serving supports the reference default architecture "
                "(hidden_layers == 1) only")
        w1, b1, w2, b2 = (jnp.asarray(a) for a in (
            self.params[0]["w"], self.params[0]["b"],    # [C,1,s],[C,s]
            self.params[1]["w"], self.params[1]["b"]))   # [C,s,1],[C,1]
        xs64 = x.astype(jnp.float64) / self.x_max
        xs = xs64.astype(jnp.float32)
        c = jnp.clip(
            jnp.searchsorted(jnp.asarray(self.xb), xs, side="right") - 1,
            0, self.xb.shape[0] - 1)
        h = jax.nn.relu(xs[:, None] * w1[c, 0, :] + b1[c])       # [B, s]
        res = jnp.sum(h * w2[c, :, 0], axis=1) + b2[c, 0]        # [B]
        rows = (xs64 * self.line_m + self.line_c) - (
            res.astype(jnp.float64) * self.res_ptp + self.res_min)
        return jnp.clip(jnp.round(rows), 0, self.n - 1).astype(jnp.int64)


def train_serving(index, num_chunks: int = 64, layer_size: int = 16,
                  epochs: int = 300, sample_stride: int = 1,
                  seed: int = 0, log=None) -> NNServing:
    """Train the residual family on an index's (k-mer, rank) stream and
    package it for serving. sample_stride > 1 trains on a subsample (the
    reference's sampleSa stride, NN/sampleSa.cpp:42-74) — the audit
    below still covers every k-mer, so bounds stay exact."""
    if index.codes is None or index.inv is None or not len(index.inv):
        raise ValueError("index needs host codes + full inv to train")
    kmers = packops.kmers_scan(index.codes, index.k)
    ranks = np.asarray(index.inv[: kmers.shape[0]], dtype=np.int64)
    ds = prepare_dataset(kmers, ranks, num_chunks,
                         sample_stride=sample_stride)
    c_count = ds.x.shape[0]
    trainer = Trainer.create(jax.random.PRNGKey(seed), c_count, layer_size)
    trainer.fit(ds, epochs=epochs, log=log)
    params = jax.tree.map(np.asarray, trainer.params)
    # chunk boundary = first scaled x of each chunk (sorted stream)
    xb = np.asarray(ds.x[:, 0, 0], dtype=np.float32)
    srv = NNServing(
        params=params, xb=xb, x_max=ds.x_max, res_min=ds.res_min,
        res_ptp=ds.res_ptp, line_m=ds.line_m, line_c=ds.line_c,
        n=index.n, k=index.k)
    audit_serving(srv, index, kmers=kmers)
    return srv


def audit_serving(srv: NNServing, index, kmers: np.ndarray | None = None,
                  batch: int = 1 << 22) -> ErrorAudit:
    """Predict EVERY genome k-mer with the serving path and derive the
    most/max error windows — the exact getError/errorStats semantics the
    PWL audit uses (index.pwl error_audit + error_stats, reference
    src/sapling_api.h:309-379), including the bounded under-shot shift
    along lcp>=k runs. Writes the windows into srv and returns the
    audit."""
    from ..index.suffix_array import fwd_runs_from_rank_kmers

    if kmers is None:
        kmers = packops.kmers_scan(index.codes, index.k)
    inv = np.asarray(index.inv[: kmers.shape[0]], dtype=np.int64)
    fwd = fwd_runs_from_rank_kmers(kmers, index.inv, index.n)
    pred_fn = jax.jit(srv.predict_ranks)
    m = kmers.shape[0]
    errors = np.empty(m, dtype=np.int64)
    for lo in range(0, m, batch):
        hi = min(lo + batch, m)
        pred = np.asarray(pred_fn(jnp.asarray(kmers[lo:hi])))
        y = inv[lo:hi]
        runs = np.where(y < fwd.shape[0],
                        fwd[np.minimum(y, fwd.shape[0] - 1)], 0)
        y_shift = np.where(y < pred, np.minimum(pred, y + runs), y)
        errors[lo:hi] = y_shift - pred
    audit = ErrorAudit(errors=errors,
                       perfect_predictions=int((errors == 0).sum()))
    mo, mu, me, so, su = error_stats(audit)
    srv.max_over, srv.max_under = mo, mu
    srv.most_over, srv.most_under = so, su
    return audit


class NNQueryEngine:
    """SaplingIndex-shaped query front-end that predicts with the NN
    instead of the PWL table. Same cascade, same probe arrays, the NN's
    own audited windows. Flag-gated research engine (the PWL engine
    remains the default, as in the reference)."""

    def __init__(self, index, serving: NNServing):
        if serving.n != index.n or serving.k != index.k:
            raise ValueError("serving model was trained for a different "
                             f"index (n={serving.n}, k={serving.k})")
        self.idx = index
        self.srv = serving

    def query_positions(self, codes2d: np.ndarray) -> np.ndarray:
        idx, srv = self.idx, self.srv
        length = int(codes2d.shape[1])
        if length != idx.k:
            raise NotImplementedError(
                "NN engine serves length == k queries (the model is "
                "trained on the k-mer stream); use the PWL engine for "
                "other lengths")
        dev = idx.device_arrays()
        q_words = packops.pack_queries(codes2d)
        x = idx.kmerize_batch(codes2d)
        q3 = (packops.pack_queries3(codes2d)
              if dev.get("prefix3") is not None
              and length <= min(idx.k, packops.P3_BASES) else None)
        pred = srv.predict_ranks(jnp.asarray(x))
        out = plquery_batch(
            dev["packed"], dev["rev"], dev["xlist"], dev["ylist"],
            q_words, x, dev.get("prefix"), dev.get("prefix3"), q3,
            n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
            most_over=srv.most_over, most_under=srv.most_under,
            max_over=srv.max_over, max_under=srv.max_under,
            pred64=pred)
        return np.asarray(out)
