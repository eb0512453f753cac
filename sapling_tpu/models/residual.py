"""Learned residual models: the NN/ research pipeline, as batched JAX.

The reference trains ONE PyTorch MLP per suffix-array chunk in a separate
process per chunk (reference: NN/fit.py:185-277 — MLP 1->s->...->1 with
ReLU, Adam, MSE, batch 64, convergence-window early stop), after a NumPy
preprocessing step that scales k-mer values to [0,1] and regresses the
residual against the straight line through the first and last points
(reference: NN/preprocess.py:97-131). Evaluation un-scales predictions
back to suffix-array rows and reports error percentiles
(reference: NN/test.py:171-215).

Here the ENTIRE per-chunk family trains as one jitted program: parameters
are stacked [C, ...] pytrees, the forward/backward is vmapped over chunks,
and one optimizer step updates every chunk at once. On a device mesh the
chunk axis shards over "dp" and the hidden dimension over "tp" (XLA
inserts the psum for the hidden contraction). This replaces C sequential
process launches with a single SPMD training step.

As in the reference, these models are research artifacts: the production
query path remains the PWL index (sapling_tpu.index.pwl).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax


@dataclass
class ResidualDataset:
    """Scaled per-chunk training tensors + the constants to un-scale.

    x:   float32 [C, S, 1]  k-mer values scaled to [0, 1]
    res: float32 [C, S, 1]  residual-vs-line targets scaled to [0, 1]
    valid: bool [C, S]      mask (last chunk may be ragged)
    """

    x: np.ndarray
    res: np.ndarray
    valid: np.ndarray
    res_min: float
    res_ptp: float
    line_m: float
    line_c: float
    x_max: float

    def unscale_to_rows(self, pred_scaled: np.ndarray, x_scaled: np.ndarray):
        """Predicted scaled residual -> predicted suffix-array row
        (reference: NN/test.py:182-185: res = pred*ptp + min; row =
        line(x) - res)."""
        res = pred_scaled * self.res_ptp + self.res_min
        line = x_scaled * self.line_m + self.line_c
        return line - res


def prepare_dataset(kmers: np.ndarray, ranks: np.ndarray, num_chunks: int,
                    sample_stride: int = 1) -> ResidualDataset:
    """Sort (kmer, rank) pairs by kmer, scale, regress out the straight
    line, and chunk — the preprocess.py pipeline as one vectorized pass.

    kmers/ranks: the (SA rank, kmer value) pairs the reference dumps with
    NN/sampleSa.cpp:42-74 and sorts with `sort -k2,2` (NN/README.md:14).
    """
    order = np.argsort(kmers, kind="stable")
    xs = kmers[order][::sample_stride].astype(np.float64)
    ys = ranks[order][::sample_stride].astype(np.float64)
    m_total = xs.shape[0]
    x_max = float(xs.max()) if m_total else 1.0
    x = xs / x_max
    # straight line through first and last points (preprocess.py:104-110)
    dx = x[-1] - x[0]
    m = (ys[-1] - ys[0]) / (dx if dx else 1.0)
    c = ys[0] - x[0] * m
    true_res = (x * m + c) - ys
    res_min = float(true_res.min())
    res_ptp = float(np.ptp(true_res)) or 1.0
    res = (true_res - res_min) / res_ptp

    # Exactly num_chunks equal-shaped chunks; the reference gives the ragged
    # tail to the last model (fit.py:139-155), we pad + mask it instead so
    # shapes stay static for one vmapped program.
    c_count = max(1, min(num_chunks, m_total))
    s = (m_total + c_count - 1) // c_count
    pad = c_count * s - m_total
    valid = np.ones(m_total, dtype=bool)

    def _pad(a):
        return np.concatenate([a, np.zeros(pad, a.dtype)]).reshape(c_count, s)

    return ResidualDataset(
        x=_pad(x.astype(np.float32))[..., None],
        res=_pad(res.astype(np.float32))[..., None],
        valid=_pad(valid),
        res_min=res_min, res_ptp=res_ptp, line_m=float(m), line_c=float(c),
        x_max=x_max,
    )


def init_params(rng: jax.Array, num_chunks: int, layer_size: int,
                hidden_layers: int = 1) -> list[dict[str, Any]]:
    """Stacked per-chunk MLP parameters: 1 -> s -> (s ...) -> 1.

    Matches the reference architecture (fit.py:185-209) with PyTorch's
    default Kaiming-uniform init so loss trajectories are comparable.
    """
    dims = [1] + [layer_size] * hidden_layers + [1]
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        rng, kw, kb = jax.random.split(rng, 3)
        bound = 1.0 / np.sqrt(din)
        params.append({
            "w": jax.random.uniform(kw, (num_chunks, din, dout),
                                    minval=-bound, maxval=bound),
            "b": jax.random.uniform(kb, (num_chunks, dout),
                                    minval=-bound, maxval=bound),
        })
    return params


def forward(params, x):
    """Vmapped-over-chunks MLP forward: x [C, B, 1] -> [C, B, 1]."""
    h = x
    for i, layer in enumerate(params):
        h = jnp.einsum("cbi,cio->cbo", h, layer["w"]) + layer["b"][:, None, :]
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


def mse_loss(params, x, y, valid):
    pred = forward(params, x)
    se = jnp.squeeze((pred - y) ** 2, -1) * valid
    return se.sum() / jnp.maximum(valid.sum(), 1)


def mse_loss_per_chunk(params, x, y, valid):
    """Per-chunk MSE [C] — each chunk normalized by its own valid count,
    exactly the loss each of the reference's independent per-chunk
    training processes sees (fit.py:211,238)."""
    pred = forward(params, x)
    se = jnp.squeeze((pred - y) ** 2, -1) * valid
    return se.sum(axis=1) / jnp.maximum(valid.sum(axis=1), 1)


@dataclass
class Trainer:
    """All-chunks-at-once trainer with the reference's convergence rule."""

    params: Any
    opt: optax.GradientTransformation
    opt_state: Any

    @classmethod
    def create(cls, rng, num_chunks: int, layer_size: int,
               hidden_layers: int = 1, lr: float = 1e-3):
        params = init_params(rng, num_chunks, layer_size, hidden_layers)
        opt = optax.adam(lr)  # fit.py:214 uses Adam defaults
        return cls(params=params, opt=opt, opt_state=opt.init(params))

    def train_step(self):
        opt = self.opt

        @jax.jit
        def step(params, opt_state, x, y, valid):
            loss, grads = jax.value_and_grad(mse_loss)(params, x, y, valid)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        return step

    def _masked_step(self):
        """One vmapped training step over all chunks with PER-CHUNK
        freezing: `active` [C] gates both the parameter update and the
        optimizer-state advance, so a converged chunk's training stops
        exactly as the reference's independent per-chunk process would
        (fit.py:259-277 breaks out of that chunk's loop). Per-chunk best
        params/losses track on device (fit.py:252-258)."""
        opt = self.opt

        @jax.jit
        def step(params, opt_state, best_loss, best_params, x, y, valid,
                 active):
            def total(p):
                lv = mse_loss_per_chunk(p, x, y, valid)
                return lv.sum(), lv

            grads, lv = jax.grad(total, has_aux=True)(params)
            updates, new_opt = opt.update(grads, opt_state)
            new_params = optax.apply_updates(params, updates)
            c = active.shape[0]

            def keep_active(new, old):
                # every param leaf (and Adam's mu/nu mirrors of them) is
                # chunk-major [C, ...] by construction (init_params);
                # non-chunk leaves (e.g. Adam's scalar step count) pass
                # through. Guarded against a non-chunk-major optimizer
                # leaf whose leading dim coincidentally equals C: params
                # themselves are always [C, ...], and mu/nu share the
                # param treedef, so shape[0]==c on a param-shaped leaf is
                # definitionally chunk-major. For any OTHER optimizer
                # (non-Adam) whose extra state is [C]-leading but not
                # chunk-major, this heuristic would mis-gate — assert the
                # optimizer state only carries param-shaped or scalar
                # leaves.
                if new.ndim and new.shape[0] == c:
                    a = active.reshape((c,) + (1,) * (new.ndim - 1))
                    return jnp.where(a, new, old)
                return new  # e.g. Adam's scalar step count

            param_shapes = {l.shape for l in jax.tree.leaves(params)}
            for leaf in jax.tree.leaves(opt_state):
                if (leaf.ndim and leaf.shape[0] == c
                        and leaf.shape not in param_shapes):
                    raise ValueError(
                        "optimizer state has a C-leading leaf of "
                        f"non-param shape {leaf.shape}; _masked_step "
                        "assumes all C-leading leaves are chunk-major "
                        "(use Adam, or extend keep_active)")
            params2 = jax.tree.map(keep_active, new_params, params)
            opt2 = jax.tree.map(keep_active, new_opt, opt_state)
            improved = active & (lv < best_loss)
            best_loss2 = jnp.where(improved, lv, best_loss)
            best_params2 = jax.tree.map(
                lambda p, bp: jnp.where(
                    improved.reshape((c,) + (1,) * (p.ndim - 1)), p, bp),
                params2, best_params)
            return params2, opt2, best_loss2, best_params2, lv

        return step

    def fit(self, ds: ResidualDataset, epochs: int = 500,
            convergence_window: int = 50, convergence_threshold: float = 0.1,
            batch: int | None = None, seed: int = 0, log=None):
        """Training loop with the reference's early stop applied PER
        CHUNK: chunk c stops when the best loss in ITS trailing window
        improves on ITS prior best by less than threshold*prior
        (fit.py:259-277 — each chunk is an independent process there).
        Minibatch indices are likewise drawn per chunk
        (rng key [seed, epoch, c]; the reference's DataLoader shuffles
        per process, fit.py:180-183).

        Returns the loss history [epochs_run, C]; per-chunk stop epochs
        land in self.stop_epochs (-1 = ran the full budget)."""
        step = self._masked_step()
        x, y = ds.x, ds.res
        valid = ds.valid.astype(np.float32)
        c_count, s = x.shape[0], x.shape[1]
        bs = min(batch, s) if batch else s
        params, opt_state = self.params, self.opt_state
        best_loss = jnp.full((c_count,), np.inf, jnp.float32)
        best_params = params
        active_np = np.ones(c_count, dtype=bool)
        self.stop_epochs = np.full(c_count, -1, dtype=np.int64)
        hist = np.empty((epochs, c_count), dtype=np.float64)
        n_done = 0
        for epoch in range(epochs):
            if bs < s:
                sel = np.stack([
                    np.random.default_rng([seed, epoch, ci])
                    .choice(s, size=bs, replace=False)
                    for ci in range(c_count)])
                xb = np.take_along_axis(x, sel[:, :, None], axis=1)
                yb = np.take_along_axis(y, sel[:, :, None], axis=1)
                vb = np.take_along_axis(valid, sel, axis=1)
            else:
                xb, yb, vb = x, y, valid
            params, opt_state, best_loss, best_params, lv = step(
                params, opt_state, best_loss, best_params,
                jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(vb),
                jnp.asarray(active_np))
            hist[epoch] = np.asarray(lv)
            n_done = epoch + 1
            if log and epoch % 50 == 0:
                log(f"epoch {epoch} mean loss {hist[epoch].mean():.6f} "
                    f"({int(active_np.sum())}/{c_count} chunks active)")
            if epoch > convergence_window:
                # reference slices exclude the current epoch's entry
                # (fit.py:262-264: loss_list[:epoch-w], [epoch-w:epoch])
                prior = hist[: epoch - convergence_window].min(axis=0)
                window = hist[epoch - convergence_window : epoch].min(axis=0)
                stop = active_np & (prior - window
                                    < convergence_threshold * prior)
                self.stop_epochs[stop] = epoch
                active_np &= ~stop
                if not active_np.any():
                    break
        self.params, self.opt_state = best_params, opt_state
        return hist[:n_done]

    def predict_rows(self, ds: ResidualDataset) -> np.ndarray:
        """Predict suffix-array rows for the whole dataset
        (test.py:171-188)."""
        pred = np.asarray(forward(self.params, jnp.asarray(ds.x)))
        rows = ds.unscale_to_rows(pred[..., 0], ds.x[..., 0])
        return rows[ds.valid]


def error_percentiles(pred_rows: np.ndarray, true_rows: np.ndarray,
                      pcts=(50, 75, 90, 95, 99, 100)) -> dict[str, float]:
    """Error metrics in suffix-array rows (reference: NN/test.py:191-215)."""
    err = np.abs(pred_rows - true_rows)
    out = {"mean": float(err.mean())}
    for p in pcts:
        out[f"p{p}"] = float(np.percentile(err, p))
    return out


def shard_for_mesh(trainer: Trainer, ds: ResidualDataset, mesh):
    """Place stacked params and data for SPMD training: chunk axis over
    "dp", hidden units over "tp" (first layer output / last layer input),
    data over "dp"."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    p = trainer.params
    sharded = []
    last = len(p) - 1
    for i, layer in enumerate(p):
        wspec = P("dp", None, "tp") if i < last else P("dp", "tp", None)
        bspec = P("dp", "tp") if i < last else P("dp", None)
        sharded.append({"w": put(layer["w"], wspec), "b": put(layer["b"], bspec)})
    trainer.params = sharded
    trainer.opt_state = trainer.opt.init(sharded)
    x = put(jnp.asarray(ds.x), P("dp", None, None))
    y = put(jnp.asarray(ds.res), P("dp", None, None))
    v = put(jnp.asarray(ds.valid, jnp.float32), P("dp", None))
    return x, y, v
