#!/usr/bin/env python
"""Learned-residual research pipeline: sample -> preprocess -> fit -> test.

One command replacing the reference's four-stage NN/ pipeline
(reference: NN/sampleSa.cpp + sort/awk preprocessing per NN/README.md:11-27,
NN/preprocess.py, NN/fit.py — one process PER chunk —, NN/test.py):

    python tools/nn_pipeline.py <genome.fa> [k=21] [chunks=100]
        [layer_size=8] [hidden_layers=1] [epochs=500] [batch=0]
        [out=<dir>]

All chunks train simultaneously as one vmapped JAX program
(sapling_tpu.models.residual); prints the same error metrics in
suffix-array rows that NN/test.py reports (mean + percentiles).
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main(argv):
    import jax

    from sapling_tpu.config import IndexConfig, parse_keyval_args
    from sapling_tpu.evalx.sa_sample import sample_sa
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.models import residual

    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    k = int(kv.get("k", 21))
    chunks = int(kv.get("chunks", 100))
    layer = int(kv.get("layer_size", 8))
    hidden = int(kv.get("hidden_layers", 1))
    epochs = int(kv.get("epochs", 500))
    batch = int(kv.get("batch", 0)) or None
    out = kv.get("out")

    idx = SaplingIndex.from_fasta(argv[1], IndexConfig(k=k))
    ranks, kmers = sample_sa(idx.codes, idx.inv, k=k)
    print(f"sampled {kmers.shape[0]} (rank, kmer) pairs")
    ds = residual.prepare_dataset(kmers, ranks, chunks)
    print(f"dataset: {ds.x.shape[0]} chunks x {ds.x.shape[1]} points")
    if batch is None and ds.x.size > (1 << 24):
        # full-batch training materializes [chunks, per, layer] f64
        # activations per epoch, which outgrows device memory at tens of
        # millions of samples. Fall back to the reference's own minibatch
        # regime (NN/fit.py batch=64; bigger here since all
        # chunks train in one vmapped step).
        batch = 2048
        print(f"dataset too large for full-batch training on one device; "
              f"using batch={batch} (override with batch=N)")
    trainer = residual.Trainer.create(
        jax.random.PRNGKey(0), num_chunks=ds.x.shape[0],
        layer_size=layer, hidden_layers=hidden)
    losses = trainer.fit(ds, epochs=epochs, batch=batch,
                         log=lambda m: print(m, flush=True))
    stopped = int((trainer.stop_epochs >= 0).sum())
    print(f"trained {len(losses)} epochs, final mean loss "
          f"{losses[-1].mean():.6f} ({stopped}/{losses.shape[1]} chunks "
          f"early-stopped)")
    rows = trainer.predict_rows(ds)
    order = np.argsort(kmers, kind="stable")
    true_rows = ranks[order].astype(np.float64)
    metrics = residual.error_percentiles(rows, true_rows)
    for key, v in metrics.items():
        print(f"  {key}: {v:,.1f} rows")
    if out:
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, "loss.npy"), losses)
        np.savez(os.path.join(out, "model.npz"),
                 **{f"p{i}_{n}": np.asarray(layer_p[n])
                    for i, layer_p in enumerate(trainer.params)
                    for n in ("w", "b")})
        print(f"wrote {out}/loss.npy and {out}/model.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
