#!/usr/bin/env python
"""Seed-and-extend read aligner CLI.

Usage (same argument order and key=val flags as the reference binary,
reference: src/align.cpp:28-67):

    python tools/align.py <query.fastq> <ref.fasta> <out.sam> \
        [num_seeds=7] [sapling_k=16] [flanking_sequence=2] [max_hits=32]
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from sapling_tpu.align.aligner import SeedExtendAligner
from sapling_tpu.config import AlignerConfig, IndexConfig, parse_keyval_args
from sapling_tpu.index.sapling import SaplingIndex


def main(argv):
    if len(argv) < 4:
        print(__doc__)
        return 1
    query_fn, ref_fn, out_fn = argv[1], argv[2], argv[3]
    kv = parse_keyval_args(argv[4:])
    cfg = AlignerConfig(
        num_seeds=int(kv.get("num_seeds", 7)),
        sapling_k=int(kv.get("sapling_k", 16)),
        flanking=int(kv.get("flanking_sequence", 2)),
        max_hits=int(kv.get("max_hits", 32)),
    )
    idx = SaplingIndex.from_fasta(ref_fn, IndexConfig(k=cfg.sapling_k))
    aligner = SeedExtendAligner(idx, cfg)
    cl = " ".join(argv)
    aligner.align_fastq(query_fn, out_fn, cl=cl)
    print(f"wrote {out_fn}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
