#!/usr/bin/env python
"""Rewrite a saved index artifact with a retabled PWL table, in place.

    python tools/swap_table_artifact.py <index.stpu.npz> <table.npz>

The table npz comes from tools/retable_index.py (table-only output).
The artifact is loaded via mmap (members stream through, ~no RAM), the
table is swapped, and the artifact is atomically replaced (write to
.tmp, rename), so the artifact carries its best-measured table.
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main(argv):
    from sapling_tpu.index.pwl import PwlTable
    from sapling_tpu.index.sapling import SaplingIndex
    from sapling_tpu.io.artifacts import load_npz

    if len(argv) != 3:
        print(__doc__)
        return 1
    src, tab = argv[1], argv[2]
    t0 = time.time()
    z = load_npz(tab)
    idx = SaplingIndex.load(src, mmap=True)
    if int(z["src_n"]) != idx.n or int(z["src_k"]) != idx.k:
        raise SystemExit(f"table {tab} was built for n={int(z['src_n'])},"
                         f"k={int(z['src_k'])} — artifact has "
                         f"n={idx.n},k={idx.k}")
    st = z["stats"]
    new = PwlTable(buckets=int(z["buckets"]), xlist=z["xlist"],
                   ylist=z["ylist"], max_over=int(st[0]),
                   max_under=int(st[1]), mean_error=int(st[2]),
                   most_over=int(st[3]), most_under=int(st[4]))
    old_b = idx.buckets
    idx.swap_table(new)
    tmp = src + ".tmp"
    print(f"rewriting {src} with 2^{old_b} -> 2^{idx.buckets} table "
          f"(most=({new.most_over},{new.most_under}) "
          f"max=({new.max_over},{new.max_under}))", flush=True)
    idx.save(tmp)
    os.replace(tmp, src)
    print(f"done in {time.time()-t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
