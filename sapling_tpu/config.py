"""Configuration dataclasses.

Preserves every knob of the reference's hand-rolled key=val CLIs
(reference: src/sapling_example.cpp:43-84, src/align.cpp:36-67) with the
same defaults, so benchmark sweeps are comparable axis-for-axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class IndexConfig:
    k: int = 21                 # k-mer length (sapling_api.h:27)
    buckets: int = -1           # log2 #bins; -1 = auto from max_mem (:29, :387-391)
    max_mem: int = 10           # bins <= genome_len / max_mem when auto (:31)
    most_threshold: float = 0.95  # error bound percentile (:35)
    pos_dtype: str = "auto"     # int32 / uint32 / int64 by genome size
    prefix_lookup: bool = True  # build uint64 per-rank 32-base prefixes
    # skip the per-rank prefixes (8 B/rank each) above this n; a budget
    # set for a smaller device and not yet re-derived for an 80 GB card
    prefix_max_n: int = 1_500_000_000

    def resolved_buckets(self, n: int) -> int:
        if self.buckets != -1:
            return self.buckets
        b = 1
        while (1 << b) * self.max_mem * 2 <= n:
            b += 1
        return b


@dataclass
class QueryConfig:
    batch: int = 1 << 18        # lanes per device kernel launch
    # Safety cap on the >k stride-scan escalation. The loop self-terminates
    # (edges advance monotonically or hit the stuck rule), so this is a pure
    # backstop against livelock; the reference's loop is unbounded
    # (sapling_api.h:184-196).
    max_stride_steps: int = 1 << 20
    # Probe each bucket's own max-error window before the reference's
    # global windows (ops.query adaptive_bounds). Faster (smaller average
    # bisection), still returns verified hits / -1s, but which member of
    # a duplicate run comes back may differ from the reference — off by
    # default to preserve byte parity.
    adaptive_bounds: bool = False
    # Bisect the escalated tail (lanes beyond the most window) in a
    # compacted static-capacity batch so the full-width while_loop only
    # runs the shallow most-window depth (ops.query compact_escalate).
    # Bit-identical results — same per-lane decision sequence. Default ON
    # (a gain at every scale where first measured; docs/PERFORMANCE.md
    # at commit 9faeb07).
    compact_escalate: bool = True
    compact_cap: int | None = None  # None = batch/8 (ops.query._compact_cap)
    # Stronger compaction (fast3 path): run EVERYTHING after the
    # prediction probe — edge probe, escalation, every bisect round — in
    # a compacted batch (ops.query compact_unresolved). Bit-identical
    # results. compact_cap then defaults to batch/2 — size it >= the
    # unresolved fraction after the prediction probe, with margin
    # (overflow stays correct but pays a full-width fallback).
    compact_unresolved: bool = False


@dataclass
class AlignerConfig:
    num_seeds: int = 7          # align.cpp:20
    sapling_k: int = 16         # align.cpp:22
    flanking: int = 2           # align.cpp:21
    max_hits: int = 32          # align.cpp:23
    match_score: int = 2        # ssw_cpp.cpp:230-241 defaults
    mismatch_penalty: int = 2
    gap_open: int = 3
    gap_extend: int = 1
    mask_len: int = 15          # align.cpp:335


@dataclass
class SaplingConfig:
    index: IndexConfig = field(default_factory=IndexConfig)
    query: QueryConfig = field(default_factory=QueryConfig)
    aligner: AlignerConfig = field(default_factory=AlignerConfig)


def parse_keyval_args(argv: list[str]) -> dict[str, str]:
    """Parse the reference's `key=val` CLI style (sapling_example.cpp:43-84)."""
    out: dict[str, str] = {}
    for cur in argv:
        if "=" in cur:
            k, v = cur.split("=", 1)
            out[k] = v
    return out
