"""Batched query engine: PWL predict -> escalating window -> masked
binary-search refinement.

This is the batched inversion of the reference's scalar, pointer-chasing
query path (reference: src/sapling_api.h:98-248). One jitted array program
maps [B] packed queries to [B] genome positions:

  * prediction is exact int64 rational math (ops.predict);
  * every `getLcp` byte-compare loop (reference :115-120) becomes a packed
    2-bit word compare: gather ceil(L/16)+1 uint32 words, align with shifts,
    XOR against the packed query, and locate the first differing base with a
    count-leading-zeros built from smear+popcount — 16 bases per word, no
    data-dependent loop;
  * the recursive binary search (reference :133-153) becomes a
    `lax.while_loop` over per-lane (lo, hi, resolved) state that exits when
    every lane has resolved — all lanes move in lock-step, stragglers cost
    whole-batch iterations but each iteration is two HBM gathers;
  * the unbounded stride-scan escalation for queries longer than k
    (reference :184-196, which can loop forever on adversarial inputs) is a
    bounded masked while_loop.

LCP bookkeeping (loLcp/hiLcp) is dropped entirely: the reference only uses
min(loLcp, hiLcp) as a compare *start offset*, which never changes any
comparison outcome (the sorted-order invariant guarantees the true LCP is at
least that offset), so full-width packed compares return identical results.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .pack import BASES_PER_WORD
from .predict import predict_pwl


class Probe(NamedTuple):
    match: jnp.ndarray    # bool [B]: full L-base match at pos
    smaller: jnp.ndarray  # bool [B]: suffix < query (incl. running off the end)
    off_end: jnp.ndarray  # bool [B]: comparison ran off the genome end
    lcp: object = None    # int32 [B] LCP(query, suffix) capped at length
    #                       (set by the packed/prefix probes; None on the
    #                       3-bit path, whose callers never need it)


def take_slice(arr, idx, m: int):
    """Gather m CONSECUTIVE elements per lane as one gather: [..., m].

    Measured no win where it was first tried (docs/PERFORMANCE.md at
    commit 9faeb07): a slice gather cost the same as m independent
    single-element gathers, and m=8 on a 5M-lane batch failed to run.
    Not yet measured on a GPU. Kept only for the flag-off ptab variant
    (ops.predict.pack_ptab); do not put this on a default path. Start indices are clamped to
    len-m — callers must pad the operand so in-range lanes never clamp
    (a clamp SHIFTS the window)."""
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(idx.ndim,), collapsed_slice_dims=(),
        start_index_map=(0,))
    return jax.lax.gather(
        arr, idx[..., None].astype(jnp.int32), dn, slice_sizes=(m,),
        mode=jax.lax.GatherScatterMode.CLIP)


class PairedU32(NamedTuple):
    """A uint32 array with >= 2^31 elements, stored as its uint64 pair
    view so one gather op reaches any element (gathers want
    int32-indexable operands). FLAG-ONLY: uint64 jit ARGUMENTS can be
    materialized TWICE on device — the X64SplitHigh/Low custom calls
    keep both u32 halves as whole-program temps next to the u64 arg
    buffer — which once ran a 3.1 Gbp index out of device memory
    (docs/PERFORMANCE.md at commit 9faeb07). HalvesU32 is the default at
    this scale."""

    w64: jnp.ndarray  # uint64 [ceil(len/2)]

    @staticmethod
    def pack(arr) -> "PairedU32":
        import numpy as _np

        a = _np.ascontiguousarray(arr, dtype=_np.uint32)
        if a.shape[0] % 2:
            a = _np.concatenate([a, _np.zeros(1, _np.uint32)])
        return PairedU32(w64=jnp.asarray(a.view(_np.uint64)))


class Rows2D(NamedTuple):
    """A uint32 array with >= 2^31 elements stored as ONE [2, ceil(len/2)]
    operand: element i lives at (i & 1, i >> 1), both coordinates int32-
    indexable. A single gather op with (row, col) index pairs reaches any
    element — half the gather OPS of HalvesU32 — at zero memory overhead
    (unlike PairedU32's u64-arg doubling). Whether one 2-D-indexed gather
    actually costs less than two 1-D takes is an empirical question per
    backend: tools/microbench_gather.py measures it."""

    rows: jnp.ndarray  # uint32 [2, ceil(len/2)]; rows[p, j] = arr[2j + p]

    @staticmethod
    def pack(arr) -> "Rows2D":
        import numpy as _np

        a = _np.ascontiguousarray(arr, dtype=_np.uint32)
        if a.shape[0] % 2:
            a = _np.concatenate([a, _np.zeros(1, _np.uint32)])
        return Rows2D(rows=jnp.asarray(_np.stack([a[0::2], a[1::2]])))


class HalvesU32(NamedTuple):
    """A uint32 array with >= 2^31 elements, stored as its even/odd
    element halves (each < 2^31, int32-indexable): element i is
    (odd if i&1 else even)[i >> 1]. Two u32 gather ops reach any
    element — one fewer than the 2^30-bank layout's three at GRCh38
    scale — with ZERO memory overhead, unlike the uint64 pair view
    whose arg doubles in HBM under the X64 rewrite (PairedU32)."""

    even: jnp.ndarray  # uint32 [ceil(len/2)] = arr[0::2]
    odd: jnp.ndarray   # uint32 [ceil(len/2)] = arr[1::2]

    @staticmethod
    def pack(arr) -> "HalvesU32":
        import numpy as _np

        a = _np.ascontiguousarray(arr, dtype=_np.uint32)
        if a.shape[0] % 2:
            a = _np.concatenate([a, _np.zeros(1, _np.uint32)])
        return HalvesU32(even=jnp.asarray(a[0::2]), odd=jnp.asarray(a[1::2]))


def _clz32(x: jnp.ndarray) -> jnp.ndarray:
    """Count leading zeros of uint32 via smear + popcount."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return 32 - jax.lax.population_count(x).astype(jnp.int32)


def probe_at(packed, pos, q_words_t, *, n: int, length: int) -> Probe:
    """Compare the L-base query against the genome at text position pos.

    packed:    uint32 [n_words+pad] big-endian 2-bit genome
    pos:       int [...] text positions (must be in [0, n)); any shape
    q_words_t: uint32 [WQ, B] packed queries, WORD-MAJOR (bits beyond L
               zeroed). Per-word [B] rows, never [B, small] arrays: a
               tiled device layout pads small trailing axes.

    All per-word work uses separate [B]-shaped 1-D arrays for the same
    reason; wq is tiny and static so the Python loop fuses flat.
    """
    wq = (length + BASES_PER_WORD - 1) // BASES_PER_WORD
    sh = ((pos & 15) << 1).astype(jnp.uint32)
    sh_nz = sh != 0
    rsh = (32 - sh) & 31
    if packed.dtype == jnp.uint64:
        # 32 bases per 8-byte gather granule (ops.pack.words_to_u64):
        # fetch ceil((wq+2)/2) uint64s covering uint32 words [w0, w0+wq]
        # for either parity of w0, select per lane — 2 granules instead
        # of 3 for k=21 probes on the no-prefix (multi-Gbp) path, bit-
        # for-bit the same words. (A take_slice fetch of the same words
        # measured no better — see take_slice — so per-word takes stay.)
        u0 = (pos >> 5).astype(jnp.int32)
        par_odd = ((pos >> 4) & 1) == 1
        w64 = []
        for j in range((wq + 3) // 2):
            pair = jax.lax.bitcast_convert_type(
                jnp.take(packed, u0 + j), jnp.uint32)
            w64 += [pair[..., 1], pair[..., 0]]  # big-endian halves
        words = [jnp.where(par_odd, w64[j + 1], w64[j])
                 for j in range(wq + 1)]
    else:
        w0 = (pos >> 4).astype(jnp.int32)
        words = [jnp.take(packed, w0 + j) for j in range(wq + 1)]
    zero = jnp.zeros_like(words[0])
    # first-differing-word selection, word 0 highest priority
    lcp_words = jnp.full(pos.shape, wq, jnp.int32)
    dw = zero
    qw = zero
    aw = zero
    seen_diff = jnp.zeros(pos.shape, bool)
    for j in range(wq):
        aligned = (words[j] << sh) | jnp.where(sh_nz, words[j + 1] >> rsh,
                                               jnp.uint32(0))
        qj = q_words_t[j]
        d = aligned ^ qj
        new = ~seen_diff & (d != 0)
        lcp_words = jnp.where(new, j, lcp_words)
        dw = jnp.where(new, d, dw)
        qw = jnp.where(new, qj, qw)
        aw = jnp.where(new, aligned, aw)
        seen_diff = seen_diff | new
    lcp_raw = jnp.where(
        seen_diff,
        lcp_words * BASES_PER_WORD + (_clz32(dw) >> 1),
        jnp.int32(length),
    )
    # Compute the in-genome remainder in the position dtype first so large
    # n - pos values cannot alias small lcp values after the int32 cast.
    rem = jnp.minimum(n - pos, length).astype(jnp.int32)
    lcp = jnp.minimum(lcp_raw, rem)
    match = lcp == length
    off_end = ~match & (lcp == rem) & (rem < length)
    q_gt_ref = qw > aw  # decided at the first differing base (big-endian pack)
    smaller = off_end | (~match & q_gt_ref)
    return Probe(match=match, smaller=smaller, off_end=off_end, lcp=lcp)


def _clz64(x: jnp.ndarray) -> jnp.ndarray:
    """Count leading zeros of uint64 via smear + popcount."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    x = x | (x >> 32)
    return 64 - jax.lax.population_count(x).astype(jnp.int32)


class SplitRanks(NamedTuple):
    """rank->pos values split 5 bytes/rank for n >= 2^32 genomes (wheat,
    14.3 Gbp): lo = low 32 bits (uint32), hi = bits 32.. (uint8). int64
    storage would need 8 B/rank — the split is what lets a wheat-scale
    rev shard fit next to the replicated packed genome in one device's
    memory. Each leaf may itself be a tuple of 1-D banks."""

    lo: object  # uint32 array (or tuple of banks)
    hi: object  # uint8 array (or tuple of banks)


def take_rank(rev, idx):
    """Gather from the rank->pos array: a flat [n] array, a SplitRanks
    pair, or — for n beyond int32 gather range (gathers want
    32-bit-indexable operands) — a TUPLE of 1-D power-of-two-sized banks
    (2-D banking would pad the small sublane axis; 1-D arrays tile
    waste-free). Each bank is gathered with clamped int32 offsets and the
    right one selected per lane."""
    if isinstance(rev, SplitRanks):
        lo = take_rank(rev.lo, idx).astype(jnp.int64)
        hi = take_rank(rev.hi, idx).astype(jnp.int64)
        return (hi << 32) | lo
    if isinstance(rev, PairedU32):
        pair = jax.lax.bitcast_convert_type(
            jnp.take(rev.w64, (idx >> 1).astype(jnp.int32)), jnp.uint32)
        return jnp.where((idx & 1) == 0, pair[..., 0], pair[..., 1])
    if isinstance(rev, HalvesU32):
        j = (idx >> 1).astype(jnp.int32)
        return jnp.where((idx & 1) == 0, jnp.take(rev.even, j),
                         jnp.take(rev.odd, j))
    if isinstance(rev, Rows2D):
        r = (idx & 1).astype(jnp.int32)
        c = (idx >> 1).astype(jnp.int32)
        dn = jax.lax.GatherDimensionNumbers(
            offset_dims=(), collapsed_slice_dims=(0, 1),
            start_index_map=(0, 1))
        return jax.lax.gather(
            rev.rows, jnp.stack([r, c], axis=-1), dn, slice_sizes=(1, 1),
            mode=jax.lax.GatherScatterMode.CLIP)
    if not isinstance(rev, (tuple, list)):
        return jnp.take(rev, idx)
    bank_bits = int(rev[0].shape[0]).bit_length() - 1
    b = (idx >> bank_bits).astype(jnp.int32)
    o = (idx & ((1 << bank_bits) - 1)).astype(jnp.int32)
    out = jnp.take(rev[0], jnp.where(b == 0, o, 0))
    for bi in range(1, len(rev)):
        sel = b == bi
        lim = rev[bi].shape[0] - 1
        g = jnp.take(rev[bi], jnp.where(sel, jnp.minimum(o, lim), 0))
        out = jnp.where(sel, g, out)
    return out


def _psum_pick(v, axis):
    """Combine a masked per-shard gather (exactly one shard contributes a
    nonzero value per lane) with one psum over the index-shard axis.
    uint64 values ride as uint32 pairs (collectives on 32-bit words)."""
    if v.dtype == jnp.uint64:
        pair = jax.lax.bitcast_convert_type(v, jnp.uint32)
        return jax.lax.bitcast_convert_type(
            jax.lax.psum(pair, axis), jnp.uint64)
    return jax.lax.psum(v, axis)


def make_take(shard):
    """Rank-array gather closure: plain take_rank, or — under index
    sharding (shard = (axis_name, shard_size), inside shard_map) — a
    local masked gather plus one psum over the shard axis. Each device
    holds the contiguous rank range [me*size, (me+1)*size); lanes whose
    rank lives elsewhere gather local index 0 (cached, no HBM traffic)
    and contribute 0 to the psum, so per-shard gather traffic is only the
    lanes that land in that shard — the property that makes an index too
    big for one chip's HBM queryable at ~replicated-index speed."""
    if shard is None:
        return take_rank
    axis, size = shard

    def take(arr, rank):
        me = jax.lax.axis_index(axis)
        owner = (rank // size).astype(jnp.int32)
        mine = owner == me
        off = jnp.where(mine, rank - owner.astype(rank.dtype) * size,
                        jnp.zeros_like(rank))
        v = take_rank(arr, off)
        v = jnp.where(mine, v, jnp.zeros_like(v))
        return _psum_pick(v, axis)

    return take


def make_rank_probe(packed, rev, prefix, q_words, *, n: int, length: int,
                    idt, take=take_rank):
    """Probe-by-suffix-array-rank closure: rank [B] -> (text pos, Probe).

    Two implementations with identical semantics:
      * packed-genome path: gather rev[rank], then gather+align 2-bit
        genome words at that position (probe_at) — the gathers are
        DEPENDENT (two HBM latency levels) and cost wq+2 elements/probe.
      * prefix path (when `prefix` is given and length <= 32): gather
        prefix[rank] (first 32 bases of the suffix at that rank, packed
        big-endian uint64) and rev[rank] INDEPENDENTLY — one latency
        level, 2 elements/probe. Zero-padded short suffixes stay exact:
        a query can only compare greater at a pad base (pad = 0 is
        minimal), and pad-equality is disambiguated by the off-end test
        n - pos < length, which the reference also applies
        (src/sapling_api.h:115-130 via getLcp running off the end).
    """
    use_prefix = prefix is not None and length <= 32
    if use_prefix:
        # All compare math in 32-bit halves: 64-bit integer ops emulate
        # as several 32-bit ops on the device. The prefix stays a uint64
        # array (one 8-byte gather granule); the gathered value is
        # bitcast to its two uint32 words.
        wq = (length + BASES_PER_WORD - 1) // BASES_PER_WORD
        qhi_full = q_words[0]
        qlo_full = q_words[1] if wq > 1 else jnp.zeros_like(q_words[0])
        if length <= 16:
            mhi = ((1 << (2 * length)) - 1) << (32 - 2 * length)
            mlo = 0
        else:
            mhi = 0xFFFFFFFF
            mlo = ((((1 << (2 * (length - 16))) - 1)
                    << (32 - 2 * (length - 16))) & 0xFFFFFFFF)
        mhi = jnp.uint32(mhi)
        mlo = jnp.uint32(mlo)
        qhi = qhi_full & mhi
        qlo = qlo_full & mlo

        def probe(rank):
            pos = take(rev, rank).astype(idt)
            pw = take(prefix, rank)
            pair = jax.lax.bitcast_convert_type(pw, jnp.uint32)  # [B, 2]
            lo32, hi32 = pair[..., 0], pair[..., 1]  # little-endian halves
            phi = hi32 & mhi
            plo = lo32 & mlo
            dhi = phi ^ qhi
            dlo = plo ^ qlo
            hi_eq = dhi == 0
            any_diff = ~hi_eq | (dlo != 0)
            clz = jnp.where(hi_eq, 32 + _clz32(dlo), _clz32(dhi))
            lcp_raw = jnp.where(any_diff, clz >> 1, jnp.int32(length))
            rem = jnp.minimum(n - pos, length).astype(jnp.int32)
            lcp = jnp.minimum(lcp_raw, rem)
            match = lcp == length
            off_end = ~match & (lcp == rem) & (rem < length)
            q_gt = (qhi > phi) | (hi_eq & (qlo > plo))
            smaller = off_end | (~match & q_gt)
            return pos, Probe(match=match, smaller=smaller,
                              off_end=off_end, lcp=lcp)

        return probe

    def probe(rank):
        pos = take(rev, rank).astype(idt)
        return pos, probe_at(packed, pos, q_words, n=n, length=length)

    return probe


def make_rank_probe3(prefix3, q3, *, length: int, take=take_rank):
    """rank -> Probe via ONE uint64 gather (no text position).

    prefix3/q3 use the shifted 3-bit encoding (ops.pack.rank_prefix3):
    pad = 0 sorts below every base, so unsigned comparison alone yields
    the reference's complete ordering including off-end-is-smaller.
    Valid for length <= 21; the off_end flag is NOT computed (callers
    restrict this path to length <= k, where the reference never consults
    it — phase C is statically absent). Compare math in uint32 halves.
    """
    mask = 0
    for j in range(length):
        mask |= 7 << (60 - 3 * j)
    mhi = jnp.uint32(mask >> 32)
    mlo = jnp.uint32(mask & 0xFFFFFFFF)
    qp = jax.lax.bitcast_convert_type(q3, jnp.uint32)
    qlo = qp[..., 0] & mlo
    qhi = qp[..., 1] & mhi

    def probe(rank):
        pv = take(prefix3, rank)
        pp = jax.lax.bitcast_convert_type(pv, jnp.uint32)
        plo = pp[..., 0] & mlo
        phi = pp[..., 1] & mhi
        hi_eq = phi == qhi
        match = hi_eq & (plo == qlo)
        q_gt = (qhi > phi) | (hi_eq & (qlo > plo))
        smaller = ~match & q_gt
        return Probe(match=match, smaller=smaller,
                     off_end=jnp.zeros_like(match))

    return probe


def _state_dtype(storage_dtype):
    """Signed per-lane state dtype for a given rank-array storage dtype.

    rev/inv may be stored uint32 for 2^31 <= n < 2^32 genomes (GRCh38-scale
    fits one chip's HBM at 4 bytes/rank); lane state (lo/hi/res) must be
    signed (-1 sentinel) and hold n, so it promotes to int64.
    """
    import numpy as _np

    if _np.dtype(storage_dtype) == _np.uint32:
        return jnp.int64
    return storage_dtype


def _rev_dtype(rev):
    if isinstance(rev, SplitRanks):
        return jnp.int64  # values are reassembled 40-bit positions
    if isinstance(rev, (PairedU32, HalvesU32, Rows2D)):
        return jnp.uint32
    return rev[0].dtype if isinstance(rev, (tuple, list)) else rev.dtype


def _masked_binary_search2(probe_fn, lo, hi, res, resolved):
    """Two reference bisection levels per gather round.

    Probes the half-, quarter- and three-quarter-point ranks of every
    active interval TOGETHER (one [3, B] gather round), then replays the
    reference binarySearch's exact decision sequence
    (src/sapling_api.h:133-153) twice — including its hi==lo+2 base case,
    whose unprobed rev[lo+1] return coincides with the quarter-point
    probes (lo1+1 == m1 on the left, m2+1 == m3 on the right, both
    guaranteed when the half-interval has size 2). Identical results to
    the one-level loop in half the rounds; the engine is
    gather-round-latency bound.
    """
    neg = jnp.array(-1, res.dtype)

    def cond(st):
        return ~st[3].all()

    def body(st):
        lo, hi, res, resolved = st
        active = ~resolved
        base2 = hi == lo + 2
        m2 = jnp.where(base2, lo + 1, lo + ((hi - lo) >> 1))
        m1 = lo + ((m2 - lo) >> 1)
        m3 = m2 + ((hi - m2) >> 1)
        z = jnp.zeros_like(m1)
        pos_1, p_1 = probe_fn(jnp.where(active, m1, z))
        pos_2, p_2 = probe_fn(jnp.where(active, m2, z))
        pos_3, p_3 = probe_fn(jnp.where(active, m3, z))
        pos3 = (pos_1, pos_2, pos_3)
        # level 1 at m2
        mm, ms = p_2.match, p_2.smaller
        now_base = active & base2
        now_match = active & ~base2 & mm
        now_fail = active & ~base2 & ~mm & (lo + 1 >= hi)
        res = jnp.where(now_base | now_match, pos3[1], res)
        res = jnp.where(now_fail, neg, res)
        resolved = resolved | now_base | now_match | now_fail
        go = active & ~(now_base | now_match | now_fail)
        right = ms
        lo1 = jnp.where(go & right, m2, lo)
        hi1 = jnp.where(go & ~right, m2, hi)
        # level 2 at m3 (right half) or m1 (left half)
        mm2 = jnp.where(right, p_3.match, p_1.match)
        ms2 = jnp.where(right, p_3.smaller, p_1.smaller)
        mpos2 = jnp.where(right, pos3[2], pos3[0])
        mid2 = jnp.where(right, m3, m1)
        base2b = hi1 == lo1 + 2
        nb = go & base2b
        nmatch = go & ~base2b & mm2
        nfail = go & ~base2b & ~mm2 & (lo1 + 1 >= hi1)
        res = jnp.where(nb | nmatch, mpos2, res)
        res = jnp.where(nfail, neg, res)
        resolved = resolved | nb | nmatch | nfail
        go2 = go & ~(nb | nmatch | nfail)
        lo = jnp.where(go, jnp.where(go2 & ms2, mid2, lo1), lo)
        hi = jnp.where(go, jnp.where(go2 & ~ms2, mid2, hi1), hi)
        return lo, hi, res, resolved

    lo, hi, res, resolved = jax.lax.while_loop(cond, body,
                                               (lo, hi, res, resolved))
    return res, resolved


def _masked_binary_search(probe_fn, lo, hi, res, resolved):
    """The reference's binarySearch (src/sapling_api.h:133-153) over all
    lanes at once. `res` holds text positions; -1 = not found."""

    def cond(state):
        _lo, _hi, _res, resolved = state
        return ~resolved.all()

    def body(state):
        lo, hi, res, resolved = state
        active = ~resolved
        base2 = hi == lo + 2
        mid = jnp.where(base2, lo + 1, lo + ((hi - lo) >> 1))
        mid = jnp.where(active, mid, 0)
        idx, p = probe_fn(mid)
        # base case hi==lo+2 returns rank lo+1 unconditionally (:136)
        now_base = active & base2
        now_match = active & ~base2 & p.match
        now_fail = active & ~base2 & ~p.match & (lo + 1 >= hi)
        res = jnp.where(now_base | now_match, idx, res)
        res = jnp.where(now_fail, jnp.array(-1, res.dtype), res)
        resolved = resolved | now_base | now_match | now_fail
        go = active & ~(now_base | now_match | now_fail)
        lo = jnp.where(go & p.smaller, mid, lo)
        hi = jnp.where(go & ~p.smaller, mid, hi)
        return lo, hi, res, resolved

    lo, hi, res, resolved = jax.lax.while_loop(cond, body, (lo, hi, res, resolved))
    return res, resolved


def _compact_cap(b: int, cap: int | None) -> int:
    """Static capacity for the compacted deep-lane batch: the 'most'
    bounds are ~95th-percentile errors (reference errorStats,
    src/sapling_api.h:342-379), so ~5% of lanes escalate; 1/8 of the
    batch is a 2.5x safety margin. Overflow is CORRECT (leftover lanes
    run in the final full-width loop), just slower."""
    if cap is None:
        cap = max(1024, b >> 3)
    return min(cap, b)


def _compact_deep(resolved, lo, hi, width: int, cap: int):
    """Indices of (up to cap) unresolved lanes whose remaining bisection
    window is wider than `width` — the escalated tail. Returns
    (idx32 [cap] clamped in-range, valid [cap], deep [B]).

    Rationale: a whole-batch while_loop round costs full-batch gather
    throughput regardless of lane masking, and its
    trip count is the MAX bisection depth over lanes — so a ~5% tail
    with a (max_over+max_under)-wide window multiplies the other 95%'s
    cost by ~log(max/most). Compacting the tail into a [cap] batch makes
    those extra trips cost cap-lane throughput instead."""
    b = resolved.shape[0]
    deep = ~resolved & ((hi - lo) > width)
    # _compact_indices, not jnp.nonzero: nonzero's bool cumsum promotes
    # to int64 under the package's global x64, and the resulting
    # (u32,u32)-pair reduce-window once failed to compile at 5M lanes
    # (docs/PERFORMANCE.md at commit 9faeb07); whether the plain form
    # compiles on a GPU is still to be measured
    idxs = _compact_indices(deep, cap)
    valid = idxs < b
    return jnp.minimum(idxs, b - 1).astype(jnp.int32), valid, deep


def _scatter_back(res, resolved, idx32, valid, res_c):
    """Write compacted-lane results into the full-width state. Invalid
    (fill) rows scatter out of bounds and are dropped; every valid
    compacted lane is fully decided by its bisection (hit or -1), so its
    full-width slot becomes resolved."""
    b = res.shape[0]
    sc = jnp.where(valid, idx32, jnp.int32(b))
    res = res.at[sc].set(res_c, mode="drop")
    resolved = resolved.at[sc].set(True, mode="drop")
    return res, resolved


def _lane_bounds(bounds, x, *, kbits: int, buckets: int, most_over: int,
                 most_under: int):
    """Per-lane (over, under) window bounds from the packed per-bucket max
    array (index.pwl.bucket_bounds). Clamped into the global 'most' bounds
    so the adaptive escalation ladder stays nested (bucket ⊆ most ⊆ max);
    clipped buckets (0xFFFF) therefore fall back to the global window.
    bounds is per-BUCKET (small) and stays replicated under index
    sharding, so the gather is always local."""
    b = (x >> (kbits - buckets)).astype(jnp.int32)
    bw = jnp.take(bounds, b)
    bo = (bw >> 16).astype(jnp.int32)
    bu = (bw & 0xFFFF).astype(jnp.int32)
    return jnp.minimum(bo, most_over), jnp.minimum(bu, most_under)


def _compact_indices(mask, cap: int):
    """First-`cap` indices of set lanes in `mask`, in order: [cap] int32,
    fill = b for absent. Equivalent to jnp.nonzero(mask, size=cap,
    fill_value=b)[0] but built from a BLOCKED cumsum (per-512-lane-row
    scans + one tiny row-offset scan) plus one scatter: XLA's fused
    lowering of a large-`size` nonzero once failed to compile at 5M
    lanes (docs/PERFORMANCE.md at commit 9faeb07); the blocked form
    streams through device memory."""
    b = mask.shape[0]
    s = 512
    pb = -(-b // s) * s
    m = jnp.pad(mask, (0, pb - b)).reshape(-1, s).astype(jnp.int32)
    intra = jnp.cumsum(m, axis=1)            # [G, 512] row scans
    tot = intra[:, -1]
    off = jnp.cumsum(tot) - tot              # [G] exclusive row offsets
    tgt = (off[:, None] + intra - m).reshape(-1)[:b]  # exclusive prefix
    lane = jnp.arange(b, dtype=jnp.int32)
    sc = jnp.where(mask & (tgt < cap), tgt, cap).astype(jnp.int32)
    return jnp.full(cap, b, jnp.int32).at[sc].set(lane, mode="drop")


def _pack_pred_dir(pred, dir_right):
    """Pack (pred, dir) into ONE gatherable value: dir rides in the sign
    via bit-not (enc = ~pred when dir is set; pred >= 0 always). One
    compaction gather instead of two — gather ops cost per-lane
    throughput, so halving the per-lane state fetched during compaction
    matters."""
    return jnp.where(dir_right, ~pred, pred)


def _unpack_pred_dir(enc):
    dir_right = enc < 0
    return jnp.where(dir_right, ~enc, enc), dir_right


def _fast3_refine(prefix3, q3c, pred, dir_right, active, *, length: int,
                  n: int, most_over: int, most_under: int, max_over: int,
                  max_under: int, idt, take, tail_cap: int):
    """Phases A/B + bisect of the fast3 cascade on a COMPACTED lane batch.

    Exact per-lane reference decision sequence (src/sapling_api.h:159-248
    restricted to length <= k, where phase C is statically absent),
    starting from the state after a non-matching prediction probe.
    The escalated tail (lanes needing the max window) is nested-compacted
    into a [tail_cap] sub-batch so the main bisect only runs the shallow
    'most'-window depth. Returns (rank_res [-1 = not found], done):
    lanes beyond the tail capacity come back done=False — the caller's
    drained loop re-picks them (graceful overflow, identical decisions).
    """
    b = pred.shape[0]
    probe = make_rank_probe3(prefix3, q3c, length=length, take=take)
    pred_w = pred.astype(jnp.int64)
    e_right = jnp.minimum(jnp.int64(n - 1), pred_w + most_over).astype(idt)
    e_left = jnp.maximum(jnp.int64(0), pred_w - most_under).astype(idt)
    rank_res = jnp.full(pred.shape, -1, idt)
    # --- phase A: 'most' window edge ---
    edge = jnp.where(dir_right, e_right, e_left)
    pa = probe(jnp.where(active, edge, 0))
    hit_a = active & pa.match
    rank_res = jnp.where(hit_a, edge, rank_res)
    resolved = ~active | hit_a
    escalate = active & ~hit_a & jnp.where(dir_right, pa.smaller,
                                           ~pa.match & ~pa.smaller)
    lo = jnp.where(dir_right, pred, e_left)
    hi = jnp.where(dir_right, e_right, pred)
    # --- phase B + deep bisect, in a nested [tail_cap] sub-batch ---
    cap2 = min(max(tail_cap, 1), b)
    idxs = _compact_indices(escalate, cap2)
    valid2 = idxs < b
    idx2 = jnp.minimum(idxs, b - 1).astype(jnp.int32)
    taken = jnp.zeros(b, bool).at[
        jnp.where(valid2, idx2, jnp.int32(b))].set(True, mode="drop")
    leftover = escalate & ~taken         # beyond capacity: retried by caller
    pred_t = jnp.take(pred, idx2)
    dir_t = jnp.take(dir_right, idx2)
    predw_t = pred_t.astype(jnp.int64)
    er_t = jnp.minimum(jnp.int64(n - 1), predw_t + most_over).astype(idt)
    el_t = jnp.maximum(jnp.int64(0), predw_t - most_under).astype(idt)
    br_t = jnp.minimum(jnp.int64(n - 1), predw_t + max_over + 1).astype(idt)
    bl_t = jnp.maximum(jnp.int64(0), predw_t - max_under - 1).astype(idt)
    probe_t = make_rank_probe3(prefix3, jnp.take(q3c, idx2, axis=0),
                               length=length, take=take)
    bedge_t = jnp.where(dir_t, br_t, bl_t)
    pb = probe_t(jnp.where(valid2, bedge_t, 0))
    hit_b = valid2 & pb.match
    res_t = jnp.where(hit_b, bedge_t, jnp.full(bedge_t.shape, -1, idt))
    lo_t = jnp.where(dir_t, er_t, bl_t)
    hi_t = jnp.where(dir_t, br_t, el_t)
    res_t, _ = _masked_rank_bisect(probe_t, lo_t, hi_t, res_t,
                                   ~valid2 | hit_b)
    rank_res, resolved = _scatter_back(rank_res, resolved, idx2, valid2,
                                       res_t)
    # --- main bisect: non-escalated lanes only (shallow 'most' depth) ---
    rank_res, _ = _masked_rank_bisect(probe, lo, hi, rank_res,
                                      resolved | escalate)
    return rank_res, active & ~leftover


def _masked_rank_bisect(probe_fn, lo, hi, rank_res, resolved):
    """The reference binarySearch (src/sapling_api.h:133-153) over RANK
    state with a Probe-only probe (fast3 phase D: no positions in the
    loop; one rev gather happens at the very end)."""

    def cond(st):
        return ~st[3].all()

    def body(st):
        lo, hi, rank_res, resolved = st
        active = ~resolved
        base2 = hi == lo + 2
        mid = jnp.where(base2, lo + 1, lo + ((hi - lo) >> 1))
        p = probe_fn(jnp.where(active, mid, 0))
        now_base = active & base2
        now_match = active & ~base2 & p.match
        now_fail = active & ~base2 & ~p.match & (lo + 1 >= hi)
        rank_res = jnp.where(now_base | now_match, mid, rank_res)
        resolved = resolved | now_base | now_match | now_fail
        go = active & ~(now_base | now_match | now_fail)
        lo = jnp.where(go & p.smaller, mid, lo)
        hi = jnp.where(go & ~p.smaller, mid, hi)
        return lo, hi, rank_res, resolved

    _, _, rank_res, resolved = jax.lax.while_loop(
        cond, body, (lo, hi, rank_res, resolved))
    return rank_res, resolved


def _plquery_fast3(rev, prefix3, q3, x, xlist, ylist, *, n, length, k,
                   buckets, most_over, most_under, max_over, max_under, idt,
                   take=take_rank, bounds=None, ptab=None, pred2=None,
                   pred2_bits=None, compact_escalate=False,
                   compact_cap=None, compact_unresolved=False,
                   pred64=None):
    """plQuery via 3-bit prefix probes: ONE 8-byte gather per probe round,
    suffix-array RANKS tracked throughout, a single rev gather at the end.
    Exact reference decision sequence; valid for length <= min(k, 21)
    (phase C, the only consumer of off_end, is statically absent).

    pred64: precomputed [B] int64 predicted ranks (e.g. an NN predictor,
    models.serve) — replaces the PWL prediction; the caller must pass
    the matching most/max windows for that predictor."""
    probe = make_rank_probe3(prefix3, q3, length=length, take=take)
    if pred64 is None:
        pred64 = predict_pwl(x, xlist, ylist, 2 * k, buckets, n, ptab=ptab,
                             pred2=pred2, pred2_bits=pred2_bits)
    pred = pred64.astype(idt)
    neg1 = jnp.array(-1, idt)
    rank_res = jnp.full(pred.shape, -1, dtype=idt)
    pred_w = pred.astype(jnp.int64)
    e_right = jnp.minimum(jnp.int64(n - 1), pred_w + most_over).astype(idt)
    e_left = jnp.maximum(jnp.int64(0), pred_w - most_under).astype(idt)

    p0 = probe(pred)
    resolved = p0.match
    rank_res = jnp.where(p0.match, pred, rank_res)
    dir_right = p0.smaller

    if compact_unresolved and bounds is None:
        # Everything after the prediction probe runs in ONE COMPACTED
        # [cap] batch: a well-tuned index resolves most lanes at the
        # prediction itself (most lanes at 4.6 Mbp), so the edge
        # probe and every bisect round would otherwise pay full-batch
        # gather-lane throughput for a minority of active lanes.
        # Decision sequence per lane is identical — only the execution
        # batch changes. Overflow (unresolved > cap, or the nested tail
        # capacity inside _fast3_refine) falls through to a lax.cond-
        # gated full-width pass — identical decisions, zero runtime cost
        # when (as virtually always) the compacted trip covers everyone.
        # The compaction stays at TOP level: a nonzero inside a
        # while_loop body once failed to compile at 5M lanes.
        b = rank_res.shape[0]
        cap = _compact_cap(b, compact_cap if compact_cap is not None
                           else max(1024, b >> 1))
        tail_cap = max(256, cap >> 4)
        # pred's sign bit is free (pred >= 0): dir rides as bit-not, so
        # compaction fetches ONE per-lane state value. int32 pred needs
        # headroom for ~pred; idt is int32 only when n < 2^31, which fits.
        enc = _pack_pred_dir(pred, dir_right)
        idxs = _compact_indices(~resolved, cap)
        valid = idxs < b
        idx32 = jnp.minimum(idxs, b - 1).astype(jnp.int32)
        pred_c, dir_c = _unpack_pred_dir(jnp.take(enc, idx32))
        res_c, done_c = _fast3_refine(
            prefix3, jnp.take(q3, idx32, axis=0), pred_c, dir_c,
            valid, length=length, n=n, most_over=most_over,
            most_under=most_under, max_over=max_over,
            max_under=max_under, idt=idt, take=take, tail_cap=tail_cap)
        sc = jnp.where(valid & done_c, idx32, jnp.int32(b))
        rank_res = rank_res.at[sc].set(res_c, mode="drop")
        resolved = resolved.at[sc].set(True, mode="drop")

        def fallback(st):
            rank_res, resolved = st
            active = ~resolved
            edge_f = jnp.where(dir_right, e_right, e_left)
            pa = probe(jnp.where(active, edge_f, 0))
            hit_a = active & pa.match
            rank_res = jnp.where(hit_a, edge_f, rank_res)
            resolved = resolved | hit_a
            esc = active & ~hit_a & jnp.where(dir_right, pa.smaller,
                                              ~pa.match & ~pa.smaller)
            lo = jnp.where(dir_right, pred, e_left)
            hi = jnp.where(dir_right, e_right, pred)
            br = jnp.minimum(jnp.int64(n - 1),
                             pred_w + max_over + 1).astype(idt)
            bl = jnp.maximum(jnp.int64(0),
                             pred_w - max_under - 1).astype(idt)
            bedge_f = jnp.where(dir_right, br, bl)
            pb = probe(jnp.where(esc, bedge_f, 0))
            hit_b = esc & pb.match
            rank_res = jnp.where(hit_b, bedge_f, rank_res)
            resolved = resolved | hit_b
            lo = jnp.where(esc, jnp.where(dir_right, e_right, bl), lo)
            hi = jnp.where(esc, jnp.where(dir_right, br, e_left), hi)
            rank_res, resolved = _masked_rank_bisect(probe, lo, hi,
                                                     rank_res, resolved)
            return rank_res, resolved

        rank_res, resolved = jax.lax.cond(
            ~resolved.all(), fallback, lambda st: st, (rank_res, resolved))
        found = rank_res >= 0
        pos = take(rev, jnp.where(found, rank_res, 0)).astype(idt)
        return jnp.where(found, pos, neg1)

    if bounds is not None:
        # adaptive pre-phase: this bucket's own max-error window. Present
        # length-k queries always resolve here (the bound is a true max),
        # so the average bisection depth tracks the lane's own bucket,
        # not the global 95th-percentile window.
        bo, bu = _lane_bounds(bounds, x, kbits=2 * k, buckets=buckets,
                              most_over=most_over, most_under=most_under)
        a_right = jnp.minimum(jnp.int64(n - 1), pred_w + bo).astype(idt)
        a_left = jnp.maximum(jnp.int64(0), pred_w - bu).astype(idt)
        aedge = jnp.where(dir_right, a_right, a_left)
        p1 = probe(jnp.where(resolved, 0, aedge))
        hit1 = ~resolved & p1.match
        rank_res = jnp.where(hit1, aedge, rank_res)
        resolved = resolved | hit1
        need_a = ~resolved & jnp.where(dir_right, p1.smaller,
                                       ~p1.match & ~p1.smaller)
        lo = jnp.where(dir_right, pred, a_left)
        hi = jnp.where(dir_right, a_right, pred)
    else:
        need_a = ~resolved
        lo = jnp.where(dir_right, pred, e_left)
        hi = jnp.where(dir_right, e_right, pred)

    edge = jnp.where(dir_right, e_right, e_left)
    pa = probe(jnp.where(need_a, edge, 0))
    hit_a = need_a & pa.match
    rank_res = jnp.where(hit_a, edge, rank_res)
    resolved = resolved | hit_a
    escalate = need_a & ~hit_a & jnp.where(dir_right, pa.smaller,
                                           ~pa.match & ~pa.smaller)
    if bounds is not None:
        lo = jnp.where(need_a, jnp.where(dir_right, a_right, e_left), lo)
        hi = jnp.where(need_a, jnp.where(dir_right, e_right, a_left), hi)

    b_right = jnp.minimum(jnp.int64(n - 1), pred_w + max_over + 1).astype(idt)
    b_left = jnp.maximum(jnp.int64(0), pred_w - max_under - 1).astype(idt)
    bedge = jnp.where(dir_right, b_right, b_left)
    pb = probe(jnp.where(escalate, bedge, 0))
    hit_b = escalate & pb.match
    rank_res = jnp.where(hit_b, bedge, rank_res)
    resolved = resolved | hit_b
    lo = jnp.where(escalate, jnp.where(dir_right, e_right, b_left), lo)
    hi = jnp.where(escalate, jnp.where(dir_right, b_right, e_left), hi)

    if compact_escalate:
        # bisect the escalated tail in a compacted [cap] batch first —
        # the full-width loop below then only runs the shallow
        # most-window depth (see _compact_deep)
        cap = _compact_cap(rank_res.shape[0], compact_cap)
        idx32, valid, _ = _compact_deep(resolved, lo, hi,
                                        most_over + most_under + 2, cap)
        probe_c = make_rank_probe3(prefix3, jnp.take(q3, idx32, axis=0),
                                   length=length, take=take)
        res_c, _ = _masked_rank_bisect(
            probe_c, jnp.take(lo, idx32), jnp.take(hi, idx32),
            jnp.take(rank_res, idx32), ~valid)
        rank_res, resolved = _scatter_back(rank_res, resolved, idx32,
                                           valid, res_c)

    rank_res, _ = _masked_rank_bisect(probe, lo, hi, rank_res, resolved)
    found = rank_res >= 0
    pos = take(rev, jnp.where(found, rank_res, 0)).astype(idt)
    return jnp.where(found, pos, neg1)


def _general_refine(make_probe, qw_sub, pred, dir_right, active, *, n: int,
                    length: int, k: int, most_over: int, most_under: int,
                    max_over: int, max_under: int, max_stride_steps: int,
                    idt, tail_cap: int | None = None):
    """Phases A/B/C/D of the general (position-typed) cascade on a lane
    batch — the exact reference decision sequence (src/sapling_api.h:
    159-248) starting after a non-matching prediction probe.

    make_probe(q_words) builds a rank->(pos, Probe) closure for a lane
    subset (the index-side arrays ride its captures; only the per-lane
    packed queries need sub-batching). With tail_cap set, the escalated
    lanes run phases B/C and their deep bisect in a nested [tail_cap]
    sub-batch; overflow lanes return done=False for the caller to retry
    (the compact_unresolved fallback). With tail_cap=None everything is
    inline masked — full current-batch width, always done.

    Returns (res positions [-1 = not found; only ACTIVE lanes
    meaningful], done bool)."""
    probe_rank = make_probe(qw_sub)
    pred_w = pred.astype(jnp.int64)
    e_right = jnp.minimum(jnp.int64(n - 1), pred_w + most_over).astype(idt)
    e_left = jnp.maximum(jnp.int64(0), pred_w - most_under).astype(idt)
    res = jnp.full(pred.shape, -1, dtype=idt)
    # --- phase A: 'most' window edge ---
    edge = jnp.where(dir_right, e_right, e_left)
    edge_idx, pa = probe_rank(jnp.where(active, edge, 0))
    hit_a = active & pa.match
    res = jnp.where(hit_a, edge_idx, res)
    resolved = ~active | hit_a
    escalate = active & ~hit_a & jnp.where(dir_right, pa.smaller,
                                           ~pa.match & ~pa.smaller)
    lo = jnp.where(dir_right, pred, e_left)
    hi = jnp.where(dir_right, e_right, pred)

    def bcd(probe_fn, pred, dir_right, esc, res, resolved, lo, hi):
        """Phases B (max edge), C (stride scan, length > k only) and D
        (masked bisect over every unresolved lane of this batch)."""
        pred_w = pred.astype(jnp.int64)
        b_right = jnp.minimum(jnp.int64(n - 1),
                              pred_w + max_over + 1).astype(idt)
        b_left = jnp.maximum(jnp.int64(0),
                             pred_w - max_under - 1).astype(idt)
        bedge = jnp.where(dir_right, b_right, b_left)
        bidx, pb = probe_fn(jnp.where(esc, bedge, 0))
        hit_b = esc & pb.match
        res = jnp.where(hit_b, bidx, res)
        resolved = resolved | hit_b
        er = jnp.minimum(jnp.int64(n - 1), pred_w + most_over).astype(idt)
        el = jnp.maximum(jnp.int64(0), pred_w - most_under).astype(idt)
        lo = jnp.where(esc, jnp.where(dir_right, er, b_left), lo)
        hi = jnp.where(esc, jnp.where(dir_right, b_right, el), hi)
        if length > k:
            scan_r = pb.smaller & ~pb.off_end
            scan_l = ~pb.match & ~pb.smaller
            active0 = esc & ~resolved & jnp.where(dir_right, scan_r,
                                                  scan_l)

            def c_cond(state):
                t, act, *_ = state
                return (t < max_stride_steps) & act.any()

            def c_body(state):
                t, act, lo, hi, res, resolved = state
                new_lo = jnp.where(dir_right, hi, lo)
                step_hi = jnp.minimum(
                    jnp.int64(n - 1), hi.astype(jnp.int64) + max_over
                ).astype(idt)
                step_lo = jnp.maximum(
                    jnp.int64(0), lo.astype(jnp.int64) - max_under
                ).astype(idt)
                new_hi = jnp.where(dir_right, step_hi, lo)
                new_lo = jnp.where(dir_right, new_lo, step_lo)
                probe_pos = jnp.where(dir_right, new_hi, new_lo)
                stuck = probe_pos == jnp.where(dir_right, hi, lo)
                lo = jnp.where(act, new_lo, lo)
                hi = jnp.where(act, new_hi, hi)
                pidx, pc = probe_fn(jnp.where(act, probe_pos, 0))
                hit = act & pc.match
                res = jnp.where(hit, pidx, res)
                resolved = resolved | hit
                keep = jnp.where(dir_right, pc.smaller & ~pc.off_end,
                                 ~pc.match & ~pc.smaller)
                act = act & ~hit & keep & ~stuck
                return t + 1, act, lo, hi, res, resolved

            _, _, lo, hi, res, resolved = jax.lax.while_loop(
                c_cond, c_body,
                (jnp.int32(0), active0, lo, hi, res, resolved))
        return _masked_binary_search(probe_fn, lo, hi, res, resolved)

    if tail_cap is None:
        res, _ = bcd(probe_rank, pred, dir_right, escalate, res, resolved,
                     lo, hi)
        return res, active
    # --- nested tail: phases B/C + deep bisect at [tail_cap] ---
    b = pred.shape[0]
    cap2 = min(max(tail_cap, 1), b)
    idxs = _compact_indices(escalate, cap2)
    valid2 = idxs < b
    idx2 = jnp.minimum(idxs, b - 1).astype(jnp.int32)
    taken = jnp.zeros(b, bool).at[
        jnp.where(valid2, idx2, jnp.int32(b))].set(True, mode="drop")
    leftover = escalate & ~taken
    pred_t = jnp.take(pred, idx2)
    dir_t = jnp.take(dir_right, idx2)
    probe_t = make_probe(jnp.take(qw_sub, idx2, axis=1))
    res_t = jnp.full(pred_t.shape, -1, dtype=idt)
    z = jnp.zeros_like(pred_t)
    res_t, _ = bcd(probe_t, pred_t, dir_t, valid2, res_t, ~valid2, z, z)
    res, resolved = _scatter_back(res, resolved, idx2, valid2, res_t)
    # main bisect: non-escalated unresolved lanes (shallow 'most' depth)
    res, _ = _masked_binary_search(probe_rank, lo, hi, res,
                                   resolved | escalate)
    return res, active & ~leftover


@functools.partial(
    jax.jit,
    static_argnames=(
        "n", "length", "k", "buckets", "most_over", "most_under",
        "max_over", "max_under", "max_stride_steps", "window_scan",
        "multiprobe", "shard_spec", "adaptive_bounds", "pred2_bits",
        "compact_escalate", "compact_cap", "compact_unresolved",
    ),
)
def plquery_batch(
    packed, rev, xlist, ylist, q_words, x, prefix=None, prefix3=None,
    q3=None, bounds=None, ptab=None, pred2=None,
    *, n: int, length: int, k: int, buckets: int,
    most_over: int, most_under: int, max_over: int, max_under: int,
    max_stride_steps: int = 1 << 20, window_scan: bool | None = None,
    pred2_bits: tuple[int, int, int] | None = None,
    multiprobe: bool = False,
    shard_spec: tuple[str, int] | None = None,
    adaptive_bounds: bool = False,
    compact_escalate: bool = False,
    compact_cap: int | None = None,
    compact_unresolved: bool = False,
    pred64=None,
):
    """Batched Sapling::plQuery (reference: src/sapling_api.h:159-248).

    Returns int [B] text positions, -1 where the reference returns -1.

    shard_spec = (mesh_axis, shard_size): rev/prefix/prefix3 are the
    LOCAL contiguous-rank-range shards of an index sharded over that mesh
    axis (call inside shard_map; see parallel.sharded_index). Probes
    gather locally and combine with a psum — decision sequence, and hence
    results, are bit-identical to the replicated engine.

    pred2 (+ static pred2_bits): pack_pred2 uint64 pair — 2-gather
    prediction (ops.predict.pack_pred2); xlist/ylist may then be None.
    Flag-off variant, as is ptab (interleaved checkpoint table,
    ops.predict.pack_ptab) — both measured slower end-to-end.

    adaptive_bounds: probe this bucket's own max-error window (`bounds`,
    index.pwl.bucket_bounds) before the reference's global windows.
    Returned positions remain verified hits / -1s, but the SEARCH ORDER
    differs from the reference, so which member of a duplicate run is
    returned may differ — off by default to preserve the byte-parity
    contract; found/-1 status is unchanged (a nested escalation ladder
    ends at the reference's own max window).

    compact_escalate: before phase D, compact the escalated tail (lanes
    whose window is wider than the most window) into a static
    [compact_cap] batch via nonzero(size=cap) and bisect it there. The
    per-lane decision sequence — and thus every returned position — is
    bit-identical; only the batch a deep lane's probes execute in
    changes. Overflow beyond cap stays in the full-width loop (correct,
    slower). See _compact_deep for the cost model.

    compact_unresolved (fast3 AND general paths): stronger form — EVERYTHING
    after the prediction probe (edge probe, max-window escalation, all
    bisect rounds) runs in a compacted [compact_cap] batch drained by a
    while_loop; the escalated tail nests into a second compaction level
    inside it. Bit-identical decision sequence; overflow re-drains
    (never falls back to full-width phases). Subsumes compact_escalate
    when the fast3 path is taken. compact_cap defaults to B/2 here —
    size it >= the unresolved fraction (1 - prediction-probe hit rate:
    29% at 4.6 Mbp nb=22, 47% at 230 Mbp nb=26 — properties of the
    index, not the device) with margin; a too-small cap stays CORRECT
    but pays the full-width fallback every launch.

    pred64: precomputed [B] int64 predicted ranks — replaces the PWL
    prediction entirely (the NN-predictor engine, models.serve, uses
    this seam). The caller must pass most/max windows measured for THAT
    predictor; found/-1 status is then correct for any prediction, but
    which member of a duplicate run is returned follows the
    prediction's search order.
    """
    idt = _state_dtype(_rev_dtype(rev))
    take = make_take(shard_spec)
    if shard_spec is not None and window_scan:
        raise NotImplementedError("window_scan under index sharding")
    if adaptive_bounds and (window_scan or multiprobe):
        raise NotImplementedError(
            "adaptive_bounds composes with the sequential cascade only")
    if adaptive_bounds and bounds is None:
        raise ValueError("adaptive_bounds=True needs the bounds array")
    ab = bounds if adaptive_bounds else None
    from .pack import P3_BASES

    if (prefix3 is not None and q3 is not None and length <= k
            and length <= P3_BASES and not window_scan):
        return _plquery_fast3(
            rev, prefix3, q3, x, xlist, ylist, n=n, length=length, k=k,
            buckets=buckets, most_over=most_over, most_under=most_under,
            max_over=max_over, max_under=max_under, idt=idt, take=take,
            bounds=ab, ptab=ptab, pred2=pred2, pred2_bits=pred2_bits,
            compact_escalate=compact_escalate, compact_cap=compact_cap,
            compact_unresolved=compact_unresolved, pred64=pred64)
    probe_rank = make_rank_probe(packed, rev, prefix, q_words,
                                 n=n, length=length, idt=idt, take=take)
    if pred64 is None:
        pred64 = predict_pwl(x, xlist, ylist, 2 * k, buckets, n, ptab=ptab,
                             pred2=pred2, pred2_bits=pred2_bits)
    pred = pred64.astype(idt)

    neg1 = jnp.array(-1, idt)
    res = jnp.full(pred.shape, -1, dtype=idt)
    pred_w = pred.astype(jnp.int64)
    e_right = jnp.minimum(jnp.int64(n - 1), pred_w + most_over).astype(idt)
    e_left = jnp.maximum(jnp.int64(0), pred_w - most_under).astype(idt)

    # The 'most' error window is usually tiny (95th-percentile bound). When
    # it is, replace the reference's sequential probe cascade with ONE wide
    # parallel probe of every rank the cascade could ever touch, then run
    # its exact decision sequence — prediction probe (:161-167), 'most'
    # edge probe (:171-174/:209-213), and the recursive binarySearch
    # (:133-153) — as register-only arithmetic over the prefetched bits.
    # Identical results, ~1 HBM round instead of ~2+log2(W).
    if window_scan is None:
        # The sequential cascade won where this was first measured
        # (docs/PERFORMANCE.md at commit 9faeb07): masked lanes re-gather
        # index 0 (cached), so its true traffic is active lanes only, while the
        # wide window pays W probes per lane always. Not yet measured on
        # a GPU.
        window_scan = False
    if window_scan:
        wsz = most_over + most_under + 1
        wstart = pred_w - most_under                       # rank of row 0
        ranks = wstart[None, :] + jnp.arange(wsz, dtype=jnp.int64)[:, None]
        rank_c = jnp.clip(ranks, 0, n - 1).astype(idt)
        win_rev = take_rank(rev, rank_c).astype(idt)        # [W, B]
        pw = probe_at(packed, win_rev, q_words, n=n, length=length)

        def at(win, rank):
            i = jnp.clip((rank.astype(jnp.int64) - wstart), 0, wsz - 1)
            return jnp.take_along_axis(win, i[None].astype(jnp.int32),
                                       axis=0)[0]

        m0, s0 = at(pw.match, pred), at(pw.smaller, pred)
        resolved = m0
        res = jnp.where(m0, at(win_rev, pred), res)
        dir_right = s0

        edge = jnp.where(dir_right, e_right, e_left)
        em, es = at(pw.match, edge), at(pw.smaller, edge)
        hit_a = ~resolved & em
        res = jnp.where(hit_a, at(win_rev, edge), res)
        resolved = resolved | hit_a
        escalate = ~resolved & jnp.where(dir_right, es, ~em & ~es)

        # emulate binarySearch(lo, hi) on the prefetched window bits
        lo = jnp.where(dir_right, pred, e_left).astype(idt)
        hi = jnp.where(dir_right, e_right, pred).astype(idt)
        active = ~resolved & ~escalate
        trips = max(wsz, 2).bit_length() + 2

        def bis(t, st):
            lo, hi, res, resolved, active = st
            base2 = hi == lo + 2
            mid = jnp.where(base2, lo + 1, lo + ((hi - lo) >> 1))
            mm, ms = at(pw.match, mid), at(pw.smaller, mid)
            mrev = at(win_rev, mid)
            now_base = active & base2
            now_match = active & ~base2 & mm
            now_fail = active & ~base2 & ~mm & (lo + 1 >= hi)
            res = jnp.where(now_base | now_match, mrev, res)
            res = jnp.where(now_fail, neg1, res)
            fin = now_base | now_match | now_fail
            resolved = resolved | (fin & ~now_fail)
            go = active & ~fin
            lo = jnp.where(go & ms, mid, lo)
            hi = jnp.where(go & ~ms, mid, hi)
            return lo, hi, res, resolved, active & ~fin

        lo, hi, res, resolved, _ = jax.lax.fori_loop(
            0, trips, bis, (lo, hi, res, resolved, active))
        # non-escalated lanes are fully decided; mark them resolved so the
        # remaining phases skip them (res already holds -1 on failures)
        resolved = resolved | ~escalate
    elif multiprobe and prefix is not None and length <= 32:
        # prefix probes vectorize over any rank shape: fuse the prediction
        # probe and BOTH 'most'-window edge probes into one gather round
        # (one gather round instead of two dependent ones — the engine is
        # gather-round-latency bound)
        pos_p, pp = probe_rank(pred)
        pos_l, pl = probe_rank(e_left)
        pos_r, pr = probe_rank(e_right)
        pos3 = (pos_p, pos_l, pos_r)
        p3 = (pp, pl, pr)
        idx0 = pos3[0]
        m0, s0 = p3[0].match, p3[0].smaller
        resolved = m0
        res = jnp.where(m0, idx0, res)
        dir_right = s0

        edge_idx = jnp.where(dir_right, pos3[2], pos3[1])
        em = jnp.where(dir_right, p3[2].match, p3[1].match)
        es = jnp.where(dir_right, p3[2].smaller, p3[1].smaller)
        hit_a = ~resolved & em
        res = jnp.where(hit_a, edge_idx, res)
        resolved = resolved | hit_a
        escalate = ~resolved & jnp.where(dir_right, es, ~em & ~es)

        lo = jnp.where(dir_right, pred, e_left)
        hi = jnp.where(dir_right, e_right, pred)
    else:
        idx0, p0 = probe_rank(pred)
        resolved = p0.match
        res = jnp.where(p0.match, idx0, res)
        dir_right = p0.smaller  # suffix at pred < query -> search right

        if compact_unresolved and ab is None:
            # see _plquery_fast3: one top-level compaction after the
            # prediction probe moves phases A-D into a [cap] batch;
            # lax.cond-gated full-width fallback covers cap/tail overflow
            b = res.shape[0]
            cap = _compact_cap(b, compact_cap if compact_cap is not None
                               else max(1024, b >> 1))
            enc = _pack_pred_dir(pred, dir_right)
            idxs = _compact_indices(~resolved, cap)
            valid = idxs < b
            idx32 = jnp.minimum(idxs, b - 1).astype(jnp.int32)
            pred_c, dir_c = _unpack_pred_dir(jnp.take(enc, idx32))

            def mk_probe(qw):
                return make_rank_probe(packed, rev, prefix, qw, n=n,
                                       length=length, idt=idt, take=take)

            res_c, done_c = _general_refine(
                mk_probe, jnp.take(q_words, idx32, axis=1), pred_c,
                dir_c, valid, n=n, length=length, k=k,
                most_over=most_over, most_under=most_under,
                max_over=max_over, max_under=max_under,
                max_stride_steps=max_stride_steps, idt=idt,
                tail_cap=max(256, cap >> 4))
            sc = jnp.where(valid & done_c, idx32, jnp.int32(b))
            res = res.at[sc].set(res_c, mode="drop")
            resolved = resolved.at[sc].set(True, mode="drop")

            def fb(st):
                res, resolved = st
                pend = ~resolved
                res_f, _ = _general_refine(
                    mk_probe, q_words, pred, dir_right, pend, n=n,
                    length=length, k=k, most_over=most_over,
                    most_under=most_under, max_over=max_over,
                    max_under=max_under,
                    max_stride_steps=max_stride_steps, idt=idt,
                    tail_cap=None)
                return (jnp.where(pend, res_f, res),
                        jnp.ones_like(resolved))

            res, _ = jax.lax.cond(~resolved.all(), fb, lambda st: st,
                                  (res, resolved))
            return res

        if ab is not None:
            # adaptive pre-phase: this bucket's own max-error window
            # (see _plquery_fast3; same ladder, position-typed results)
            bo, bu = _lane_bounds(ab, x, kbits=2 * k, buckets=buckets,
                                  most_over=most_over,
                                  most_under=most_under)
            a_right = jnp.minimum(jnp.int64(n - 1),
                                  pred_w + bo).astype(idt)
            a_left = jnp.maximum(jnp.int64(0), pred_w - bu).astype(idt)
            aedge = jnp.where(dir_right, a_right, a_left)
            aidx, p1 = probe_rank(jnp.where(resolved, 0, aedge))
            hit1 = ~resolved & p1.match
            res = jnp.where(hit1, aidx, res)
            resolved = resolved | hit1
            need_a = ~resolved & jnp.where(dir_right, p1.smaller,
                                           ~p1.match & ~p1.smaller)
            lo = jnp.where(dir_right, pred, a_left)
            hi = jnp.where(dir_right, a_right, pred)
        else:
            need_a = ~resolved
            lo = jnp.where(dir_right, pred, e_left)
            hi = jnp.where(dir_right, e_right, pred)

        # --- phase A: 'most' window edge (:171-174 right, :209-213 left) ---
        edge = jnp.where(dir_right, e_right, e_left)
        edge_idx, pa = probe_rank(jnp.where(need_a, edge, 0))
        hit_a = need_a & pa.match
        res = jnp.where(hit_a, edge_idx, res)
        resolved = resolved | hit_a
        # escalation (:175 right-still-smaller, :214/:221 left-still-bigger)
        bigger_a = ~pa.match & ~pa.smaller
        escalate = need_a & ~hit_a & jnp.where(dir_right, pa.smaller,
                                               bigger_a)
        if ab is not None:
            lo = jnp.where(need_a, jnp.where(dir_right, a_right, e_left),
                           lo)
            hi = jnp.where(need_a, jnp.where(dir_right, e_right, a_left),
                           hi)

    # --- phase B: 'max' window edge (:180-183 right, :225-228 left) --------
    b_right = jnp.minimum(jnp.int64(n - 1), pred_w + max_over + 1).astype(idt)
    b_left = jnp.maximum(jnp.int64(0), pred_w - max_under - 1).astype(idt)
    bedge = jnp.where(dir_right, b_right, b_left)
    bedge_idx, pb = probe_rank(jnp.where(escalate, bedge, 0))
    hit_b = escalate & pb.match
    res = jnp.where(hit_b, bedge_idx, res)
    resolved = resolved | hit_b
    lo = jnp.where(escalate, jnp.where(dir_right, e_right, b_left), lo)
    hi = jnp.where(escalate, jnp.where(dir_right, b_right, e_left), hi)

    # --- phase C: stride scan, only for queries longer than k (:184-196,
    # :229-241). The reference's loop is unbounded and can livelock at the
    # array ends; we cap iterations and stop when the edge can't advance.
    if length > k:
        scan_r = pb.smaller & ~pb.off_end           # :186 condition
        scan_l = ~pb.match & ~pb.smaller            # :231 condition (bigger)
        active0 = escalate & ~resolved & jnp.where(dir_right, scan_r, scan_l)

        def c_cond(state):
            t, active, *_ = state
            return (t < max_stride_steps) & active.any()

        def c_body(state):
            t, active, lo, hi, res, resolved = state
            new_lo = jnp.where(dir_right, hi, lo)
            step_hi = jnp.minimum(
                jnp.int64(n - 1), hi.astype(jnp.int64) + max_over
            ).astype(idt)
            step_lo = jnp.maximum(
                jnp.int64(0), lo.astype(jnp.int64) - max_under
            ).astype(idt)
            new_hi = jnp.where(dir_right, step_hi, lo)
            new_lo = jnp.where(dir_right, new_lo, step_lo)
            probe_pos = jnp.where(dir_right, new_hi, new_lo)
            stuck = probe_pos == jnp.where(dir_right, hi, lo)
            lo = jnp.where(active, new_lo, lo)
            hi = jnp.where(active, new_hi, hi)
            pidx, pc = probe_rank(jnp.where(active, probe_pos, 0))
            hit = active & pc.match
            res = jnp.where(hit, pidx, res)
            resolved = resolved | hit
            keep = jnp.where(dir_right, pc.smaller & ~pc.off_end,
                             ~pc.match & ~pc.smaller)
            active = active & ~hit & keep & ~stuck
            return t + 1, active, lo, hi, res, resolved

        _, _, lo, hi, res, resolved = jax.lax.while_loop(
            c_cond, c_body, (jnp.int32(0), active0, lo, hi, res, resolved)
        )

    # --- phase D: masked binary search (:245-247) ---------------------------
    if compact_escalate:
        # bisect the escalated tail in a compacted [cap] batch first —
        # the full-width loop below then only runs the shallow
        # most-window depth (see _compact_deep)
        cap = _compact_cap(res.shape[0], compact_cap)
        idx32, valid, _ = _compact_deep(resolved, lo, hi,
                                        most_over + most_under + 2, cap)
        qw_c = jnp.take(q_words, idx32, axis=1)
        probe_c = make_rank_probe(packed, rev, prefix, qw_c, n=n,
                                  length=length, idt=idt, take=take)
        res_c, _ = _masked_binary_search(
            probe_c, jnp.take(lo, idx32), jnp.take(hi, idx32),
            jnp.take(res, idx32), ~valid)
        res, resolved = _scatter_back(res, resolved, idx32, valid, res_c)
    if multiprobe and prefix is not None and length <= 32:
        res, resolved = _masked_binary_search2(probe_rank, lo, hi, res,
                                               resolved)
    else:
        res, resolved = _masked_binary_search(probe_rank, lo, hi, res,
                                              resolved)
    del resolved, neg1
    return res


@functools.partial(jax.jit, static_argnames=("n", "length", "shard_spec"))
def binsearch_batch(packed, rev, q_words, *, n: int, length: int,
                    shard_spec: tuple[str, int] | None = None):
    """Batched classic suffix-array binary search — the baseline being
    beaten (reference: src/binarysearch.cpp:38-58,158-165).

    The reference's bQuery probes rank 0 and rank n-1 first, then searches
    [0, n-1]. Its recursion lacks a not-found guard and can recurse forever
    on absent queries; we resolve those lanes to -1 instead.
    """
    idt = _state_dtype(_rev_dtype(rev))
    take = make_take(shard_spec)
    b = q_words.shape[1]
    res = jnp.full((b,), -1, dtype=idt)

    idx_lo = take(rev, jnp.zeros((b,), jnp.int32)).astype(idt)
    p_lo = probe_at(packed, idx_lo, q_words, n=n, length=length)
    res = jnp.where(p_lo.match, idx_lo, res)
    resolved = p_lo.match
    idx_hi = take(rev, jnp.full((b,), n - 1, jnp.int64)).astype(idt)
    p_hi = probe_at(packed, idx_hi, q_words, n=n, length=length)
    hit = ~resolved & p_hi.match
    res = jnp.where(hit, idx_hi, res)
    resolved = resolved | hit

    # derive from res so the carries inherit its device-varying manual
    # axes under shard_map (a plain constant would trip the vma check)
    lo = res * 0
    hi = res * 0 + jnp.array(n - 1, idt)
    probe_rank = make_rank_probe(packed, rev, None, q_words,
                                 n=n, length=length, idt=idt, take=take)
    res, _ = _masked_binary_search(probe_rank, lo, hi, res, resolved)
    return res


def fancy_binsearch_batch(packed, rev, llcp, rlcp, q_words, *, n: int,
                          length: int, prefix=None):
    """Manber-Myers llcp/rlcp-pruned binary search, batched.

    The reference ships this as `fancyBinarySearch`
    (src/binarysearch.cpp:90-153) but its own bQuery never calls it
    (:158-165) — dead code with a latent bug: the llcp/rlcp midpoint
    tree is initialized over (0, n-k) (:84-86) while the search interval
    is (0, n-1). This implementation follows the intended algorithm with
    tables built over the search interval
    (index.suffix_array.build_llcp_rlcp).

    Per round every lane gathers two small int32 table entries and
    probes the genome ONLY when its llcp/rlcp equals its boundary LCP —
    the classic trick that skips most genome comparisons. Same
    O(log2 n)+2 fixed trip count as the plain search (each branch
    halves the interval). Search-space variant for the baseline
    competition; requires n < 2^31 (the tables are int32-indexed flat).
    """
    idt = _state_dtype(_rev_dtype(rev))
    take = take_rank
    b = q_words.shape[1]
    res = jnp.full((b,), -1, dtype=idt)

    # bQuery pre-probes of rank 0 / n-1 (binarysearch.cpp:158-163); their
    # LCPs seed loLcp/hiLcp
    idx0 = take(rev, jnp.zeros((b,), jnp.int32)).astype(idt)
    p0 = probe_at(packed, idx0, q_words, n=n, length=length)
    res = jnp.where(p0.match, idx0, res)
    resolved = p0.match
    idx1 = take(rev, jnp.full((b,), n - 1, jnp.int64)).astype(idt)
    p1 = probe_at(packed, idx1, q_words, n=n, length=length)
    hit = ~resolved & p1.match
    res = jnp.where(hit, idx1, res)
    resolved = resolved | hit

    probe = make_rank_probe(packed, rev, prefix, q_words,
                            n=n, length=length, idt=idt, take=take)
    lo = res * 0
    hi = res * 0 + jnp.array(n - 1, idt)
    lo_lcp = p0.lcp.astype(jnp.int32)
    hi_lcp = p1.lcp.astype(jnp.int32)
    base_rank = jnp.full((b,), -1, dtype=idt)
    llcp = jnp.asarray(llcp)
    rlcp = jnp.asarray(rlcp)

    def body(_, st):
        lo, hi, lo_lcp, hi_lcp, res, resolved, base_rank = st
        live = ~resolved & (base_rank < 0)
        nf = live & (hi == lo + 1)          # :93 -> n+1 sentinel -> -1
        resolved = resolved | nf
        b2 = live & ~nf & (hi == lo + 2)    # :94 -> rank lo+1, unprobed
        base_rank = jnp.where(b2, lo + 1, base_rank)
        active = live & ~nf & ~b2

        mid = lo + ((hi - lo) >> 1)
        m32 = jnp.clip(mid, 0, n - 1).astype(jnp.int32)
        L = jnp.take(llcp, m32).astype(jnp.int32)
        R = jnp.take(rlcp, m32).astype(jnp.int32)
        condA = lo_lcp >= hi_lcp
        r_np = active & jnp.where(condA, L > lo_lcp, R < hi_lcp)
        l_np = active & jnp.where(condA, L < lo_lcp, R > hi_lcp)
        need = active & ~r_np & ~l_np       # llcp/rlcp == boundary: probe
        pos, p = probe(jnp.where(need, mid, jnp.zeros_like(mid)))
        nlcp = p.lcp.astype(jnp.int32)
        m_hit = need & p.match
        res = jnp.where(m_hit, pos.astype(idt), res)
        resolved = resolved | m_hit
        pr = need & ~p.match & p.smaller    # suffix too small -> right
        pl = need & ~p.match & ~p.smaller
        lo = jnp.where(r_np | pr, mid, lo)
        hi = jnp.where(l_np | pl, mid, hi)
        lo_lcp = jnp.where(~condA & r_np, R, lo_lcp)
        lo_lcp = jnp.where(pr, nlcp, lo_lcp)
        hi_lcp = jnp.where(condA & l_np, L, hi_lcp)
        hi_lcp = jnp.where(pl, nlcp, hi_lcp)
        return lo, hi, lo_lcp, hi_lcp, res, resolved, base_rank

    trips = max(int(n - 1).bit_length() + 2, 2)
    _, _, _, _, res, resolved, base_rank = jax.lax.fori_loop(
        0, trips, body, (lo, hi, lo_lcp, hi_lcp, res, resolved, base_rank))
    # base-case lanes return rev[lo+1] UNverified, exactly like the
    # reference's base case (and the plain search's)
    has_base = base_rank >= 0
    pos_base = take(rev, jnp.where(has_base, base_rank,
                                   jnp.zeros_like(base_rank))).astype(idt)
    return jnp.where(has_base, pos_base, res)
