"""Exact piecewise-linear prediction with integer rational arithmetic.

The reference evaluates the PWL index in C++ `double`
(reference: src/sapling_api.h:98-109):

    predict = (long long)(.5 + ylo + (yhi - ylo) * ((x - xlo) * 1. / (xhi - xlo)))

An accelerator's float64 division need not be IEEE-exact (some backends
emulate it), so we instead compute the same quantity with exact int64 rational arithmetic:
round-half-up of ylo + M*N/D where M = yhi-ylo >= 0, N = x-xlo, D = xhi-xlo.
This is deterministic across backends and agrees with the C++ double except in
pathological double-rounding cases (none observed on the conformance corpora;
tests/test_pwl.py checks against the float64 oracle).

The 128-bit product M*N (up to ~2^74 for k=21 human-scale inputs) is handled
by splitting N in base 2^16 and propagating remainders through two exact
int64 divisions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _divmod_nonneg(p, d):
    """Exact (q, r) for p >= 0, d > 0, works in jnp or np."""
    q = p // d
    return q, p - q * d


def _as_i64(arr, xp):
    """Materialize a table (int64 array or split-(hi,lo)-u32 tuple) as
    one int64 vector — elementwise over the small table, no gathers."""
    i64 = jnp.int64 if xp is jnp else np.int64
    if isinstance(arr, tuple):
        return (arr[0].astype(i64) << 32) | arr[1].astype(i64)
    return arr if arr.dtype == i64 else arr.astype(i64)


PTAB_COLS = 4  # u32 slots per checkpoint row: x_lo32, x_hi16, y32, bounds


def pack_ptab(xlist, ylist, bounds=None):
    """Host-side interleaved checkpoint table: flat uint32 [4*R + 4] with
    row j at [4j, 4j+4) = (x_low32, x_high16, y, bounds_word_or_0).

    ONE sliced 8-u32 gather (ops.query.take_slice) fetches BOTH
    endpoints of a bucket. FLAG-OFF VARIANT: measured slower than the
    4-gather xy64+xhi16 repack where first tried — slice gathers cost
    per-ELEMENT like independent takes, not per-op (docs/PERFORMANCE.md
    at commit 9faeb07). Kept behind device_arrays(use_ptab=True) with
    bit-parity tests to document the search space. Flat 1-D layout on
    purpose: a tiled device layout pads a small trailing axis. Exact
    whenever y < 2^32 (n <= 4.3 Gbp) and x < 2^48 (k <= 24) — the same
    gate as _endpoints_packed. The bounds word ((over << 16) | under,
    index.pwl.bucket_bounds) rides in the spare slot so the
    adaptive-bounds variant costs no extra gather."""
    xl = np.asarray(xlist, dtype=np.int64)
    yl = np.asarray(ylist, dtype=np.int64)
    r = xl.shape[0]
    tbl = np.zeros(PTAB_COLS * r + PTAB_COLS, dtype=np.uint32)
    tbl[0 : PTAB_COLS * r : PTAB_COLS] = (xl & 0xFFFFFFFF).astype(np.uint32)
    tbl[1 : PTAB_COLS * r : PTAB_COLS] = (xl >> 32).astype(np.uint32)
    tbl[2 : PTAB_COLS * r : PTAB_COLS] = (yl & 0xFFFFFFFF).astype(np.uint32)
    if bounds is not None:
        nb = min(len(bounds), r)
        tbl[3 : PTAB_COLS * nb : PTAB_COLS] = np.asarray(
            bounds[:nb], dtype=np.uint32)
    return tbl


def _endpoints_ptab(bucket, ptab):
    """Both checkpoint endpoints of `bucket` from the interleaved table
    in ONE sliced gather. Returns (xlo, xhi, ylo, yhi[, bw]) — bw is the
    bucket's packed bounds word."""
    from .query import take_slice

    sl = take_slice(ptab, (bucket << 2).astype(jnp.int32), 2 * PTAB_COLS)
    i64 = jnp.int64

    def endpoint(o):
        x = ((sl[..., o + 1].astype(i64) << 32)
             | sl[..., o].astype(i64))
        return x, sl[..., o + 2].astype(i64)

    xlo, ylo = endpoint(0)
    xhi, yhi = endpoint(PTAB_COLS)
    return xlo, xhi, ylo, yhi, sl[..., 3]


def pack_pred2(xlist, ylist, kbits: int):
    """Host-side TWO-gather checkpoint packing: per-bucket uint64 pair
    (x2[j], y2[j]) holding (xlo, d=xhi-xlo, ylo, m=yhi-ylo) — the four
    quantities prediction actually consumes — so predict_pwl costs 2
    8-byte gather ops instead of the 4 of the xy64+xhi16 endpoint
    repack (gather ops were the dominant query cost where first
    measured). FLAG-OFF variant: faster in isolation but slower end to
    end inside the fast3 program — in both pair and pre-split quad form,
    so not a u64-argument cost; an unexplained scheduling interaction
    (docs/PERFORMANCE.md at commit 9faeb07). Kept (with bit-parity tests) as search-space record.

    Layout (b = 64 - kbits, spill = max(0, nd - b) where nd = bits of
    max d, nm = bits of max m):
      x2[j] = (xlo << b) | low_b(d)
      y2[j] = (ylo << (nm+spill)) | (m << spill) | (d >> b)
    Validity is a STATIC build-time check (bits(ylo)+nm+spill <= 64) —
    never a per-lane fallback, which measured slower than just paying
    the extra gathers. Typical tables fit easily (bench 4.6 Mbp nb=22:
    42+26+23+7 = 98 of 128 bits). Returns (x2, y2, (b, nm, spill)) or
    None when the table doesn't fit (caller keeps the 4-gather path).
    """
    xl = np.asarray(xlist, dtype=np.int64)
    yl = np.asarray(ylist, dtype=np.int64)
    if xl.shape[0] < 2:
        return None
    d = np.diff(xl)
    m = np.diff(yl)
    if (d < 0).any() or (m < 0).any():
        return None
    bx = 64 - kbits
    if bx <= 0 or bx > 63:
        return None
    nd = max(1, int(d.max()).bit_length())
    nm = max(1, int(m.max()).bit_length())
    ny = max(1, int(yl.max()).bit_length())
    spill = max(0, nd - bx)
    if ny + nm + spill > 64:
        return None
    du = d.astype(np.uint64)
    x2 = ((xl[:-1].astype(np.uint64) << np.uint64(bx))
          | (du & np.uint64((1 << bx) - 1)))
    y2 = ((yl[:-1].astype(np.uint64) << np.uint64(nm + spill))
          | (m.astype(np.uint64) << np.uint64(spill))
          | (du >> np.uint64(bx)))
    return x2, y2, (bx, nm, spill)


def _u64_field(hi, lo, shift: int, width: int):
    """(word >> shift) & ((1<<width)-1) of a uint64 decomposed into u32
    halves (hi, lo), with STATIC shift/width — pure 32-bit ops plus one
    i64 assemble only when the field straddles the half boundary (u64
    shifts emulate as several 32-bit ops each, so fields are cut out of
    the halves directly)."""
    i64 = jnp.int64
    if width <= 0:
        return jnp.zeros(hi.shape, i64)
    if shift >= 32:
        v = (hi >> (shift - 32)).astype(i64)
    elif shift + width <= 32:
        v = (lo >> shift).astype(i64)
    else:
        v = (lo.astype(i64) >> shift) | (hi.astype(i64) << (32 - shift))
    return v & ((1 << width) - 1)


def _parts_pred2(bucket, pred2, pred2_bits, kbits: int):
    """(xlo, d, ylo, m) of `bucket` from the pack_pred2 table.

    pred2 is either the (x2, y2) uint64 pair — TWO 8-byte gathers, the
    small-table default — or its pre-split (x2hi, x2lo, y2hi, y2lo)
    uint32 quad — FOUR 4-byte gathers but no X64-rewrite arg doubling
    (u64 jit args are materialized twice on device, which matters when
    the bucket table is GBs)."""
    bx, nm, spill = pred2_bits

    def take_halves(a):
        pair = jax.lax.bitcast_convert_type(jnp.take(a, bucket), jnp.uint32)
        return pair[..., 1], pair[..., 0]  # (hi, lo)

    if len(pred2) == 4:
        i32b = bucket.astype(jnp.int32)
        xh, xl = jnp.take(pred2[0], i32b), jnp.take(pred2[1], i32b)
        yh, yl = jnp.take(pred2[2], i32b), jnp.take(pred2[3], i32b)
    else:
        xh, xl = take_halves(pred2[0])
        yh, yl = take_halves(pred2[1])
    xlo = _u64_field(xh, xl, bx, kbits)
    d = _u64_field(xh, xl, 0, bx) | (_u64_field(yh, yl, 0, spill) << bx)
    m = _u64_field(yh, yl, spill, nm)
    ylo = _u64_field(yh, yl, spill + nm, 64 - spill - nm)
    return xlo, d, ylo, m


def _endpoints_packed(bucket, xlist, ylist, need_hi: bool = True):
    """Checkpoint gathers via one uint64 per endpoint + ONE shared uint32.

    The int64 tables cost two u32 gather OPS per value under the
    X64-rewrite — 8 per prediction, measured as the single largest cost
    of a k=21 query where first profiled (docs/PERFORMANCE.md at commit
    9faeb07; gather ops cost per-lane throughput regardless of masking,
    so any per-lane fallback scheme loses). Deterministic repack: xy64[j] = (x_low32 << 32) | y, and the
    x high bits of BOTH endpoints of bucket j ride one uint32
    xhp[j] = (xhi16[j] << 16) | xhi16[j+1] — exact for every entry
    whenever y < 2^32 (n <= 4.3 Gbp) and x < 2^48 (k <= 24), i.e. 3
    cheap gather ops per prediction, no fallback. Reconstruction is
    exact int math — bit-identical predictions. Built elementwise on
    device (tiny vs one gather round); XLA hoists it out of query loops.
    """
    xl64 = _as_i64(xlist, jnp)
    yl64 = _as_i64(ylist, jnp)
    xy = ((xl64.astype(jnp.uint64) << 32)
          | (yl64.astype(jnp.uint64) & jnp.uint64(0xFFFFFFFF)))

    def endpoint(j, hi16):
        w = jnp.take(xy, j)
        pair = jax.lax.bitcast_convert_type(w, jnp.uint32)
        y32, x32 = pair[..., 0], pair[..., 1]
        x = x32.astype(jnp.int64)
        if hi16 is not None:
            x = (hi16.astype(jnp.int64) << 32) | x
        return x, y32.astype(jnp.int64)

    if need_hi:
        xh = xl64 >> 32
        xhp = ((xh[:-1] << 16) | xh[1:]).astype(jnp.uint32)
        hp = jnp.take(xhp, bucket)
        hi_lo, hi_hi = hp >> 16, hp & 0xFFFF
    else:
        # k <= 16 (kbits <= 32): every x fits the xy64 low half — the
        # high-bits gather is statically zero and skipped (2 gather ops)
        hi_lo = hi_hi = None
    xlo, ylo = endpoint(bucket, hi_lo)
    xhi, yhi = endpoint(bucket + 1, hi_hi)
    return xlo, xhi, ylo, yhi


def predict_pwl(x, xlist, ylist, kbits: int, buckets: int, n: int, xp=jnp,
                ptab=None, pred2=None, pred2_bits=None):
    """Batched PWL prediction.

    x:      int64 [B] k-mer values
    xlist:  int64 [2^buckets + 1]
    ylist:  int64 [2^buckets + 1]
    kbits:  2*k (total bits in a k-mer value)
    n:      genome length (predictions are clamped to [0, n-1]; the reference
            clamps only below at 0 — src/sapling_api.h:107 — and reads
            rev[] out of bounds for x beyond the last checkpoint, which we
            refuse to reproduce).
    ptab:   optional pack_ptab table — when given, both endpoints come
            from ONE sliced gather and xlist/ylist may be None (flag-off
            variant; measured slower, see pack_ptab).
    pred2:  optional (x2, y2) pack_pred2 pair with its static
            pred2_bits — prediction in TWO 8-byte gathers (flag-off
            variant; measured slower end-to-end, see pack_pred2).

    Returns int64 [B] predicted suffix-array ranks.
    """
    shift = kbits - buckets
    bucket = (x >> shift).astype(jnp.int64 if xp is jnp else np.int64)
    if pred2 is not None:
        xlo, d, ylo, m = _parts_pred2(bucket, pred2, pred2_bits, kbits)
        return _predict_from_parts(x, xlo, d, ylo, m, n, xp)
    if ptab is not None:
        xlo, xhi, ylo, yhi, _bw = _endpoints_ptab(bucket, ptab)
        return _predict_from_endpoints(x, xlo, xhi, ylo, yhi, n, xp)

    def tk(arr, i):
        if xp is jnp:
            i = i.astype(jnp.int32)  # tables are < 2^31 entries
        if isinstance(arr, tuple):
            # split storage (hi, lo): avoids the X64-rewrite pass
            # materializing duplicate 32-bit copies of s64 arguments on
            # device; hi may be u16 (x fits 48
            # bits) or u32
            hi = xp.take(arr[0], i).astype(jnp.int64 if xp is jnp else np.int64)
            lo = xp.take(arr[1], i).astype(jnp.int64 if xp is jnp else np.int64)
            return (hi << 32) | lo
        v = xp.take(arr, i)
        if v.dtype != (jnp.int64 if xp is jnp else np.int64):
            v = v.astype(jnp.int64 if xp is jnp else np.int64)
        return v

    repack_ok = n <= (1 << 31)
    if not repack_ok and n < (1 << 32):
        # The repack itself is exact for every y < 2^32 (docstring of
        # _endpoints_packed); above 2^31 bases it is gated off only for
        # its device temps (~12 B/checkpoint next to a multi-GB rev).
        # SAPLING_PRED_REPACK_BIG=1 opts in for the end-to-end A/B.
        import os

        repack_ok = os.environ.get("SAPLING_PRED_REPACK_BIG", "0") == "1"
    if xp is jnp and repack_ok and kbits <= 48:
        # Below 2^31 bases the xy64+xhi16 repack temps (10 B/checkpoint
        # on device) are affordable and save 2-4 gather ops. Above —
        # GRCh38-scale, where rev alone is ~12.4 GB — prediction
        # gathers straight from the slim split arguments instead
        # ((u16 hi, u32 lo) xlist + u32 ylist, index.sapling
        # .device_arrays): 6 gather ops, zero repack temps.
        xlo, xhi, ylo, yhi = _endpoints_packed(bucket, xlist, ylist,
                                               need_hi=kbits > 32)
    else:
        xlo = tk(xlist, bucket)
        xhi = tk(xlist, bucket + 1)
        ylo = tk(ylist, bucket)
        yhi = tk(ylist, bucket + 1)
    return _predict_from_endpoints(x, xlo, xhi, ylo, yhi, n, xp)


def _predict_from_endpoints(x, xlo, xhi, ylo, yhi, n, xp):
    return _predict_from_parts(x, xlo, xhi - xlo, ylo, yhi - ylo, n, xp)


def _predict_from_parts(x, xlo, d, ylo, m, n, xp):
    # m = yhi - ylo >= 0 (ylist nondecreasing), < n
    # d = xhi - xlo > 0 unless degenerate bucket
    nn = x - xlo           # may be negative for out-of-genome kmers

    a = xp.abs(nn)
    nh = a >> 16
    nl = a & 0xFFFF
    d_safe = xp.where(d == 0, 1, d)
    q1, r1 = _divmod_nonneg(m * nh, d_safe)
    q2, r2 = _divmod_nonneg((r1 << 16) + m * nl, d_safe)
    q = (q1 << 16) + q2
    r = r2
    # round-half-up of ylo + sign * (q + r/d): see module docstring.
    pred_pos = ylo + q + xp.where(2 * r >= d_safe, 1, 0)
    pred_neg = ylo - q - xp.where(2 * r > d_safe, 1, 0)
    pred = xp.where(nn >= 0, pred_pos, pred_neg)
    pred = xp.where(d == 0, ylo, pred)
    return xp.clip(pred, 0, n - 1)


def predict_pwl_f64(x, xlist, ylist, kbits: int, buckets: int, n: int):
    """NumPy float64 oracle with the reference's exact C++ double semantics
    (src/sapling_api.h:98-109), including no upper clamp. Host-side only;
    used by tests and the build-time audit cross-check."""
    shift = kbits - buckets
    bucket = x >> shift
    xlo = xlist[bucket]
    xhi = xlist[bucket + 1]
    ylo = ylist[bucket]
    yhi = ylist[bucket + 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (x - xlo).astype(np.float64) / (xhi - xlo).astype(np.float64)
    val = 0.5 + ylo + (yhi - ylo) * ratio
    pred = val.astype(np.int64)  # C-style truncation toward zero
    pred = np.where(pred < 0, 0, pred)
    pred = np.where(xlo == xhi, ylo, pred)
    return pred
