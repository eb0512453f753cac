"""Batched affine-gap Smith-Waterman scoring.

Replacement for the vendored striped Smith-Waterman SSE2 kernels
(reference: src/ssw.c:192-380 byte pass, :406-580 word pass). The striping
is an SSE2 register trick; on an accelerator the natural inversion is
*batch* parallelism: score B (query, ref-window) candidate pairs at once.
sw_pass is the plain form, a `lax.scan` over reference columns vectorized
[B, W] over lanes x query rows; on a GPU, sw_kernel() picks the CUDA
kernel of ops/sw_cuda.py, which computes the same fields bit for bit.

The only sequential hazard in a column-major sweep is the vertical gap
recurrence F[j] = max(F[j-1]-gapE, H[j-1]-gapO) (H depends on F in the
same column — ssw.c's "lazy-F" loop exists for exactly this). Because
gapO >= gapE, substituting H = max(H_nof, F) gives
F[j] = max(F[j-1]-gapE, H_nof[j-1]-gapO), which is a decayed running max:
F[j] + gapE*j = cummax(H_nof[j-1] - gapO + gapE*j) — ONE cumulative max
per column instead of a data-dependent fixup loop.

Parity notes vs ssw.c (validated in tests against a direct NumPy oracle):
  * score1 is exact int32 (the byte kernel's 255-overflow -> word-kernel
    rerun, ssw.c:835-841, always converges to the exact score).
  * ref_end = EARLIEST column attaining the global max (strict-greater
    update, ssw.c:320-328); read_end = SMALLEST row attaining it in that
    column (ssw.c:337-345).
  * score2/ref_end2 = the best column max outside +/-mask_len of ref_end
    (ssw.c:355-373), earliest column on ties.
  * SSE pad rows: the striped kernels round the query up to a multiple of
    16 (byte) / 8 (word) rows whose substitution score is 0 for every ref
    base (qP_byte ssw.c:158-166: pad profile = bias). Those rows carry
    real scores diagonally "for free" and leak into the per-column maxima
    (score2, and the reverse pass's terminate test) but never into the
    global max. `pad_to` reproduces this exactly; pad rows are excluded
    from read_end tracking, matching ssw.c:337-345's striped index map.
  * terminate: the reverse pass stops at the first column whose column
    max equals the forward score (ssw.c:333-334), after updating the best
    (so the terminating column can win). terminate=-1 disables.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.int32(-(1 << 30))


@functools.partial(
    jax.jit,
    static_argnames=("match", "mismatch", "gap_open", "gap_extend",
                     "mask_len", "pad_to", "second_inclusive",
                     "score_only"),
)
def sw_pass(
    query, qlen, ref, rlen, terminate,
    *, match: int = 2, mismatch: int = 2, gap_open: int = 3,
    gap_extend: int = 1, mask_len: int = 15, pad_to: int = 16,
    second_inclusive: bool = False, score_only: bool = False,
):
    """One SW scoring pass over B candidate pairs.

    query: int8/int32 [B, W] base codes 0..4 (4 = N, mismatches everything)
    qlen:  int32 [B] true query lengths (rows beyond are dead)
    ref:   int8/int32 [B, R] base codes
    rlen:  int32 [B] true ref-window lengths (columns beyond are skipped)
    terminate: int32 [B]; stop updating a lane after a column max equals
               this value (-1 = never).

    Returns dict of int32 [B] arrays: score, ref_end, read_end, score2,
    ref_end2. ref_end = -1 when nothing scored > 0 (unaligned lane).
    """
    if gap_open < gap_extend:
        raise ValueError("decayed-max F factorization requires gapO >= gapE")
    b, w = query.shape
    # room for every lane's SSE pad rows: ceil(qlen/pad_to)*pad_to <= w'
    wpad = ((w + pad_to - 1) // pad_to) * pad_to
    if wpad != w:
        query = jnp.pad(query, ((0, 0), (0, wpad - w)))
        w = wpad
    r = ref.shape[1]
    q = query.astype(jnp.int32)
    refi = ref.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    terminate = terminate.astype(jnp.int32)

    jidx = jnp.arange(w, dtype=jnp.int32)[None, :]          # [1, W]
    valid_row = jidx < qlen[:, None]                        # [B, W] real rows
    padlen = ((qlen + pad_to - 1) // pad_to) * pad_to
    live_row = jidx < padlen[:, None]                       # real + SSE pads
    ge_j = gap_extend * jidx                                # decay offsets

    if score_only:
        # Score-value-only sweep: per-cell running max instead of the
        # per-column reductions + best-column snapshot — the global max
        # VALUE is all the fused winner program needs for every
        # non-winner candidate (terminate unsupported: value-exact
        # early-out is a reverse-pass concern). Returns {"score"} only;
        # the value is bit-identical to the full pass's score (same
        # recurrence, same masks).
        def column_s(carry, i):
            h, e, best_h = carry
            rbase = refi[:, i][:, None]
            sub = jnp.where((q == rbase) & (q < 4), match, -mismatch)
            sub = jnp.where(valid_row, sub, 0)
            diag = jnp.pad(h[:, :-1], ((0, 0), (1, 0)))
            h_nof = jnp.maximum(jnp.maximum(diag + sub, e), 0)
            h_nof = jnp.where(live_row, h_nof, 0)
            a = jnp.pad(h_nof[:, :-1] - gap_open, ((0, 0), (1, 0)),
                        constant_values=int(NEG))
            f = jax.lax.cummax(a + ge_j, axis=1) - ge_j
            h_new = jnp.where(live_row, jnp.maximum(h_nof, f), 0)
            e_new = jnp.where(
                live_row, jnp.maximum(e - gap_extend, h_new - gap_open),
                NEG)
            col_ok = (i < rlen)[:, None]
            best_h = jnp.where(col_ok, jnp.maximum(best_h, h_new), best_h)
            h = jnp.where(col_ok, h_new, h)
            e = jnp.where(col_ok, e_new, e)
            return (h, e, best_h), None

        zero = jnp.zeros((b, w), jnp.int32)
        (h, e, best_h), _ = jax.lax.scan(
            column_s, (zero, jnp.full((b, w), NEG, jnp.int32), zero),
            jnp.arange(r, dtype=jnp.int32))
        return {"score": jnp.max(jnp.where(valid_row, best_h, 0), axis=1)}

    def column(carry, i):
        h, e, best, best_ref, best_col, done = carry
        rbase = refi[:, i][:, None]                         # [B, 1]
        sub = jnp.where((q == rbase) & (q < 4), match, -mismatch)
        sub = jnp.where(valid_row, sub, 0)                  # pad rows: 0
        diag = jnp.pad(h[:, :-1], ((0, 0), (1, 0)))         # H[j-1] prev col
        h_nof = jnp.maximum(jnp.maximum(diag + sub, e), 0)
        h_nof = jnp.where(live_row, h_nof, 0)
        # F via decayed running max (see module docstring)
        a = jnp.pad(h_nof[:, :-1] - gap_open, ((0, 0), (1, 0)),
                    constant_values=int(NEG))
        f = jax.lax.cummax(a + ge_j, axis=1) - ge_j
        h_new = jnp.where(live_row, jnp.maximum(h_nof, f), 0)
        e_new = jnp.where(
            live_row, jnp.maximum(e - gap_extend, h_new - gap_open), NEG
        )

        col_ok = (i < rlen) & ~done
        colmax_real = jnp.max(jnp.where(valid_row, h_new, -1), axis=1)
        colmax_pad = jnp.max(jnp.where(live_row, h_new, -1), axis=1)
        upd = col_ok & (colmax_real > best)
        best = jnp.where(upd, colmax_real, best)
        best_ref = jnp.where(upd, i, best_ref)
        best_col = jnp.where(upd[:, None], h_new, best_col)
        done = done | (col_ok & (colmax_pad == terminate))
        # freeze H/E on finished lanes (the C loop broke out)
        h = jnp.where(col_ok[:, None], h_new, h)
        e = jnp.where(col_ok[:, None], e_new, e)
        colmax_out = jnp.where(col_ok, colmax_pad, 0)
        return (h, e, best, best_ref, best_col, done), colmax_out

    zero = jnp.zeros((b, w), jnp.int32)
    init = (
        zero,                                   # H
        jnp.full((b, w), NEG, jnp.int32),       # E
        jnp.zeros((b,), jnp.int32),             # best score
        jnp.full((b,), -1, jnp.int32),          # best ref col
        zero,                                   # H at best col
        jnp.zeros((b,), bool),                  # done
    )
    (h, e, best, best_ref, best_col, done), colmax = jax.lax.scan(
        column, init, jnp.arange(r, dtype=jnp.int32)
    )
    colmax = colmax.T                           # [B, R]

    # read_end: smallest real row attaining the max in the best column
    hit = valid_row & (best_col == best[:, None])
    read_end = jnp.where(
        hit.any(axis=1), jnp.argmax(hit, axis=1), qlen - 1
    ).astype(jnp.int32)

    # second best: best column max outside [ref_end-mask, ref_end+mask]
    iidx = jnp.arange(r, dtype=jnp.int32)[None, :]
    lo_edge = jnp.maximum(best_ref - mask_len, 0)[:, None]
    hi_edge = jnp.minimum(best_ref + mask_len, rlen)[:, None]
    # the reference's 8-bit kernel excludes the right edge column
    # (ssw.c:366: i = edge + 1), the 16-bit kernel includes it
    # (ssw.c:571: i = edge) — second_inclusive selects the word behavior.
    right_ok = (iidx >= hi_edge) if second_inclusive else (iidx > hi_edge)
    eligible = ((iidx < lo_edge) | right_ok) & (iidx < rlen[:, None])
    masked = jnp.where(eligible, colmax, 0)
    score2 = jnp.max(masked, axis=1)
    has2 = score2 > 0
    ref_end2 = jnp.where(has2, jnp.argmax(masked, axis=1), 0).astype(jnp.int32)

    return {
        "score": best,
        "ref_end": best_ref,
        "read_end": read_end,
        "score2": score2,
        "ref_end2": ref_end2,
    }


def _default_platform() -> str:
    """Platform of the device that new arrays land on: the one set by
    `jax.default_device(...)` if any, else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def sw_kernel(platform: str | None = None, use_kernel: bool = True):
    """The scoring pass for a platform (default: that of the default
    device, which `jax.default_device(...)` sets).

    'gpu' -> the CUDA kernel (ops/sw_cuda.py), or sw_pass with
    use_kernel=False (for A/B timing); 'cpu' -> sw_pass. Any other
    platform raises, and so does a failed CUDA build: nothing falls back
    silently."""
    platform = platform or _default_platform()
    if platform == "cpu" or (platform == "gpu" and not use_kernel):
        return sw_pass
    if platform == "gpu":
        from .sw_cuda import _register, sw_pass_cuda

        _register()  # build + register now, not inside a trace
        return sw_pass_cuda
    raise ValueError(f"no Smith-Waterman pass for platform {platform!r}")


def _pad_bucket(b0: int, min_size: int = 256) -> int:
    """Candidate-axis pad bucket for the hot from-genome SW paths:
    round up to a 4-significant-bit bucket (always a multiple of 256).
    Next-pow-2 padding wasted up to 2x DP compute on pad lanes (an
    8192-read block's ~82k candidates padded to 131k; 16384-read blocks
    fell off a 2x cliff at 164k->262k); this caps waste at ~12.5% while
    keeping distinct jit shapes bounded (<=16 per octave, each a
    one-time compile covered by a corpus-shaped warmup)."""
    if b0 <= min_size:
        return min_size
    step = max(256, 1 << (b0.bit_length() - 4))
    return -(-b0 // step) * step


def sw_align_ends(query, qlen, ref, rlen, *, match=2, mismatch=2,
                  gap_open=3, gap_extend=1, mask_len=15, use_kernel=True,
                  forward_only=False):
    """Forward + reverse passes: full ssw_align endpoint semantics
    (reference: src/ssw.c:810-901) for a batch.

    Returns dict with score, score2, ref_end2, ref_begin, ref_end,
    read_begin, read_end (all int32 [B], genome-window coordinates).
    With forward_only=True the reverse pass is skipped and the begin
    fields are omitted — callers that select a winning subset first can
    compute begins for just those rows via sw_align_begins (the reverse
    pass is ~half the scoring FLOPs; winners are typically <<1% of
    candidates in the aligner).

    The byte/word kernel split (ssw.c:835-841) changes only the SSE pad
    multiple: byte pads to 16 rows, word to 8. A lane reruns in word mode
    when its byte score saturates (score + bias >= 255, bias = mismatch).

    Shapes are padded to canonical buckets (B -> power of two, W -> x128
    lanes, R -> x32 columns) so repeated calls with nearby sizes reuse one
    compiled executable.

    The pass is sw_kernel(use_kernel=use_kernel): the CUDA kernel on a
    GPU, sw_pass on the CPU (bit-identical results).
    """
    _pass = sw_kernel(use_kernel=use_kernel)

    query = np.asarray(query)
    ref = np.asarray(ref)
    qlen = np.asarray(qlen, np.int32)
    rlen = np.asarray(rlen, np.int32)
    b0, w0 = query.shape
    r0 = ref.shape[1]
    b = max(256, 1 << (b0 - 1).bit_length())
    w = ((w0 + 127) // 128) * 128
    r = ((r0 + 31) // 32) * 32
    query = np.pad(query, ((0, b - b0), (0, w - w0)))
    ref = np.pad(ref, ((0, b - b0), (0, r - r0)))
    qlen = np.pad(qlen, (0, b - b0), constant_values=1)
    rlen = np.pad(rlen, (0, b - b0), constant_values=1)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mask_len=mask_len)
    no_term = np.full(b, -1, np.int32)

    fwd = {k: np.asarray(v) for k, v in
           _pass(query, qlen, ref, rlen, no_term, pad_to=16, **kw).items()}
    overflow = fwd["score"] + mismatch >= 255
    if overflow.any():
        fw = {k: np.asarray(v) for k, v in
              _pass(query, qlen, ref, rlen, no_term, pad_to=8, second_inclusive=True, **kw).items()}
        for k in fwd:
            fwd[k] = np.where(overflow, fw[k], fwd[k])

    if forward_only:
        return {
            "score": fwd["score"][:b0],
            "score2": fwd["score2"][:b0],
            "ref_end2": fwd["ref_end2"][:b0],
            "ref_end": fwd["ref_end"][:b0],
            "read_end": fwd["read_end"][:b0],
        }

    # reverse pass: reversed query prefix [0..read_end] vs reversed ref
    # prefix [0..ref_end], terminate at the forward score (ssw.c:860-875)
    q_end, r_end = fwd["read_end"], fwd["ref_end"]
    qlen_rev = (q_end + 1).astype(np.int32)
    rlen_rev = (r_end + 1).astype(np.int32)
    jr = np.arange(query.shape[1])[None, :]
    ir = np.arange(ref.shape[1])[None, :]
    qr_idx = np.clip(q_end[:, None] - jr, 0, None)
    rr_idx = np.clip(r_end[:, None] - ir, 0, None)
    q_rev = np.take_along_axis(query, qr_idx, axis=1)
    r_rev = np.take_along_axis(ref, rr_idx, axis=1)
    term = fwd["score"].astype(np.int32)

    rev = {k: np.asarray(v) for k, v in
           _pass(q_rev, qlen_rev, r_rev, rlen_rev, term, pad_to=16, **kw).items()}
    if overflow.any():
        rv = {k: np.asarray(v) for k, v in
              _pass(q_rev, qlen_rev, r_rev, rlen_rev, term, pad_to=8, second_inclusive=True, **kw).items()}
        for k in rev:
            rev[k] = np.where(overflow, rv[k], rev[k])

    return {
        "score": fwd["score"][:b0],
        "score2": fwd["score2"][:b0],
        "ref_end2": fwd["ref_end2"][:b0],
        "ref_end": r_end[:b0],
        "read_end": q_end[:b0],
        "ref_begin": (r_end - rev["ref_end"])[:b0],
        "read_begin": (q_end - rev["read_end"])[:b0],
    }


def _decode_windows(packed, codes_mat, cand_ei, qlen, w0, lo_mod, rlen,
                    rmax):
    """Traced helper: materialize [C, WMAX] query rows (codes_mat gather,
    tails zeroed) and [C, rmax] ref windows decoded from the big-endian
    2-bit packed genome (ops/pack.py pack_codes layout: base p lives in
    word p>>4 at bit 30-2*(p&15))."""
    q = codes_mat[cand_ei].astype(jnp.int32)            # [C, WMAX]
    col = jnp.arange(q.shape[1], dtype=jnp.int32)[None, :]
    q = jnp.where(col < qlen[:, None], q, 0)

    # Row-aligned word shift instead of a per-element take_along_axis:
    # the in-word offset lo_mod is UNIFORM per row, so the window's words
    # realign with one funnel shift (w'_j = wv_j << 2*m | wv_{j+1} >>
    # 32-2*m) and every base then decodes at a static stride. The
    # [C, rmax] element gather this replaces was most of the fused SW
    # program's runtime where first profiled. Bit-identical output.
    na = rmax // 16
    widx = jnp.minimum(
        w0[:, None] + jnp.arange(na + 1, dtype=jnp.int32)[None, :],
        jnp.int32(packed.shape[0] - 1))
    wv = packed[widx]                                    # [C, na+1] u32
    sh = (lo_mod.astype(jnp.uint32) * 2)[:, None]        # [C, 1]
    hi_part = jnp.where(sh == 0, jnp.uint32(0),
                        wv[:, 1:] >> (jnp.uint32(32) - sh))
    al = (wv[:, :na] << sh) | hi_part                    # aligned words
    shifts = jnp.arange(30, -2, -2, dtype=jnp.uint32)[None, None, :]
    bases = ((al[:, :, None] >> shifts) & jnp.uint32(3)).astype(jnp.int32)
    r = bases.reshape(bases.shape[0], rmax)              # [C, rmax]
    jcol = jnp.arange(rmax, dtype=jnp.int32)[None, :]
    r = jnp.where(jcol < rlen[:, None], r, 0)
    return q, r


@functools.partial(
    jax.jit,
    static_argnames=("rmax", "match", "mismatch", "gap_open", "gap_extend",
                     "mask_len", "pad_to", "second_inclusive", "sw_fn"),
)
def _sw_fwd_from_genome(packed, codes_mat, cand_ei, qlen, w0, lo_mod, rlen,
                        *, rmax, match, mismatch, gap_open, gap_extend,
                        mask_len, pad_to, second_inclusive, sw_fn):
    """Gather candidate windows ON DEVICE and run the forward SW pass in
    one program: q rows from codes_mat, ref windows decoded from the
    big-endian 2-bit packed genome (ops/pack.py pack_codes layout: base p
    lives in word p>>4 at bit 30-2*(p&15)). Eliminates the host-side
    window materialization and its [C, W+R] host->device transfer (the
    packed genome is device-resident)."""
    q, r = _decode_windows(packed, codes_mat, cand_ei, qlen, w0, lo_mod,
                           rlen, rmax)
    term = jnp.full(q.shape[0], -1, jnp.int32)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mask_len=mask_len)
    return sw_fn(q, qlen, r, rlen, term, pad_to=pad_to,
                 second_inclusive=second_inclusive, **kw)


def sw_align_ends_from_genome(packed, codes_mat, cand_ei, qlen, lo, rlen,
                              *, match=2, mismatch=2, gap_open=3,
                              gap_extend=1, mask_len=15):
    """Forward-only sw_align_ends where ref windows come straight from the
    device-resident packed genome (u32 words, >= rmax//16+1 pad words —
    pack_codes' default build pads 16) instead of a host-built [C, R]
    matrix. codes_mat is the [NE, WMAX] per-entry read-code matrix; each
    candidate row is (cand_ei, qlen, lo, rlen): query = codes_mat[cand_ei]
    [:qlen], ref window = genome[lo : lo+rlen]. Bit-identical to
    sw_align_ends(forward_only=True) on the equivalent host-built windows
    (tests/test_sw.py::test_from_genome_matches_host_windows)."""
    cand_ei = np.asarray(cand_ei, np.int32)
    qlen = np.asarray(qlen, np.int32)
    lo = np.asarray(lo, np.int64)
    rlen = np.asarray(rlen, np.int32)
    b0 = cand_ei.shape[0]
    b = _pad_bucket(b0)
    rmax = ((int(rlen.max()) if b0 else 1) + 31) // 32 * 32
    cand_ei = np.pad(cand_ei, (0, b - b0))
    qlen = np.pad(qlen, (0, b - b0), constant_values=1)
    rlen = np.pad(rlen, (0, b - b0), constant_values=1)
    lo = np.pad(lo, (0, b - b0))
    # 64-bit genome positions split on host: word index + in-word offset
    # both fit int32 at any genome scale (w0 < n/16 < 2^31 for n < 32 Gbp)
    w0 = (lo >> 4).astype(np.int32)
    lo_mod = (lo & 15).astype(np.int32)

    kw = dict(rmax=rmax, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mask_len=mask_len,
              sw_fn=sw_kernel())
    fwd = {k: np.asarray(v) for k, v in
           _sw_fwd_from_genome(packed, codes_mat, cand_ei, qlen, w0,
                               lo_mod, rlen, pad_to=16,
                               second_inclusive=False, **kw).items()}
    overflow = fwd["score"] + mismatch >= 255
    if overflow.any():
        fw = {k: np.asarray(v) for k, v in
              _sw_fwd_from_genome(packed, codes_mat, cand_ei, qlen, w0,
                                  lo_mod, rlen, pad_to=8,
                                  second_inclusive=True, **kw).items()}
        for k in fwd:
            fwd[k] = np.where(overflow, fw[k], fwd[k])
    return {k: fwd[k][:b0] for k in
            ("score", "score2", "ref_end2", "ref_end", "read_end")}


# row order of the stacked winner-program result (after the win row)
_WINNER_FIELDS = ("score", "ref_end", "read_end", "score2", "ref_end2",
                  "ref_begin", "read_begin")


@functools.partial(
    jax.jit,
    static_argnames=("nr", "rmax", "match", "mismatch", "gap_open",
                     "gap_extend", "mask_len", "sw_fn"),
)
def _sw_winner_from_genome(packed, codes_mat, cand_ei, qlen, w0, lo_mod,
                           rlen, cand_rd, *, nr, rmax, match, mismatch,
                           gap_open, gap_extend, mask_len, sw_fn):
    """ONE program per aligner block: decode windows, forward-score all
    candidates, select each read's winner (first row attaining the
    per-read max — the reference's strict-greater serial walk), and run
    the reverse (begin-position) pass on just the winner rows.

    cand_rd: int32 [C] read id per candidate row, ascending (walk order);
    pad rows carry read id nr. Returns one stacked int32 [1+7, nr] array
    (row 0 = win[read], the winning candidate row; rows 1.. =
    _WINNER_FIELDS per-read endpoint arrays) so the host makes a single
    fetch. Candidates run a score-only sweep; full fields
    (incl. the reverse begin pass) run on the <= nr winner rows only.

    Winner selection uses the 16-pad forward score, which is exact for
    both SSW kernel modes (the byte/word split only changes SSE pad-row
    semantics — score2/ref_end2 — never the global max; see sw_pass
    docstring). Overflowing winners (score+mismatch >= 255) get their
    pad-8 fields recomputed host-side by the caller."""
    q, r = _decode_windows(packed, codes_mat, cand_ei, qlen, w0, lo_mod,
                           rlen, rmax)
    term = jnp.full(q.shape[0], -1, jnp.int32)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mask_len=mask_len)
    # score-VALUE-only sweep over every candidate (winner selection needs
    # nothing else; skipping the per-column reductions + best-column
    # snapshot for the ~10x-larger candidate batch is most of this
    # program's win)
    fwd = sw_fn(q, qlen, r, rlen, term, pad_to=16, score_only=True, **kw)

    c = q.shape[0]
    sc = fwd["score"]
    best = jax.ops.segment_max(sc, cand_rd, num_segments=nr + 1,
                               indices_are_sorted=True)
    rowid = jnp.arange(c, dtype=jnp.int32)
    isb = sc == best[cand_rd]
    # empty segments get int32 max (segment_min identity) = no winner
    win = jax.ops.segment_min(
        jnp.where(isb, rowid, jnp.int32(np.iinfo(np.int32).max)),
        cand_rd, num_segments=nr + 1, indices_are_sorted=True)[:nr]
    wv = jnp.clip(win, 0, c - 1)

    qw_, rw_ = q[wv], r[wv]
    # full-field forward pass on just the <= nr winner rows: SW lanes are
    # independent, so each row's fields here are bit-identical to the
    # ones a full-batch pass would return for it
    out = sw_fn(qw_, qlen[wv], rw_, rlen[wv],
                jnp.full(wv.shape[0], -1, jnp.int32), pad_to=16, **kw)
    # reverse pass on the <= nr winner rows (ssw.c:860-875 semantics,
    # same as sw_align_begins: reversed prefixes, terminate at score)
    q_end, r_end = out["read_end"], out["ref_end"]
    jr = jnp.arange(qw_.shape[1], dtype=jnp.int32)[None, :]
    ir = jnp.arange(rw_.shape[1], dtype=jnp.int32)[None, :]
    q_rev = jnp.take_along_axis(
        qw_, jnp.clip(q_end[:, None] - jr, 0, None), axis=1)
    r_rev = jnp.take_along_axis(
        rw_, jnp.clip(r_end[:, None] - ir, 0, None), axis=1)
    rev = sw_fn(q_rev, (q_end + 1).astype(jnp.int32), r_rev,
                (r_end + 1).astype(jnp.int32), out["score"], pad_to=16,
                **kw)
    out["ref_begin"] = r_end - rev["ref_end"]
    out["read_begin"] = q_end - rev["read_end"]
    # ONE stacked [1+7, nr] result: one device->host fetch instead of eight
    return jnp.stack([win] + [out[k].astype(jnp.int32)
                              for k in _WINNER_FIELDS])


def sw_align_winner_from_genome(packed, codes_mat, cand_ei, qlen, lo, rlen,
                                cand_rd, nr, *, match=2, mismatch=2,
                                gap_open=3, gap_extend=1, mask_len=15):
    """Host wrapper for the fused score+select+begins program: pads the
    candidate axis to a power-of-two bucket (pad rows land in a dropped
    segment) and nr to its own bucket, splits 64-bit genome positions
    into int32 word/offset, and returns (win[:nr], fields[:nr]) as numpy.
    win[read] < len(cand_ei) iff the read has a winner."""
    cand_ei = np.asarray(cand_ei, np.int32)
    qlen = np.asarray(qlen, np.int32)
    lo = np.asarray(lo, np.int64)
    rlen = np.asarray(rlen, np.int32)
    cand_rd = np.asarray(cand_rd, np.int32)
    b0 = cand_ei.shape[0]
    b = _pad_bucket(b0)
    nrp = max(256, 1 << (nr - 1).bit_length())
    rmax = ((int(rlen.max()) if b0 else 1) + 31) // 32 * 32
    cand_ei = np.pad(cand_ei, (0, b - b0))
    qlen = np.pad(qlen, (0, b - b0), constant_values=1)
    rlen = np.pad(rlen, (0, b - b0), constant_values=1)
    lo = np.pad(lo, (0, b - b0))
    cand_rd = np.pad(cand_rd, (0, b - b0), constant_values=nrp)
    w0 = (lo >> 4).astype(np.int32)
    lo_mod = (lo & 15).astype(np.int32)

    stacked = np.asarray(_sw_winner_from_genome(
        packed, codes_mat, cand_ei, qlen, w0, lo_mod, rlen, cand_rd,
        nr=nrp, rmax=rmax, match=match, mismatch=mismatch,
        gap_open=gap_open, gap_extend=gap_extend, mask_len=mask_len,
        sw_fn=sw_kernel()))  # ONE fetch
    win = stacked[0, :nr]
    out = {k: stacked[i + 1, :nr] for i, k in enumerate(_WINNER_FIELDS)}
    # winners must be REAL rows: pad rows live in segment nrp (dropped),
    # so any win >= b0 means "no winner"
    win = np.where(win < b0, win, np.iinfo(np.int32).max)
    return win, out


def sw_align_begins(query, qlen, ref, rlen, fwd_rows, *, match=2,
                    mismatch=2, gap_open=3, gap_extend=1, mask_len=15):
    """The reverse pass of ssw_align (src/ssw.c:860-875) for rows whose
    forward results are already known: reversed query prefix [0..read_end]
    vs reversed ref prefix [0..ref_end], terminating at the forward score.

    fwd_rows: dict with at least score / read_end / ref_end (int32 [B]),
    as returned by sw_align_ends(forward_only=True), subset to these rows.
    Returns {"ref_begin", "read_begin"} — bit-identical to the fields
    sw_align_ends computes when run on the full batch (same kernel, same
    byte/word overflow split keyed off the forward score).
    """
    _pass = sw_kernel()

    query = np.asarray(query)
    ref = np.asarray(ref)
    b0, w0 = query.shape
    r0 = ref.shape[1]
    b = max(256, 1 << (b0 - 1).bit_length())
    w = ((w0 + 127) // 128) * 128
    r = ((r0 + 31) // 32) * 32
    query = np.pad(query, ((0, b - b0), (0, w - w0)))
    ref = np.pad(ref, ((0, b - b0), (0, r - r0)))
    q_end = np.pad(np.asarray(fwd_rows["read_end"], np.int32), (0, b - b0))
    r_end = np.pad(np.asarray(fwd_rows["ref_end"], np.int32), (0, b - b0))
    score = np.pad(np.asarray(fwd_rows["score"], np.int32), (0, b - b0))
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mask_len=mask_len)

    qlen_rev = (q_end + 1).astype(np.int32)
    rlen_rev = (r_end + 1).astype(np.int32)
    jr = np.arange(query.shape[1])[None, :]
    ir = np.arange(ref.shape[1])[None, :]
    qr_idx = np.clip(q_end[:, None] - jr, 0, None)
    rr_idx = np.clip(r_end[:, None] - ir, 0, None)
    q_rev = np.take_along_axis(query, qr_idx, axis=1)
    r_rev = np.take_along_axis(ref, rr_idx, axis=1)

    rev = {k: np.asarray(v) for k, v in
           _pass(q_rev, qlen_rev, r_rev, rlen_rev, score, pad_to=16,
                 **kw).items()}
    overflow = score + mismatch >= 255
    if overflow.any():
        rv = {k: np.asarray(v) for k, v in
              _pass(q_rev, qlen_rev, r_rev, rlen_rev, score, pad_to=8,
                    second_inclusive=True, **kw).items()}
        for k in rev:
            rev[k] = np.where(overflow, rv[k], rev[k])

    return {
        "ref_begin": (r_end - rev["ref_end"])[:b0],
        "read_begin": (q_end - rev["read_end"])[:b0],
    }
