"""Batched seed-and-extend read aligner.

The reference SaplingAligner (reference: src/align.cpp:151-389) aligns one
read at a time: 7 seeds per strand, one plQuery each, hit expansion via
LCP runs, then one striped-SW call per candidate window, keeping the best
strictly-greater score with a perfect-match early exit.

The batched inversion runs the same computation in three phases over a
whole block of reads, then replays the reference's *serial selection
order* on the host so the chosen alignment (and therefore the SAM bytes)
is identical:

  phase 1 (device): one plquery_batch over all (read, strand, seed)
    16-mers at once;
  phase 2 (host, vectorized): seed verification + hit counting via the
    precomputed lcp>=k run-length arrays (countHitsLeft/Right semantics,
    reference: src/sapling_api.h:254-303, including the i=0-probes-
    lcp[sa_pos] quirk shared by both directions);
  phase 3 (device): one sw_align_ends over the SUPERSET of candidate
    windows any selection path could visit;
  replay (host): walk candidates in the reference's exact order — strands
    fwd,rc; seeds sorted by (total_hits, query_pos, sa_pos, left, right);
    offsets -left..right; maxHits clamping that depends on whether a best
    exists yet (src/align.cpp:310-321); strict-greater updates; early
    exit on a perfect match, which for any scoring is exactly
    score == match*read_len (full-length, zero-edit).

The never-populated `Sapling::sa` defect (src/align.cpp:287 reads an empty
vector — the shipped binary segfaults) is fixed by design: seeds use
inv[ref_pos], the semantically intended array (SURVEY.md §3.2).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..config import AlignerConfig
from ..ops import pack as packops
from ..ops.sw import (sw_align_begins, sw_align_ends,
                      sw_align_ends_from_genome,
                      sw_align_winner_from_genome)
from .cigar import Alignment, finish_alignments_batch
from .sam import sam_header, sam_record

_COMP_CODE = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T C<->G, N=N

# SSW base translation (reference: src/ssw_cpp.cpp:12-25): upper+lowercase
# acgt map to 0..3, everything else to 4 (N, mismatches everything).
_SSW_TRANS = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _SSW_TRANS[_b] = _i
    _SSW_TRANS[_b + 32] = _i  # lowercase

# uppercase ACGT only — what the reference's seed path effectively accepts
# (kmerize reads an uninitialized vals[] entry for anything else and the
# exact-match check query.compare(ref_seq) then fails; src/align.cpp:283-285)
_UPPER_ACGT = np.zeros(256, bool)
for _b in b"ACGT":
    _UPPER_ACGT[_b] = True

_COMP_CHAR = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP_CHAR[_a] = _b


@dataclass
class AlignedRead:
    name: str
    seq: str
    qual: str
    aligned: bool
    strand: int = 0
    ref_name: str = ""
    alignment: Alignment | None = None

    def to_sam(self) -> str:
        return sam_record(self.name, self.seq, self.qual, self.aligned,
                          self.alignment, self.ref_name, self.strand)


class SeedExtendAligner:
    def __init__(self, index, cfg: AlignerConfig | None = None):
        self.idx = index
        self.cfg = cfg or AlignerConfig()
        if index.lcpk_fwd is None or index.lcpk_bwd is None:
            raise ValueError("index built without aligner arrays "
                             "(keep_aligner_arrays=True required)")
        if getattr(index, "inv_hi", None) is not None:
            # split-limb (>=2^32-rank) artifacts store inv as low 32 bits
            # + a separate uint8 high limb; reading idx.inv alone would
            # silently truncate ranks >= 2^32
            raise ValueError(
                "split-limb index (inv_hi present) unsupported by the "
                "aligner — ranks would truncate; build with n < 2^32")
        if index.inv is None or len(index.inv) != index.n:
            raise ValueError("index has no full inverse-rank array "
                             "(built with inv=0?) — aligner needs inv[n]")
        if self.cfg.max_hits > 255:
            raise ValueError("max_hits > 255 unsupported (uint8 run arrays)")
        if index.k != self.cfg.sapling_k:
            raise ValueError(
                f"index k={index.k} != aligner sapling_k={self.cfg.sapling_k}"
                " — build the index with IndexConfig(k=sapling_k)")
        # cumulative per-phase wall time across align_block calls (the
        # observability hook bench_align prints; device phases include the
        # host-side materialization of their results)
        self.phase_seconds: dict[str, float] = {}
        self._packed_dev = None

    def _packed_device(self):
        """Device-resident packed genome words for the fused window-gather
        SW path (one device_put, reused across blocks)."""
        if self._packed_dev is None:
            import jax
            self._packed_dev = jax.device_put(self.idx.packed)
        return self._packed_dev

    def _seed_qcfg(self):
        """QueryConfig for the seed lookups. compact_unresolved measured
        SLOWER here where first tried (20 Mbp k=16 index; not yet
        measured on a GPU): seed batches are small (~115k lanes) so the
        compaction scan/scatter overhead isn't amortized, and the k=16
        index's dense buckets (~38 suffixes each) give a low
        prediction-probe hit rate — the win scales with resolved
        fraction x batch size. SAPLING_SEED_COMPACTU=1 opts in."""
        import os

        from ..config import QueryConfig

        return QueryConfig(compact_unresolved=os.environ.get(
            "SAPLING_SEED_COMPACTU", "0") == "1")

    def _count_hits(self, sa_pos: np.ndarray):
        """Vectorized countHitsLeft/Right (reference:
        src/sapling_api.h:254-303) — now the public
        SaplingIndex.count_hits; the reference can return left ==
        sa_pos+1 (its `sa_pos < i` stop fires one step late) and then
        reads rev[-1], UB the index method clamps away."""
        return self.idx.count_hits(sa_pos, self.cfg.max_hits)

    # --- main entry ---------------------------------------------------------

    def align_block(self, reads: list) -> list[AlignedRead]:
        """Align a block of FASTQ reads; returns per-read results in input
        order. Composition of the three pipeline stages (encode -> seed
        query -> finish); align_blocks coalesces the middle stage across
        blocks."""
        prep = self._encode_block(reads)
        (positions,) = self._query_seeds([prep])
        return self._finish_block(prep, positions)

    def _encode_block(self, reads: list) -> dict:
        """Host-only stage 1: per-block byte matrices for both strands,
        seed k-mers, and the too-short-read results skeleton."""
        idx, cfg = self.idx, self.cfg
        k = idx.k
        results: list[AlignedRead | None] = [None] * len(reads)

        _t = [time.perf_counter()]

        def _tick(name):
            now = time.perf_counter()
            self.phase_seconds[name] = (
                self.phase_seconds.get(name, 0.0) + now - _t[0])
            _t[0] = now

        # encode both strands of every usable read (SSW translation; the
        # seed path additionally requires uppercase ACGT, see _UPPER_ACGT),
        # vectorized over the whole block: one byte matrix, table lookups
        # and the per-row reversal as array ops (the per-read Python loop
        # was the 'encode' phase's entire cost)
        nr = len(reads)
        raws = [rd.seq if isinstance(rd.seq, bytes) else rd.seq.encode()
                for rd in reads]
        lens_r = np.array([len(x) for x in raws], np.int64)
        for ri in np.flatnonzero(lens_r < k):
            rd = reads[ri]
            results[ri] = AlignedRead(
                name=rd.name, seq=_as_str(rd.seq), qual=rd.qual,
                aligned=False)
        rix = np.flatnonzero(lens_r >= k)
        lenv = lens_r[rix]
        lmax = int(lenv.max()) if len(rix) else 0
        mat = np.zeros((nr, lmax), np.uint8)
        if nr:
            allmask = np.arange(lmax)[None, :] < lens_r[:, None]
            mat[allmask] = np.frombuffer(b"".join(raws), np.uint8)
        mat = mat[rix]
        jj = np.arange(lmax)[None, :]
        colmask = jj < lenv[:, None]
        # reference revComp complements UPPERCASE ACGT only and leaves
        # every other char untouched (src/align.cpp:241-256)
        rc_raw = np.take_along_axis(
            _COMP_CHAR[mat], np.clip(lenv[:, None] - 1 - jj, 0, None),
            axis=1)
        ne = 2 * len(rix)
        codes_mat = np.zeros((ne, lmax), np.uint8)
        codes_mat[0::2] = np.where(colmask, _SSW_TRANS[mat], 0)
        codes_mat[1::2] = np.where(colmask, _SSW_TRANS[rc_raw], 0)
        seedable_mat = np.zeros((ne, lmax), bool)
        seedable_mat[0::2] = _UPPER_ACGT[mat] & colmask
        seedable_mat[1::2] = _UPPER_ACGT[rc_raw] & colmask
        lens = np.repeat(lenv, 2)
        read_of_entry = np.repeat(rix, 2)
        strand_of_entry = np.tile(np.array([0, 1], np.int64), len(rix))

        # --- phase 1: batched seed lookups ---------------------------------
        # Everything from here to the replay is vectorized over flat
        # [entries x num_seeds] and [candidates] axes: the per-seed /
        # per-candidate Python loops were most of block wall time when
        # profiled (the kernels are not the aligner's bottleneck, the
        # host loops are).
        ns = cfg.num_seeds
        # seed offsets (reference: src/align.cpp:271-275): 0, last//(ns-1)*i,
        # last — batched over entries
        last = lens - k
        qpos_m = (last[:, None] // max(ns - 1, 1)) * np.arange(ns)[None, :]
        if ne:
            qpos_m[:, 0] = 0
            qpos_m[:, ns - 1] = last if ns > 1 else 0
        ei_s = np.repeat(np.arange(ne), ns)            # [S]
        qpos_s = qpos_m.ravel()                        # [S]
        gidx = qpos_s[:, None] + np.arange(k)[None, :]
        seed_kmers = codes_mat[ei_s[:, None], gidx]    # [S, k]
        valid = seedable_mat[ei_s[:, None], gidx].all(axis=1)
        _tick("encode")
        return dict(reads=reads, results=results, nr=nr,
                    codes_mat=codes_mat, lens=lens,
                    read_of_entry=read_of_entry,
                    strand_of_entry=strand_of_entry,
                    ei_s=ei_s, qpos_s=qpos_s,
                    seed_kmers=seed_kmers, valid=valid)

    def _query_seeds(self, preps: list[dict],
                     pad_shapes: bool = True) -> list[np.ndarray]:
        """Stage 2: ONE plquery dispatch over the concatenated valid seed
        k-mers of one or more encoded blocks; returns each block's [S]
        position array (-1 for invalid seeds).

        Coalescing across blocks amortizes the per-dispatch cost of the
        seed-query phase and widens the lane count the compaction cascade
        works with. The batch is padded to a
        few-significant-bits bucket so plquery_batch (shape-specialized
        jit) compiles O(log B) variants instead of one per distinct valid
        count; pad lanes repeat row 0 and are discarded. Per-lane results
        are independent of batch composition (the engine's bit-parity
        guarantee, tests/test_query.py), so coalescing and padding leave
        every position byte-identical."""
        kms = [p["seed_kmers"][p["valid"]] for p in preps]
        counts = [len(x) for x in kms]
        tot = sum(counts)
        outs: list[np.ndarray] = []
        pos_all = None
        if tot:
            allk = kms[0] if len(kms) == 1 else np.concatenate(kms, axis=0)
            if pad_shapes:
                want = _shape_bucket(tot)
                if want > tot:
                    allk = np.concatenate(
                        [allk,
                         np.broadcast_to(allk[:1], (want - tot,
                                                    allk.shape[1]))])
            t0 = time.perf_counter()
            pos_all = self.idx.query_positions(allk, self._seed_qcfg())
            self.phase_seconds["query(dev)"] = (
                self.phase_seconds.get("query(dev)", 0.0)
                + time.perf_counter() - t0)
        off = 0
        for p, c in zip(preps, counts):
            positions = np.full(len(p["valid"]), -1, dtype=np.int64)
            if c:
                positions[p["valid"]] = pos_all[off:off + c]
            off += c
            outs.append(positions)
        return outs

    def _finish_block(self, prep: dict, positions: np.ndarray
                      ) -> list[AlignedRead]:
        """Stage 3: seed verification + hit counting, candidate SW,
        winner replay, and native traceback for one encoded block."""
        idx, cfg = self.idx, self.cfg
        k, flank, mh = idx.k, cfg.flanking, cfg.max_hits
        reads = prep["reads"]
        results = prep["results"]
        nr = prep["nr"]
        codes_mat = prep["codes_mat"]
        lens = prep["lens"]
        read_of_entry = prep["read_of_entry"]
        strand_of_entry = prep["strand_of_entry"]
        ei_s = prep["ei_s"]
        qpos_s = prep["qpos_s"]
        seed_kmers = prep["seed_kmers"]

        _t = [time.perf_counter()]

        def _tick(name):
            now = time.perf_counter()
            self.phase_seconds[name] = (
                self.phase_seconds.get(name, 0.0) + now - _t[0])
            _t[0] = now

        # --- phase 2: verify + hit counting ---------------------------------
        ref_pos = positions
        ok = (ref_pos >= 0) & (ref_pos <= idx.n - k)
        if ok.any():
            window = idx.codes[
                np.clip(ref_pos[ok, None], 0, idx.n - k)
                + np.arange(k)[None, :]
            ]
            exact = (window == seed_kmers[ok]).all(axis=1)
            tmp = np.zeros(len(positions), bool)
            tmp[np.flatnonzero(ok)[exact]] = True
            ok = tmp
        sa_pos = np.where(ok, idx.inv[np.clip(ref_pos, 0, idx.n - 1)], 0)
        left, right = self._count_hits(sa_pos)

        # verified seeds, reference sort order within each entry: ascending
        # (total, qpos, sa_pos, left, right) (src/align.cpp:301)
        okI = np.flatnonzero(ok)
        eiA = ei_s[okI]
        qpA = qpos_s[okI].astype(np.int64)
        spA = sa_pos[okI].astype(np.int64)
        lfA = left[okI].astype(np.int64)
        rgA = right[okI].astype(np.int64)
        totA = lfA + rgA + 1
        order = np.lexsort((rgA, lfA, spA, qpA, totA, eiA))
        eiA, qpA, spA, lfA, rgA, totA = (
            a[order] for a in (eiA, qpA, spA, lfA, rgA, totA))
        _tick("hits")

        # --- phase 3: superset candidate windows + batched SW ----------------
        # possible offset range per seed (reference: src/align.cpp:310-321):
        # total <= maxHits -> [-left, right]; else either [-mh/2-clamped]
        # (no best yet) or just {0}; the clamped range is a superset of {0}.
        over = lfA + rgA > mh
        lfC = np.where(over, np.minimum(lfA, mh // 2), lfA)
        rgC = np.where(over, np.minimum(rgA, mh // 2), rgA)
        counts = (lfC + rgC + 1).astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(counts)])
        rep = np.repeat(np.arange(len(counts)), counts)   # seed row / cand
        off = np.arange(csum[-1]) - csum[rep] - lfC[rep]
        rp = idx.rev[spA[rep] + off].astype(np.int64)
        ln_c = lens[eiA[rep]]
        qp_c = qpA[rep]
        lo = np.maximum(rp - qp_c - flank, 0)
        hi = rp + (ln_c - qp_c) + flank
        keep = hi < idx.n                                  # off-end windows
        rep, off, lo, hi, ln_c = (a[keep] for a in (rep, off, lo, hi, ln_c))

        # Eligibility is pure geometry — known BEFORE scoring. The serial
        # walk visits an over-maxHits seed's full clamped range only while
        # no best exists, i.e. only for the read's first seed with any
        # surviving window (y0); later over-limit seeds contribute offset 0
        # alone (src/align.cpp:310-321). Scoring ineligible windows is pure
        # waste — on repeat-heavy genomes they are the bulk of the
        # superset.
        if len(rep):
            yrows = np.unique(rep)
            y0 = np.full(nr, len(eiA), np.int64)
            np.minimum.at(y0, read_of_entry[eiA[yrows]], yrows)
            cand_rd_all = read_of_entry[eiA[rep]]
            elig = ((rep == y0[cand_rd_all]) | (totA[rep] <= mh)
                    | (off == 0))
            rep, off, lo, hi, ln_c = (
                a[elig] for a in (rep, off, lo, hi, ln_c))

        ends = None
        fused_win = None
        cand_ei = eiA[rep]
        cand_left = lo
        if len(rep):
            import os
            wmax = int(ln_c.max())
            rl = (hi - lo).astype(np.int32)
            ql = ln_c.astype(np.int32)
            swkw = dict(match=cfg.match_score,
                        mismatch=cfg.mismatch_penalty,
                        gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
                        mask_len=cfg.mask_len)
            # Default path: ONE device program per block — decode windows
            # from the resident packed genome, forward-score every
            # candidate, select each read's winner on device (segment
            # max + first attaining row = the reference's strict-greater
            # walk), and run the begin-position reverse pass on just the
            # winner rows. Winner selection needs only the forward score,
            # which is identical in byte/word SSW modes; overflowing
            # winners get a host-side pad-8 fix-up below.
            # SAPLING_ALIGN_FUSED=0 falls back to the 2-dispatch flow,
            # SAPLING_SW_DEVWIN=0 to host-built windows.
            devwin = os.environ.get("SAPLING_SW_DEVWIN", "1") == "1"
            fused = devwin and (
                os.environ.get("SAPLING_ALIGN_FUSED", "1") == "1")
            if fused:
                _tick("windows")
                cand_rd_f = read_of_entry[eiA[rep]]
                fused_win, ends = sw_align_winner_from_genome(
                    self._packed_device(), codes_mat[:, :wmax],
                    cand_ei, ql, lo, rl, cand_rd_f, nr, **swkw)
            elif devwin:
                _tick("windows")
                ends = sw_align_ends_from_genome(
                    self._packed_device(), codes_mat[:, :wmax],
                    cand_ei, ql, lo, rl, **swkw)
            else:
                rmax = int(rl.max())
                q = codes_mat[cand_ei, :wmax].astype(np.int8)
                col = np.arange(wmax)[None, :]
                q[col >= ln_c[:, None]] = 0                # zero-pad tails
                ridx = np.minimum(lo[:, None] + np.arange(rmax)[None, :],
                                  idx.n - 1)
                r = idx.codes[ridx].astype(np.int8)
                r[np.arange(rmax)[None, :] >= rl[:, None]] = 0
                _tick("windows")
                ends = sw_align_ends(q, ql, r, rl, forward_only=True,
                                     **swkw)
            # materialize device results ONCE: np.asarray on a device
            # array copies device->host every call, and the replay loop
            # below reads scores per (seed, offset) candidate
            ends = {kk: np.asarray(vv) for kk, vv in ends.items()}
        _tick("sw(dev)")
        # --- replay: the reference's serial selection, vectorized --------
        # The reference walks candidates serially with a strict-greater
        # best update and a perfect-match early exit (src/align.cpp:
        # 301-348). Three facts make the winner computable without the
        # walk:
        #   * the winner is the FIRST visited candidate attaining the max
        #     visited score (strict > keeps the earliest max; the early
        #     exit only skips candidates that cannot strictly beat a
        #     perfect score, and the first perfect row IS the first max);
        #   * "a best exists" from the first visited candidate onward (SW
        #     scores are >= 0 > the -1 sentinel) — the y0 eligibility
        #     pruning above already reduced rows to exactly the visited
        #     candidates whose scores can matter;
        #   * candidate rows were built in walk order (reads partition the
        #     row array contiguously: entries fwd,rc consecutive, seeds in
        #     sorted order, offsets ascending), so "first" = lowest row.
        winners = []  # (read_i, cand_i, strand, window_start)
        if fused_win is not None:
            # winners came back from the fused device program
            for ri in np.flatnonzero(fused_win < len(rep)):
                w = int(fused_win[ri])
                winners.append((int(ri), w, int(strand_of_entry[cand_ei[w]]),
                                int(cand_left[w])))
        elif len(rep):
            c = len(rep)
            cand_rd = read_of_entry[cand_ei]               # [C] ascending
            sc = np.asarray(ends["score"], np.int64)[:c]
            best_sc = np.full(nr, -1, np.int64)
            np.maximum.at(best_sc, cand_rd, sc)
            is_best = sc == best_sc[cand_rd]
            win = np.full(nr, c, np.int64)
            bi = np.flatnonzero(is_best)
            np.minimum.at(win, cand_rd[bi], bi)
            for ri in np.flatnonzero(win < c):
                w = int(win[ri])
                winners.append((int(ri), w, int(strand_of_entry[cand_ei[w]]),
                                int(cand_left[w])))
        has_winner = np.zeros(nr, bool)
        for ri, *_ in winners:
            has_winner[ri] = True
        for ri, rd in enumerate(reads):
            if results[ri] is None and not has_winner[ri]:
                results[ri] = AlignedRead(
                    name=rd.name, seq=_as_str(rd.seq), qual=rd.qual,
                    aligned=False)

        _tick("winner")
        # one native call finishes every winner: traceback + soft clips +
        # '='/'X' runs + mismatch counts (align.cigar.finish_alignments_batch)
        if winners:
            wi = np.array([w[1] for w in winners], np.int64)
            if fused_win is not None:
                ris = np.array([w[0] for w in winners], np.int64)
                rows = {kk: vv[ris].copy() for kk, vv in ends.items()}
            else:
                rows = {kk: vv[wi] for kk, vv in ends.items()}
            # winner-only host windows for the reverse pass + native
            # traceback (identical content to rows wi of the full q/r
            # matrices; the full matrices are never materialized on the
            # device-window path)
            qw = codes_mat[cand_ei[wi], :wmax].astype(np.int8)
            qw[np.arange(wmax)[None, :] >= ql[wi][:, None]] = 0
            rmax_w = int(rl[wi].max())
            rw = idx.codes[np.minimum(
                lo[wi][:, None] + np.arange(rmax_w)[None, :],
                idx.n - 1)].astype(np.int8)
            rw[np.arange(rmax_w)[None, :] >= rl[wi][:, None]] = 0
            if fused_win is not None:
                # the fused program's fields use 16-row SSE pad semantics;
                # winners whose score would overflow SSW's byte kernel
                # (score+mismatch >= 255, ssw.c:835-841) take the word
                # kernel's pad-8 fields — recompute those rare rows with
                # the full host-window path (score itself is pad-exact,
                # so winner IDENTITY is unaffected)
                ovr = rows["score"] + cfg.mismatch_penalty >= 255
                if ovr.any():
                    full = sw_align_ends(qw[ovr], ql[wi][ovr], rw[ovr],
                                         rl[wi][ovr], **swkw)
                    for kk in rows:
                        rows[kk][ovr] = np.asarray(full[kk])
            else:
                rows.update(sw_align_begins(
                    qw, ql[wi], rw, rl[wi], rows,
                    match=cfg.match_score, mismatch=cfg.mismatch_penalty,
                    gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
                    mask_len=cfg.mask_len))
            _tick("begins(dev)")
            als = finish_alignments_batch(
                qw, rw, ql[wi], rows,
                match=cfg.match_score, mismatch=cfg.mismatch_penalty,
                gap_open=cfg.gap_open, gap_extend=cfg.gap_extend)
            for (ri, _bi, strand, bleft), al in zip(winners, als):
                rd = reads[ri]
                if al is None:  # traceback failure (align.cpp:336)
                    results[ri] = AlignedRead(
                        name=rd.name, seq=_as_str(rd.seq), qual=rd.qual,
                        aligned=False)
                    continue
                gpos = al.ref_begin + bleft
                ref_name, last_end = _chr_of(idx.chr_ends, gpos)
                al.ref_begin = gpos - last_end
                results[ri] = AlignedRead(
                    name=rd.name, seq=_as_str(rd.seq), qual=rd.qual,
                    aligned=True, strand=strand, ref_name=ref_name,
                    alignment=al)
        _tick("finish")
        return results

    def align_blocks(self, blocks, workers: int = 8, coalesce: int = 2):
        """Pipeline the three stages over an iterable of read blocks,
        yielding per-block result lists in input order.

        The caller's thread encodes blocks and runs ONE coalesced
        seed-query dispatch per `coalesce` blocks (_query_seeds); finish
        stages (hit counting, candidate SW, winner replay, native
        traceback) run in a small thread pool, overlapping the next
        group's encode + query. Device dispatches from in-flight finishes
        interleave with the query dispatch — host and device both stay
        busy, and the seed query pays one RPC per group instead of one
        per block. All stages are stateless w.r.t. the read stream (the
        index is read-only); JAX dispatch and the native batch calls are
        thread-safe. phase_seconds still accumulates but phases from
        concurrent blocks overlap in wall time."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        # materialize lazy device state before threads race the init
        self._packed_device()
        self.idx.device_arrays()
        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending = collections.deque()
            group: list[dict] = []

            def _flush():
                if not group:
                    return
                for prep, pos in zip(group, self._query_seeds(group)):
                    pending.append(ex.submit(self._finish_block, prep, pos))
                group.clear()

            for blk in blocks:
                group.append(self._encode_block(blk))
                if len(group) >= coalesce:
                    _flush()
                while len(pending) > workers + coalesce:
                    yield pending.popleft().result()
            _flush()
            while pending:
                yield pending.popleft().result()

    def align_fastq(self, fastq_path, out, cl: str = "align",
                    block: int = 16384, workers: int = 8,
                    coalesce: int = 2) -> None:
        """Full FASTQ -> SAM pipeline (reference: src/align.cpp:193-224).
        SAM records are written strictly in input-read order (byte parity
        with the reference's serial stream) while blocks are aligned
        through the align_blocks pipeline."""
        from ..io.fastq import read_fastq

        def _blocks():
            buf = []
            for rd in read_fastq(fastq_path):
                buf.append(rd)
                if len(buf) >= block:
                    yield buf
                    buf = []
            if buf:
                yield buf

        close = False
        if isinstance(out, str):
            out = open(out, "w")
            close = True
        try:
            out.write(sam_header(self.idx.chr_ends, cl))
            for ars in self.align_blocks(_blocks(), workers=workers,
                                         coalesce=coalesce):
                for ar in ars:
                    out.write(ar.to_sam())
        finally:
            if close:
                out.close()


def _shape_bucket(n: int, min_size: int = 1024) -> int:
    """Round a batch size up to a 4-significant-bit bucket: bounded
    distinct jit shapes (<=8 per octave), <=~7% padding waste."""
    if n <= min_size:
        return min_size
    step = 1 << (n.bit_length() - 4)
    return -(-n // step) * step


def _as_str(seq) -> str:
    return seq.decode() if isinstance(seq, (bytes, bytearray)) else str(seq)


def _chr_of(chr_ends, pos: int):
    """Chromosome + its start offset for a genome position (reference:
    src/align.cpp:354-372)."""
    best_end, name = 0, "*"
    last_end = 0
    for end, nm in chr_ends:
        if end > pos and (best_end == 0 or end < best_end):
            best_end, name = end, nm
        if end <= pos and (last_end == 0 or end > last_end):
            last_end = end
    return name, last_end
