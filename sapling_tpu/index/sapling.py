"""SaplingIndex: the user-facing learned suffix-array index.

Equivalent surface to the reference's `struct Sapling`
(reference: src/sapling_api.h:17-679) redesigned for batched device
execution: the constructor-side state (genome, rev, inv, PWL table, error
bounds, chrEnds) lives as typed numpy arrays on the host and is shipped to
device HBM on first query. Queries are batched: `query_positions` maps a
[B, L] batch of base codes to [B] genome positions in one jitted program.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..config import IndexConfig, QueryConfig
from ..io import artifacts
from ..io.fasta import Genome, read_fasta
from ..ops import pack as packops
from ..ops.query import binsearch_batch, plquery_batch
from .pwl import PwlTable, build_pwl
from .suffix_array import SuffixData, build_suffix_data, lcp_ge_k_runs, pack_bitmask


def _pos_dtype(n: int, cfg: str = "auto"):
    """Rank/position STORAGE dtype. uint32 covers 2^31 <= n < 2^32
    (a GRCh38-scale rev at 4 B/rank); query-lane state
    promotes to signed int64 on gather (ops.query._state_dtype)."""
    if cfg in ("int32", "int64", "uint32"):
        return np.dtype(cfg).type
    if n < np.iinfo(np.int32).max:
        return np.int32
    if n < np.iinfo(np.uint32).max - 1:
        return np.uint32
    return np.int64


def _build_dtype(pdt):
    """The native SA-IS builder emits int32/int64 only."""
    return np.int64 if np.dtype(pdt) == np.uint32 else pdt


@dataclass
class SaplingIndex:
    n: int
    k: int
    buckets: int
    packed: np.ndarray            # uint32 2-bit genome, padded
    rev: np.ndarray               # rank -> pos
    inv: np.ndarray               # pos -> rank (aligner seeds need it)
    table: PwlTable
    chr_ends: list[tuple[int, str]] = field(default_factory=list)
    codes: np.ndarray | None = None       # uint8 0..3 (host; optional)
    prefix64: np.ndarray | None = None    # uint64 per-rank 32-base prefixes
    prefix3: np.ndarray | None = None     # uint64 per-rank 21-base 3-bit
    lcpk_fwd: np.ndarray | None = None    # forward run of lcp>=k (aligner)
    lcpk_bwd: np.ndarray | None = None    # backward run of lcp>=k
    # >= 2^32-base genomes (wheat axis, eval/TimingPlot/plot.py:16) store
    # ranks/positions as split limbs: rev/inv hold the uint32 LOW 32 bits
    # and these the uint8 bits 32.. (5 B/entry instead of 8; the int64
    # view never materializes host- or device-side)
    rev_hi: np.ndarray | None = None
    inv_hi: np.ndarray | None = None
    _device: dict = field(default_factory=dict, repr=False)

    # --- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        genome: Genome | np.ndarray,
        cfg: IndexConfig | None = None,
        suffix: SuffixData | None = None,
        keep_aligner_arrays: bool = True,
    ) -> "SaplingIndex":
        cfg = cfg or IndexConfig()
        if isinstance(genome, Genome):
            seq, chr_ends = genome.seq, genome.chr_ends
        else:
            seq, chr_ends = np.asarray(genome, dtype=np.uint8), []
        n = int(seq.shape[0])
        buckets = cfg.resolved_buckets(n)
        pdt = _pos_dtype(n, cfg.pos_dtype)
        if suffix is None:
            suffix = build_suffix_data(seq, _build_dtype(pdt))
        codes = packops.encode_bases(seq)
        table = build_pwl(codes, suffix.inv, suffix.lcp, cfg.k, buckets,
                          cfg.most_threshold)
        packed = packops.pack_codes(codes, pad_words=16)
        rev = np.empty(n, dtype=pdt)
        rev[suffix.inv] = np.arange(n, dtype=pdt)
        # probe-acceleration prefixes: 8 B/rank; skipped above
        # cfg.prefix_max_n (see IndexConfig)
        want_prefix = cfg.prefix_lookup and n <= cfg.prefix_max_n
        prefix64 = packops.rank_prefix64(codes, rev) if want_prefix else None
        prefix3 = packops.rank_prefix3(codes, rev) if want_prefix else None
        idx = cls(
            n=n, k=cfg.k, buckets=buckets, packed=packed, rev=rev,
            inv=suffix.inv.astype(pdt), table=table, chr_ends=list(chr_ends),
            codes=codes, prefix64=prefix64, prefix3=prefix3,
        )
        if keep_aligner_arrays:
            fwd, bwd = lcp_ge_k_runs(suffix.lcp, cfg.k)
            idx.lcpk_fwd = np.minimum(fwd, 255).astype(np.uint8)
            idx.lcpk_bwd = np.minimum(bwd, 255).astype(np.uint8)
        return idx

    @classmethod
    def from_fasta(cls, path: str, cfg: IndexConfig | None = None,
                   cache: bool = True) -> "SaplingIndex":
        """Build from a FASTA path with the reference's artifact-caching
        pattern: <path>.sa and <path>_k<k>.stpu.npz are transparently
        reloaded if present, else built and written
        (reference: src/sapling_api.h:552-675)."""
        cfg = cfg or IndexConfig()
        genome = read_fasta(path)
        npz = f"{path}_k{cfg.k}_b{cfg.buckets}.stpu.npz"
        if cache and os.path.exists(npz):
            return cls.load(npz)
        sa_path = path + ".sa"
        pdt = _pos_dtype(genome.n, cfg.pos_dtype)
        bdt = _build_dtype(pdt)
        if os.path.exists(sa_path):
            inv64, lcp64 = artifacts.read_sa(sa_path)
            inv = inv64.astype(bdt)
            sa = np.empty(genome.n, dtype=bdt)
            sa[inv] = np.arange(genome.n, dtype=bdt)
            suffix = SuffixData(sa=sa, inv=inv, lcp=lcp64.astype(bdt))
        else:
            suffix = build_suffix_data(genome.seq, bdt)
            if cache:
                artifacts.write_sa(sa_path, suffix.inv, suffix.lcp)
        idx = cls.build(genome, cfg, suffix=suffix)
        if cache:
            idx.save(npz)
        return idx

    # --- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        ends = np.array([e for e, _ in self.chr_ends], dtype=np.int64)
        names = np.array([nm for _, nm in self.chr_ends])
        artifacts.save_npz(
            path,
            format_version=np.int64(4 if self.rev_hi is not None else 3),
            n=np.int64(self.n), k=np.int64(self.k),
            buckets=np.int64(self.buckets),
            packed=self.packed, rev=self.rev, inv=self.inv,
            xlist=self.table.xlist, ylist=self.table.ylist,
            stats=np.array([self.table.max_over, self.table.max_under,
                            self.table.mean_error, self.table.most_over,
                            self.table.most_under], dtype=np.int64),
            chr_end_pos=ends, chr_end_name=names,
            codes=self.codes if self.codes is not None else np.zeros(0, np.uint8),
            prefix64=(self.prefix64 if self.prefix64 is not None
                      else np.zeros(0, np.uint64)),
            prefix3=(self.prefix3 if self.prefix3 is not None
                     else np.zeros(0, np.uint64)),
            lcpk_fwd=self.lcpk_fwd if self.lcpk_fwd is not None else np.zeros(0, np.uint8),
            lcpk_bwd=self.lcpk_bwd if self.lcpk_bwd is not None else np.zeros(0, np.uint8),
            bounds=(self.table.bounds if self.table.bounds is not None
                    else np.zeros(0, np.uint32)),
            rev_hi=(self.rev_hi if self.rev_hi is not None
                    else np.zeros(0, np.uint8)),
            inv_hi=(self.inv_hi if self.inv_hi is not None
                    else np.zeros(0, np.uint8)),
        )

    # 1: pre-prefix3 artifacts; 2: +prefix3; 3: +per-bucket bounds;
    # 4: +split-limb rev_hi/inv_hi (>= 2^32-base genomes)
    SUPPORTED_FORMATS = (1, 2, 3, 4)

    @classmethod
    def load(cls, path: str, skip: tuple = (),
             mmap: bool = False) -> "SaplingIndex":
        """Load an artifact. skip: member names to leave out (they load
        as None / empty — e.g. skip=("inv",) for query-only use, where
        the 12.4 GB inverse array is 40% of a GRCh38 artifact's load
        time). mmap=True memory-maps large members instead of copying
        into RAM (io.artifacts.load_npz): load returns in milliseconds
        and untouched members never cost disk reads."""
        z = artifacts.load_npz(path, skip=skip, mmap=mmap)
        for name in skip:
            z.setdefault(name, np.zeros(0, np.uint8))
        ver = int(z.get("format_version", 1))
        if ver not in cls.SUPPORTED_FORMATS:
            raise IOError(
                f"{path}: unsupported index artifact format v{ver} "
                f"(supported: {cls.SUPPORTED_FORMATS})")
        st = z["stats"]
        table = PwlTable(
            buckets=int(z["buckets"]), xlist=z["xlist"], ylist=z["ylist"],
            max_over=int(st[0]), max_under=int(st[1]), mean_error=int(st[2]),
            most_over=int(st[3]), most_under=int(st[4]),
            bounds=(z["bounds"] if "bounds" in z and z["bounds"].size
                    else None),
        )
        chr_ends = [(int(e), str(nm)) for e, nm in
                    zip(z["chr_end_pos"], z["chr_end_name"])]
        return cls(
            n=int(z["n"]), k=int(z["k"]), buckets=int(z["buckets"]),
            packed=z["packed"], rev=z["rev"], inv=z["inv"], table=table,
            chr_ends=chr_ends,
            codes=z["codes"] if z["codes"].size else None,
            prefix64=(z["prefix64"] if "prefix64" in z and z["prefix64"].size
                      else None),
            prefix3=(z["prefix3"] if "prefix3" in z and z["prefix3"].size
                     else None),
            lcpk_fwd=z["lcpk_fwd"] if z["lcpk_fwd"].size else None,
            lcpk_bwd=z["lcpk_bwd"] if z["lcpk_bwd"].size else None,
            rev_hi=(z["rev_hi"] if "rev_hi" in z and z["rev_hi"].size
                    else None),
            inv_hi=(z["inv_hi"] if "inv_hi" in z and z["inv_hi"].size
                    else None),
        )

    def write_reference_artifacts(self, sa_path: str | None, sap_path: str | None,
                                  suffix: SuffixData | None = None) -> None:
        """Emit reference-compatible .sa/.sap files."""
        if sap_path:
            t = self.table
            artifacts.write_sap(sap_path, self.buckets, t.xlist, t.ylist,
                                t.max_over, t.max_under, t.mean_error,
                                t.most_over, t.most_under)
        if sa_path:
            if suffix is None:
                raise ValueError("need SuffixData (inv+lcp) to write .sa")
            artifacts.write_sa(sa_path, suffix.inv, suffix.lcp)

    # --- device state --------------------------------------------------------

    def device_arrays(self, rev_bank_bits: int | None = None,
                      rev_pair: bool | None = None,
                      rev_rows2d: bool | None = None,
                      use_ptab: bool | None = None,
                      use_pred2: bool | None = None):
        """Lazily put the hot arrays on the default device.

        Gathers want int32-indexable operands, so a rev with more than
        2^31-1 entries (GRCh38-scale) ships 2-D (ops.query.Rows2D) by
        default, or as its even/odd halves (ops.query.HalvesU32) with
        rev_rows2d=False: two u32 gathers + a select reach any rank, and
        none of the uint64 pair view's doubled device args (X64Split
        temps; PairedU32 is flag-only). At the same scale int64/u64
        tables ship pre-split as u32 — the X64-rewrite pass materializes
        duplicate 32-bit copies of 64-bit args on device. rev_bank_bits
        forces the legacy banked layout, rev_pair forces the pair view,
        use_ptab=True opts into the interleaved checkpoint table
        (ops.predict.pack_ptab). use_pred2=True ships the PWL table as
        the pack_pred2 uint64 pair instead of the endpoint layouts —
        prediction in 2 gather ops instead of 4. Both were measured
        slower end to end where they were first tried and are flag-off
        variants (docs/PERFORMANCE.md at commit 9faeb07); tests exercise
        all layouts at small n. None of these layouts has been measured
        on a GPU yet."""
        if not self._device:
            import jax.numpy as jnp

            from ..ops.query import (HalvesU32, PairedU32, Rows2D,
                                     SplitRanks)

            rev = self.rev
            big = rev.shape[0] > (1 << 31) - 1
            bits = rev_bank_bits
            if self.rev_hi is not None:
                # >= 2^32-base split-limb storage: SplitRanks on device,
                # each limb banked into 2^30-entry tuples past the int32
                # gather range (ops.query.take_rank's tuple path)
                def _bank(a):
                    if a.shape[0] <= (1 << 31) - 1:
                        return jnp.asarray(a)
                    bank = 1 << 30
                    return tuple(jnp.asarray(a[lo : lo + bank])
                                 for lo in range(0, a.shape[0], bank))

                rev = SplitRanks(lo=_bank(self.rev), hi=_bank(self.rev_hi))
            elif rev_pair:
                # flag-only: u64 args are materialized twice on device
                # (X64Split temps) at the >= 2^31-entry scale this
                # targets
                rev = PairedU32.pack(rev)
            elif rev_rows2d or (big and bits is None
                                and rev_rows2d is not False):
                # ONE 2-D-indexed gather per rank lookup, zero overhead —
                # the default at > 2^31 ranks, where it beat HalvesU32
                # when first measured (docs/PERFORMANCE.md at commit
                # 9faeb07); tools/microbench_gather.py measures the
                # gather law of the device at hand
                rev = Rows2D.pack(rev)
            elif big and bits is None:
                rev = HalvesU32.pack(rev)  # 2 gathers; rev_rows2d=False
            elif bits is not None:
                bank = 1 << bits
                rev = tuple(
                    jnp.asarray(rev[lo : lo + bank])
                    for lo in range(0, rev.shape[0], bank)
                )
            else:
                rev = jnp.asarray(rev)
            from ..ops.predict import pack_ptab, pack_pred2

            xl64 = self.table.xlist
            yl64 = self.table.ylist
            ptab = None
            pred2 = None
            pred2_bits = None
            if use_ptab is None:
                # slice gathers gave no op-count win where first
                # measured (ops.query.take_slice); flag-off variant
                use_ptab = False
            p2 = (pack_pred2(xl64, yl64, 2 * self.k)
                  if use_pred2 and not use_ptab else None)
            if use_pred2 and p2 is None:
                raise ValueError("table does not fit the pack_pred2 "
                                 "bit budget")
            if use_ptab:
                assert self.n <= (1 << 32) and 2 * self.k <= 48
                # exact interleaved checkpoint table: prediction becomes
                # ONE sliced gather (ops.predict.pack_ptab); the split
                # int64 tables are then not shipped at all
                ptab = jnp.asarray(pack_ptab(xl64, yl64, self.table.bounds))
                xlist = ylist = None
            elif p2 is not None:
                # 2-gather prediction; the endpoint tables need not
                # ship. At multi-Gbp scale the bucket table is GBs and
                # u64 args cost 2x HBM (X64Split temps) — ship the
                # pre-split u32 quad instead (4 gathers, still half the
                # split-int64 layout's 8).
                if big:
                    pred2 = tuple(
                        jnp.asarray((a >> np.uint64(32)).astype(np.uint32)
                                    if hi else
                                    (a & np.uint64(0xFFFFFFFF))
                                    .astype(np.uint32))
                        for a in (p2[0], p2[1]) for hi in (True, False))
                else:
                    pred2 = (jnp.asarray(p2[0]), jnp.asarray(p2[1]))
                pred2_bits = p2[2]
                xlist = ylist = None
            elif big or rev_bank_bits is not None:
                xlist, ylist = _ship_table_arrays(xl64, yl64, self.k,
                                                  self.n, slim=True)
            else:
                xlist, ylist = _ship_table_arrays(xl64, yl64, self.k,
                                                  self.n, slim=False)
            # uint64 word pairing halves probe gather granules but adds
            # per-probe select work; it is used only when the per-rank
            # prefix arrays are absent, where probes read the packed
            # genome. NOT at `big` (>= 2^31-rank) scale: there the u64
            # packed ARG's X64Split temps (2x the packed bytes) come on
            # top of a multi-GB rev — u32 words cost one extra probe
            # gather op per round instead.
            pk = (packops.words_to_u64(self.packed)
                  if self.prefix64 is None and not big else self.packed)
            self._device = {
                "packed": jnp.asarray(pk),
                "rev": rev,
                "xlist": xlist,
                "ylist": ylist,
                "ptab": ptab,
                "pred2": pred2,
                "pred2_bits": pred2_bits,
                "prefix": (jnp.asarray(self.prefix64)
                           if self.prefix64 is not None else None),
                "prefix3": (jnp.asarray(self.prefix3)
                            if self.prefix3 is not None else None),
                "bounds": (jnp.asarray(self.table.bounds)
                           if self.table.bounds is not None else None),
            }
        return self._device

    def swap_table(self, table) -> None:
        """Replace the PWL table in place (e.g. a tools/retable_index.py
        bucket-count A/B). If device arrays are already resident, ONLY
        the table entries re-ship — rev/packed/prefix stay on device
        (at GRCh38 scale that is a ~1 GB transfer instead of ~14 GB).
        Requires the default table layouts (no ptab/pred2)."""
        self.table = table
        self.buckets = table.buckets
        if self._device:
            import jax.numpy as jnp

            if (self._device.get("ptab") is not None
                    or self._device.get("pred2") is not None):
                raise NotImplementedError(
                    "swap_table with ptab/pred2 layouts — rebuild "
                    "device arrays instead")
            big = self.rev.shape[0] > (1 << 31) - 1
            xl, yl = _ship_table_arrays(table.xlist, table.ylist,
                                        self.k, self.n, slim=big)
            self._device["xlist"] = xl
            self._device["ylist"] = yl
            self._device["bounds"] = (jnp.asarray(table.bounds)
                                      if table.bounds is not None else None)

    # --- queries -------------------------------------------------------------

    def kmerize_batch(self, codes2d: np.ndarray) -> np.ndarray:
        return packops.batch_kmers_adjusted(codes2d, self.k)

    def query_positions(self, codes2d: np.ndarray,
                        qcfg: QueryConfig | None = None) -> np.ndarray:
        """plQuery over a [B, L] batch of base codes -> [B] positions (-1 =
        not found). Equivalent of reference plQuery (src/sapling_api.h:159)."""
        qcfg = qcfg or QueryConfig()
        dev = self.device_arrays()
        q_words = packops.pack_queries(codes2d)
        x = self.kmerize_batch(codes2d)
        length = int(codes2d.shape[1])
        q3 = (packops.pack_queries3(codes2d)
              if dev.get("prefix3") is not None
              and length <= min(self.k, packops.P3_BASES) else None)
        t = self.table
        out = plquery_batch(
            dev["packed"], dev["rev"], dev["xlist"], dev["ylist"],
            q_words, x, dev.get("prefix"), dev.get("prefix3"), q3,
            dev.get("bounds"), dev.get("ptab"), dev.get("pred2"),
            pred2_bits=dev.get("pred2_bits"),
            n=self.n, length=int(codes2d.shape[1]), k=self.k,
            buckets=self.buckets,
            most_over=t.most_over, most_under=t.most_under,
            max_over=t.max_over, max_under=t.max_under,
            max_stride_steps=qcfg.max_stride_steps,
            adaptive_bounds=qcfg.adaptive_bounds,
            compact_escalate=qcfg.compact_escalate,
            compact_cap=qcfg.compact_cap,
            compact_unresolved=qcfg.compact_unresolved,
        )
        return np.asarray(out)

    def count_hits(self, sa_ranks: np.ndarray, max_hits: int = 32):
        """Number of additional suffix-array neighbors sharing the first k
        bases with each rank: (left, right) counts, each capped at
        max_hits. Equivalent of reference countHitsLeft/countHitsRight
        (src/sapling_api.h:254-303), vectorized over the lcp>=k
        run-length arrays. The reference's off-by-one left walk can step
        to rev[-1] (UB); left is clamped to the ranks that exist."""
        n, k = self.n, self.k
        sa_ranks = np.asarray(sa_ranks)
        m = self.lcpk_fwd.shape[0]                # == n-1 lcp entries
        sp = np.clip(sa_ranks, 0, m - 1)
        fwd = np.where(sa_ranks < m, self.lcpk_fwd[sp].astype(np.int64), 0)
        bwd = np.where(sa_ranks < m, self.lcpk_bwd[sp].astype(np.int64), 0)
        # the right walk also stops at rank > n-k (":258"), a RANK cap
        right = np.minimum(np.minimum(fwd, n - k - sa_ranks + 1), max_hits)
        right = np.maximum(right, 0)
        left = np.minimum(np.minimum(bwd, max_hits), sa_ranks)
        return left, right

    def query_positions_binsearch(self, codes2d: np.ndarray) -> np.ndarray:
        """Classic binary-search baseline over the same device arrays."""
        dev = self.device_arrays()
        q_words = packops.pack_queries(codes2d)
        out = binsearch_batch(
            dev["packed"], dev["rev"], q_words,
            n=self.n, length=int(codes2d.shape[1]),
        )
        return np.asarray(out)

    def verify_hits(self, codes2d: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """Self-check: does the genome substring at each position equal the
        query? (reference: src/sapling_example.cpp:143-154)."""
        if self.codes is None:
            raise ValueError("index was built without host codes")
        length = codes2d.shape[1]
        ok = (positions >= 0) & (positions + length <= self.n)
        good = np.zeros(codes2d.shape[0], dtype=bool)
        pos_ok = positions[ok]
        window = self.codes[pos_ok[:, None] + np.arange(length)]
        good[ok] = (window == codes2d[ok]).all(axis=1)
        return good


def _ship_table_arrays(xl64, yl64, k: int, n: int, slim: bool):
    """Device placement of the PWL checkpoint tables.

    slim split storage (the >= 2^31-rank default): x has 2k bits (hi
    fits u16 for k <= 24) and y <= n fits u32 alone when n < 2^32 — a
    checkpoint ships as 10 bytes, not the 16 of full (u32 hi, u32 lo)
    pairs. At GRCh38 scale that is ~0.4 GB of device args saved on top
    of the on-device xy64+xhi16 repack temps (ops.predict
    ._endpoints_packed), which memory accounting must count too."""
    import jax.numpy as jnp

    if not slim:
        return jnp.asarray(xl64), jnp.asarray(yl64)
    xhi_dt = np.uint16 if 2 * k <= 48 else np.uint32
    xlist = (jnp.asarray((xl64 >> 32).astype(xhi_dt)),
             jnp.asarray((xl64 & 0xFFFFFFFF).astype(np.uint32)))
    if n <= (1 << 32):
        ylist = jnp.asarray((yl64 & 0xFFFFFFFF).astype(np.uint32))
    else:
        ylist = (jnp.asarray((yl64 >> 32).astype(np.uint32)),
                 jnp.asarray((yl64 & 0xFFFFFFFF).astype(np.uint32)))
    return xlist, ylist
