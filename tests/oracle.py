"""Scalar Python oracle implementing the reference's exact semantics.

A deliberately slow, string-based reimplementation of the C++ reference
(/root/reference/src/sapling_api.h, sa.h, binarysearch.cpp) used as the
conformance ground truth for the vectorized engine. Every method cites
the reference lines it mirrors.
"""

from __future__ import annotations

import numpy as np

VALS = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T


def suffix_array_naive(seq: bytes) -> list[int]:
    return sorted(range(len(seq)), key=lambda i: seq[i:])


def lcp_array(seq: bytes, sa: list[int]) -> list[int]:
    n = len(seq)
    out = []
    for r in range(n - 1):
        a, b = seq[sa[r]:], seq[sa[r + 1]:]
        l = 0
        while l < min(len(a), len(b)) and a[l] == b[l]:
            l += 1
        out.append(l)
    return out


class OracleSapling:
    """Mirror of struct Sapling (sapling_api.h:17-679)."""

    def __init__(self, seq: bytes, k: int = 21, buckets: int = -1,
                 max_mem: int = 10, most_threshold: float = 0.95):
        self.ref = seq
        self.n = len(seq)
        self.k = k
        self.alpha = 2
        self.most_threshold = most_threshold
        sa = suffix_array_naive(seq)
        self.rev = sa                       # rank -> pos
        self.inv = [0] * self.n             # pos -> rank
        for r, p in enumerate(sa):
            self.inv[p] = r
        self.lcp = lcp_array(seq, sa)
        # krmq (sa.h:33-43)
        m = len(self.lcp)
        self.krmqb = [0] * (m + 1)
        for i in range(m - 1, -1, -1):
            self.krmqb[i] = 0 if self.lcp[i] < k else 1 + self.krmqb[i + 1]
        if buckets == -1:                   # sapling_api.h:387-391
            buckets = 1
            while (1 << buckets) * max_mem * 2 <= self.n:
                buckets += 1
        self.buckets = buckets
        self._build_pwl()

    # sapling_api.h:73-78
    def kmerize(self, s: bytes) -> int:
        v = 0
        for c in s[: self.k]:
            v = (v << self.alpha) | VALS[c]
        return v

    # sapling_api.h:83-90
    def kmerize_adjusted(self, length: int, s: bytes) -> int:
        if length >= self.k:
            return self.kmerize(s)
        v = 0
        for c in s[:length]:
            v = (v << self.alpha) | VALS[c]
        v = (v << self.alpha) | 2
        return v << (2 * (self.k - length - 1))

    # sapling_api.h:98-109 (exact C++ double semantics)
    def query_pwl(self, x: int) -> int:
        bucket = x >> (self.alpha * self.k - self.buckets)
        xlo, xhi = self.xlist[bucket], self.xlist[bucket + 1]
        ylo, yhi = self.ylist[bucket], self.ylist[bucket + 1]
        if xlo == xhi:
            return ylo
        predict = int(
            np.float64(0.5)
            + np.float64(ylo)
            + np.float64(yhi - ylo) * (np.float64(x - xlo) / np.float64(xhi - xlo))
        )
        return max(predict, 0)

    # sapling_api.h:115-120
    def get_lcp(self, idx: int, s: bytes, start: int, length: int) -> int:
        i = start
        while i < length and idx + i < self.n:
            if s[i] != self.ref[idx + i]:
                return i
            i += 1
        return i

    # sa.h:47-57
    def query_lcp_k(self, a: int, b: int) -> bool:
        i, j = min(a, b), max(a, b) - 1
        return (i > j) or (self.krmqb[i] + i > j)

    # sapling_api.h:309-337 — note the over branch discards its search result
    def get_error(self, y: int, predict: int) -> int:
        if y < predict:
            lo, hi = y, predict + 1
            while lo < hi - 1:
                mid = (lo + hi) // 2
                if self.query_lcp_k(y, mid):
                    lo = mid
                else:
                    hi = mid
            return lo - predict
        return y - predict

    # sapling_api.h:384-487
    def _build_pwl(self):
        nb = 1 << self.buckets
        self.xlist = [-1] * (nb + 1)
        self.ylist = [0] * (nb + 1)
        shift = self.alpha * self.k - self.buckets
        kmers = []
        for i in range(self.n - self.k + 1):
            x = self.kmerize(self.ref[i : i + self.k])
            kmers.append(x)
            y = self.inv[i]
            b = x >> shift
            if self.xlist[b] == -1 or self.xlist[b] > x:
                self.xlist[b] = x
                self.ylist[b] = y
            if x > self.xlist[nb]:
                self.xlist[nb] = x
                self.ylist[nb] = y
        if self.xlist[0] == -1:
            self.xlist[0] = 0
            self.ylist[0] = 0
        for i in range(1, nb + 1):
            if self.xlist[i] == -1:
                self.xlist[i] = self.xlist[i - 1]
                self.ylist[i] = self.ylist[i - 1]
        overs, unders, perfect = [], [], 0
        self.errors = []
        for i, x in enumerate(kmers):
            predict = self.query_pwl(x)
            val = self.get_error(self.inv[i], predict)
            self.errors.append(val)
            if val > 0:
                overs.append(val)
            elif val < 0:
                unders.append(-val)
            else:
                perfect += 1
        self.perfect = perfect
        # errorStats (sapling_api.h:342-379)
        self.max_over = max(overs) if overs else 0
        self.max_under = max(unders) if unders else 0
        tot = sum(overs) + sum(unders)
        ntot = len(overs) + len(unders) + perfect
        self.max_under = max(self.max_under, 2)
        self.max_over = max(self.max_over, 2)
        self.mean_error = int(0.5 + tot // ntot) if ntot else 0
        overs.sort()
        unders.sort()
        self.most_over = overs[int(self.most_threshold * len(overs))] if overs else 0
        self.most_under = unders[int(self.most_threshold * len(unders))] if unders else 0
        self.most_over = max(self.most_over, 1)
        self.most_under = max(self.most_under, 1)

    # sapling_api.h:133-153
    def binary_search(self, s: bytes, lo: int, hi: int, length: int):
        while True:
            if hi == lo + 2:
                return lo + 1
            mid = (lo + hi) >> 1
            idx = self.rev[mid]
            nlcp = self.get_lcp(idx, s, 0, length)
            if nlcp == len(s):
                return mid
            if lo + 1 >= hi:
                return -1
            if nlcp + idx == self.n or s[nlcp] > self.ref[idx + nlcp]:
                lo = mid
            else:
                hi = mid

    # sapling_api.h:159-248
    def pl_query(self, s: bytes, kmer: int, length: int,
                 max_steps: int = 10_000):
        predicted = self.query_pwl(kmer)
        idx = self.rev[predicted]
        lcp = self.get_lcp(idx, s, 0, length)
        if lcp == length:
            return idx
        if lcp + idx == self.n or s[lcp] > self.ref[idx + lcp]:
            lo = predicted
            hi = min(self.n - 1, predicted + self.most_over)
            hi_idx = self.rev[hi]
            olcp = self.get_lcp(hi_idx, s, 0, length)
            if olcp == length:
                return hi_idx
            if olcp + hi_idx == self.n or s[olcp] > self.ref[hi_idx + olcp]:
                lo = hi
                hi = min(self.n - 1, predicted + self.max_over + 1)
                hi_idx = self.rev[hi]
                olcp = self.get_lcp(hi_idx, s, 0, length)
                if olcp == length:
                    return hi_idx
                if len(s) > self.k:
                    steps = 0
                    while (olcp + hi_idx != self.n
                           and s[olcp] > self.ref[hi_idx + olcp]):
                        if hi == self.n - 1:
                            # The C++ loop (sapling_api.h:186-196) cannot
                            # advance and livelocks here; the batched kernel's
                            # stuck rule sets lo=hi and proceeds.
                            lo = hi
                            break
                        lo = hi
                        hi = min(self.n - 1, hi + self.max_over)
                        hi_idx = self.rev[hi]
                        olcp = self.get_lcp(hi_idx, s, 0, length)
                        if olcp == len(s):
                            return hi_idx
                        steps += 1
                        if steps > max_steps:
                            raise RuntimeError("reference would livelock")
        else:
            lo = max(0, predicted - self.most_under)
            hi = predicted
            lo_idx = self.rev[lo]
            olcp = self.get_lcp(lo_idx, s, 0, length)
            if olcp == len(s):
                return lo_idx
            if olcp + lo_idx == self.n or s[olcp] > self.ref[lo_idx + olcp]:
                pass  # good case
            else:
                hi = lo
                lo = max(0, predicted - self.max_under - 1)
                lo_idx = self.rev[lo]
                olcp = self.get_lcp(lo_idx, s, 0, length)
                if olcp == len(s):
                    return lo_idx
                if len(s) > self.k:
                    steps = 0
                    while (olcp + lo_idx != self.n
                           and s[olcp] < self.ref[lo_idx + olcp]):
                        if lo == 0:
                            # C++ would underflow size_t lo (:235-236); the
                            # batched kernel's stuck rule sets hi=lo and proceeds.
                            hi = lo
                            break
                        hi = lo
                        lo = max(0, lo - self.max_under)
                        lo_idx = self.rev[lo]
                        olcp = self.get_lcp(lo_idx, s, 0, length)
                        if olcp == len(s):
                            return lo_idx
                        steps += 1
                        if steps > max_steps:
                            raise RuntimeError("reference would livelock")
        rev_pos = self.binary_search(s, lo, hi, length)
        if rev_pos == -1:
            return -1
        return self.rev[rev_pos]

    # sapling_api.h:254-303
    def count_hits_right(self, sa_pos: int, max_hits: int) -> int:
        for i in range(max_hits):
            if i + sa_pos > (self.n - self.k) or self.lcp[i + sa_pos] < self.k:
                return i
        return max_hits

    def count_hits_left(self, sa_pos: int, max_hits: int) -> int:
        for i in range(max_hits):
            if sa_pos < i or self.lcp[sa_pos - i] < self.k:
                return i
        return max_hits

    # binarysearch.cpp:158-165 (baseline)
    def b_query(self, s: bytes):
        length = len(s)
        lo_lcp = self.get_lcp(self.rev[0], s, 0, length)
        if lo_lcp == length:
            return self.rev[0]
        hi_lcp = self.get_lcp(self.rev[self.n - 1], s, 0, length)
        if hi_lcp == length:
            return self.rev[self.n - 1]
        r = self.binary_search(s, 0, self.n - 1, length)
        return self.rev[r] if r != -1 else -1
