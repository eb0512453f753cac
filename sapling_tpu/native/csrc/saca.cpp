// saca.cpp — suffix-array construction (SA-IS) + Kasai LCP for sapling-tpu.
//
// Host-side substrate of the framework: the suffix array is built once per
// genome on the host and then shipped to device memory as int32/int64
// arrays. This replaces the reference's DC3 (reference: src/sa.h:82-183) and
// its libdivsufsort offline pipeline (reference: suffixarray/refToSuffixArray.sh)
// with a fresh SA-IS ("induced sorting") implementation, which is O(n) with
// better constants than DC3 and no submodule dependency.
//
// Exposed C ABI (ctypes-friendly):
//   stpu_sais_u8_i32 / stpu_sais_u8_i64 : SA over a byte string
//   stpu_lcp_kasai_i32 / _i64          : rank (inverse SA) + LCP arrays
//   stpu_version
//
// Output conventions match the reference's .sa semantics
// (reference: src/sapling_api.h:559-603, suffixarray/addlcp.cpp:19-77):
//   sa[rank] = text position; inv[text_pos] = rank;
//   lcp[r] = LCP(suffix at rank r, suffix at rank r+1), length n-1.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// SA-IS over a string that ends in a unique smallest sentinel s[n-1] == 0.
// I: index type. Symbols are stored as I as well (uniform at all levels).
template <typename T, typename I>
static void sais(const T* s, I* sa, I n, I K) {
  const I EMPTY = (I)-1;
  // --- classify L/S types -------------------------------------------------
  std::vector<bool> is_s((size_t)n);
  is_s[(size_t)(n - 1)] = true;  // sentinel is S-type
  for (I i = n - 2; i >= 0; --i) {
    is_s[(size_t)i] =
        (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[(size_t)(i + 1)]);
    if (i == 0) break;
  }
  auto is_lms = [&](I i) -> bool {
    return i > 0 && is_s[(size_t)i] && !is_s[(size_t)(i - 1)];
  };

  // --- bucket bookkeeping --------------------------------------------------
  std::vector<I> cnt((size_t)K + 1, 0), bkt((size_t)K + 1);
  for (I i = 0; i < n; ++i) ++cnt[(size_t)s[i]];
  auto bucket_starts = [&]() {
    I sum = 0;
    for (I c = 0; c <= K; ++c) { bkt[(size_t)c] = sum; sum += cnt[(size_t)c]; }
  };
  auto bucket_ends = [&]() {
    I sum = 0;
    for (I c = 0; c <= K; ++c) { sum += cnt[(size_t)c]; bkt[(size_t)c] = sum; }
  };

  auto induce = [&]() {
    // L-type, left to right.
    bucket_starts();
    for (I i = 0; i < n; ++i) {
      I j = sa[i];
      if (j != EMPTY && j > 0 && !is_s[(size_t)(j - 1)])
        sa[bkt[(size_t)s[j - 1]]++] = j - 1;
    }
    // S-type, right to left.
    bucket_ends();
    for (I i = n - 1; i >= 0; --i) {
      I j = sa[i];
      if (j != EMPTY && j > 0 && is_s[(size_t)(j - 1)])
        sa[--bkt[(size_t)s[j - 1]]] = j - 1;
      if (i == 0) break;
    }
  };

  // --- step 1: sort LMS substrings by induction ---------------------------
  for (I i = 0; i < n; ++i) sa[i] = EMPTY;
  bucket_ends();
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) sa[--bkt[(size_t)s[i]]] = i;
  induce();

  // --- step 2: name LMS substrings ----------------------------------------
  I m = 0;
  for (I i = 0; i < n; ++i) {
    I j = sa[i];
    if (j != EMPTY && is_lms(j)) sa[m++] = j;  // LMS in sorted substring order
  }
  for (I i = m; i < n; ++i) sa[i] = EMPTY;
  // names keyed by pos>>1 live in sa[m..n)
  I name = 0, prev = EMPTY;
  for (I i = 0; i < m; ++i) {
    I pos = sa[i];
    bool diff = false;
    if (prev == EMPTY) {
      diff = true;
    } else {
      for (I d = 0;; ++d) {
        if (s[pos + d] != s[prev + d]) { diff = true; break; }
        if (d > 0) {
          bool lp = is_lms(pos + d), lq = is_lms(prev + d);
          if (lp || lq) { diff = !(lp && lq); break; }
        }
        // The sentinel is a unique char, so the scans always terminate at a
        // mismatch or an LMS boundary before running past n.
      }
    }
    if (diff) { ++name; prev = pos; }
    sa[m + (size_t)(pos >> 1)] = name - 1;
  }
  // compact names (in text order of their LMS positions) to the tail of sa.
  {
    I j = n - 1;
    for (I i = n - 1; i >= m; --i) {
      if (sa[i] != EMPTY) sa[j--] = sa[i];
      if (i == m) break;
    }
  }
  I* s1 = sa + (size_t)(n - m);

  // --- step 3: recurse if names are not yet unique -------------------------
  if (name < m) {
    sais<I, I>(s1, sa, m, name - 1);
  } else {
    for (I i = 0; i < m; ++i) sa[(size_t)s1[i]] = i;
  }

  // --- step 4: map recursion result back to LMS text positions ------------
  {
    I j = 0;
    for (I i = 1; i < n; ++i)
      if (is_lms(i)) s1[j++] = i;  // s1[r] = text pos of r-th LMS (text order)
    for (I i = 0; i < m; ++i) sa[i] = s1[(size_t)sa[i]];
  }

  // --- step 5: final induction from fully sorted LMS suffixes -------------
  for (I i = m; i < n; ++i) sa[i] = EMPTY;
  bucket_ends();
  for (I i = m - 1; i >= 0; --i) {
    I j = sa[i];
    sa[i] = EMPTY;
    sa[--bkt[(size_t)s[j]]] = j;
    if (i == 0) break;
  }
  induce();
}

// Wrapper for byte input: shift symbols +1, append sentinel 0, run SA-IS and
// drop the sentinel's (rank-0) entry. The level-0 text stays uint8 (the
// +1 shift keeps every byte value in 1..255 with 0 reserved for the
// sentinel) — at multi-Gbp scale an I-typed copy would cost n*8 bytes.
template <typename I>
static int sais_u8(const uint8_t* s, I* sa_out, int64_t n64) {
  I n = (I)n64;
  if (n == 0) return 0;
  std::vector<uint8_t> t((size_t)n + 1);
  std::memcpy(t.data(), s, (size_t)n);
  for (I i = 0; i < n; ++i) ++t[(size_t)i];
  t[(size_t)n] = 0;
  std::vector<I> sa((size_t)n + 1);
  sais<uint8_t, I>(t.data(), sa.data(), n + 1, 256);
  // sa[0] == n (sentinel suffix); the rest is the SA of s.
  std::memcpy(sa_out, sa.data() + 1, sizeof(I) * (size_t)n);
  return 0;
}

// Kasai LCP. sa: rank -> pos. Outputs inv (pos -> rank) and lcp (size n-1),
// semantics identical to reference src/sa.h:192-210.
template <typename I>
static void lcp_kasai(const uint8_t* s, const I* sa, I n, I* inv, I* lcp) {
  for (I i = 0; i < n; ++i) inv[(size_t)sa[i]] = i;
  I h = 0;
  for (I i = 0; i < n; ++i) {
    I r = inv[(size_t)i];
    if (r + 1 < n) {
      I j = sa[(size_t)(r + 1)];
      while (i + h < n && j + h < n && s[i + h] == s[j + h]) ++h;
      lcp[(size_t)r] = h;
    }
    if (h > 0) --h;
  }
}

}  // namespace

extern "C" {

int stpu_version() { return 1; }

// All return 0 on success, nonzero on bad arguments.
int stpu_sais_u8_i32(const uint8_t* s, int32_t* sa, int64_t n) {
  if (n < 0 || n >= INT32_MAX) return 1;
  return sais_u8<int32_t>(s, sa, n);
}

int stpu_sais_u8_i64(const uint8_t* s, int64_t* sa, int64_t n) {
  if (n < 0) return 1;
  return sais_u8<int64_t>(s, sa, n);
}

int stpu_lcp_kasai_i32(const uint8_t* s, const int32_t* sa, int64_t n,
                       int32_t* inv, int32_t* lcp) {
  if (n < 0 || n >= INT32_MAX) return 1;
  if (n > 0) lcp_kasai<int32_t>(s, sa, (int32_t)n, inv, lcp);
  return 0;
}

int stpu_lcp_kasai_i64(const uint8_t* s, const int64_t* sa, int64_t n,
                       int64_t* inv, int64_t* lcp) {
  if (n < 0) return 1;
  if (n > 0) lcp_kasai<int64_t>(s, sa, n, inv, lcp);
  return 0;
}

// Fused Kasai for n >= 2^32 genomes (wheat-scale axis,
// reference eval/TimingPlot/plot.py:16): emits the split-limb inverse SA
// (uint32 lo + uint8 hi = 5 B/rank — the SplitRanks storage the query
// engine uses at this scale) and the `lcp >= k` FORWARD RUN LENGTHS
// directly, never materializing the int64 LCP array (~8n bytes, which at
// 4.7 Gbp would not fit host RAM next to sa + inv). fwd has n-1 entries:
// fwd[r] = #consecutive ranks j >= r with LCP(j, j+1) >= k — the closed
// form of the reference's k-RMQ (src/sa.h:33-57), matching
// index.suffix_array.lcp_ge_k_runs. Supports n < 2^40 (hi is one byte).
int stpu_lcp_ge_k_fwd_i64(const uint8_t* s, const int64_t* sa, int64_t n,
                          int64_t k, uint32_t* inv_lo, uint8_t* inv_hi,
                          int32_t* fwd) {
  if (n < 0 || k <= 0 || n >= ((int64_t)1 << 40)) return 1;
  if (n == 0) return 0;
  for (int64_t r = 0; r < n; ++r) {
    int64_t p = sa[r];
    inv_lo[p] = (uint32_t)(r & 0xFFFFFFFFLL);
    inv_hi[p] = (uint8_t)(r >> 32);
  }
  int64_t h = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = (int64_t)inv_lo[i] | ((int64_t)inv_hi[i] << 32);
    if (r + 1 < n) {
      int64_t j = sa[r + 1];
      while (i + h < n && j + h < n && s[i + h] == s[j + h]) ++h;
      fwd[r] = h >= k ? 1 : 0;
    }
    if (h > 0) --h;
  }
  // in-place 0/1 -> run length, right to left (lean reverse scan of
  // index.suffix_array.lcp_ge_k_runs)
  int32_t run = 0;
  for (int64_t r = n - 2; r >= 0; --r) {
    run = fwd[r] ? (run < INT32_MAX ? run + 1 : run) : 0;
    fwd[r] = run;
  }
  return 0;
}

}  // extern "C"
