// swcigar.cpp — banded affine-gap traceback for winning alignments.
//
// The device kernels (sapling_tpu/ops/sw.py) score every candidate window in
// batch and produce endpoints; only the single winning candidate per read
// needs a CIGAR. That traceback is inherently sequential, tiny (the band is
// a few columns wide), and runs once per read — host-native C++ is the
// right tool, exactly as the reference keeps it native
// (reference: src/ssw.c:584-783 banded_sw).
//
// Semantics replicate the reference's banded DP bit-for-bit so SAM output
// is byte-identical:
//   * band grows 2x until the banded max reaches the known score or the
//     band covers the read (ssw.c:607-667 do/while)
//   * direction codes: 1 diag, 2 E-extend, 3 E-open, 4 F-extend, 5 F-open;
//     diagonal wins ties (ssw.c:655-659: "if (temp1 <= temp2) dh = 1")
//   * E consumes the read (emitted 'I'), F consumes the reference ('D')
//   * traceback walks from (readLen-1, refLen-1) in state h until row 0,
//     then closes with a final 'M' (ssw.c:668-745)
//
// CIGAR ints use the SAM/BAM packing length<<4 | op with
// op in {0:M 1:I 2:D 4:S 7:= 8:X}.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int32_t umax(int32_t a, int32_t b) { return a > b ? a : b; }

// Relative banded column index of cell (i, j) within row i's buffer:
// u = j - max(i - band, 0) + 1 (reference: src/ssw.c:87).
inline int32_t band_u(int32_t band, int32_t i, int32_t j) {
  int32_t x = i - band;
  if (x < 0) x = 0;
  return j - x + 1;
}

// Flat index into the per-row direction stripe for (i, j) and DP state p
// (0 = E, 1 = F, 2 = H) (reference: src/ssw.c:90).
inline int32_t band_d(int32_t band, int32_t i, int32_t j, int32_t p) {
  int32_t x = i - band;
  if (x < 0) x = 0;
  return (j - x) * 3 + p;
}

inline uint32_t cig(uint32_t len, uint32_t op) { return (len << 4) | op; }

// Banded DP + traceback core. ref/read point at the aligned region ONLY;
// emits M/I/D ops in SAM order into c. Returns op count or -1 on
// traceback failure.
int32_t banded_core(const int8_t* ref, const int8_t* read, int32_t refLen,
                    int32_t readLen, int32_t score, int32_t match,
                    int32_t mismatch, int32_t gapO, int32_t gapE,
                    int32_t band_width, std::vector<uint32_t>& c);

}  // namespace

extern "C" {

// Banded DP + traceback. ref/read are base codes over the aligned region
// ONLY (ref window [ref_begin..ref_end], read [read_begin..read_end]).
// Emits M/I/D cigar ops into out (capacity out_cap). Returns the number of
// ops, or -1 on traceback failure (the reference returns NULL and the
// aligner skips the candidate, src/align.cpp:336), or -2 if out_cap is too
// small.
int32_t stpu_banded_cigar(const int8_t* ref, const int8_t* read,
                          int32_t refLen, int32_t readLen, int32_t score,
                          int32_t match, int32_t mismatch, int32_t gapO,
                          int32_t gapE, int32_t band_width, uint32_t* out,
                          int32_t out_cap) {
  if (out_cap <= 0) return -1;
  std::vector<uint32_t> c;
  int32_t n = banded_core(ref, read, refLen, readLen, score, match,
                          mismatch, gapO, gapE, band_width, c);
  if (n < 0) return -1;
  if (n > out_cap) return -2;
  for (int32_t t = 0; t < n; ++t) out[(size_t)t] = c[(size_t)t];
  return n;
}

// Batched traceback + SSW-wrapper post-processing for the per-read WINNING
// candidates: banded_core over the aligned slices, then soft-clip the
// unaligned read ends, split M runs into '='/'X', and count mismatches as
// X bases + I/D lengths (reference: src/ssw_cpp.cpp:54-92 ConvertAlignment,
// :120-210 CalculateNumberMismatch). One call per aligner block instead of
// one ctypes round-trip + per-base Python loop per read.
//
// q/r: [B, q_stride] / [B, r_stride] int8 code matrices (full read, full
// ref window). ql: full read lengths (for the tail soft clip). Per row:
// final ops at out + b*out_stride, count in n_ops[b] (-1 = traceback
// failure), mismatches in mism[b]. Returns 0, or -2 if out_stride is too
// small for some row.
int32_t stpu_finish_batch(const int8_t* q, int32_t q_stride, const int8_t* r,
                          int32_t r_stride, const int32_t* ql,
                          const int32_t* score, const int32_t* ref_begin,
                          const int32_t* ref_end, const int32_t* read_begin,
                          const int32_t* read_end, int32_t nrows,
                          int32_t match, int32_t mismatch, int32_t gapO,
                          int32_t gapE, uint32_t* out, int32_t out_stride,
                          int32_t* n_ops, int32_t* mism) {
  std::vector<uint32_t> raw, fin;
  for (int32_t b = 0; b < nrows; ++b) {
    const int8_t* qq = q + (size_t)b * (size_t)q_stride;
    const int8_t* rr = r + (size_t)b * (size_t)r_stride;
    const int32_t rb = ref_begin[b], qb = read_begin[b];
    const int32_t refLen = ref_end[b] - rb + 1;
    const int32_t readLen = read_end[b] - qb + 1;
    int32_t band = refLen - readLen;
    if (band < 0) band = -band;
    band += 1;  // ssw.c:885
    raw.clear();
    int32_t n = banded_core(rr + rb, qq + qb, refLen, readLen, score[b],
                            match, mismatch, gapO, gapE, band, raw);
    if (n < 0) {
      n_ops[b] = -1;
      mism[b] = 0;
      continue;
    }
    fin.clear();
    int32_t mm = 0;
    if (qb > 0) fin.push_back(cig((uint32_t)qb, 4u));
    int32_t ri = rb, qi = qb;
    uint32_t run_op = 0xFFu, run_len = 0;
    auto flush = [&]() {
      if (run_len) fin.push_back(cig(run_len, run_op));
      run_len = 0;
      run_op = 0xFFu;
    };
    for (int32_t t = 0; t < n; ++t) {
      const uint32_t op = raw[(size_t)t] & 0xFu;
      const uint32_t len = raw[(size_t)t] >> 4;
      if (op == 0u) {  // M -> per-base '='/'X'
        for (uint32_t s = 0; s < len; ++s) {
          const bool eq = rr[ri] == qq[qi];
          const uint32_t want = eq ? 7u : 8u;
          if (run_op != want) {
            flush();
            run_op = want;
          }
          ++run_len;
          if (!eq) ++mm;
          ++ri;
          ++qi;
        }
      } else if (op == 1u) {  // I
        flush();
        qi += (int32_t)len;
        mm += (int32_t)len;
        fin.push_back(raw[(size_t)t]);
      } else {  // D
        flush();
        ri += (int32_t)len;
        mm += (int32_t)len;
        fin.push_back(raw[(size_t)t]);
      }
    }
    flush();
    const int32_t tail = ql[b] - qi;  // query_len - query_end - 1, qi = end+1
    if (tail > 0) fin.push_back(cig((uint32_t)tail, 4u));
    if ((int32_t)fin.size() > out_stride) return -2;
    for (size_t t = 0; t < fin.size(); ++t)
      out[(size_t)b * (size_t)out_stride + t] = fin[t];
    n_ops[b] = (int32_t)fin.size();
    mism[b] = mm;
  }
  return 0;
}

}  // extern "C"

namespace {

int32_t banded_core(const int8_t* ref, const int8_t* read, int32_t refLen,
                    int32_t readLen, int32_t score, int32_t match,
                    int32_t mismatch, int32_t gapO, int32_t gapE,
                    int32_t band_width, std::vector<uint32_t>& c) {
  if (refLen <= 0 || readLen <= 0) return -1;
  std::vector<int32_t> h_b, e_b, h_c;
  std::vector<int8_t> direction;
  int32_t max = 0;
  int32_t width = 0, width_d = 0;

  do {
    width = band_width * 2 + 3;
    width_d = band_width * 2 + 1;
    h_b.assign((size_t)width, 0);
    e_b.assign((size_t)width, 0);
    h_c.assign((size_t)width, 0);
    direction.assign((size_t)width_d * (size_t)readLen * 3, 0);

    for (int32_t j = 1; j < width - 1; ++j) h_b[(size_t)j] = 0;
    for (int32_t i = 0; i < readLen; ++i) {
      int32_t beg = umax(0, i - band_width);
      int32_t end = i + band_width < refLen - 1 ? i + band_width : refLen - 1;
      int32_t edge = end + 1 < width - 1 ? end + 1 : width - 1;
      int32_t f = 0;
      h_b[0] = e_b[0] = h_b[(size_t)edge] = e_b[(size_t)edge] = h_c[0] = 0;
      int8_t* dl = direction.data() + (size_t)width_d * (size_t)i * 3;
      int32_t u = 0;
      for (int32_t j = beg; j <= end; ++j) {
        u = band_u(band_width, i, j);
        int32_t e_idx = band_u(band_width, i - 1, j);
        int32_t b_idx = band_u(band_width, i, j - 1);
        int32_t d_idx = band_u(band_width, i - 1, j - 1);
        int32_t de = band_d(band_width, i, j, 0);
        int32_t df = band_d(band_width, i, j, 1);
        int32_t dh = band_d(band_width, i, j, 2);

        // E: gap consuming the read (vertical in reference orientation)
        int32_t t1 = (i == 0) ? -gapO : h_b[(size_t)e_idx] - gapO;
        int32_t t2 = (i == 0) ? -gapE : e_b[(size_t)e_idx] - gapE;
        e_b[(size_t)u] = umax(t1, t2);
        dl[de] = (int8_t)(t1 > t2 ? 3 : 2);
        // F: gap consuming the reference
        t1 = h_c[(size_t)b_idx] - gapO;
        t2 = f - gapE;
        f = umax(t1, t2);
        dl[df] = (int8_t)(t1 > t2 ? 5 : 4);

        int32_t e1 = umax(e_b[(size_t)u], 0);
        int32_t f1 = umax(f, 0);
        t1 = umax(e1, f1);
        int32_t sub = (ref[j] == read[i] && ref[j] < 4) ? match : -mismatch;
        t2 = h_b[(size_t)d_idx] + sub;
        h_c[(size_t)u] = umax(t1, t2);
        if (h_c[(size_t)u] > max) max = h_c[(size_t)u];
        if (t1 <= t2)
          dl[dh] = 1;
        else
          dl[dh] = e1 > f1 ? dl[de] : dl[df];
      }
      for (int32_t j = 1; j <= u; ++j) h_b[(size_t)j] = h_c[(size_t)j];
    }
    band_width *= 2;
  } while (max < score && band_width < readLen);
  band_width /= 2;

  // traceback (reference: src/ssw.c:668-745)
  c.clear();
  int32_t i = readLen - 1, j = refLen - 1;
  int32_t e = 0;  // run length of the current op
  char op = 'M', prev_op = 'M';
  int32_t state = 2;  // h
  const int8_t* dl = direction.data() + (size_t)width_d * (size_t)i * 3;
  while (i > 0) {
    int32_t idx = band_d(band_width, i, j, state);
    int8_t dir = dl[idx];
    switch (dir) {
      case 1:
        --i; --j; state = 2; dl -= (size_t)width_d * 3; op = 'M';
        break;
      case 2:
        --i; state = 0; dl -= (size_t)width_d * 3; op = 'I';
        break;
      case 3:
        --i; state = 2; dl -= (size_t)width_d * 3; op = 'I';
        break;
      case 4:
        --j; state = 1; op = 'D';
        break;
      case 5:
        --j; state = 2; op = 'D';
        break;
      default:
        return -1;  // inconsistent score/position (ssw.c:710-721)
    }
    if (op == prev_op) {
      ++e;
    } else {
      c.push_back(cig((uint32_t)e, prev_op == 'M' ? 0u
                                   : prev_op == 'I' ? 1u : 2u));
      prev_op = op;
      e = 1;
    }
  }
  if (op == 'M') {
    c.push_back(cig((uint32_t)e + 1, 0u));
  } else {
    c.push_back(cig((uint32_t)e, op == 'I' ? 1u : 2u));
    c.push_back(cig(1u, 0u));
  }

  std::reverse(c.begin(), c.end());
  return (int32_t)c.size();
}

}  // namespace
