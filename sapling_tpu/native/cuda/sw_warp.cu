// sw_warp.cu — warp-per-candidate affine-gap Smith-Waterman scoring pass
// for Hopper (sm_90a), called from JAX through the XLA FFI.
//
// Same semantics, bit for bit, as sapling_tpu/ops/sw.py:sw_pass (module
// docstring there; reference: src/ssw.c:192-380 byte pass, :406-580 word
// pass). The XLA lowering of sw_pass is a lax.scan over reference columns
// that round-trips the [B, W] H/E state through device memory at every
// column. Here one warp owns one candidate for the whole sweep:
//
//   * the W query rows are striped over the 32 lanes in contiguous runs of
//     K = W/32 rows, so H, E and the best-column snapshot live in registers;
//   * the column loop runs inside the kernel; 32 reference bases are loaded
//     at once (one byte per lane) and broadcast with __shfl_sync;
//   * the vertical gap uses the decayed-running-max factorization of
//     sw_pass: F[j] + gapE*j = cummax(H_nof[j-1] - gapO + gapE*j), done as
//     an in-thread scan over the lane's K rows plus a 5-step __shfl_up_sync
//     max-scan over the lanes' totals;
//   * per-column maxima are warp reductions (__reduce_max_sync); the
//     column-max history needed for score2/ref_end2 is kept in shared
//     memory, one int32 per column per warp.
//
// Integer DP with max/+/- only and no overflow, so any evaluation order
// gives the same values as the scan.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFields = 5;  // score, ref_end, read_end, score2, ref_end2

struct Scoring {
  int w_rows;  // query rows of the padded problem (sw_pass's wpad)
  int match, mismatch, gap_open, gap_extend, mask_len, pad_to;
  int second_inclusive;
};

template <int K, bool kScoreOnly>
__global__ void __launch_bounds__(128)
sw_warp_kernel(const int8_t* __restrict__ query, const int8_t* __restrict__ ref,
               const int32_t* __restrict__ qlen, const int32_t* __restrict__ rlen,
               const int32_t* __restrict__ term, int32_t* __restrict__ out,
               int b, int r, Scoring s) {
  extern __shared__ int32_t colmax_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cand = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cand >= b) return;  // warp-uniform

  const int ql = qlen[cand];
  const int rl_raw = rlen[cand];
  const int rl = min(rl_raw, r);
  const int tm = term[cand];
  const int vlen = min(ql, s.w_rows);  // real rows
  const int padlen =                   // real + SSE pad rows
      min(((ql + s.pad_to - 1) / s.pad_to) * s.pad_to, s.w_rows);
  const int row0 = lane * K;

  int q[K], h[K], e[K], bc[K];
  const int8_t* qrow = query + static_cast<size_t>(cand) * (32 * K) + row0;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    q[m] = qrow[m];
    h[m] = 0;
    e[m] = kNeg;
    bc[m] = 0;
  }

  int32_t* colmax = colmax_all + warp * r;
  if (!kScoreOnly) {
    for (int i = lane; i < r; i += 32) colmax[i] = 0;
    __syncwarp();
  }

  int best = 0, best_ref = -1;  // full mode
  int best_h = 0;               // score-only mode: per-lane running max
  bool done = false;
  const int8_t* rrow = ref + static_cast<size_t>(cand) * r;

  for (int c0 = 0; c0 < rl && !done; c0 += 32) {
    const int rv = (c0 + lane < r) ? rrow[c0 + lane] : 0;
    const int nc = min(32, rl - c0);
    for (int t = 0; t < nc; ++t) {
      const int i = c0 + t;
      const int rb = __shfl_sync(kFull, rv, t);

      // H without the vertical gap; diag of row j is H[j-1] of the previous
      // column, which for the lane's first row sits in the lane below
      int diag0 = __shfl_up_sync(kFull, h[K - 1], 1);
      if (lane == 0) diag0 = 0;
      int hn[K];
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int j = row0 + m;
        const int diag = (m == 0) ? diag0 : h[m - 1];
        const int sub = (j < vlen)
                            ? ((q[m] == rb && q[m] < 4) ? s.match : -s.mismatch)
                            : 0;
        const int v = max(max(diag + sub, e[m]), 0);
        hn[m] = (j < padlen) ? v : 0;
      }

      // F via the decayed running max: in-lane inclusive scan ...
      int a0 = __shfl_up_sync(kFull, hn[K - 1], 1) - s.gap_open;
      if (lane == 0) a0 = kNeg;
      int cm[K];
      int run = kNeg;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int j = row0 + m;
        const int a = (m == 0) ? a0 : hn[m - 1] - s.gap_open;
        run = max(run, a + s.gap_extend * j);
        cm[m] = run;
      }
      // ... then a warp max-scan of the lane totals
      int tot = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, tot, d);
        if (lane >= d) tot = max(tot, o);
      }
      int excl = __shfl_up_sync(kFull, tot, 1);
      if (lane == 0) excl = kNeg;

      int cr = -1, cp = -1;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int j = row0 + m;
        const bool live = j < padlen;
        const int f = max(excl, cm[m]) - s.gap_extend * j;
        const int hv = live ? max(hn[m], f) : 0;
        e[m] = live ? max(e[m] - s.gap_extend, hv - s.gap_open) : kNeg;
        h[m] = hv;
        if (kScoreOnly) {
          if (j < vlen) best_h = max(best_h, hv);
        } else {
          if (j < vlen) cr = max(cr, hv);
          if (live) cp = max(cp, hv);
        }
      }
      if (!kScoreOnly) {
        cr = __reduce_max_sync(kFull, cr);
        cp = __reduce_max_sync(kFull, cp);
        if (cr > best) {  // warp-uniform
          best = cr;
          best_ref = i;
#pragma unroll
          for (int m = 0; m < K; ++m) bc[m] = h[m];
        }
        if (lane == 0) colmax[i] = cp;
        if (cp == tm) {  // terminate after this column (ssw.c:333-334)
          done = true;
          break;
        }
      }
    }
  }

  if (kScoreOnly) {
    const int score = __reduce_max_sync(kFull, best_h);
    if (lane == 0) out[cand] = score;
    return;
  }

  // read_end: smallest real row attaining the max in the best column
  int first = INT_MAX;
#pragma unroll
  for (int m = K - 1; m >= 0; --m) {
    const int j = row0 + m;
    if (j < vlen && bc[m] == best) first = j;
  }
  first = __reduce_min_sync(kFull, first);
  const int read_end = (first == INT_MAX) ? ql - 1 : first;

  // second best: best column max outside [ref_end - mask, ref_end + mask]
  __syncwarp();
  const int lo_edge = max(best_ref - s.mask_len, 0);
  const int hi_edge = min(best_ref + s.mask_len, rl_raw);
  int m2 = INT_MIN, i2 = INT_MAX;
  for (int i = lane; i < r; i += 32) {
    const bool right_ok = s.second_inclusive ? (i >= hi_edge) : (i > hi_edge);
    const bool eligible = (i < lo_edge || right_ok) && i < rl_raw;
    const int v = eligible ? colmax[i] : 0;
    if (v > m2) {
      m2 = v;
      i2 = i;
    }
  }
  const int score2 = __reduce_max_sync(kFull, m2);
  i2 = __reduce_min_sync(kFull, (m2 == score2) ? i2 : INT_MAX);

  if (lane == 0) {
    out[cand] = best;
    out[b + cand] = best_ref;
    out[2 * b + cand] = read_end;
    out[3 * b + cand] = score2;
    out[4 * b + cand] = (score2 > 0) ? i2 : 0;
  }
}

template <bool kScoreOnly>
cudaError_t launch(cudaStream_t stream, int k, const int8_t* query,
                   const int8_t* ref, const int32_t* qlen, const int32_t* rlen,
                   const int32_t* term, int32_t* out, int b, int r,
                   const Scoring& s) {
  constexpr int kWarps = 4;
  const dim3 grid((b + kWarps - 1) / kWarps), block(32 * kWarps);
  const size_t smem = kScoreOnly ? 0 : sizeof(int32_t) * kWarps * r;
  switch (k) {
#define SW_CASE(KK)                                                       \
  case KK:                                                                \
    sw_warp_kernel<KK, kScoreOnly><<<grid, block, smem, stream>>>(        \
        query, ref, qlen, rlen, term, out, b, r, s);                      \
    break;
    SW_CASE(1)
    SW_CASE(2)
    SW_CASE(4)
    SW_CASE(8)
    SW_CASE(16)
    SW_CASE(32)
#undef SW_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

ffi::Error SwPassImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> query,
                      ffi::Buffer<ffi::S8> ref, ffi::Buffer<ffi::S32> qlen,
                      ffi::Buffer<ffi::S32> rlen, ffi::Buffer<ffi::S32> term,
                      ffi::ResultBuffer<ffi::S32> out, int32_t w_rows,
                      int32_t match, int32_t mismatch, int32_t gap_open,
                      int32_t gap_extend, int32_t mask_len, int32_t pad_to,
                      int32_t second_inclusive, int32_t score_only) {
  const auto qd = query.dimensions();
  const auto rd = ref.dimensions();
  if (qd.size() != 2 || rd.size() != 2 || qd[0] != rd[0])
    return ffi::Error::InvalidArgument("query [B, W] and ref [B, R] expected");
  const int64_t b = qd[0], wk = qd[1], r = rd[1];
  if (wk % 32 != 0 || w_rows > wk)
    return ffi::Error::InvalidArgument("query width must be 32*K >= w_rows");
  const int k = static_cast<int>(wk / 32);
  const int fields = score_only ? 1 : kFields;
  if (out->element_count() != static_cast<size_t>(fields * b))
    return ffi::Error::InvalidArgument("result must be [fields, B]");
  if (!score_only && sizeof(int32_t) * 4 * r > 48 * 1024)
    return ffi::Error::InvalidArgument("reference window too long");
  if (b == 0) return ffi::Error::Success();
  const Scoring s{w_rows,     match,    mismatch, gap_open, gap_extend,
                  mask_len,   pad_to,   second_inclusive};
  const cudaError_t err =
      score_only
          ? launch<true>(stream, k, query.typed_data(), ref.typed_data(),
                         qlen.typed_data(), rlen.typed_data(),
                         term.typed_data(), out->typed_data(),
                         static_cast<int>(b), static_cast<int>(r), s)
          : launch<false>(stream, k, query.typed_data(), ref.typed_data(),
                          qlen.typed_data(), rlen.typed_data(),
                          term.typed_data(), out->typed_data(),
                          static_cast<int>(b), static_cast<int>(r), s);
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sw_warp launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SaplingSwPass, SwPassImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // query
                                  .Arg<ffi::Buffer<ffi::S8>>()   // ref
                                  .Arg<ffi::Buffer<ffi::S32>>()  // qlen
                                  .Arg<ffi::Buffer<ffi::S32>>()  // rlen
                                  .Arg<ffi::Buffer<ffi::S32>>()  // terminate
                                  .Ret<ffi::Buffer<ffi::S32>>()  // [F, B]
                                  .Attr<int32_t>("w_rows")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend")
                                  .Attr<int32_t>("mask_len")
                                  .Attr<int32_t>("pad_to")
                                  .Attr<int32_t>("second_inclusive")
                                  .Attr<int32_t>("score_only"));
