/* Test-only shim: links the REFERENCE's vendored ssw.c (read-only at
 * /root/reference/src/ssw.c) into a tiny C ABI so pytest can compare our
 * batched Smith-Waterman engine against the reference implementation
 * bit-for-bit. This is an oracle harness, not framework code — the .so is
 * built into a gitignored directory by tests/test_sw.py. */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include "ssw.h"

/* Score matrix identical to StripedSmithWaterman::BuildSwScoreMatrix
 * (reference: src/ssw_cpp.cpp:27-52). */
static void build_mat(int8_t match, int8_t mismatch, int8_t *mat) {
  int id = 0, i, j;
  for (i = 0; i < 4; ++i) {
    for (j = 0; j < 4; ++j) mat[id++] = (i == j) ? match : (int8_t)(-mismatch);
    mat[id++] = (int8_t)(-mismatch);
  }
  for (i = 0; i < 5; ++i) mat[id++] = (int8_t)(-mismatch);
}

/* Returns 0 on success. out: score1, score2, ref_begin, ref_end,
 * read_begin, read_end, ref_end2, cigar_len; cigar ops into cig_out. */
int ref_ssw_align(const int8_t *read, int32_t read_len, const int8_t *ref,
                  int32_t ref_len, int32_t match, int32_t mismatch,
                  int32_t gapo, int32_t gape, int32_t mask_len, int32_t *out,
                  uint32_t *cig_out, int32_t cig_cap) {
  int8_t mat[25];
  build_mat((int8_t)match, (int8_t)mismatch, mat);
  s_profile *prof = ssw_init(read, read_len, mat, 5, 2);
  /* flag/filters identical to Aligner::Align with a default Filter
   * (reference: src/ssw_cpp.cpp:212-215 SetFlag -> 0x0f;
   * src/ssw_cpp.h:58-63: score_filter=0, distance_filter=32767). */
  s_align *al = ssw_align(prof, ref, ref_len, (uint8_t)gapo, (uint8_t)gape,
                          0x0f, 0, 32767, mask_len);
  if (!al) {
    init_destroy(prof);
    return 1;
  }
  out[0] = al->score1;
  out[1] = al->score2;
  out[2] = al->ref_begin1;
  out[3] = al->ref_end1;
  out[4] = al->read_begin1;
  out[5] = al->read_end1;
  out[6] = al->ref_end2;
  out[7] = al->cigarLen;
  if (al->cigarLen > 0 && al->cigarLen <= cig_cap)
    memcpy(cig_out, al->cigar, (size_t)al->cigarLen * sizeof(uint32_t));
  align_destroy(al);
  init_destroy(prof);
  return 0;
}
