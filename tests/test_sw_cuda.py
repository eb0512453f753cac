"""The Smith-Waterman scoring pass: plain sw_pass, the choice of pass per
platform, and the CUDA kernel (ops/sw_cuda.py, native/cuda/sw_warp.cu).

On the CPU these tests hold sw_pass to the cell-by-cell oracle
(tests/oracle_sw.py) over every semantic knob the kernel must reproduce
(terminate, byte/word pad rows, second-best edge inclusivity, scoring),
check the choice function and the wrapper's padding, and run a NumPy
transcription of the kernel's warp algorithm (rows striped over 32 lanes,
in-lane scan + shuffle max-scan) against sw_pass. The kernel itself has
no CPU or interpret mode: the cases marked `gpu` compare it with sw_pass
field by field on the card, and skip elsewhere. Run them there with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_sw_cuda.py -m gpu
"""

import jax
import numpy as np
import pytest

from sapling_tpu.ops.sw import (_pad_bucket, sw_align_ends, sw_kernel,
                                sw_pass)
from sapling_tpu.ops.sw_cuda import rows_per_lane

from .oracle_sw import sw_oracle

FIELDS = ("score", "ref_end", "read_end", "score2", "ref_end2")
NEG = -(1 << 30)


def _random_batch(rng, b, w, r, related_every=3):
    q = rng.integers(0, 5, (b, w)).astype(np.int8)
    ref = rng.integers(0, 5, (b, r)).astype(np.int8)
    for i in range(0, b, related_every):   # some high-scoring lanes
        ln = min(w, r - 5)
        ref[i, 5:5 + ln] = q[i, :ln]
    ql = rng.integers(5, w + 1, b).astype(np.int32)
    rl = rng.integers(10, r + 1, b).astype(np.int32)
    # tails past the true lengths are zero, as every caller builds them
    q[np.arange(w)[None, :] >= ql[:, None]] = 0
    ref[np.arange(r)[None, :] >= rl[:, None]] = 0
    return q, ql, ref, rl


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _oracle_rows(q, ql, ref, rl, term=None, **kw):
    out = {k: [] for k in FIELDS}
    for i in range(len(q)):
        o = sw_oracle(q[i, :ql[i]], ref[i, :rl[i]],
                      terminate=-1 if term is None else int(term[i]), **kw)
        for k in FIELDS:
            out[k].append(o[k])
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_fields(got, want, fields=FIELDS):
    for k in fields:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- plain sw_pass vs the oracle, over the kernel's knobs -----------------

@pytest.mark.parametrize("pad_to,second_inclusive", [(16, False), (8, True)])
def test_sw_pass_pad_modes_vs_oracle(pad_to, second_inclusive):
    rng = np.random.default_rng(11)
    q, ql, ref, rl = _random_batch(rng, 48, 40, 60)
    kw = dict(pad_to=pad_to, second_inclusive=second_inclusive)
    got = _np(sw_pass(q, ql, ref, rl, np.full(48, -1, np.int32), **kw))
    _assert_fields(got, _oracle_rows(q, ql, ref, rl, **kw))


def test_sw_pass_terminate_vs_oracle():
    rng = np.random.default_rng(12)
    q, ql, ref, rl = _random_batch(rng, 32, 24, 36)
    no_term = np.full(32, -1, np.int32)
    term = np.asarray(sw_pass(q, ql, ref, rl, no_term)["score"], np.int32)
    got = _np(sw_pass(q, ql, ref, rl, term))
    _assert_fields(got, _oracle_rows(q, ql, ref, rl, term=term))


def test_sw_pass_nonstandard_scoring_vs_oracle():
    # the aligner's actual params are the SSW defaults (align.cpp:20-23);
    # sweep a different matrix to catch hard-coded constants
    rng = np.random.default_rng(14)
    q, ql, ref, rl = _random_batch(rng, 16, 30, 50)
    kw = dict(match=3, mismatch=1, gap_open=5, gap_extend=2, mask_len=7)
    got = _np(sw_pass(q, ql, ref, rl, np.full(16, -1, np.int32), **kw))
    _assert_fields(got, _oracle_rows(q, ql, ref, rl, **kw))


def test_sw_align_ends_vs_oracle():
    # forward fields plus the begins from the reverse pass (ssw.c:860-875):
    # reversed prefixes, terminating at the forward score
    rng = np.random.default_rng(13)
    q, ql, ref, rl = _random_batch(rng, 30, 100, 140)
    got = _np(sw_align_ends(q, ql, ref, rl))
    want = _oracle_rows(q, ql, ref, rl)
    _assert_fields(got, want)
    for i in range(len(q)):
        qe, re_ = int(want["read_end"][i]), int(want["ref_end"][i])
        rev = sw_oracle(q[i, :qe + 1][::-1], ref[i, :re_ + 1][::-1],
                        terminate=int(want["score"][i]))
        assert got["ref_begin"][i] == re_ - rev["ref_end"], i
        assert got["read_begin"][i] == qe - rev["read_end"], i


# --- the choice of pass and the wrapper's shapes ---------------------------

def test_sw_kernel_cpu_is_sw_pass():
    assert sw_kernel("cpu") is sw_pass
    assert sw_kernel() is sw_pass          # the test backend is the CPU
    with jax.default_device(jax.devices("cpu")[0]):
        assert sw_kernel() is sw_pass


def test_sw_kernel_gpu_without_kernel_is_sw_pass():
    # the A/B switch for timing: no build is attempted
    assert sw_kernel("gpu", use_kernel=False) is sw_pass


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_sw_kernel_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no Smith-Waterman pass"):
        sw_kernel(platform)


def test_rows_per_lane():
    assert [rows_per_lane(w) for w in (8, 32, 33, 112, 128, 256, 1024)] == \
        [1, 1, 2, 4, 4, 8, 32]
    with pytest.raises(ValueError):
        rows_per_lane(1025)


def test_pad_bucket():
    assert _pad_bucket(1) == 256 and _pad_bucket(256) == 256
    for b0 in (257, 1000, 16_384, 82_000, 164_000):
        b = _pad_bucket(b0)
        assert b >= b0 and b % 256 == 0 and b - b0 < max(256, b0 // 8)


def test_dead_query_columns_leave_sw_pass_unchanged():
    # the CUDA wrapper widens the query to 32*K rows; rows past a lane's
    # true length must not change any field, in either pad mode
    rng = np.random.default_rng(21)
    q, ql, ref, rl = _random_batch(rng, 24, 40, 70)
    qw = np.pad(q, ((0, 0), (0, 128 - 40)))
    for pad_to, si in ((16, False), (8, True)):
        kw = dict(pad_to=pad_to, second_inclusive=si)
        term = np.full(24, -1, np.int32)
        _assert_fields(_np(sw_pass(qw, ql, ref, rl, term, **kw)),
                       _np(sw_pass(q, ql, ref, rl, term, **kw)))


def test_sw_align_ends_padding_of_b_w_r():
    # sw_align_ends pads B to a power of two, W to x128, R to x32: a batch
    # of odd sizes must give each row what a batch of that row alone gives
    rng = np.random.default_rng(22)
    q, ql, ref, rl = _random_batch(rng, 5, 37, 53)
    whole = _np(sw_align_ends(q, ql, ref, rl))
    for i in range(5):
        one = _np(sw_align_ends(q[i:i + 1, :ql[i]], ql[i:i + 1],
                                ref[i:i + 1, :rl[i]], rl[i:i + 1]))
        for k in whole:
            assert whole[k][i] == one[k][0], (i, k)


# --- the kernel's warp algorithm, transcribed to NumPy ---------------------

def _shfl_up(x, d):
    """__shfl_up_sync over the lane axis (1): lanes < d keep their own."""
    y = x.copy()
    y[:, d:] = x[:, :-d]
    return y


def _warp_model(query, qlen, ref, rlen, term, *, match=2, mismatch=2,
                gap_open=3, gap_extend=1, mask_len=15, pad_to=16,
                second_inclusive=False, score_only=False):
    """sw_warp_kernel, step for step, vectorized over candidates: lane
    l holds rows [l*K, l*K+K); F's decayed running max is an in-lane
    scan plus a 5-step shuffle max-scan of the lane totals."""
    b, w = query.shape
    r = ref.shape[1]
    w_rows = -(-w // pad_to) * pad_to
    k = rows_per_lane(w_rows)
    q = np.zeros((b, 32 * k), np.int64)
    q[:, :w] = query
    q = q.reshape(b, 32, k)
    j = np.arange(32 * k).reshape(1, 32, k)
    lane = np.arange(32)[None, :]
    ql = qlen.astype(np.int64)
    vlen = np.minimum(ql, w_rows)[:, None, None]
    padlen = np.minimum(-(-ql // pad_to) * pad_to, w_rows)[:, None, None]
    valid, live = j < vlen, j < padlen
    rl = np.minimum(rlen, r)
    h = np.zeros((b, 32, k), np.int64)
    e = np.full((b, 32, k), NEG, np.int64)
    bc = np.zeros_like(h)
    best = np.zeros(b, np.int64)
    best_ref = np.full(b, -1, np.int64)
    best_h = np.zeros_like(h)
    done = np.zeros(b, bool)
    colmax = np.zeros((b, r), np.int64)
    for i in range(r):
        act = (i < rl) & ~done
        rb = ref[:, i].astype(np.int64)[:, None, None]
        diag0 = _shfl_up(h[:, :, k - 1], 1)
        diag0[:, 0] = 0
        diag = np.concatenate([diag0[:, :, None], h[:, :, :-1]], axis=2)
        sub = np.where(valid, np.where((q == rb) & (q < 4), match,
                                       -mismatch), 0)
        hn = np.where(live, np.maximum(np.maximum(diag + sub, e), 0), 0)
        a0 = _shfl_up(hn[:, :, k - 1], 1) - gap_open
        a0[:, 0] = NEG
        a = np.concatenate([a0[:, :, None], hn[:, :, :-1] - gap_open],
                           axis=2)
        cm = np.maximum.accumulate(np.maximum(a + gap_extend * j, NEG),
                                   axis=2)
        tot = cm[:, :, k - 1]
        for d in (1, 2, 4, 8, 16):
            tot = np.where(lane >= d, np.maximum(tot, _shfl_up(tot, d)),
                           tot)
        excl = _shfl_up(tot, 1)
        excl[:, 0] = NEG
        f = np.maximum(excl[:, :, None], cm) - gap_extend * j
        hv = np.where(live, np.maximum(hn, f), 0)
        ev = np.where(live, np.maximum(e - gap_extend, hv - gap_open), NEG)
        m = act[:, None, None]
        h, e = np.where(m, hv, h), np.where(m, ev, e)
        if score_only:
            best_h = np.where(m & valid, np.maximum(best_h, hv), best_h)
            continue
        cr = np.where(valid, hv, -1).max(axis=(1, 2))
        cp = np.where(live, hv, -1).max(axis=(1, 2))
        upd = act & (cr > best)
        best = np.where(upd, cr, best)
        best_ref = np.where(upd, i, best_ref)
        bc = np.where(upd[:, None, None], hv, bc)
        colmax[:, i] = np.where(act, cp, 0)
        done |= act & (cp == term)
    if score_only:
        return {"score": best_h.max(axis=(1, 2))}
    big = np.iinfo(np.int32).max
    first = np.where(valid & (bc == best[:, None, None]), j, big)
    first = first.min(axis=(1, 2))
    read_end = np.where(first == big, ql - 1, first)
    # second best: lane l scans columns l, l+32, ...; then max over lanes
    # and the smallest column among lanes attaining it
    lo_edge = np.maximum(best_ref - mask_len, 0)[:, None]
    hi_edge = np.minimum(best_ref + mask_len, rlen)[:, None]
    iidx = np.arange(r)[None, :]
    right_ok = (iidx >= hi_edge) if second_inclusive else (iidx > hi_edge)
    elig = ((iidx < lo_edge) | right_ok) & (iidx < rlen[:, None])
    v = np.where(elig, colmax, 0)
    m2 = np.full((b, 32), np.iinfo(np.int64).min)
    i2 = np.full((b, 32), big)
    for c in range(r):
        better = v[:, c] > m2[:, c % 32]
        m2[:, c % 32] = np.where(better, v[:, c], m2[:, c % 32])
        i2[:, c % 32] = np.where(better, c, i2[:, c % 32])
    score2 = m2.max(axis=1)
    i2 = np.where(m2 == score2[:, None], i2, big).min(axis=1)
    return {"score": best, "ref_end": best_ref, "read_end": read_end,
            "score2": score2, "ref_end2": np.where(score2 > 0, i2, 0)}


@pytest.mark.parametrize("w,r,pad_to,second_inclusive,scoring", [
    (20, 45, 16, False, {}),                       # K=1
    (40, 60, 8, True, {}),                         # K=2
    (100, 140, 16, False, {}),                     # K=4
    (128, 128, 8, True, {}),                       # K=4, full width
    (200, 96, 16, False,                           # K=8, R < W
     dict(match=3, mismatch=1, gap_open=5, gap_extend=2, mask_len=7)),
])
def test_warp_model_matches_sw_pass(w, r, pad_to, second_inclusive, scoring):
    rng = np.random.default_rng(w + r)
    q, ql, ref, rl = _random_batch(rng, 24, w, r)
    kw = dict(pad_to=pad_to, second_inclusive=second_inclusive, **scoring)
    term = np.full(24, -1, np.int32)
    _assert_fields(_warp_model(q, ql, ref, rl, term, **kw),
                   _np(sw_pass(q, ql, ref, rl, term, **kw)))
    sc = _warp_model(q, ql, ref, rl, term, score_only=True, **kw)
    np.testing.assert_array_equal(
        sc["score"],
        np.asarray(sw_pass(q, ql, ref, rl, term, score_only=True,
                           **kw)["score"]))


def test_warp_model_terminate_matches_sw_pass():
    rng = np.random.default_rng(31)
    q, ql, ref, rl = _random_batch(rng, 32, 64, 80)
    term = np.asarray(sw_pass(q, ql, ref, rl, np.full(32, -1, np.int32))
                      ["score"], np.int32)
    _assert_fields(_warp_model(q, ql, ref, rl, term),
                   _np(sw_pass(q, ql, ref, rl, term)))


# --- the CUDA kernel on the card --------------------------------------------

@pytest.fixture
def gpu_devices():
    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the CUDA kernel has no CPU or interpret mode")
    return gpu, jax.devices("cpu")[0]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pad16", "pad8", "terminate", "score_only",
                                  "scoring"])
def test_cuda_kernel_matches_sw_pass(gpu_devices, mode):
    from sapling_tpu.ops.sw_cuda import sw_pass_cuda

    gpu, cpu = gpu_devices
    rng = np.random.default_rng(41)
    q, ql, ref, rl = _random_batch(rng, 1000, 128, 160)
    term = np.full(1000, -1, np.int32)
    kw = {"pad16": {}, "pad8": dict(pad_to=8, second_inclusive=True),
          "terminate": {}, "score_only": dict(score_only=True),
          "scoring": dict(match=3, mismatch=1, gap_open=5, gap_extend=2,
                          mask_len=7)}[mode]
    with jax.default_device(cpu):
        if mode == "terminate":
            term = np.asarray(sw_pass(q, ql, ref, rl, term)["score"],
                              np.int32)
        want = _np(sw_pass(q, ql, ref, rl, term, **kw))
    with jax.default_device(gpu):
        got = _np(sw_pass_cuda(q, ql, ref, rl, term, **kw))
    _assert_fields(got, want, fields=tuple(want))
