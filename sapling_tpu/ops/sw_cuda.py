"""The Smith-Waterman scoring pass as a CUDA kernel for Hopper GPUs.

Same arguments, results and semantics as ops.sw.sw_pass, bit for bit. The
kernel (native/cuda/sw_warp.cu) gives each candidate one warp and keeps
the DP state in registers for the whole column sweep, where the lax.scan
lowering of sw_pass sends the [B, W] H/E state through device memory at
every reference column. It is reached through jax.ffi and has no CPU or
interpret mode: tests/test_sw_cuda.py checks it on the card, and the CPU
tests cover the wrapper's padding here.

The library is built with nvcc from the committed sources on first use
(native/build.py:build_cuda); a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np

_TARGET = "sapling_sw_pass"
_FIELDS = ("score", "ref_end", "read_end", "score2", "ref_end2")
MAX_ROWS_PER_LANE = 32  # the kernel's largest K: query width <= 1024


@functools.lru_cache(maxsize=1)
def _register() -> None:
    from ..native.build import build_cuda

    lib = ctypes.CDLL(build_cuda())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.SaplingSwPass), platform="CUDA")


def rows_per_lane(w: int) -> int:
    """Query rows each of a warp's 32 lanes holds: the smallest power of
    two K with 32*K >= w (the kernel is instantiated for K = 1..32)."""
    k = 1
    while 32 * k < w:
        k *= 2
    if k > MAX_ROWS_PER_LANE:
        raise ValueError(f"query width {w} exceeds the kernel's "
                         f"{32 * MAX_ROWS_PER_LANE} rows")
    return k


@functools.partial(
    jax.jit,
    static_argnames=("match", "mismatch", "gap_open", "gap_extend",
                     "mask_len", "pad_to", "second_inclusive",
                     "score_only"),
)
def sw_pass_cuda(
    query, qlen, ref, rlen, terminate,
    *, match: int = 2, mismatch: int = 2, gap_open: int = 3,
    gap_extend: int = 1, mask_len: int = 15, pad_to: int = 16,
    second_inclusive: bool = False, score_only: bool = False,
):
    """Drop-in CUDA equivalent of ops.sw.sw_pass (same args/returns)."""
    if gap_open < gap_extend:
        raise ValueError("decayed-max F factorization requires gapO >= gapE")
    _register()
    b, w = query.shape
    # sw_pass pads the query to whole SSE pad blocks; those rows take part
    # in the DP. The kernel's lanes hold 32*K rows; rows past w_rows stay
    # dead inside the kernel.
    w_rows = -(-w // pad_to) * pad_to
    wk = 32 * rows_per_lane(w_rows)
    q = jnp.pad(query.astype(jnp.int8), ((0, 0), (0, wk - w)))
    nf = 1 if score_only else len(_FIELDS)
    out = jax.ffi.ffi_call(
        _TARGET, jax.ShapeDtypeStruct((nf, b), jnp.int32),
        vmap_method="broadcast_all",
    )(q, ref.astype(jnp.int8), qlen.astype(jnp.int32),
      rlen.astype(jnp.int32), terminate.astype(jnp.int32),
      w_rows=np.int32(w_rows), match=np.int32(match),
      mismatch=np.int32(mismatch), gap_open=np.int32(gap_open),
      gap_extend=np.int32(gap_extend), mask_len=np.int32(mask_len),
      pad_to=np.int32(pad_to), second_inclusive=np.int32(second_inclusive),
      score_only=np.int32(score_only))
    if score_only:
        return {"score": out[0]}
    return {k: out[i] for i, k in enumerate(_FIELDS)}
