"""Tracing / profiling / structured logging.

The reference's only instrumentation is wall-clock around the query loop
(reference: src/sapling_example.cpp:134-141) and cout progress lines. The
equivalents here:
  * device-fenced timers (block_until_ready before/after) so numbers mean
    device time, not dispatch time;
  * jax.profiler traces viewable in XProf/TensorBoard;
  * structured one-line JSON event logging.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time


@contextlib.contextmanager
def device_timer(name: str, sink=None, pending=None):
    """Fenced wall-clock timer: waits for `pending` (arrays) before
    starting and for the block's result via sink['result'] if set."""
    import jax

    if pending is not None:
        jax.block_until_ready(pending)
    t0 = time.perf_counter()
    out = {}
    yield out
    if "result" in out:
        jax.block_until_ready(out["result"])
    out["seconds"] = time.perf_counter() - t0
    log_event("timer", name=name, seconds=out["seconds"], **(sink or {}))


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace context (open in XProf / TensorBoard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def log_event(kind: str, stream=None, **fields):
    """One-line JSON structured log record."""
    rec = {"t": round(time.time(), 3), "kind": kind}
    rec.update(fields)
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)


def bench_fn(fn, *args, warmup: int = 1, iters: int = 3):
    """Time a jitted function: compile via warmup, then min over iters of
    fenced executions. Returns (seconds_min, result)."""
    import jax

    result = None
    for _ in range(max(warmup, 1)):
        result = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, result
