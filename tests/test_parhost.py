"""utils.parhost: forked workers before JAX starts, a serial loop after."""

import os
import subprocess
import sys

from sapling_tpu.utils import parhost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pid_of(span):
    return span, os.getpid(), parhost.ctx()["tag"]


def test_run_forked_uses_workers_before_jax_starts():
    # a fresh interpreter that never touches a device: the pool forks
    code = (
        "import os, sys; sys.path.insert(0, sys.argv[1])\n"
        "from tests.test_parhost import _pid_of\n"
        "from sapling_tpu.utils import parhost\n"
        "out = parhost.run_forked(_pid_of, parhost.spans_of(12, 1),\n"
        "                         {'tag': 7}, workers=3)\n"
        "assert sorted(s for s, _, _ in out) == parhost.spans_of(12, 1)\n"
        "assert all(t == 7 for _, _, t in out)\n"
        "assert os.getpid() not in {p for _, p, _ in out}\n"
        "print('forked', len({p for _, p, _ in out}))\n")
    res = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("forked")


def test_run_forked_is_serial_once_jax_started():
    import jax

    jax.devices()  # the backend (and its threads) now exist
    out = parhost.run_forked(_pid_of, parhost.spans_of(6, 1), {"tag": 3},
                             workers=3)
    assert [s for s, _, _ in out] == parhost.spans_of(6, 1)
    assert {p for _, p, _ in out} == {os.getpid()}
    assert all(t == 3 for _, _, t in out)
