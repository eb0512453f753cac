"""Compile-on-demand builds of the native substrate.

Two shared libraries are built from the committed sources the first time
they are needed, with no external build system (the reference used a
7-line Makefile: src/Makefile:1-7):

  * libsapling_native — the host C++ (csrc/*.cpp), built with g++;
  * libsapling_cuda — the CUDA kernels (cuda/*.cu) for Hopper (sm_90a),
    built with nvcc against JAX's FFI headers.

Outputs go to native/_build/ (gitignored), named by a key over the
sources, the compiler's identity and the flags, so an edit or another
toolchain triggers a rebuild. No flag tunes for the build host's CPU, so
a library built on one machine runs on any x86-64 machine.

To build ahead of first use: `python -m sapling_tpu.native.build`
(add `cuda` for the GPU library).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(__file__)
_CSRC = os.path.join(_HERE, "csrc")
_CUDA_SRC = os.path.join(_HERE, "cuda")
BUILD_DIR = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_CACHE: dict[str, str] = {}

_CXX = os.environ.get("CXX", "g++")
# SAPLING_NATIVE_DEBUG=1 switches to a sanitized debug build (ASan +
# UBSan, -O1, frame pointers) — the reference ships no sanitizer config
# at all (src/Makefile:2 has only -g -Wall). The build is keyed on the
# flag set, so debug and release .so files never collide; note an ASan .so
# only loads into a process started with LD_PRELOAD=libasan.
if os.environ.get("SAPLING_NATIVE_DEBUG"):
    _FLAGS = ["-O1", "-g", "-std=c++17", "-fPIC", "-shared",
              "-fsanitize=address,undefined", "-fno-omit-frame-pointer"]
else:
    _FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-funroll-loops"]

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _sources(directory: str, exts: tuple[str, ...]) -> list[str]:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if f.endswith(exts))


def _compiler_id(cmd: str) -> str:
    try:
        res = subprocess.run([cmd, "--version"], check=True,
                             capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"compiler {cmd!r} not usable: {e}") from e
    return res.stdout.strip()


def _key(compiler: str, flags: list[str], paths: list[str]) -> str:
    h = hashlib.sha256()
    h.update(_compiler_id(compiler).encode())
    h.update(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(name: str, compiler: str, flags: list[str],
           srcs: list[str], deps: list[str]) -> str:
    """Compile srcs into BUILD_DIR/<name>-<key>.so unless it exists;
    returns the path. A failed build raises."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        out = os.path.join(BUILD_DIR,
                           f"{name}-{_key(compiler, flags, deps)}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = out + f".tmp{os.getpid()}"
            cmd = [compiler, *flags, "-o", tmp, *srcs]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    f"native build failed:\n{' '.join(cmd)}\n{e.stderr}"
                ) from e
            os.replace(tmp, out)
            for f in os.listdir(BUILD_DIR):  # tidy stale builds
                if (f.startswith(name + "-") and f.endswith(".so")
                        and f != os.path.basename(out)):
                    try:
                        os.remove(os.path.join(BUILD_DIR, f))
                    except OSError:
                        pass
        _CACHE[name] = out
        return out


def build_native(name: str = "libsapling_native") -> str:
    """Build (or reuse) the host C++ library; returns its path."""
    deps = _sources(_CSRC, (".cpp", ".cc", ".h", ".hpp"))
    srcs = [p for p in deps if p.endswith((".cpp", ".cc"))]
    return _build(name, _CXX, _FLAGS, srcs, deps)


def _nvcc() -> str:
    env = os.environ.get("NVCC")
    if env:
        return env
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME) — the "
                           "GPU Smith-Waterman kernel cannot be built")
    return found


def build_cuda(name: str = "libsapling_cuda") -> str:
    """Build (or reuse) the CUDA kernel library; returns its path."""
    import jax.ffi

    deps = _sources(_CUDA_SRC, (".cu", ".cuh", ".h"))
    srcs = [p for p in deps if p.endswith(".cu")]
    flags = [*_NVCC_FLAGS, "-I", jax.ffi.include_dir()]
    return _build(name, _nvcc(), flags, srcs, deps)


if __name__ == "__main__":
    import sys

    print(build_native())
    if "cuda" in sys.argv[1:]:
        print(build_cuda())
