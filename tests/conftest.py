"""Test harness config: run JAX on a virtual 8-device CPU mesh.

Multi-chip sharding is validated without a cluster via
xla_force_host_platform_device_count, per the framework's test strategy
(SURVEY.md §4: the reference has no test framework at all; we add real unit
tests plus CPU-simulated multi-device tests).

JAX_PLATFORMS defaults to cpu. Tests marked `gpu` need the card and skip
without one; on a GPU host run them with JAX_PLATFORMS=cuda,cpu.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the CUDA kernels have no "
        "CPU or interpret mode); skips elsewhere")
