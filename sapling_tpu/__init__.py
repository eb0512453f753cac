"""sapling-tpu: a learned suffix-array query framework in JAX.

Built from scratch in JAX/XLA with the capabilities of mkirsche/sapling (a
piecewise-linear learned index over a genome suffix array plus a
seed-and-extend aligner), redesigned as batched array programs over
device-resident index arrays and scaled data-parallel over device meshes.
"""

import jax as _jax

from .utils.compile_cache import use_compile_cache as _use_compile_cache

# The engine needs real int64 on device: k-mer values are 2k-bit (42 bits at
# k=21) and the exact rational PWL prediction works in int64 (see
# ops/predict.py). Explicit dtypes are used everywhere else, so enabling x64
# does not change the int32 hot-path arrays.
_jax.config.update("jax_enable_x64", True)
_use_compile_cache()

from .config import AlignerConfig, IndexConfig, QueryConfig, SaplingConfig
from .index.sapling import SaplingIndex
from .io.fasta import Genome, read_fasta

__version__ = "0.1.0"

__all__ = [
    "AlignerConfig",
    "Genome",
    "IndexConfig",
    "QueryConfig",
    "SaplingConfig",
    "SaplingIndex",
    "read_fasta",
    "__version__",
]
