"""jn_cuclark_tpu — GPU-accelerated metagenomic classifier (CLARK family).

A from-scratch JAX/XLA re-design of the capabilities of
ardaicoz/jn_cuclark (CuCLARK + kent/kent-mpi): discriminative canonical k-mer
database construction, FASTA/FASTQ read classification with gamma/confidence
scoring, taxonomy-aware abundance estimation, multi-sample merge/report, and
multi-host sharded-database classification over a JAX device mesh.

The classifier needs 64-bit integer k-mer keys on device, so x64 mode is
enabled at import.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

#: Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is not set.
#: The path is fixed (part of the cache key), inside the checkout, and
#: listed in .gitignore.
DEFAULT_COMPILE_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)

from . import params  # noqa: E402,F401

__version__ = "0.1.0"
