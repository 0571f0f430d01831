"""ntsm_tpu — sample-swap detection on a GPU, written in JAX.

A from-scratch reimplementation of the capabilities of ntsm (Nucleotide
Sequence/Sample Matcher, JustinChu/ntsm v1.2.1) for an accelerator:

* k-mer counting (``ntsm count``) runs as a JAX/XLA pipeline over
  batched, 2-bit-encoded reads with a device-resident static hash table and
  data-parallel sharding over a device mesh (reference: src/FingerPrint.hpp).
* sample comparison (``ntsm eval``) is dense linear algebra: genotype one-hot
  matmuls for relatedness/IBS tallies and a blocked pairwise pass
  for the log-likelihood score (reference: src/CompareCounts.hpp).
* PCA projection + candidate pre-filter replace the reference's nanoflann
  kd-tree with a batched distance computation (reference: src/KDTreeUtil.h).
* ``ntsm vcf`` and ``ntsm sitegen`` cover synthetic count generation and
  offline site-set construction (reference: src/VCFConvert.hpp, ntsm-scripts/).

Output files (counts.txt, summary.tsv) are byte-compatible with the
reference implementation.
"""

import jax as _jax

# The k-mer space is 2k bits (k <= 32): the rolling encoder and the
# invertible hash64 (reference: vendor/KseqHashIterator.hpp:129-139) need
# uint64 arithmetic, which JAX only exposes with x64 enabled; all hot-path
# floating point stays explicitly f32.
_jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: with it a repeat CLI invocation skips
# compiling the counting and eval programs.  JAX_COMPILATION_CACHE_DIR (read
# by JAX itself) or NTSM_NO_COMPILE_CACHE=1 overrides the default location
# inside the checkout (utils/machine.py compile_cache_dir).
from ntsm_tpu.utils.machine import enable_compile_cache as _enable_cache  # noqa: E402

_enable_cache()

__version__ = "0.1.0"

from ntsm_tpu.options import Options  # noqa: E402,F401
