"""Compile once, run anywhere: the kernel library as a durable artifact.

Counterpart of ``deeplearning4j_tpu/compile/``. The port's compile-time
cost is the ``nvcc`` build of ``csrc/`` into one shared library
(``ops/_build.py``), not XLA compilation. Two tiers:

- **Tier 1, the persistent cache** (``persistent.py``): a chosen,
  size-bounded directory of built libraries named by their source
  digest (``DL4J_TPU_COMPILE_CACHE_DIR``,
  ``DL4J_TPU_COMPILE_CACHE_MAX_BYTES``), with hit / miss / build-second
  accounting.
- **Tier 2, the AOT bundle** (``aot.py``): the built library carried in
  a checkpoint's ``artifacts`` map with one shape record a serving
  bucket, installed by ``ModelServer`` at ``start()`` / ``reload()``
  into the cache directory, so a server restarted from that checkpoint
  into an empty directory serves with no ``nvcc`` build. A stale,
  truncated or foreign artifact counts ``aot_fallback_total`` and the
  kernels build as without a bundle.
"""

from deeplearning4j_tpu_torch.compile.aot import (  # noqa: F401
    AotArtifactError,
    AotStepFunction,
    artifact_fingerprint,
    export_artifact,
    export_serving_bundle,
    install_serving_bundle,
    load_artifact,
    pack_artifact,
    peek_meta,
    unpack_artifact,
)
from deeplearning4j_tpu_torch.compile.persistent import (  # noqa: F401
    bound_cache_size,
    cache_stats,
    default_cache_dir,
    enable_persistent_cache,
    install_cache_accounting,
)
