"""The port's domain rule set. Importing this package registers every rule
with :mod:`vnsum_tpu_torch.analysis.core`; add a module here and import it
below to ship a new rule.

Against the JAX package's ten rules (``vnsum_tpu/analysis/rules/``):

- **copies**, their scope regexes pointed at ``vnsum_tpu_torch/``:
  ``guarded-by``, ``swallowed-exception``, ``unbounded-blocking-wait``,
  ``metric-label-cardinality``, ``metrics-doc`` (the same README table; the
  four ``vnsum_serve_mesh_*`` names the port lacks until ROADMAP A10 are its
  ``NOT_PORTED`` exemption) and ``durable-write``;
- **counterparts** of the two JAX-shaped rules: ``host-sync-in-hot-path``
  (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``np.asarray``,
  ``bool``/``int``/``float`` of a tensor expression, ``torch.cuda.synchronize``
  and the acknowledged ``device_get``/``device_sync`` in ``# hot path``
  functions) and ``device-pinning`` (``"cuda:0"``, ``torch.device("cuda",
  0)``, a bare ``.cuda()``, ``torch.cuda.set_device(0)`` in ``backend/``
  and ``cache/``);
- **exemptions**, with no counterpart: ``donation-safety`` (the port has no
  ``donate_argnums``: torch frees a buffer when its last reference goes,
  and the engine's in-place updates are explicit ``copy_``/``index_copy_``),
  ``jit-recompile-hazard`` (the port has no ``jax.jit``: nothing is traced,
  so a Python branch on a tensor is a host read, which
  ``host-sync-in-hot-path`` and the transfer guard catch; inside a captured
  CUDA graph CUDA itself refuses the sync), and ``core/jax_cache.py``'s
  lint surface (its counterpart is the kernel build cache of
  ``ops/kernels.py``, which has no annotations to check).
"""
from . import (  # noqa: F401
    device_pinning,
    durable,
    guarded_by,
    host_sync,
    label_cardinality,
    metrics_doc,
    swallowed,
    unbounded_wait,
)
