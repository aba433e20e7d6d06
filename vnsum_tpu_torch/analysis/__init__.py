"""Domain static analysis + runtime sanitizers for the port.

Counterpart of ``vnsum_tpu/analysis``:

- :mod:`core` — the AST lint framework (a copy): rule registry, per-file
  source model (AST + comment map), ``# lint-allow[rule]: reason``
  suppressions (a reason is mandatory), human + JSON output, and the
  ``python -m vnsum_tpu_torch.analysis`` CLI (:mod:`__main__`; default
  path ``vnsum_tpu_torch``, exit 0 clean, 1 on findings, 2 on a bad path
  or rule);
- :mod:`rules` — six copies of the JAX rules, the torch counterparts of
  ``host-sync-in-hot-path`` and ``device-pinning``, and the recorded
  exemptions (its docstring);
- :mod:`sanitizers` — runtime detectors switchable via ``VNSUM_SANITIZERS``:
  the lock-order detector wrapping the serve/obs locks and the hot-loop
  transfer guard over CUDA's sync debug mode, with ``device_get`` /
  ``device_sync`` as the acknowledged syncs. Both are constructed away
  when disabled.

Lint annotations are conventions, not syntax: ``# guarded by: <lock>[, alt]``
on a ``self.field = ...`` line, ``# hot path`` on (or directly above) a
``def`` line, ``# durable`` above a crash-safe writer, and methods named
``*_locked`` are trusted to be called with the lock already held.
"""
from .core import Finding, Rule, all_rules, run_paths

__all__ = ["Finding", "Rule", "all_rules", "run_paths"]
