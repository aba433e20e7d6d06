"""Reference-guided speculative decoding (draft-model-free).

Copy of ``vnsum_tpu/spec/__init__.py``. The package splits along the
draft/verify seam:

- :mod:`drafter` — n-gram suffix matching against the request's source
  document proposes up to ``k`` continuation tokens per row (torch for the
  engine's device path, numpy for host callers);
- the batched verify step lives in ``backend/engine.py`` (it is a decode
  variant of TorchBackend, entangled with its cache/bucketing machinery);
  the multi-position attention it needs is ``models.llama`` (dense) and
  ``ops.verify_attention.flash_spec_verify_attention`` (the K3 kernel);
- :class:`SpecRecord` is the per-prompt accounting unit
  (``TorchBackend.take_spec_report``).

Enabled per call via ``GenerationConfig(spec_k=K)`` plus per-prompt
``references`` on ``backend.generate``; ``spec_k=0`` (the default) leaves
every existing path untouched.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from .drafter import (  # noqa: F401
    NO_TOKEN,
    encode_references,
    history_tail,
    propose_drafts,
    propose_drafts_host,
)


@dataclass
class SpecRecord:
    """Per-prompt speculative-decoding accounting for ONE generate call.

    ``draft_tokens`` counts tokens proposed by the drafter and fed to
    verification; ``accepted_tokens`` counts those the model kept (emitted);
    ``verify_steps`` counts batched verify forwards the row was live for.
    Mean emitted-per-step is ``(accepted_tokens + verify_steps) /
    verify_steps`` — every step retires at least the model's own token."""

    draft_tokens: int = 0
    accepted_tokens: int = 0
    verify_steps: int = 0

    @property
    def acceptance_rate(self) -> float:
        return (
            self.accepted_tokens / self.draft_tokens if self.draft_tokens else 0.0
        )

    @property
    def tokens_per_step(self) -> float:
        if not self.verify_steps:
            return 0.0
        return (self.accepted_tokens + self.verify_steps) / self.verify_steps

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["acceptance_rate"] = round(self.acceptance_rate, 6)
        d["tokens_per_step"] = round(self.tokens_per_step, 6)
        return d


__all__ = [
    "NO_TOKEN",
    "SpecRecord",
    "encode_references",
    "history_tail",
    "propose_drafts",
    "propose_drafts_host",
]
