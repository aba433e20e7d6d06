"""Deterministic fake backend for hermetic strategy, judge and serving tests.

Copy of ``vnsum_tpu/backend/fake.py``. Two modes:

- extractive (default): return the first ``summary_words`` words of the
  longest <content>-like region of the prompt, so collapse loops terminate
  the way real summarization does;
- scripted: pop canned responses in order (critique accept-paths, judge
  verdicts).

An optional latency model (``batch_overhead_s`` + ``per_token_s`` per
uncached prompt word, ``per_prompt_s`` a row, ``per_step_s`` a decode step
of the longest row, the per-row terms divided over ``dp_replicas``) makes a
generate() call sleep like a device dispatch: a fixed per-call cost plus a
much smaller marginal per-row cost, the economics that make micro-batching
win. It defaults off. ``batch_sizes`` records the prompt count of each
call, ``calls`` the prompts, ``references_seen`` and ``cache_hints_seen``
the per-prompt metadata.

Speculative decoding is mirrored synthetically: with ``config.spec_k`` (or
the constructor's ``spec_k``) > 0 each prompt gets a deterministic
SpecRecord at the ``spec_acceptance`` rate, retrievable once through
``take_spec_report()``, the contract TorchBackend exposes.

The prefix KV cache (``vnsum_tpu_torch.cache``) is mirrored the same way:
``prefix_cache_blocks > 0`` runs the port's radix index (cache/radix.py)
over whitespace words (block matching, ref-counted pins, LRU eviction) with
no device pool behind it. ``cache_hints`` bound insertion as in the
engine, hit counts flow through ``take_cache_report()``,
``cached_prefix_tokens()`` and ``prefix_cache_stats()``, and
``per_token_s`` bills only uncached words.

The serving hooks are mirrored too: ``start_slot_loop`` opens a
``FakeSlotLoop`` (the in-flight contract of ``backend/inflight.py``'s
``TorchSlotLoop``, with the prefix-cache pass at admission and a
per-segment latency model), ``set_cancel_poll`` / ``request_drain`` /
``reset_drain`` cut the simulated sleeps short, the seeded fault sites
(``testing/faults.py``: ``fake.dispatch``, ``fake.prefill``,
``fake.slot_admit``, ``fake.slot_step``) fire at the dispatch boundaries,
and the latency model emits the engine's ``prefill`` / ``decode`` /
``decode_seg`` spans when a trace collector is installed.
"""
from __future__ import annotations

import re
import time

from ..core.config import GenerationConfig
from ..obs.trace import current_collector, emit
from ..spec import SpecRecord
from ..testing.faults import fault
from ..text.tokenizer import whitespace_token_count

_BLOCK = re.compile(
    r"<(?:content|summary|docs|reference_content|critique)>\n?(.*?)\n?</(?:content|summary|docs|reference_content|critique)>",
    re.DOTALL,
)


class FakeBackend:
    name = "fake"

    def __init__(
        self,
        responses: list[str] | None = None,
        summary_words: int = 40,
        prefix: str = "",
        batch_overhead_s: float = 0.0,
        per_prompt_s: float = 0.0,
        per_token_s: float = 0.0,
        spec_k: int = 0,
        spec_acceptance: float = 0.5,
        prefix_cache_blocks: int = 0,
        cache_block_tokens: int = 8,
        segment_words: int = 8,
        segment_overhead_s: float = 0.0,
        per_slot_segment_s: float = 0.0,
        per_step_s: float = 0.0,
        dp_replicas: int = 1,
    ) -> None:
        self._responses = list(responses) if responses else None
        self.summary_words = summary_words
        self.prefix = prefix
        self.batch_overhead_s = batch_overhead_s
        self.per_prompt_s = per_prompt_s
        # per-UNCACHED-prompt-token prefill cost: the lever that makes
        # prefix-cache hits show up as TTFT/goodput improvement hermetically
        self.per_token_s = per_token_s
        # default spec_k applied when a call's config doesn't carry one —
        # mirrors TorchBackend's generation=GenerationConfig(spec_k=...)
        self.spec_k = spec_k
        self.spec_acceptance = spec_acceptance
        # synthetic prefix cache: the real radix index over whitespace
        # words, matching TorchBackend's hit/insert/evict dynamics without a
        # device pool (tokens here are words, consistent with count_tokens)
        self.prefix_index = None
        if prefix_cache_blocks:
            from ..cache.radix import RadixIndex

            self.prefix_index = RadixIndex(
                prefix_cache_blocks, cache_block_tokens
            )
        # in-flight slot loop latency model (start_slot_loop): each decode
        # segment advances live rows by ``segment_words`` words and sleeps
        # segment_overhead_s + per_slot_segment_s * live — the per-segment
        # analogue of the one-shot batch_overhead_s/per_prompt_s model
        self.segment_words = max(int(segment_words), 1)
        self.segment_overhead_s = segment_overhead_s
        self.per_slot_segment_s = per_slot_segment_s
        # per-DECODE-STEP cost, charged by BOTH paths: a one-shot batch
        # decodes until its LONGEST row finishes (per_step_s * max output
        # words — the ragged-tail convoy a real fixed batch pays), while the
        # slot loop pays only for the steps a segment actually runs. This
        # is the economics in-flight refill exploits, modeled symmetrically.
        self.per_step_s = per_step_s
        # data-parallel replica model (the sharded-serving bench,
        # the JAX package's sharded serving bench): per-ROW marginal costs
        # divide over replicas (rows spread across the data axis and run
        # concurrently) while per-dispatch overheads and per-STEP depth
        # costs don't — replication buys row throughput, not step latency.
        # 1 = single-chip, every existing test unchanged.
        self.dp_replicas = max(int(dp_replicas), 1)
        # degradation-ladder hook (serve/supervisor.py NO_CACHE_INSERT):
        # False stops prefix-index insertion while hits keep serving —
        # same contract as TorchBackend.set_prefix_cache_inserts
        self.cache_inserts_enabled = True
        self.calls: list[str] = []
        self.batch_sizes: list[int] = []
        self.references_seen: list[str | None] = []
        self.cache_hints_seen: list[str | None] = []
        self._spec_report: list[SpecRecord] = []
        self._cache_report: list[int] = []
        # cooperative cancel flag (serve/scheduler.py::_dispatch): polled at
        # the simulated segment boundaries of a one-shot dispatch; True
        # aborts the remaining decode sleep — the hermetic mirror of an
        # engine checking a cancel flag between decode segments. None = off
        # (every pre-cancellation caller unchanged)
        self._cancel_poll = None
        self.cancel_aborts = 0
        # drain-wins flag (serve/scheduler.py close -> request_drain): a
        # draining server must never wait out simulated device time — every
        # sleep here is pure simulation, so aborting it changes wall clock,
        # never outputs. Also cuts injected `latency` fault sleeps short
        self._draining = False

    def _one(self, prompt: str) -> str:
        if self._responses is not None:
            if not self._responses:
                raise RuntimeError("FakeBackend ran out of scripted responses")
            return self._responses.pop(0)
        blocks = _BLOCK.findall(prompt)
        source = max(blocks, key=len) if blocks else prompt
        words = source.split()
        return self.prefix + " ".join(words[: self.summary_words])

    def _cache_pass(
        self,
        prompts: list[str],
        cache_hints: list[str | None] | None,
    ) -> int:
        """Match then insert, mirroring the engine's per-call order: ALL
        prompts match up front (pinned), insertion follows — so duplicates
        within one call miss together, exactly like a shared engine batch.
        Returns total UNCACHED tokens for the latency model; fills
        _cache_report with per-prompt hit counts."""
        idx = self.prefix_index
        words_per = [p.split() for p in prompts]
        matches = [
            idx.match(w, max_tokens=len(w) - 1) for w in words_per
        ]
        # pins released on EVERY path: a fault firing mid-pass (the
        # fake.prefill injection site sits exactly here, while the matched
        # chains are pinned) must not leak refcounts — leaked pins would
        # make blocks uneviciable forever, the serving-stack analogue of a
        # KV-block leak on a crashed device batch
        try:
            fault("fake.prefill", prompts=prompts)
            if self.cache_inserts_enabled:
                for i, (w, m) in enumerate(zip(words_per, matches)):
                    hint = cache_hints[i] if cache_hints else None
                    if hint:
                        # mirror the engine's _hint_prefix_len: the hint
                        # bounds insertion only up to its true common prefix
                        # with the prompt — a hint the prompt doesn't start
                        # with caches nothing, instead of caching unique
                        # content by length
                        hw = hint.split()
                        upto = 0
                        while (
                            upto < min(len(hw), len(w)) and hw[upto] == w[upto]
                        ):
                            upto += 1
                    else:
                        upto = len(w) - 1
                    idx.insert(w, min(upto, len(w) - 1))
        finally:
            for m in matches:
                idx.release(m)
        self._cache_report = [m.tokens for m in matches]
        return sum(
            len(w) - m.tokens for w, m in zip(words_per, matches)
        )

    def generate(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        references: list[str | None] | None = None,
        cache_hints: list[str | None] | None = None,
    ) -> list[str]:
        # seeded fault injection (vnsum_tpu_torch.testing.faults): free when
        # disarmed; fires BEFORE call bookkeeping so a retried dispatch is
        # indistinguishable from a fresh one to the latency model
        fault("fake.dispatch", prompts=prompts)
        self.calls.extend(prompts)
        self.batch_sizes.append(len(prompts))
        self.references_seen.extend(
            references if references is not None else [None] * len(prompts)
        )
        self.cache_hints_seen.extend(
            cache_hints if cache_hints is not None else [None] * len(prompts)
        )
        if self.prefix_index is not None:
            uncached = self._cache_pass(prompts, cache_hints)
        else:
            uncached = sum(len(p.split()) for p in prompts)
            self._cache_report = []
        t0 = time.monotonic() if current_collector() is not None else 0.0
        outs_early = None
        rep = self.dp_replicas
        prefill_s = self.batch_overhead_s + self.per_token_s * -(-uncached // rep)
        decode_s = self.per_prompt_s * -(-len(prompts) // rep)
        if self.per_step_s:
            # the batch decodes until its LONGEST row finishes — every
            # rider pays the convoy (what in-flight refill avoids)
            outs_early = [self._one(p) for p in prompts]
            decode_s += self.per_step_s * max(
                (len(o.split()) for o in outs_early), default=0
            )
        if prefill_s or decode_s:
            self._sleep_cancellable(prefill_s + decode_s)
        # engine-telemetry contract mirror: the latency model's fixed
        # per-dispatch cost (plus the per-uncached-token prefill term) plays
        # the prefill phase and the marginal per-row cost plays decode, so
        # hermetic serving runs get the same prefill/decode structure (and
        # TTFT anchor) TorchBackend emits — emit() is a no-op unless the
        # scheduler installed a BatchTrace
        if t0:
            emit("prefill", t0, prefill_s, B=len(prompts))
            emit("decode", t0 + prefill_s, decode_s, B=len(prompts))
        outs = (
            outs_early if outs_early is not None
            else [self._one(p) for p in prompts]
        )
        k = config.spec_k if config is not None else self.spec_k
        self._spec_report = [
            self._synthetic_spec(k, references[i] if references else None, o)
            for i, o in enumerate(outs)
        ] if k > 0 else []
        return outs

    def _synthetic_spec(self, k: int, reference, out: str) -> SpecRecord:
        """Deterministic per-prompt stats: a row with a reference drafts k
        per step and keeps spec_acceptance of them; one with no reference
        drafts nothing (matching the real drafter's degradation)."""
        steps = max(len(out.split()), 1)
        drafted = k * steps if reference else 0
        return SpecRecord(
            draft_tokens=drafted,
            accepted_tokens=int(drafted * self.spec_acceptance),
            verify_steps=steps,
        )

    def set_cancel_poll(self, poll) -> None:
        """Arm (or clear, with None) the cooperative cancel flag the
        scheduler sets around a one-shot dispatch — the backend-optional
        hook checked at segment boundaries, same shape as
        take_spec_report's duck typing."""
        self._cancel_poll = poll

    def request_drain(self) -> None:
        """Graceful-shutdown hook (duck-typed; serve/scheduler.py close):
        abort in-flight and future simulated sleeps — including any armed
        `latency` fault-plan sleeps — so drain always beats fake device
        time. Outputs are unaffected; only the wall clock shrinks. Real
        backends simply don't expose this."""
        self._draining = True
        from ..testing.faults import interrupt_sleeps

        interrupt_sleeps()

    def reset_drain(self) -> None:
        """Undo request_drain (duck-typed; a NEW scheduler attaching to a
        reused backend calls this): drain is scoped to the server that
        drained, not to the backend's remaining lifetime — without the
        reset, every later sleep and armed latency/hang fault would
        pass through instantly and simulate nothing."""
        self._draining = False
        from ..testing.faults import reset_interrupts

        reset_interrupts()

    def _sleep_cancellable(self, seconds: float) -> bool:
        """The dispatch sleep, sliced at segment granularity: each slice is
        one simulated decode segment (``segment_words`` steps). An armed
        cancel poll returning True abandons the remainder — the whole batch
        was cancelled, so burning more simulated device time would only
        model waste — and a draining server (request_drain) aborts
        unconditionally: the sleep is simulation, and SIGTERM must win over
        it. Returns True when aborted."""
        # slice: segment-grained with a cancel poll armed (poll cadence is
        # the contract), coarse 50ms otherwise (drain responsiveness only)
        seg = (
            max(self.per_step_s * self.segment_words, 0.002)
            if self._cancel_poll is not None else 0.05
        )
        t_end = time.monotonic() + seconds
        while True:
            if self._draining:
                return True
            if self._cancel_poll is not None and self._cancel_poll():
                self.cancel_aborts += 1
                return True
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(seg, remaining))

    def take_spec_report(self) -> list[SpecRecord]:
        """Per-prompt SpecRecords of the LAST generate call (empty when
        speculation was off), cleared on read — the backend-optional hook
        the serving scheduler attributes acceptance metrics through."""
        report, self._spec_report = self._spec_report, []
        return report

    def take_cache_report(self) -> list[int]:
        """Per-prompt prefix-cache hit tokens of the LAST generate call
        (empty when the cache is off), cleared on read — the same
        attribution hook TorchBackend exposes."""
        report, self._cache_report = self._cache_report, []
        return report

    def set_prefix_cache_inserts(self, enabled: bool) -> None:
        """Degradation-ladder hook: gate prefix-index insertion (hits still
        serve). Engine-thread-only, like every other mutation here."""
        self.cache_inserts_enabled = bool(enabled)

    def cached_prefix_tokens(self, text: str, cache_hint: str | None = None) -> int:
        """Read-only probe in whitespace-word tokens (consistent with
        count_tokens) — the admission-discount hook."""
        if self.prefix_index is None:
            return 0
        words = text.split()
        return self.prefix_index.probe(words, max_tokens=len(words) - 1)

    def prefix_cache_stats(self) -> dict | None:
        if self.prefix_index is None:
            return None
        return self.prefix_index.stats_dict()

    def count_tokens(self, text: str) -> int:
        return whitespace_token_count(text)

    def count_tokens_batch(self, texts: list[str]) -> list[int]:
        return [whitespace_token_count(t) for t in texts]

    # -- in-flight slot loop (mirrors TorchBackend.start_slot_loop) ------

    def start_slot_loop(
        self,
        slots: int | None = None,
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        prompt_tokens: int = 0,
        fused_segments: int = 1,
    ) -> "FakeSlotLoop":
        """The in-flight batching contract, hermetically: admission runs the
        REAL radix prefix index (when configured) and sleeps the prefill
        model (batch_overhead_s + per_token_s * uncached words); each step()
        advances live rows by ``segment_words`` words of their deterministic
        extractive output and sleeps the segment model. ``prompt_tokens``
        bounds admitted prompts exactly like the engine's S bucket (0 =
        unlimited) so scheduler fallback paths are testable without a
        device. ``fused_segments`` mirrors TorchSlotLoop's fused multi-step
        decode: one step() covers up to N segments and charges
        ``segment_overhead_s`` ONCE per dispatch (per-step cost unchanged)
        — the dispatch-amortization economics the fused A/B measures."""
        max_new = max_new_tokens
        if max_new is None and config is not None:
            max_new = config.max_new_tokens
        return FakeSlotLoop(self, slots or 8, prompt_tokens, max_new,
                            fused_segments=fused_segments)


class FakeSlotLoop:
    """Slot-loop double over FakeBackend's latency + cache model; the
    admission/segment/harvest contract matches backend/inflight.TorchSlotLoop
    (shared record types), so serving tests and the hermetic bench exercise
    the same scheduler paths the real engine loop serves."""

    def __init__(self, backend: FakeBackend, slots: int, prompt_tokens: int,
                 max_new: int | None, fused_segments: int = 1) -> None:
        from .inflight import (
            SegmentResult,
            SlotAdmission,
            SlotCompletion,
            SlotEviction,
        )

        self._SegmentResult = SegmentResult
        self._SlotAdmission = SlotAdmission
        self._SlotCompletion = SlotCompletion
        self._SlotEviction = SlotEviction
        self.backend = backend
        self.slots = int(slots)
        self.S = int(prompt_tokens)  # 0 = unlimited
        self.max_new = max_new
        self._keys: list = [None] * self.slots
        self._words: list[list[str] | None] = [None] * self.slots
        self._prompts: list[str | None] = [None] * self.slots
        self._emitted: list[int] = [0] * self.slots
        self.fused_segments = max(int(fused_segments), 1)
        self.segments = 0           # inner segments retired (device cadence)
        self.fused_dispatches = 0   # step() calls that did work
        self.refills = 0
        self._closed = False

    @property
    def active(self) -> int:
        return sum(1 for k in self._keys if k is not None)

    @property
    def free(self) -> int:
        return self.slots - self.active

    def admit(self, items):
        if self._closed:
            raise RuntimeError("slot loop is closed")
        b = self.backend
        t_admit = time.monotonic()
        items = list(items)
        if not items or not self.free:
            return [], []
        fault("fake.slot_admit", prompts=[p for _k, p, _h in items])
        rejected = [
            k for k, p, _h in items
            if self.S and len(p.split()) > self.S
        ]
        ok = [(k, p, h) for k, p, h in items
              if not (self.S and len(p.split()) > self.S)]
        take = ok[: self.free]
        if not take:
            return [], rejected
        prompts = [p for _k, p, _h in take]
        hints = [h for _k, _p, h in take]
        if b.prefix_index is not None:
            uncached = b._cache_pass(prompts, hints)
            report = b._cache_report
            b._cache_report = []
        else:
            uncached = sum(len(p.split()) for p in prompts)
            report = [0] * len(take)
        prefill_s = (
            b.batch_overhead_s
            + b.per_token_s * -(-uncached // b.dp_replicas)
        )
        if prefill_s:
            time.sleep(prefill_s)
        prefill_end = time.monotonic()
        emit("prefill", t_admit, prefill_end - t_admit, B=len(take))
        free_slots = [s for s, k in enumerate(self._keys) if k is None]
        admissions = []
        occupancy = self.active + len(take)
        for j, (key, prompt, _hint) in enumerate(take):
            slot = free_slots[j]
            words = b._one(prompt).split()
            if self.max_new is not None:
                words = words[: self.max_new]
            self._keys[slot] = key
            self._words[slot] = words
            self._prompts[slot] = prompt
            self._emitted[slot] = 0
            admissions.append(self._SlotAdmission(
                key=key, slot=slot, admitted_at=t_admit,
                prefill_end=prefill_end,
                prompt_tokens=len(prompt.split()),
                cached_tokens=int(report[j]),
                occupancy=occupancy,
            ))
        self.refills += len(take)
        b.batch_sizes.append(len(take))
        b.calls.extend(prompts)
        return admissions, rejected

    def step(self):
        """One FUSED dispatch: up to ``fused_segments`` inner segments with
        the on-device early stop mirrored (a window whose rows all finish
        stops advancing), harvest at dispatch retirement only. The latency
        model charges ``segment_overhead_s`` ONCE per dispatch — that is
        the dispatch/sync tax fusing amortizes — while per-slot-segment and
        per-step costs accrue for the work actually run, so the fused A/B
        is honest hermetically."""
        if self._closed:
            raise RuntimeError("slot loop is closed")
        res = self._SegmentResult(live=self.active)
        if not res.live:
            return res
        # resident prompts ride the poison matcher: a poison RESIDENT
        # crashes segments, not just its own admission
        fault("fake.slot_step", prompts=[
            p for p in self._prompts if p is not None
        ])
        b = self.backend
        t0 = time.monotonic()
        steps = 0
        segments_run = 0
        slot_segment_units = 0  # sum over inner segments of ceil(live/rep)
        for _ in range(self.fused_segments):
            live_rows = [
                s for s, k in enumerate(self._keys)
                if k is not None and self._emitted[s] < len(self._words[s])
            ]
            if not live_rows:
                break  # the on-device all-rows-done stop
            seg_steps = 0
            for s in live_rows:
                words = self._words[s]
                advance = min(b.segment_words, len(words) - self._emitted[s])
                seg_steps = max(seg_steps, advance)
                self._emitted[s] += advance
                res.new_tokens += advance
            steps += seg_steps
            segments_run += 1
            slot_segment_units += -(-len(live_rows) // b.dp_replicas)
        res.device_segments = max(segments_run, 1)
        seg_s = (
            # ONE dispatch overhead per fused window — the host round-trip
            # cost fusing exists to amortize
            b.segment_overhead_s
            # live rows spread over DP replicas, per inner segment actually
            # run; segment depth doesn't
            + b.per_slot_segment_s * slot_segment_units
            + b.per_step_s * steps
        )
        if seg_s:
            time.sleep(seg_s)
        for s, k in enumerate(self._keys):
            if k is None:
                continue
            words = self._words[s]
            if self._emitted[s] >= len(words):
                res.completions.append(self._SlotCompletion(
                    key=k, text=" ".join(words), slot=s,
                    gen_tokens=len(words),
                ))
                self._keys[s] = None
                self._words[s] = None
                self._prompts[s] = None
        self.segments += res.device_segments
        self.fused_dispatches += 1
        res.seconds = time.monotonic() - t0
        emit("decode_seg", t0, res.seconds, live=res.live, refill=True,
             fused=res.device_segments)
        return res

    def evict(self, keys, pin: bool = True):
        """Preemption/cancellation double (mirrors TorchSlotLoop.evict): free
        the slots, drop decode progress, and — with the synthetic radix
        index on and ``pin`` True — return each evictee's prompt prefix
        PINNED so the requeue's admission finds it warm and unevicted.
        ``pin=False`` is the cancel path: terminal, nothing to keep warm."""
        b = self.backend
        targets = {id(k) for k in keys}
        out = []
        for s, k in enumerate(self._keys):
            if k is None or id(k) not in targets:
                continue
            ev_pin = None
            if pin and b.prefix_index is not None:
                words = self._prompts[s].split()
                m = b.prefix_index.match(words, max_tokens=len(words) - 1)
                ev_pin = (b.prefix_index, m)
            out.append(self._SlotEviction(key=k, slot=s, pin=ev_pin))
            self._keys[s] = None
            self._words[s] = None
            self._prompts[s] = None
            self._emitted[s] = 0
        return out

    def partial_outputs(self, keys) -> dict:
        """Decoded-so-far text per resident key, keyed by ``id(key)`` —
        keys are arbitrary caller objects, not necessarily hashable
        (mirrors TorchSlotLoop.partial_outputs)."""
        targets = {id(k) for k in keys}
        return {
            id(k): " ".join(self._words[s][: self._emitted[s]])
            for s, k in enumerate(self._keys)
            if k is not None and id(k) in targets
        }

    def outstanding(self) -> list:
        return [k for k in self._keys if k is not None]

    def close(self) -> None:
        self._closed = True
