"""In-flight batching: a persistent slot-based decode loop with refill.

Counterpart of ``vnsum_tpu/backend/inflight.py`` (``TpuSlotLoop``):

- a long-lived fixed-shape batch of B *slots*;
- per-slot state (step counter ``t``, done flag, RNG uid, output cursor) is
  slot-indexed, so rows at different generation depths coexist
  (``TorchBackend._slot_segment``'s per-row steps, attention through K3);
- at every segment boundary finished rows are harvested, and freed slots
  are REFILLED from waiting prompts: joiners are prefilled (resumed from
  the radix prefix cache when the backend has one) into a small join
  batch, then ``TorchBackend._adopt`` scatters their cache rows and state
  into the resident batch, and they decode with the residents.

Greedy per-request outputs are identical to the one-shot path's. Sampled
streams key on (loop seed, request uid, row-local step), so a request's
randomness does not depend on its slot, its join segment or its companions.

The loop is driven from ONE thread; nothing here locks. With a trace
collector installed (``obs/trace.py``) each join emits a ``prefill`` span
and each dispatch a ``decode_seg`` span, both ending at syncs the loop
already pays. ``admit`` and ``step`` fire the JAX loop's fault sites
(``engine.slot_admit``, ``engine.slot_step``, with the same ``prompts=``
payloads) and run their device work under the transfer guard
(``analysis/sanitizers.py``), where the join's TTFT read is an acknowledged
``device_get`` and the boundary fetch lands in pinned buffers with
non-blocking copies.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..analysis.sanitizers import device_get, hot_path_transfer_guard
from ..obs.trace import current_collector, emit
from ..testing.faults import fault
from .base import left_pad_batch


@dataclass
class SlotAdmission:
    """One request's admission into the loop. ``prefill_end`` is the host
    time its join group's prefill finished on the device (the TTFT anchor)."""

    key: object
    slot: int
    admitted_at: float          # time.monotonic() at admit entry
    prefill_end: float          # time.monotonic() after the prefill sync
    prompt_tokens: int = 0
    cached_tokens: int = 0      # prompt tokens resumed from the prefix cache
    occupancy: int = 0          # busy slots right after this admit


@dataclass
class SlotCompletion:
    """One finished request harvested at a segment boundary."""

    key: object
    text: str
    slot: int
    gen_tokens: int = 0


@dataclass
class SegmentResult:
    """One decode dispatch's outcome (up to ``fused_segments`` segment
    boundaries per dispatch; N=1 is the one-segment step)."""

    completions: list = field(default_factory=list)
    live: int = 0               # rows live at dispatch start
    new_tokens: int = 0         # tokens retired across all rows this dispatch
    seconds: float = 0.0
    device_segments: int = 1    # segments the fused dispatch actually ran


@dataclass
class SlotEviction:
    """One request preempted out of its decode slot. ``pin`` is a
    ``(cache, match)`` pair the loop took on the request's prompt prefix at
    eviction: the blocks stay pinned against LRU until the caller releases
    them (``cache.release(match)``), so a restarted prefill resumes warm.
    None when the backend has no prefix cache or ``evict(pin=False)``."""

    key: object
    slot: int
    pin: object = None


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class TorchSlotLoop:
    """Slot bookkeeping and program driving for TorchBackend's in-flight
    loop. Built by ``TorchBackend.start_slot_loop``."""

    def __init__(self, backend, slots: int, S: int, max_new: int, gen,
                 seed: int, fused_segments: int = 1) -> None:
        from ..models.llama import init_kv_cache

        self.backend = backend
        self.slots = int(slots)
        self.S = int(S)
        self.max_new = int(max_new)
        self.gen = gen
        self.seed = seed
        # one dispatch covers up to N segment boundaries
        self.fused_segments = max(int(fused_segments), 1)
        b = backend
        B = self.slots
        dev = b.device
        # resident device state: every slot starts FREE (all-pad, done)
        self._st = {
            "cache": init_kv_cache(b.cfg, B, S + max_new, quantized=b.quantize_kv, device=dev),
            "cur": torch.zeros((B,), dtype=torch.long, device=dev),
            "done": torch.ones((B,), dtype=torch.bool, device=dev),
            "t": torch.zeros((B,), dtype=torch.long, device=dev),
            "out": torch.full((B, max_new), b.tok.pad_id, dtype=torch.long, device=dev),
            "pads": torch.full((B,), S, dtype=torch.int32, device=dev),
        }
        # host-side slot table: caller key per busy slot (None = free), its
        # prompt (an eviction pins the prompt's cached prefix), per-request
        # RNG uid, last fetched per-row t
        self._keys: list = [None] * B
        self._prompts: list[str | None] = [None] * B
        self._uids: list[int] = [0] * B
        self._admissions: dict[int, SlotAdmission] = {}
        self._t_host = np.zeros((B,), np.int64)
        self._uid_next = 0
        self.segments = 0           # segments retired
        self.fused_dispatches = 0   # host dispatches (== segments at N=1)
        self.refills = 0
        self.decode_steps = 0       # decoder forwards the segments ran
        # boundary out-buffer snapshot: partial_outputs serves from it
        # instead of paying a second device-to-host copy per boundary
        self._out_snap = None
        # pinned host buffers the boundary fetch lands in (on the card)
        self._host = None
        self._closed = False

    # -- introspection ---------------------------------------------------

    @property
    def active(self) -> int:
        return sum(1 for k in self._keys if k is not None)

    @property
    def free(self) -> int:
        return self.slots - self.active

    # -- admission (prefill + adopt) -------------------------------------

    # hot path
    def admit(self, items) -> tuple[list[SlotAdmission], list]:
        """Admit up to the free-slot budget from ``items`` (an iterable of
        ``(key, prompt, cache_hint)``). Returns (admissions, rejected_keys):
        rejected keys had prompts longer than the loop's S budget and must
        go through the one-shot path; items beyond the admitted count are
        not consumed (the caller retries at the next boundary). The join
        group buckets to a power of two capped at the free-slot count, so
        every scatter target, all-pad filler rows included, is a distinct
        free slot. With the backend's prefix cache on, the join group is
        ordered by uncovered suffix, its prefill resumes from the matched
        blocks, and its new prefix blocks (bounded by each cache_hint) are
        inserted before the adopt."""
        if self._closed:
            raise RuntimeError("slot loop is closed")
        b = self.backend
        t_admit = time.monotonic()
        tracing = current_collector() is not None
        items = list(items)
        if not items or not self.free:
            return [], []
        # seeded fault injection (testing/faults.py); a no-op unless a plan
        # is armed. A raise propagates before any chain is matched (below)
        fault("engine.slot_admit", prompts=[it[1] for it in items])
        keys = [it[0] for it in items]
        prompts = [it[1] for it in items]
        hints = [it[2] for it in items]
        encoded = b.tok.encode_batch(prompts, add_bos=True)
        rejected = [keys[i] for i in range(len(items)) if len(encoded[i]) > self.S]
        ok = [i for i in range(len(items)) if len(encoded[i]) <= self.S]
        if not ok:
            return [], rejected
        free_slots = [s for s, k in enumerate(self._keys) if k is None]
        n = min(len(ok), len(free_slots))
        Bj = 1
        while Bj < n:
            Bj *= 2
        if Bj > len(free_slots):
            # the bucket's filler rows need free slots too: shrink the admit
            # to the largest power of two that fits
            n = Bj = _pow2_floor(len(free_slots))
        take = ok[:n]

        pc = b.prefix_cache
        matches = None
        if pc is not None:
            matches = {i: pc.match(encoded[i], max_tokens=len(encoded[i]) - 1) for i in take}
            # order the join group by UNCOVERED suffix so its shared resume
            # boundary K is as deep as the coldest row allows (generate's
            # cache ordering)
            take.sort(key=lambda i: (len(encoded[i]) - matches[i].tokens, len(encoded[i])))
        try:
            group_ids = [encoded[i] for i in take]
            tokens, pad_lens = left_pad_batch(group_ids, Bj, self.S, b.tok.pad_id)
            resume = None
            if matches is not None:
                group_matches = [matches[i] for i in take]
                resume = b._prepare_resume(list(range(len(take))), group_ids, group_matches,
                                           pad_lens, Bj, self.S, self.max_new, tracing)
            uids = [self._uid_next + j for j in range(len(take))]
            self._uid_next += len(take)
            uids_row = uids + [0] * (Bj - len(take))
            t_pre = time.monotonic()
            with hot_path_transfer_guard(b.device):
                first, join_cache, join_pads, done0 = b._prefill_group(
                    tokens, pad_lens, self.S, self.S + self.max_new, self.gen, self.seed,
                    uids_row, resume and resume[:2],
                )
                if pc is not None:
                    # insertion reads the join cache's prefix slots before
                    # the adopt scatters it into the resident batch
                    b._cache_insert(join_cache, list(range(len(take))), group_ids,
                                    group_matches, [hints[i] for i in take], pad_lens, tracing)
                # the joiners' first token is their TTFT: bound the prefill
                # with the cheapest output so the anchor is honest
                # lint-allow[host-sync-in-hot-path]: sync makes the per-joiner TTFT anchor real, one [Bj] bool fetch per admit
                device_get(done0)
                prefill_end = time.monotonic()
                b._adopt(self._st, join_cache, first, done0, join_pads, free_slots[:Bj])
        finally:
            if matches is not None:
                for m in matches.values():
                    pc.release(m)
        # the adopt scatter rewrote out rows: any boundary snapshot is stale
        self._out_snap = None
        skipped = resume[2] if resume else [0] * len(take)
        admissions: list[SlotAdmission] = []
        occupancy = self.active + len(take)
        for j, i in enumerate(take):
            slot = free_slots[j]
            self._keys[slot] = keys[i]
            self._prompts[slot] = prompts[i]
            self._uids[slot] = uids[j]
            self._t_host[slot] = 0
            adm = SlotAdmission(
                key=keys[i], slot=slot, admitted_at=t_admit, prefill_end=prefill_end,
                prompt_tokens=len(encoded[i]), cached_tokens=int(skipped[j]),
                occupancy=occupancy,
            )
            self._admissions[slot] = adm
            admissions.append(adm)
        self.refills += len(take)
        st = b.stats
        st.batches += 1
        st.prompts += len(take)
        st.prompt_tokens += sum(len(g) for g in group_ids)
        st.by_bucket[(Bj, self.S)] = st.by_bucket.get((Bj, self.S), 0) + 1
        if pc is not None:
            hit = sum(skipped)
            st.cache_hit_tokens += hit
            st.cache_miss_tokens += sum(len(g) for g in group_ids) - hit
        if tracing:
            emit("prefill", t_pre, prefill_end - t_pre, B=Bj, S=self.S,
                 occupancy=len(take), synced=True)
        return admissions, rejected

    # -- one decode segment ----------------------------------------------

    def _retire(self, tensors) -> list[np.ndarray]:
        """The boundary fetch. On the card: non-blocking copies into pinned
        host buffers, then a CUDA event polled with a backing-off sleep, so
        the host never blocks inside the runtime while the device is still
        decoding; the copies have landed when the event has. On the CPU the
        tensors are already host memory."""
        if self.backend.device.type != "cuda":
            return [t.numpy().copy() for t in tensors]
        if self._host is None:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(self._host, tensors):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        spin = 0.0001
        while not ev.query():
            time.sleep(spin)
            spin = min(spin * 2, 0.005)
        return [h.numpy().copy() for h in self._host]

    # hot path
    def step(self) -> SegmentResult:
        """Advance every live slot by up to ``segment_tokens *
        fused_segments`` tokens in one dispatch (which stops early once
        every row is done), then harvest finished rows at the boundary with
        ONE coalesced done/t/out fetch. The out snapshot it leaves behind
        serves ``partial_outputs``."""
        if self._closed:
            raise RuntimeError("slot loop is closed")
        res = SegmentResult(live=self.active)
        if not res.live:
            return res
        fault("engine.slot_step", prompts=[p for p in self._prompts if p is not None])
        b = self.backend
        tracing = current_collector() is not None
        t0 = time.monotonic()
        self._out_snap = None
        st = self._st
        with hot_path_transfer_guard(b.device):
            self.decode_steps += b._slot_segment(
                st, self.S, self.max_new, self.gen, self.seed, self._uids,
                b.segment_tokens * self.fused_segments,
            )
            # ONE fetch for the whole boundary: done, t and out together,
            # non-blocking copies into pinned buffers behind a polled event
            done_h, t_h, out_h = self._retire((st["done"], st["t"], st["out"]))
        finished = [s for s, k in enumerate(self._keys) if k is not None and done_h[s]]
        res.seconds = time.monotonic() - t0
        deltas = [
            int(t_h[s]) - int(self._t_host[s])
            for s, k in enumerate(self._keys) if k is not None
        ]
        res.new_tokens = int(sum(deltas))
        # segment boundaries the dispatch crossed: the deepest row's
        # advance in segment_tokens units (early stops report fewer)
        res.device_segments = min(
            max(-(-max(deltas, default=0) // b.segment_tokens), 1), self.fused_segments
        )
        for s, k in enumerate(self._keys):
            if k is not None:
                self._t_host[s] = int(t_h[s])
        self._out_snap = out_h
        for s in finished:
            text = b._detok(out_h[s], tuple(self.gen.eos_ids))
            res.completions.append(SlotCompletion(
                key=self._keys[s], text=text, slot=s, gen_tokens=int(t_h[s]),
            ))
            self._keys[s] = None
            self._prompts[s] = None
            self._admissions.pop(s, None)
        self.segments += res.device_segments
        self.fused_dispatches += 1
        if tracing:
            emit("decode_seg", t0, res.seconds, B=self.slots, S=self.S, live=res.live,
                 refill=True, fused=res.device_segments)
        return res

    # -- preemption / streaming ------------------------------------------

    def evict(self, keys, pin: bool = True) -> list[SlotEviction]:
        """Free the slots of ``keys`` mid-decode (preemption, cancellation):
        their done flags flip on the device so the next segment skips them,
        and their host rows clear. With the backend's prefix cache on and
        ``pin`` True, each evictee's prompt prefix is matched and left
        PINNED (the returned ``SlotEviction.pin``), so its cached blocks
        survive LRU until the caller releases them; ``pin=False`` is the
        cancel path, which has no restart to keep warm. The evictee's decode
        state is dropped either way; a re-admit restarts it from its prompt
        (greedy restarts are identical)."""
        b = self.backend
        targets = {id(k) for k in keys}
        slots = [s for s, k in enumerate(self._keys) if k is not None and id(k) in targets]
        if not slots:
            return []
        self._st["done"][torch.tensor(slots, device=b.device)] = True
        out: list[SlotEviction] = []
        pc = b.prefix_cache if pin else None
        for s in slots:
            ev_pin = None
            if pc is not None:
                ids = b.tok.encode_batch([self._prompts[s]], add_bos=True)[0]
                ev_pin = (pc, pc.match(ids, max_tokens=len(ids) - 1))
            out.append(SlotEviction(key=self._keys[s], slot=s, pin=ev_pin))
            self._keys[s] = None
            self._prompts[s] = None
            self._admissions.pop(s, None)
        return out

    def partial_outputs(self, keys) -> dict:
        """Decoded-so-far text per resident key, keyed by ``id(key)`` (keys
        are arbitrary caller objects). Served from the boundary snapshot
        ``step`` left behind; rows are cut at their host-tracked cursor so
        unwritten tail slots never leak. The device fetch is the fallback
        for a poll between an admit and the next step."""
        targets = {id(k) for k in keys}
        rows = [s for s, k in enumerate(self._keys) if k is not None and id(k) in targets]
        if not rows:
            return {}
        out_h = self._out_snap
        if out_h is None:
            out_h = self._st["out"].cpu().numpy()
        eos = tuple(self.gen.eos_ids)
        return {
            id(self._keys[s]): self.backend._detok(out_h[s][: int(self._t_host[s])], eos)
            for s in rows
        }

    # -- lifecycle -------------------------------------------------------

    def outstanding(self) -> list:
        """Keys still resident (the caller drains before closing)."""
        return [k for k in self._keys if k is not None]

    def close(self) -> None:
        self._closed = True
        # drop the device state promptly: the resident cache is the big
        # tenant of device memory, and a replacement loop allocates its own
        self._st = None
        self._host = None
        self._out_snap = None
