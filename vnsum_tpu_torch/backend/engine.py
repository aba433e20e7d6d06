"""TorchBackend — batched generation on one card.

Counterpart of the one-shot path of ``vnsum_tpu/backend/engine.py``
(``TpuBackend``). A list of prompts becomes length-bucketed, fixed-shape
left-padded [B, S] batches; each batch runs a whole or chunked prefill
through the decoder, then a greedy (or seeded sampled) decode loop with
per-row EOS masking and an early exit once every row is done.

The JAX program runs the decode as an on-device ``while_loop``; here a
host loop runs one decode step function (``_decode_step``) that reads and
writes only persistent device buffers, its step counter among them. On the
card, for greedy generation through the kernels, the loop runs it as a
captured CUDA graph (``backend/capture.py``): step 0 eagerly, then one
replay a step. ``cuda_graphs=False`` keeps every step eager (the control).
The all-done check reads the device only every ``DONE_CHECK_INTERVAL``
steps: the steps between a batch finishing and the next check emit pad for
every row, so outputs are identical to a check at every step.

With ``flash`` on, attention goes through the hand-written kernels
(``ops/flash_attention.py`` for prefill, ``ops/decode_attention.py`` for
decode, ``ops/verify_attention.py`` for the speculative verify step and the
slot segment) and the KV cache is int8 by default, as in the JAX engine. On
the CPU the kernel wrappers take their plain versions.

Two more paths run on the verify kernel:

- reference-guided speculative decoding: ``generate`` with
  ``GenerationConfig(spec_k=k)`` and per-prompt ``references`` drafts up to
  k tokens per row from the row's reference and verifies them in one
  forward over k + 1 positions (``_run_group_spec``);
- the in-flight slot loop (``start_slot_loop``, ``backend/inflight.py``):
  slots at different generation depths decode together, with per-row step
  counters, and freed slots are refilled from new prompts.

``score_choices`` is the constrained choice scorer of the G-Eval judge
(``eval/geval.py``): one prefill with no decode budget (C = S) through K1,
and the next-token logits of the last position gathered at the choices'
first ids, the argmax taken on the device.

``quantize=True`` runs int8 weights (``models/quant.py``): every
projection and the LM head of a forward with at most 128 rows (decode, the
verify forward, the slot segment, a ``last_only`` head) goes through the
int8-weight GEMV kernel (``ops/int8_matmul.py``), a prefill through a
dequantized ``torch.matmul``; ``quantize_act=True`` adds W8A8 prefill.

``cache_blocks > 0`` turns on the radix prefix KV cache (``cache/``, the
JAX engine's ``cache_blocks``): ``generate`` matches every prompt against
the radix index up front, orders its rows by uncovered suffix, gathers a
group's matched blocks into a fresh cache and resumes its prefill at a
shared boundary K (K1 at q_offset = K over the gathered slots), then
copies the group's new prefix blocks into the pool. ``cache_hints`` bound
that insertion to the hinted prefix. The slot loop's joins resume the same
way (``backend/inflight.py``); spec calls bypass the cache.

With a trace collector installed (``obs/trace.py``, the serving
scheduler's BatchTrace) ``generate`` and the slot loop emit the JAX
engine's spans (``tokenize``, ``cache_lookup``, ``cache_gather``,
``prefill``, ``decode_seg``, ``dispatch``, ``cache_insert``,
``detokenize``, ``spec_prefill``, ``spec_step``); each span that times
device work ends at a sync the path already pays, and with no collector
nothing is timed or read.

Not ported yet: the continuous scheduler and meshes.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..cache import PrefixCache
from ..core.config import GenerationConfig
from ..core.logging import get_logger
from ..models.llama import (
    LlamaConfig,
    LlamaModel,
    decode_attention_mask,
    init_kv_cache,
    init_model,
    layer_windows,
    llama32_3b,
    prefill_attention_mask,
    prefill_positions,
    verify_attention_mask,
    verify_positions,
)
from ..models.quant import quantize_model
from ..models.sampling import draft_acceptance_rows, row_seed, sample_logits_rows
from ..obs.trace import current_collector, emit
from ..ops.decode_attention import flash_decode_attention
from ..ops.flash_attention import B4, flash_prefill_attention, supports_flash, supports_verify
from ..ops.verify_attention import flash_spec_verify_attention
from ..spec import NO_TOKEN, SpecRecord, encode_references, propose_drafts
from ..text.tokenizer import Tokenizer, get_tokenizer
from .base import (
    fold_seed,
    left_pad_batch,
    mask_unsampleable,
    resolve_max_new,
    sampling_vocab,
    terminator_ids,
    trim_to_eos,
)
from .capture import (
    DONE_CHECK_INTERVAL,
    captures,
    decode_buffers,
    decode_loop,
    token_step,
)

logger = get_logger("vnsum.engine")

_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
# tokens encoded per speculation reference (matched, never attended: a
# longer reference only loses tail draft coverage)
_SPEC_MAX_REF_TOKENS = 4096


def _bucket_len(n: int, max_len: int) -> int:
    for b in _BUCKETS:
        if n <= b and b <= max_len:
            return b
    return max_len


def resolve_device(device) -> torch.device:
    """The engine's device; "cuda" with no card visible raises instead of
    carrying on on the CPU. A bare "cuda" resolves to the current card's
    index, the device tensors made there report."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA card is visible; pass "
            "device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def kernel_gates(head_dim: int, flash: bool, on_card: bool) -> tuple[bool, bool]:
    """(use_kernels, verify_missing): each path asks for the kernel it
    launches. The one-shot path's K1 and K2 take head_dim 128 and 256 on
    the card (head_dim 64 runs dense attention there, as in the JAX
    package), and so does the spec path's and the slot loop's K3. Where K1
    and K2 run and K3 does not take the head_dim, those two paths raise
    (ROADMAP B4) and never fall back; while the three take the same
    head_dims (today: 128 and 256), ``verify_missing`` is never set. The
    plain versions, the CPU's, take any head_dim."""
    use_kernels = flash and (supports_flash(head_dim) or not on_card)
    return use_kernels, use_kernels and on_card and not supports_verify(head_dim)


@dataclass
class EngineStats:
    """Wall-clock and token accounting for run records."""

    calls: int = 0
    prompts: int = 0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    generate_seconds: float = 0.0
    batches: int = 0
    # forwards through the decoder: one per prefill chunk, one per decode
    # step (one-shot decode and slot segments)
    prefill_forwards: int = 0
    decode_steps: int = 0
    # captured decode (backend/capture.py): CUDA graphs recorded, one per
    # captured group, and the decode steps that ran as their replays
    graph_captures: int = 0
    captured_steps: int = 0
    # speculative decoding: batched verify forwards run, draft tokens
    # proposed to them, and draft tokens the model kept. Every step also
    # retires one model-own token per live row
    spec_verify_steps: int = 0
    spec_draft_tokens: int = 0
    spec_accepted_tokens: int = 0
    # prefix KV cache: prompt tokens whose prefill was skipped by resuming
    # from cached prefix blocks, and tokens prefilled from scratch
    cache_hit_tokens: int = 0
    cache_miss_tokens: int = 0
    by_bucket: dict = field(default_factory=dict)
    # one-shot groups' decode steps per (B, S) bucket, for launch counts
    # per kernel shape
    steps_by_bucket: dict = field(default_factory=dict)
    # "prefill" / "decode" (and the prefix cache's "cache_gather" /
    # "cache_insert"): device time, bounded by a synchronize at each phase's
    # end; host phases ("tokenize_host", "pack_host") by wall clock
    phase_seconds: dict = field(default_factory=dict)

    def add_phase(self, name: str, seconds: float) -> None:
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + seconds

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if not k.endswith("by_bucket")}
        for k in ("by_bucket", "steps_by_bucket"):
            d[k] = {f"B={b},S={s}": n for (b, s), n in getattr(self, k).items()}
        return d


class TorchBackend:
    name = "torch"

    def __init__(
        self,
        model_config: LlamaConfig | None = None,
        tokenizer: str | Tokenizer = "byte",
        model: LlamaModel | None = None,
        batch_size: int = 8,
        max_new_tokens: int = 1024,
        generation: GenerationConfig | None = None,
        seed: int = 0,
        flash: str | bool = "auto",
        quantize: bool = False,
        quantize_act: bool = False,
        quantize_kv: str | bool = "auto",
        prefill_chunk_tokens: int = 0,
        segment_tokens: int = 128,
        cuda_graphs: str | bool = "auto",
        cache_blocks: int = 0,
        cache_block_tokens: int = 64,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = model.cfg if model is not None else (model_config or llama32_3b())
        if quantize_act:
            # W8A8 prefill (models/llama.py): s8 x s8 products on multi-token
            # forwards. Lossy (per-token activation rounding) and meaningless
            # without int8 weights
            if not quantize:
                raise ValueError(
                    "quantize_act (W8A8 prefill) requires quantize=True — "
                    "without int8 weights there is no s8xs8 matmul to run"
                )
            self.cfg = dataclasses.replace(self.cfg, w8a8_prefill=True)
        on_card = self.device.type == "cuda"
        # the kernels: on by default on the card; CPU callers pass
        # flash=True explicitly and get the kernels' plain versions
        if flash == "auto":
            flash = on_card
        self.flash = bool(flash)
        self.use_kernels, self.verify_missing = kernel_gates(
            self.cfg.head_dim, self.flash, on_card)
        # each layer's window for the kernels: 0 on global layers
        self.windows = layer_windows(self.cfg)
        if quantize_kv == "auto":
            quantize_kv = self.use_kernels
        elif quantize_kv and not self.use_kernels:
            raise ValueError(
                "quantize_kv=True needs the attention kernels (flash=True and, "
                "on the card, head_dim 128 or 256); the dense path "
                "would dequantize the whole cache per step"
            )
        self.quantize_kv = bool(quantize_kv)
        # captured greedy decode steps: on by default where they apply (the
        # card, through the kernels); True raises where they cannot
        self._graphs_required = cuda_graphs is True
        if cuda_graphs == "auto":
            cuda_graphs = on_card and self.use_kernels
        elif cuda_graphs and not (on_card and self.use_kernels):
            raise ValueError(
                "cuda_graphs=True needs a CUDA device and the attention kernels "
                "(flash on, head_dim 128 or 256)"
            )
        self.cuda_graphs = bool(cuda_graphs)
        self.tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.gen_cfg = generation or GenerationConfig()
        if max_new_tokens >= self.cfg.max_seq_len:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} must be < "
                f"max_seq_len={self.cfg.max_seq_len}"
            )
        if prefill_chunk_tokens < 0 or (
            prefill_chunk_tokens and prefill_chunk_tokens % 128
        ):
            raise ValueError(
                "prefill_chunk_tokens must be a non-negative multiple of 128"
            )
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        # decode steps per slot-loop segment (backend/inflight.py)
        self.segment_tokens = max(int(segment_tokens), 1)
        self._spec_report: list = []
        self.stats = EngineStats()
        self._seed = seed
        self._dispatch = 0
        if model is None:
            t0 = time.time()
            model = init_model(self.cfg, seed, self.device)
            logger.info("initialized random params in %.1fs", time.time() - t0)
        elif model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        # int8 weights before any CUDA graph is recorded, so the graphs hold
        # the int8 buffers; a model given already quantized is kept
        if quantize and not model.quantized:
            t0 = time.time()
            model = quantize_model(model, self.cfg)
            logger.info("int8-quantized params in %.1fs", time.time() - t0)
        elif model.cfg != self.cfg:
            model = LlamaModel(self.cfg, model.tree())
        self.model = model
        # radix prefix KV cache: cache_blocks > 0 keeps prefix KV blocks on
        # the device after prefill, and later groups resume prefill from
        # the matched prefix, computing only the suffix
        self.prefix_cache = None
        self._cache_report: list = []
        self._hint_ids_cache: dict[str, list[int]] = {}
        # False stops pool insertion and eviction churn while matched
        # prefixes keep serving hits
        self.cache_inserts_enabled = True
        if cache_blocks:
            if not 1 <= cache_block_tokens <= 128:
                # the resume boundary K is 128-aligned, and the padded-gather
                # safety argument (scratch writes land inside the recomputed
                # [K, S) span) needs blocks no wider than that alignment
                raise ValueError("cache_block_tokens must be in [1, 128]")
            self.prefix_cache = PrefixCache(
                cache_blocks, cache_block_tokens, n_layers=self.cfg.n_layers,
                n_kv_heads=self.cfg.n_kv_heads, head_dim=self.cfg.head_dim,
                dtype=self.cfg.dtype, quantized=self.quantize_kv, device=self.device,
            )
            logger.info(
                "prefix KV cache: %d blocks x %d tokens (%.1f MB)",
                cache_blocks, cache_block_tokens, self.prefix_cache.store.hbm_bytes / 1e6,
            )

    # -- pieces of one generation batch -----------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_seed(self, gen: GenerationConfig) -> int:
        s = fold_seed(gen.seed, self._seed, self._dispatch)
        self._dispatch += 1
        return s

    def _sampling_setup(self, gen: GenerationConfig):
        """(eos ids tensor, vocab limit, restrict fn): never sample a token
        the tokenizer cannot render, but keep every terminator sampleable."""
        terminators = terminator_ids(self.tok, gen)
        eos = torch.tensor(terminators, dtype=torch.long, device=self.device)
        vocab_limit, allowed = sampling_vocab(
            self.tok, self.cfg.vocab_size, terminators
        )
        allowed_dev = None if allowed is None else torch.from_numpy(allowed).to(self.device)

        def restrict(row_logits):  # [B, vocab_limit]
            return mask_unsampleable(row_logits, allowed_dev)

        return eos, vocab_limit, restrict

    def _sample(self, logits, seed: int, uids, step: int, gen, vocab_limit, restrict):
        seeds = [row_seed(seed, u, step) for u in uids] if gen.temperature > 0 else []
        return sample_logits_rows(
            restrict(logits[:, -1, :vocab_limit]), seeds,
            gen.temperature, gen.top_k, gen.top_p,
        )

    def _prefill_stacked(self, pad_lens, q_offset: int):
        """K1 for queries from cache slot ``q_offset``, at each layer's
        window; None on the dense path."""
        if not self.use_kernels:
            return None
        q_per_kv, windows = self.cfg.q_per_kv, self.windows

        def stacked_fn(q, cache, layer_idx):
            return flash_prefill_attention(
                q, cache, layer_idx, pad_lens, q_per_kv, windows[layer_idx], q_offset
            )

        return stacked_fn

    def _prefill_forward(self, tokens, pad_lens, B: int, S: int, C: int, cache,
                         start: int = 0):
        """Whole- or chunked-prompt prefill into ``cache``; returns the
        last-position logits. Chunk c runs the queries at cache slots
        [lo, hi) with the kernel's q_offset = lo.

        ``start`` > 0 is the prefix cache's resume boundary K: ``cache``
        arrives seeded with gathered prefix KV for slots < K, and the
        forward runs over [K, S) only, chunk by chunk from K, as chunked
        prefill's later chunks run."""
        positions = prefill_positions(pad_lens, S)
        mask = None if self.use_kernels else prefill_attention_mask(pad_lens, S, C)
        CL = self.prefill_chunk_tokens
        span = S - start
        step = CL if CL and span > CL else span
        logits = None
        for lo in range(start, S, step):
            hi = min(S, lo + step)
            logits = self.model(
                tokens[:, lo:hi], positions[:, lo:hi], cache, lo,
                None if mask is None else mask[:, lo:hi, :],
                last_only=(hi == S),
                stacked_attention_fn=self._prefill_stacked(pad_lens, lo),
            )
            self.stats.prefill_forwards += 1
        return logits

    def _decode_stacked(self, pad_lens, fill):
        """K2 at ``fill``: an int, or a one-element int32 tensor on the
        device (the captured step's); each layer's window is a host int,
        fixed in a captured step. None on the dense path."""
        if not self.use_kernels:
            return None
        q_per_kv, windows = self.cfg.q_per_kv, self.windows

        def stacked_fn(q, cache, layer_idx):
            return flash_decode_attention(
                q, cache, layer_idx, pad_lens, fill, q_per_kv, windows[layer_idx]
            )

        return stacked_fn

    def _require_verify_kernel(self, path: str) -> None:
        """Raise where ``path`` would launch K3 at a head_dim it does not
        take yet: it never carries on through dense attention. It guards
        the day K1 and K2 take a head_dim before K3 does; no head_dim
        reaches it today (kernel_gates)."""
        if self.verify_missing:
            raise NotImplementedError(
                f"{path} runs K3 (flash_spec_verify_attention), which does not take "
                f"head_dim {self.cfg.head_dim} on the card: {B4}"
            )

    def _verify_stacked(self, pad_lens, fills):
        """K3 over per-row fills (a [B] int32 tensor that stays on the
        device), at each layer's window; None on the dense path."""
        if not self.use_kernels:
            return None
        q_per_kv, windows = self.cfg.q_per_kv, self.windows

        def stacked_fn(q, cache, layer_idx):
            return flash_spec_verify_attention(
                q, cache, layer_idx, pad_lens, fills, q_per_kv, windows[layer_idx]
            )

        return stacked_fn

    def _verify_forward(self, toks, pad_lens, fills, cache, C: int):
        """One forward over toks [B, Sq] sitting at per-row cache slots
        fills_b .. fills_b + Sq - 1 (the spec verify step, Sq = k + 1, and
        the slot segment, Sq = 1); writes their K/V at those slots."""
        Sq = toks.shape[1]
        fills = fills.to(torch.int32)
        mask = None if self.use_kernels else verify_attention_mask(pad_lens, fills, Sq, C)
        return self.model(
            toks, verify_positions(pad_lens, fills, Sq), cache, fills, mask,
            stacked_attention_fn=self._verify_stacked(pad_lens, fills),
        )

    # hot path
    def _prefill_group(self, tokens_np, pad_np, S: int, C: int, gen, seed: int, uids,
                       resume=None):
        """Prefill a packed left-padded batch into a fresh cache of C slots
        and sample each row's first token, keyed on (seed, uids[row], 0).
        The one-shot and spec paths pass the row positions as uids; a slot
        loop's join group passes per-request uids, so a request's stream
        does not depend on when it joined or with whom. All-pad filler rows
        start done, else they would hold off the early exit. ``resume`` =
        (K, seeded cache of C slots) from ``_prepare_resume`` runs the
        forward over slots [K, S) of that cache only. Returns (first [B],
        cache, pad_lens [B] int32, done [B])."""
        dev = self.device
        _, vocab_limit, restrict = self._sampling_setup(gen)
        pad_lens = torch.from_numpy(pad_np).to(dev)
        if resume is None:
            start = 0
            cache = init_kv_cache(self.cfg, len(pad_np), C, quantized=self.quantize_kv,
                                  device=dev)
        else:
            start, cache = resume
        logits = self._prefill_forward(
            torch.from_numpy(tokens_np).to(dev), pad_lens, len(pad_np), S, C, cache, start
        )
        first = self._sample(logits, seed, list(uids), 0, gen, vocab_limit, restrict)
        return first, cache, pad_lens, pad_lens == S

    # hot path
    def _decode_step(self, buffers, cache, pads, S: int, C: int, gen, seed: int, sampling):
        """The one-token decode step of a packed group over its
        ``capture.decode_buffers``, as ``step(t_host)``
        (``capture.token_step``): the forward writes the cache at ``S + t``
        for every row (``cache_write``'s tensor branch) and K2 reads its
        fill ``S + t`` on the device, so the step also runs as a captured
        graph. Sampled rows key step ``t_host + 1``."""
        eos, vocab_limit, restrict = sampling
        uids = list(range(pads.shape[0]))

        def forward(cur, t):
            fill = t + S                                                    # [1]
            mask = None if self.use_kernels else decode_attention_mask(pads, fill, C)
            return self.model(
                cur[:, None], ((S - pads.long()) + t)[:, None], cache,
                fill.expand(cur.shape[0]), mask,
                stacked_attention_fn=self._decode_stacked(pads, fill.to(torch.int32)),
            )

        def sample(logits, step):
            return self._sample(logits, seed, uids, step, gen, vocab_limit, restrict)

        return token_step(buffers, eos, self.tok.pad_id, forward, sample)

    # hot path
    def _run_group(self, tokens_np, pad_np, B: int, S: int, max_new: int, gen, seed: int,
                   resume=None, occupancy: int = 0, tracing: bool = False):
        """Prefill (resumed from ``resume``'s seeded cache, when given) +
        decode of one packed batch; returns (out ids [B, max_new], cache).
        Decode writes only slots >= S, so the returned cache holds the
        prompt's prefix KV as the prefill wrote it. With ``tracing`` the
        ``prefill`` and ``decode_seg`` spans end at the syncs the group
        already pays (the prefill sync is the batch's TTFT anchor)."""
        C = S + max_new
        sampling = self._sampling_setup(gen)

        t_pre = time.time()
        t_pre_m = time.monotonic()
        cur, cache, pad_lens, done = self._prefill_group(
            tokens_np, pad_np, S, C, gen, seed, range(B), resume
        )
        self._sync()
        prefill_s = time.time() - t_pre
        self.stats.add_phase("prefill", prefill_s)
        if tracing:
            emit("prefill", t_pre_m, prefill_s, B=B, S=S, occupancy=occupancy, synced=True)

        t_dec = time.time()
        t_dec_m = time.monotonic()
        buffers = decode_buffers(cur, done, max_new, self.tok.pad_id)
        run = decode_loop(
            self._decode_step(buffers, cache, pad_lens, S, C, gen, seed, sampling), done,
            max_new, capture=captures(gen, self.cuda_graphs, self._graphs_required),
        )
        out_h = buffers["out"].cpu().numpy()  # synchronizes
        decode_s = time.time() - t_dec
        if tracing:
            # the out fetch above synced: a true device time. One span for
            # the group's decode loop (the JAX engine's continuous path
            # emits one a segment)
            emit("decode_seg", t_dec_m, decode_s, B=B, S=S, steps=run.steps,
                 live=int((~buffers["done"]).sum()),
                 kv_frac=round((S + run.steps) / (S + max_new), 4))
        self.stats.decode_steps += run.steps
        self.stats.graph_captures += run.captures
        self.stats.captured_steps += run.replays
        self.stats.add_phase("decode", decode_s)
        return out_h, cache

    # -- speculative decoding (reference-guided, vnsum_tpu_torch.spec) -----

    def _spec_step(self, state, gen, seed: int, S: int, C: int, max_new: int):
        """One speculative step of a packed group: draft (n-gram suffix
        match of each row's emitted tail against its reference), verify (ONE
        forward over k + 1 positions per row at the row's own fill, through
        K3), accept (exact argmax prefix for greedy, rejection-style for
        sampling), emit. Rows accept different draft counts, so fills and
        emitted counts ``e`` are [B] tensors; rejected drafts roll back by
        not advancing ``e``: their stale cache slots sit past every mask and
        the next step's write at the row's true fill overwrites them.

        Nothing here reads the device: ``state`` holds device tensors, and
        the caller fetches (n_draft, accepted, done) once per step."""
        k = gen.spec_k
        k1 = k + 1
        N = max(gen.spec_ngram, 1)
        eos, vocab_limit, restrict = state["sampling"]
        cur, done, e, out = state["cur"], state["done"], state["e"], state["out"]
        dev = cur.device
        B = cur.shape[0]

        # draft: the last N emitted tokens (with cur) against the reference
        if N > 1:
            out_pad = torch.cat(
                [torch.full((B, N - 1), NO_TOKEN, dtype=out.dtype, device=dev), out], dim=1
            )
            hist = torch.gather(out_pad, 1, e[:, None] + torch.arange(N - 1, device=dev)[None, :])
            tail = torch.cat([hist, cur[:, None]], dim=1)
        else:
            tail = cur[:, None]
        drafts, n_draft = propose_drafts(state["ref"], state["ref_lens"], tail, k)
        # done rows draft nothing; live rows never draft past the budget
        n_draft = n_draft.masked_fill(done, 0)
        n_draft = torch.minimum(n_draft, (max_new - e - 1).clamp_min(0))

        # verify: one forward over k + 1 positions per row
        toks = torch.cat([cur[:, None], drafts], dim=1)                    # [B, k1]
        logits = self._verify_forward(toks, state["pads"], S + e, state["cache"], C)
        logits = restrict(logits[:, :, :vocab_limit])

        # accept: position i (when reached) emits stream token e + i, so its
        # randomness is keyed on that absolute position; the host mirrors e
        seeds = None
        if gen.temperature > 0:
            seeds = [
                [row_seed(seed, u, int(state["e_host"][u]) + i + 1) for i in range(k1)]
                for u in range(B)
            ]
        m, nxt = draft_acceptance_rows(
            logits, drafts, n_draft, seeds, gen.temperature, gen.top_k, gen.top_p
        )

        # emit cur plus the accepted drafts, cut just after a terminator
        # (the terminator itself is emitted and detok-stripped, as in the
        # plain decode's emit-before-done-check)
        idx = torch.arange(k1, device=dev)[None, :]
        is_term = torch.isin(toks, eos)
        no_term_before = torch.cumprod(
            torch.cat(
                [torch.ones((B, 1), dtype=torch.long, device=dev), (~is_term[:, :-1]).long()],
                dim=1,
            ),
            dim=1,
        ).bool()
        valid = (idx <= m[:, None]) & no_term_before & ~done[:, None]
        emit = torch.where(valid, toks, torch.full_like(toks, self.tok.pad_id))
        out.scatter_(1, e[:, None] + idx, emit)
        n_emit = valid.sum(dim=1)
        state["e"] = e + n_emit
        state["done"] = done | (is_term & valid).any(dim=1) | (state["e"] >= max_new)
        state["cur"] = torch.where(done, cur, nxt)
        return n_draft, (n_emit - 1).clamp_min(0)

    # hot path
    def _run_group_spec(
        self, group, encoded, references, max_new: int, gen, results, report, seed: int,
        tracing: bool = False,
    ) -> None:
        """Generate one prompt group with reference-guided speculation: the
        shared prefill, then a host loop of spec steps. Every step retires
        >= 1 token per live row, so the loop is bounded by max_new; rows
        whose reference never matches retire exactly one token a step.

        Cache and out geometry: C = S + max_new + k + 1 and ``out`` is
        max_new + k + 1 wide, so a step entered at e = max_new - 1 (or a done
        row parked at e = max_new) writes its fixed k + 1 tokens in bounds."""
        self._require_verify_kernel("the spec path")
        dev = self.device
        k1 = gen.spec_k + 1
        tokens_np, pads_np, B, S = self._pack_group(group, encoded, max_new)
        C = S + max_new + k1

        # per-row reference buffers, R bucketed to a power of two
        refs_group = [references[i] for i in group]
        ref_np, ref_lens_np = encode_references(self.tok, refs_group, _SPEC_MAX_REF_TOKENS)
        R = 64
        while R < ref_np.shape[1]:
            R *= 2
        ref_full = np.full((B, R), NO_TOKEN, dtype=np.int64)
        ref_full[: len(group), : ref_np.shape[1]] = ref_np
        lens_full = np.zeros((B,), dtype=np.int64)
        lens_full[: len(group)] = ref_lens_np

        t_pre = time.time()
        t_pre_m = time.monotonic()
        cur, cache, pad_lens, done = self._prefill_group(
            tokens_np, pads_np, S, C, gen, seed, range(B)
        )
        prev_done = done.cpu().numpy()  # seeds the host loop's exit condition
        self.stats.add_phase("prefill", time.time() - t_pre)
        if tracing:
            emit("spec_prefill", t_pre_m, time.time() - t_pre, B=B, S=S,
                 occupancy=len(group), synced=True)
        self.stats.batches += 1
        self.stats.by_bucket[(B, S)] = self.stats.by_bucket.get((B, S), 0) + 1

        state = {
            "sampling": self._sampling_setup(gen), "cur": cur, "done": done, "cache": cache, "pads": pad_lens,
            "e": torch.zeros((B,), dtype=torch.long, device=dev),
            "e_host": np.zeros((B,), dtype=np.int64),
            "out": torch.full((B, max_new + k1), self.tok.pad_id, dtype=torch.long, device=dev),
            "ref": torch.from_numpy(ref_full).to(dev),
            "ref_lens": torch.from_numpy(lens_full).to(dev),
        }
        drafted = np.zeros((B,), dtype=np.int64)
        accepted = np.zeros((B,), dtype=np.int64)
        steps_live = np.zeros((B,), dtype=np.int64)
        t_dec = time.time()
        while not prev_done.all():
            t_step = time.monotonic() if tracing else 0.0
            n_draft, acc = self._spec_step(state, gen, seed, S, C, max_new)
            # ONE fetch per verify step: draft/accept counts feed the stats,
            # done drives the loop's exit
            nd_h, acc_h, done_h = torch.stack(
                [n_draft, acc, state["done"].long()]
            ).cpu().numpy()
            live = ~prev_done
            steps_live += live
            drafted += nd_h
            accepted += acc_h
            # a live row emits its accepted drafts plus one token
            state["e_host"] += np.where(live, acc_h + 1, 0)
            prev_done = done_h.astype(bool)
            self.stats.spec_verify_steps += 1
            if tracing:
                # the nd/acc/done fetch above is the sync the loop already pays
                emit("spec_step", t_step, time.monotonic() - t_step, B=B,
                     k=gen.spec_k, live=int((~prev_done).sum()),
                     drafted=int(nd_h.sum()), accepted=int(acc_h.sum()))
        self.stats.add_phase("spec_decode", time.time() - t_dec)
        self.stats.spec_draft_tokens += int(drafted[: len(group)].sum())
        self.stats.spec_accepted_tokens += int(accepted[: len(group)].sum())

        out_h = state["out"].cpu().numpy()[:, :max_new]
        for row, i in enumerate(group):
            results[i] = self._detok(out_h[row], tuple(gen.eos_ids))
            report[i] = SpecRecord(
                draft_tokens=int(drafted[row]),
                accepted_tokens=int(accepted[row]),
                verify_steps=int(steps_live[row]),
            )

    # -- in-flight slot programs (backend/inflight.py) ---------------------

    # hot path
    def _slot_segment(self, st, S: int, max_new: int, gen, seed: int, uids, steps: int) -> int:
        """Advance every live slot by up to ``steps`` tokens, with PER-ROW
        step counters ``t``: slots at different generation depths decode
        together, so fills, positions and cache writes are per row and the
        attention is K3 at Sq = 1. For any single row the emitted-token math
        is the one-shot decode's.

        ``st`` holds the resident device state (t, cur, cache, done, out,
        pads), updated in place. The all-done check reads the device every
        ``DONE_CHECK_INTERVAL`` steps; the steps after every row is done
        change no output (done rows freeze their t, cur and out), so where
        the loop stops never matters. Sampled rows key step t of request uid
        on (seed, uid, t + 1), which needs t on the host: a sampled segment
        reads it once a step. Returns the steps run."""
        C = S + max_new
        eos, vocab_limit, restrict = self._sampling_setup(gen)
        ran = 0
        for k in range(steps):
            if k % DONE_CHECK_INTERVAL == 0 and bool(st["done"].all()):
                break
            t, cur, done, out = st["t"], st["cur"], st["done"], st["out"]
            # emit BEFORE sampling; a done row keeps its out row (its stale
            # cur must not clobber its last real token)
            col = t.clamp_max(max_new - 1)[:, None]
            out.scatter_(1, col, torch.where(done, torch.gather(out, 1, col)[:, 0], cur)[:, None])
            done = done | torch.isin(cur, eos)
            logits = self._verify_forward(cur[:, None], st["pads"], S + t, st["cache"], C)
            seeds = []
            if gen.temperature > 0:
                seeds = [row_seed(seed, u, tt + 1) for u, tt in zip(uids, t.tolist())]
            nxt = sample_logits_rows(
                restrict(logits[:, -1, :vocab_limit]), seeds,
                gen.temperature, gen.top_k, gen.top_p,
            )
            # done rows freeze t (their out cursor) and cur
            t = torch.where(done, t, t + 1)
            done = done | (t >= max_new)
            st["t"], st["done"] = t, done
            st["cur"] = torch.where(done, cur, nxt)
            ran += 1
        self.stats.decode_steps += ran
        return ran

    def _adopt(self, st, join_cache, first, done0, join_pads, slot_idx) -> None:
        """Scatter a join group's freshly prefilled cache rows and per-row
        state into the resident slot batch at ``slot_idx``, in place. The
        targets are distinct free slots (the loop caps the join bucket at
        the free-slot count), so the order of the writes never matters."""
        idx = torch.as_tensor(slot_idx, dtype=torch.long, device=self.device)
        for name, buf in st["cache"].items():
            buf.index_copy_(1, idx, join_cache[name])
        st["cur"][idx] = first
        st["done"][idx] = done0
        st["t"][idx] = 0
        st["out"][idx] = self.tok.pad_id
        st["pads"][idx] = join_pads

    def start_slot_loop(
        self,
        slots: int | None = None,
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        prompt_tokens: int = 0,
        fused_segments: int = 1,
    ):
        """Open a persistent in-flight loop: a fixed batch of ``slots`` rows
        where finished rows are harvested at every segment boundary and freed
        slots are refilled from new prompts (prefill, then an adopt scatter
        into the resident cache). ``prompt_tokens`` fixes the prompt bucket S
        (0 = the full context minus the decode budget); longer prompts are
        rejected at admit, for the caller to send through ``generate``.
        ``fused_segments`` runs N segments per dispatch: joins and harvests
        coarsen to that cadence, greedy outputs stay identical."""
        from .inflight import TorchSlotLoop

        self._require_verify_kernel("the slot loop")
        n_slots = slots or self.batch_size
        gen = config or self.gen_cfg
        max_new = resolve_max_new(max_new_tokens, gen, self.max_new_tokens)
        if max_new >= self.cfg.max_seq_len:
            raise ValueError(
                f"max_new_tokens={max_new} must be < max_seq_len={self.cfg.max_seq_len}"
            )
        max_input = self.cfg.max_seq_len - max_new
        S = prompt_tokens or _bucket_len(max_input, max_input)
        if S > max_input:
            raise ValueError(
                f"prompt_tokens={S} exceeds the context budget {max_input} "
                "(max_seq_len - max_new_tokens)"
            )
        return TorchSlotLoop(
            self, n_slots, S, max_new, gen, seed=self._next_seed(gen),
            fused_segments=fused_segments,
        )

    def _pack_group(self, group, encoded, max_new: int):
        """Pack one prompt group into a fixed-shape left-padded batch; the
        batch dim buckets to a power of two so a trailing partial group
        does not pay for all-pad rows up to the full batch_size."""
        t_pack = time.time()
        max_input = self.cfg.max_seq_len - max_new
        S = _bucket_len(max(len(encoded[i]) for i in group), max_input)
        B = 1
        while B < len(group):
            B *= 2
        B = min(B, self.batch_size)
        tokens, pad_lens = left_pad_batch(
            [encoded[i] for i in group], B, S, self.tok.pad_id
        )
        self.stats.add_phase("pack_host", time.time() - t_pack)
        return tokens, pad_lens, B, S

    # -- prefix KV cache (vnsum_tpu_torch.cache) ---------------------------

    def _prepare_resume(self, group, encoded, matches, pad_lens, B: int, S: int,
                        max_new: int, tracing: bool = False):
        """The skip boundary K for one packed group, and a fresh cache of
        S + max_new slots seeded with the group's matched prefix blocks.

        Slot arithmetic (left-padded rows; pad_r = S - len_r):

        - K = the floor, on a coarse grid, of S minus the longest uncovered
          suffix: for every row, slots [pad_r, K) are covered by matched
          blocks, so ONE boundary serves the whole batch; rows whose prompt
          starts at or after K (pad_r >= K) need no blocks;
        - row r gathers ceil((K - pad_r) / BLK) blocks at slots
          pad_r + i * BLK; ragged rows pad with the scratch block, whose
          writes land at slots >= K (clamped to at most C - BLK, which
          K <= C - BLK keeps >= K), inside the span the resume prefill
          (slots [K, S)) or decode (slots >= S, each written before it is
          attended) overwrites, so padding never corrupts a live row.

        The grid (steps of max(128, S / 8)) is the JAX engine's, where each
        K compiles a program of its own; here it keeps the per-prompt cache
        reports equal to that engine's. Returns (K, seeded cache, skipped
        tokens a row), or None when the group has no usable coverage."""
        pc = self.prefix_cache
        BLK = pc.block_tokens
        max_suffix = max(len(encoded[i]) - matches[i].tokens for i in group)
        step = max(128, S // 8 // 128 * 128)
        K = min(S - max_suffix, S + max_new - BLK) // step * step
        if K < 128:
            return None
        ids_rows: list[list[int]] = []
        for row, i in enumerate(group):
            need = K - int(pad_lens[row])
            n = -(-need // BLK) if need > 0 else 0
            ids_rows.append(matches[i].blocks[:n])
        nb_max = max(len(blocks) for blocks in ids_rows)
        if nb_max == 0:
            return None
        t0 = time.time()
        t0_m = time.monotonic()
        ids = np.full((B, nb_max), pc.store.scratch_id, dtype=np.int64)
        for row, blocks in enumerate(ids_rows):
            ids[row, : len(blocks)] = blocks
        cache = init_kv_cache(self.cfg, B, S + max_new, quantized=self.quantize_kv,
                              device=self.device)
        pc.gather(cache, ids, pad_lens)
        self._sync()
        self.stats.add_phase("cache_gather", time.time() - t0)
        skipped = [max(K - int(pad_lens[row]), 0) for row in range(len(group))]
        if tracing:
            emit("cache_gather", t0_m, time.time() - t0, B=B, K=K,
                 blocks=int((ids != pc.store.scratch_id).sum()), hit_tokens=sum(skipped))
        return K, cache, skipped

    def _cache_insert(self, cache, group, encoded, matches, hints, pad_lens,
                      tracing: bool = False) -> int:
        """Index the freshly prefilled prompts and copy their new prefix
        blocks into the pool. A cache_hint bounds a prompt's insertion to
        its hint-covered prefix (template headers, carried-forward
        summaries) so unique content tails do not churn the pool; without
        one the whole prompt (minus its last token) is insertable and LRU
        manages it. Returns the number of new blocks."""
        pc = self.prefix_cache
        if not self.cache_inserts_enabled:
            return 0
        BLK = pc.block_tokens
        t0 = time.time()
        t0_m = time.monotonic()
        evict0 = pc.index.stats.evictions
        rows = []
        for row, i in enumerate(group):
            ids = encoded[i]
            target = len(ids) - 1
            hint = hints[i] if hints else None
            if hint:
                target = min(self._hint_prefix_len(hint, ids), target)
            upto = target // BLK * BLK
            if upto > matches[i].tokens:
                rows.append((row, int(pad_lens[row]), ids, upto))
        new_blocks = pc.insert_rows(cache, rows)
        self._sync()
        self.stats.add_phase("cache_insert", time.time() - t0)
        if tracing and (new_blocks or pc.index.stats.evictions != evict0):
            emit("cache_insert", t0_m, time.time() - t0, blocks=new_blocks,
                 evictions=pc.index.stats.evictions - evict0)
        return new_blocks

    def _hint_prefix_len(self, hint: str, ids: list[int]) -> int:
        """Token-aligned hint boundary: the longest common prefix of the
        hint's own encoding and the prompt's. Exact when tokenization is
        prefix-stable; safely shorter when a merge crosses the boundary."""
        hint_ids = self._hint_ids_cache.get(hint)
        if hint_ids is None:
            if len(self._hint_ids_cache) >= 256:
                self._hint_ids_cache.clear()
            hint_ids = self.tok.encode(hint, add_bos=True)
            self._hint_ids_cache[hint] = hint_ids
        n = min(len(hint_ids), len(ids))
        k = 0
        while k < n and hint_ids[k] == ids[k]:
            k += 1
        return k

    def set_prefix_cache_inserts(self, enabled: bool) -> None:
        """Gate prefix-cache insertion while hits keep serving. Engine
        thread only, like every generate call."""
        self.cache_inserts_enabled = bool(enabled)

    def cached_prefix_tokens(self, text: str, cache_hint: str | None = None) -> int:
        """Read-only probe, safe from other threads: how many prompt tokens
        the prefix cache would serve now. An estimate: the usable skip also
        depends on the batch (the grid-aligned K)."""
        if self.prefix_cache is None:
            return 0
        ids = self.tok.encode(text, add_bos=True)
        # generate's truncation for the default decode budget, so the
        # estimate never exceeds what a call could reuse
        max_input = self.cfg.max_seq_len - self.max_new_tokens
        if len(ids) > max_input:
            ids = ids[:max_input]
        return self.prefix_cache.probe(ids, max_tokens=len(ids) - 1)

    def prefix_cache_stats(self) -> dict | None:
        """Pool and index counters (None: the cache is off)."""
        if self.prefix_cache is None:
            return None
        return self.prefix_cache.stats_dict()

    def take_cache_report(self) -> list[int]:
        """Per-prompt prefill tokens served from the prefix cache on the
        last generate call (empty when the cache was off), cleared on
        read."""
        report, self._cache_report = self._cache_report, []
        return report

    # -- public API --------------------------------------------------------

    # hot path
    @torch.inference_mode()
    def generate(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        references: list[str | None] | None = None,
        cache_hints: list[str | None] | None = None,
    ) -> list[str]:
        """One completion per prompt, order-preserving. ``references``
        aligns one source text per prompt: with ``spec_k > 0`` a group with
        any reference decodes speculatively, drafting from it. With the
        prefix cache on, ``cache_hints`` (one per prompt) bound each
        prompt's insertion into the pool to its hinted prefix."""
        gen = config or self.gen_cfg
        max_new = resolve_max_new(max_new_tokens, gen, self.max_new_tokens)
        if max_new >= self.cfg.max_seq_len:
            raise ValueError(
                f"max_new_tokens={max_new} must be < max_seq_len={self.cfg.max_seq_len}"
            )
        if not prompts:
            return []
        if references is not None and len(references) != len(prompts):
            raise ValueError(
                f"references must align with prompts: got {len(references)} "
                f"for {len(prompts)}"
            )
        if cache_hints is not None and len(cache_hints) != len(prompts):
            raise ValueError(
                f"cache_hints must align with prompts: got {len(cache_hints)} "
                f"for {len(prompts)}"
            )
        spec_on = gen.spec_k > 0 and references is not None and any(references)
        spec_report: list = [None] * len(prompts) if spec_on else []
        self.stats.calls += 1
        self.stats.prompts += len(prompts)
        # cleared up front: a call that errors mid-loop leaves no previous
        # call's attribution behind
        self._cache_report = []
        # telemetry gate (obs/trace.py), resolved once per call: untraced
        # runs skip every span's timestamps and host reads
        tracing = current_collector() is not None
        max_input = self.cfg.max_seq_len - max_new
        encoded: list[list[int]] = []
        t_enc = time.time()
        t_enc_m = time.monotonic()
        for ids in self.tok.encode_batch(prompts, add_bos=True):
            if len(ids) > max_input:
                ids = ids[:max_input]
            encoded.append(ids)
            self.stats.prompt_tokens += len(ids)
        self.stats.add_phase("tokenize_host", time.time() - t_enc)
        if tracing:
            emit("tokenize", t_enc_m, time.time() - t_enc, prompts=len(prompts))

        # prefix KV cache: match every prompt (pinning the matched blocks
        # for the call) and order rows by UNCOVERED suffix: a group's skip K
        # is S minus its longest suffix, so one cold row in a warm group
        # would zero everyone's reuse. Spec calls bypass the cache: the
        # verify path's per-row fills do not share one resume boundary
        pc = self.prefix_cache
        use_cache = pc is not None and not spec_on
        matches = None
        cache_report = [0] * len(encoded)
        if use_cache:
            t_cl = time.time()
            t_cl_m = time.monotonic() if tracing else 0.0
            matches = [pc.match(ids, max_tokens=len(ids) - 1) for ids in encoded]
            if tracing:
                emit("cache_lookup", t_cl_m, time.time() - t_cl, prompts=len(encoded),
                     hit_tokens=sum(m.tokens for m in matches))
            order = sorted(range(len(encoded)),
                           key=lambda i: (len(encoded[i]) - matches[i].tokens, len(encoded[i])))
        else:
            # group indices by length, then emit fixed-shape batches
            order = sorted(range(len(encoded)), key=lambda i: len(encoded[i]))
        results: list[str | None] = [None] * len(encoded)
        t0 = time.time()
        try:
            for start in range(0, len(order), self.batch_size):
                group = order[start : start + self.batch_size]
                seed = self._next_seed(gen)
                # per-group routing: a group whose prompts carry no reference
                # would pay the (k+1)-wide verify forward to retire one token
                # a step, so it takes the plain path (same greedy output)
                if spec_on and any(references[i] for i in group):
                    self._run_group_spec(
                        group, encoded, references, max_new, gen, results, spec_report, seed,
                        tracing,
                    )
                    continue
                tokens, pad_lens, B, S = self._pack_group(group, encoded, max_new)
                resume = None
                if use_cache:
                    resume = self._prepare_resume(group, encoded, matches, pad_lens, B, S,
                                                  max_new, tracing)
                    if resume is not None:
                        for row, i in enumerate(group):
                            cache_report[i] = resume[2][row]
                steps = self.stats.decode_steps
                t_disp = time.monotonic() if tracing else 0.0
                out, cache = self._run_group(tokens, pad_lens, B, S, max_new, gen, seed,
                                             resume and resume[:2], len(group), tracing)
                if tracing:
                    # the group's whole device call, its result fetched
                    emit("dispatch", t_disp, time.monotonic() - t_disp, B=B, S=S,
                         occupancy=len(group), max_new=max_new)
                self.stats.batches += 1
                self.stats.by_bucket[(B, S)] = self.stats.by_bucket.get((B, S), 0) + 1
                self.stats.steps_by_bucket[(B, S)] = (
                    self.stats.steps_by_bucket.get((B, S), 0) + self.stats.decode_steps - steps
                )
                if use_cache:
                    self._cache_insert(cache, group, encoded, matches, cache_hints, pad_lens,
                                       tracing)
                del cache  # freed before the next group allocates its own
                t_detok = time.monotonic() if tracing else 0.0
                for row, i in enumerate(group):
                    results[i] = self._detok(out[row], tuple(gen.eos_ids))
                if tracing:
                    emit("detokenize", t_detok, time.monotonic() - t_detok, rows=len(group))
        finally:
            if matches is not None:
                for m in matches:
                    pc.release(m)
        self.stats.generate_seconds += time.time() - t0
        if use_cache:
            hit = sum(cache_report)
            self.stats.cache_hit_tokens += hit
            self.stats.cache_miss_tokens += sum(len(e) for e in encoded) - hit
        self._cache_report = cache_report if use_cache else []
        # rows whose group took the plain path report zeros, keeping the
        # per-prompt alignment
        self._spec_report = [r if r is not None else SpecRecord() for r in spec_report]
        return results  # type: ignore[return-value]

    # -- constrained choice scoring ------------------------------------------

    def _choice_logits(self, tokens_np, pad_np, S: int, choice_ids: torch.Tensor):
        """One prefill of a packed batch into a cache of C = S slots (no
        decode budget: the cache only serves the forward), then the last
        position's logits gathered at ``choice_ids``: [B, K] f32."""
        dev = self.device
        B = len(pad_np)
        cache = init_kv_cache(self.cfg, B, S, quantized=self.quantize_kv, device=dev)
        logits = self._prefill_forward(
            torch.from_numpy(tokens_np).to(dev), torch.from_numpy(pad_np).to(dev), B, S, S, cache
        )
        return logits[:, -1, :].index_select(-1, choice_ids)

    # hot path
    @torch.inference_mode()
    def score_choices(self, prompts: list[str], choices: list[str]) -> list[int]:
        """For each prompt, the index of the choice whose FIRST token has the
        highest next-token logit after prefilling the prompt.

        Prompts longer than the context are cut from the LEFT, keeping BOS:
        the tail is where a forced template ends, so it must survive.
        Choices must differ in their first token id (the G-Eval judge uses
        the digits "1".."5", one byte each)."""
        ids = []
        for c in choices:
            enc = self.tok.encode(c, add_bos=False)
            if not enc:
                raise ValueError(f"choice {c!r} encodes to no tokens")
            ids.append(enc[0])
        if len(set(ids)) != len(ids):
            raise ValueError("choices must differ in their first token")
        choice_dev = torch.tensor(ids, dtype=torch.long, device=self.device)

        self.stats.calls += 1
        self.stats.prompts += len(prompts)
        max_input = self.cfg.max_seq_len
        encoded: list[list[int]] = []
        t_enc = time.time()
        for tok_ids in self.tok.encode_batch(prompts, add_bos=True):
            if len(tok_ids) > max_input:
                tok_ids = [tok_ids[0]] + tok_ids[-(max_input - 1):]
            encoded.append(tok_ids)
            self.stats.prompt_tokens += len(tok_ids)
        self.stats.add_phase("tokenize_host", time.time() - t_enc)

        order = sorted(range(len(encoded)), key=lambda i: len(encoded[i]))
        results: list[int] = [0] * len(encoded)
        for start in range(0, len(order), self.batch_size):
            group = order[start : start + self.batch_size]
            # no decode budget: the whole context is prompt space; the
            # bucketing and padding rules are generate()'s
            tokens, pad_lens, B, S = self._pack_group(group, encoded, 0)
            t_disp = time.time()
            idx = self._choice_logits(tokens, pad_lens, S, choice_dev).argmax(dim=-1)
            idx_h = idx.cpu().numpy()  # the group's one host read
            self.stats.add_phase("choice", time.time() - t_disp)
            self.stats.batches += 1
            self.stats.by_bucket[(B, S)] = self.stats.by_bucket.get((B, S), 0) + 1
            for row, i in enumerate(group):
                results[i] = int(idx_h[row])
        return results

    def take_spec_report(self) -> list[SpecRecord]:
        """Per-prompt SpecRecords of the last generate call, aligned with its
        prompt order (empty when speculation was off), cleared on read."""
        report, self._spec_report = self._spec_report, []
        return report

    def _detok(self, ids: np.ndarray, extra_eos: tuple[int, ...] = ()) -> str:
        self.stats.generated_tokens += int((ids != self.tok.pad_id).sum())
        out = trim_to_eos(
            ids.tolist(), self.tok.eos_id, self.tok.pad_id, extra_eos
        )
        return self.tok.decode(out).strip()

    def count_tokens(self, text: str) -> int:
        return self.tok.count(text)

    def count_tokens_batch(self, texts: list[str]) -> list[int]:
        return self.tok.count_batch(texts)
