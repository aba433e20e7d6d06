"""TorchBackend — batched generation on one card.

Counterpart of the one-shot path of ``vnsum_tpu/backend/engine.py``
(``TpuBackend``). A list of prompts becomes length-bucketed, fixed-shape
left-padded [B, S] batches; each batch runs a whole or chunked prefill
through the decoder, then a greedy (or seeded sampled) decode loop with
per-row EOS masking and an early exit once every row is done.

The JAX program runs the decode as an on-device ``while_loop``; here it is a
Python loop over eager steps. The all-done check reads the device only
every ``_DONE_CHECK_INTERVAL`` steps: the steps between a batch finishing
and the next check emit pad for every row, so outputs are identical to a
check at every step.

With ``flash`` on, attention goes through the hand-written kernels
(``ops/flash_attention.py`` for prefill, ``ops/decode_attention.py`` for
decode) and the KV cache is int8 by default, as in the JAX engine. On the
CPU the kernel wrappers take their plain versions.

Not ported yet: the prefix cache, speculative decoding, the continuous and
in-flight schedulers, meshes, ``score_choices``, int8 weights and W8A8.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.config import GenerationConfig
from ..core.logging import get_logger
from ..models.llama import (
    LlamaConfig,
    LlamaModel,
    decode_attention_mask,
    init_kv_cache,
    init_model,
    llama32_3b,
    prefill_attention_mask,
    prefill_positions,
)
from ..models.sampling import row_seed, sample_logits_rows
from ..ops.decode_attention import flash_decode_attention
from ..ops.flash_attention import flash_prefill_attention, supports_flash
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

logger = get_logger("vnsum.engine")

_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
# decode steps between host reads of the all-done flag (each read syncs)
_DONE_CHECK_INTERVAL = 16


def _bucket_len(n: int, max_len: int) -> int:
    for b in _BUCKETS:
        if n <= b and b <= max_len:
            return b
    return max_len


def resolve_device(device) -> torch.device:
    """The engine's device; "cuda" with no card visible raises instead of
    carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA card is visible; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


@dataclass
class EngineStats:
    """Wall-clock and token accounting for run records."""

    calls: int = 0
    prompts: int = 0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    generate_seconds: float = 0.0
    batches: int = 0
    # forwards through the decoder: one per prefill chunk, one per decode step
    prefill_forwards: int = 0
    decode_steps: int = 0
    by_bucket: dict = field(default_factory=dict)
    # "prefill" / "decode": device time, bounded by a synchronize at each
    # phase's end; host phases ("tokenize_host", "pack_host") by wall clock
    phase_seconds: dict = field(default_factory=dict)

    def add_phase(self, name: str, seconds: float) -> None:
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + seconds

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "by_bucket"}
        d["by_bucket"] = {f"B={b},S={s}": n for (b, s), n in self.by_bucket.items()}
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
        quantize_kv: str | bool = "auto",
        prefill_chunk_tokens: int = 0,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = model.cfg if model is not None else (model_config or llama32_3b())
        on_card = self.device.type == "cuda"
        # the kernels: on by default on the card; CPU callers pass
        # flash=True explicitly and get the kernels' plain versions
        if flash == "auto":
            flash = on_card
        self.flash = bool(flash)
        # the card's kernels take head_dim 128; their plain versions any
        kernels_supported = supports_flash(self.cfg.head_dim) or not on_card
        if quantize_kv == "auto":
            quantize_kv = self.flash and kernels_supported
        elif quantize_kv and not (self.flash and kernels_supported):
            raise ValueError(
                "quantize_kv=True needs the attention kernels (flash=True and, "
                "on the card, head_dim 128); the dense path "
                "would dequantize the whole cache per step"
            )
        self.quantize_kv = bool(quantize_kv)
        self.use_kernels = self.flash and kernels_supported
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
        self.stats = EngineStats()
        self._seed = seed
        self._dispatch = 0
        if model is None:
            t0 = time.time()
            model = init_model(self.cfg, seed, self.device)
            logger.info("initialized random params in %.1fs", time.time() - t0)
        elif model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        self.model = model

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
        if not self.use_kernels:
            return None
        q_per_kv = self.cfg.q_per_kv

        def stacked_fn(q, cache, layer_idx):
            return flash_prefill_attention(
                q, cache, layer_idx, pad_lens, q_per_kv, 0, q_offset
            )

        return stacked_fn

    def _prefill_forward(self, tokens, pad_lens, B: int, S: int, C: int, cache):
        """Whole- or chunked-prompt prefill into ``cache``; returns the
        last-position logits. Chunk c runs the queries at cache slots
        [lo, hi) with the kernel's q_offset = lo."""
        positions = prefill_positions(pad_lens, S)
        mask = None if self.use_kernels else prefill_attention_mask(pad_lens, S, C)
        CL = self.prefill_chunk_tokens
        step = CL if CL and S > CL else S
        logits = None
        for lo in range(0, S, step):
            hi = min(S, lo + step)
            logits = self.model(
                tokens[:, lo:hi], positions[:, lo:hi], cache, lo,
                None if mask is None else mask[:, lo:hi, :],
                last_only=(hi == S),
                stacked_attention_fn=self._prefill_stacked(pad_lens, lo),
            )
            self.stats.prefill_forwards += 1
        return logits

    def _decode_stacked(self, pad_lens, fill: int):
        if not self.use_kernels:
            return None
        q_per_kv = self.cfg.q_per_kv

        def stacked_fn(q, cache, layer_idx):
            return flash_decode_attention(q, cache, layer_idx, pad_lens, fill, q_per_kv, 0)

        return stacked_fn

    # hot path
    def _run_group(self, tokens_np, pad_np, B: int, S: int, max_new: int, gen, seed: int):
        """Prefill + decode of one packed batch; returns out ids [B, max_new]."""
        dev = self.device
        C = S + max_new
        eos, vocab_limit, restrict = self._sampling_setup(gen)
        pad_id = self.tok.pad_id
        tokens = torch.from_numpy(tokens_np).to(dev)
        pad_lens = torch.from_numpy(pad_np).to(dev)
        uids = list(range(B))

        t_pre = time.time()
        cache = init_kv_cache(self.cfg, B, C, quantized=self.quantize_kv, device=dev)
        logits = self._prefill_forward(tokens, pad_lens, B, S, C, cache)
        cur = self._sample(logits, seed, uids, 0, gen, vocab_limit, restrict)
        # all-pad filler rows start done, else they would hold off the exit
        done = pad_lens == S
        self._sync()
        prefill_s = time.time() - t_pre
        self.stats.add_phase("prefill", prefill_s)

        t_dec = time.time()
        out = torch.full((B, max_new), pad_id, dtype=torch.long, device=dev)
        pad_fill = torch.full_like(cur, pad_id)
        steps = 0
        for t in range(max_new):
            if t % _DONE_CHECK_INTERVAL == 0 and bool(done.all()):
                break
            # emit, then the done check, then forward, then sample
            out[:, t] = torch.where(done, pad_fill, cur)
            done = done | torch.isin(cur, eos)
            pos = (S - pad_lens.long()) + t
            mask = None
            if not self.use_kernels:
                mask = decode_attention_mask(pad_lens, S + t, C)
            logits = self.model(
                cur[:, None], pos[:, None], cache, S + t, mask,
                stacked_attention_fn=self._decode_stacked(pad_lens, S + t),
            )
            cur = self._sample(logits, seed, uids, t + 1, gen, vocab_limit, restrict)
            steps += 1
        out_h = out.cpu().numpy()  # synchronizes
        decode_s = time.time() - t_dec
        self.stats.decode_steps += steps
        self.stats.add_phase("decode", decode_s)
        return out_h

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

    # -- public API --------------------------------------------------------

    # hot path
    @torch.inference_mode()
    def generate(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
    ) -> list[str]:
        gen = config or self.gen_cfg
        max_new = resolve_max_new(max_new_tokens, gen, self.max_new_tokens)
        if max_new >= self.cfg.max_seq_len:
            raise ValueError(
                f"max_new_tokens={max_new} must be < max_seq_len={self.cfg.max_seq_len}"
            )
        if not prompts:
            return []
        self.stats.calls += 1
        self.stats.prompts += len(prompts)
        max_input = self.cfg.max_seq_len - max_new
        encoded: list[list[int]] = []
        t_enc = time.time()
        for ids in self.tok.encode_batch(prompts, add_bos=True):
            if len(ids) > max_input:
                ids = ids[:max_input]
            encoded.append(ids)
            self.stats.prompt_tokens += len(ids)
        self.stats.add_phase("tokenize_host", time.time() - t_enc)

        # group indices by length, then emit fixed-shape batches
        order = sorted(range(len(encoded)), key=lambda i: len(encoded[i]))
        results: list[str | None] = [None] * len(encoded)
        t0 = time.time()
        for start in range(0, len(order), self.batch_size):
            group = order[start : start + self.batch_size]
            seed = self._next_seed(gen)
            tokens, pad_lens, B, S = self._pack_group(group, encoded, max_new)
            out = self._run_group(tokens, pad_lens, B, S, max_new, gen, seed)
            self.stats.batches += 1
            self.stats.by_bucket[(B, S)] = self.stats.by_bucket.get((B, S), 0) + 1
            for row, i in enumerate(group):
                results[i] = self._detok(out[row], tuple(gen.eos_ids))
        self.stats.generate_seconds += time.time() - t0
        return results  # type: ignore[return-value]

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
